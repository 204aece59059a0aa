// Port copy of inferno_tpu/native/queueing.cc, verbatim below this
// comment apart from one source path in the comment that follows: the
// same code and C ABI, built with the same g++ flags, so the port's
// backend "native" and the reference's agree bit for bit.
//
// Native (C++) fleet sizing: the CPU fast path of the queueing solve.
//
// Semantics are defined by the Python scalar analyzer
// (inferno_tpu/analyzer/queue.py) and mirrored by the batched JAX kernel
// (inferno_tpu/ops/queueing.py); this file implements the same math in
// double precision for deployments where the controller runs without a
// TPU attachment (the reference's solver is likewise ordinary CPU code,
// the upstream project's pkg/analyzer/mm1modelstatedependent.go:70-116 and
// pkg/core/allocation.go:27-163).
//
// Per lane (one (server, slice-shape) pair):
//   mu(n)   = n / (prefill(n) + num_decodes * decode(n)),  n = 1..B
//   logp[k] = k*log(lam) - cumsum(log mu)  (stationary dist, log-space)
//   sizing  = bisection over lam for the TTFT and ITL targets, TPS cap,
//             then replicas = ceil(total_rate / rate*) and the expected
//             per-replica operating point.
//
// Exposed as a C ABI consumed via ctypes (inferno_tpu/native/__init__.py).
// Lanes are independent; an optional thread pool splits them.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr double kRateEps = 1e-3;            // analyzer.queue.RATE_EPSILON
constexpr double kStabilitySafety = 0.1;     // defaults.STABILITY_SAFETY_FRACTION
constexpr double kFeasSlack = 1e-6;          // ops.queueing feasibility slack

struct Lane {
  double alpha, beta, gamma, delta;
  double in_tokens, out_tokens;
  int32_t max_batch, occupancy_cap;
  double target_ttft, target_itl, target_tps;
  double total_rate;  // req/sec
  int32_t min_replicas;
  double cost_per_replica;
};

struct Stats {
  double wait, serv, in_servers, tput;
};

struct Grid {
  // cml[k-1] = sum_{j<=k} log mu(j), k = 1..K
  std::vector<double> cml;
  int32_t K;  // occupancy cap
  int32_t B;  // max batch
};

double num_decodes(const Lane& ln) {
  // analyzer.queue.service_rates: single-token decode-only requests still
  // pay one decode step
  if (ln.in_tokens == 0.0 && ln.out_tokens == 1.0) return 1.0;
  return ln.out_tokens - 1.0;
}

double service_time(const Lane& ln, double n) {
  double prefill =
      ln.in_tokens > 0.0 ? ln.gamma + ln.delta * ln.in_tokens * n : 0.0;
  return prefill + num_decodes(ln) * (ln.alpha + ln.beta * n);
}

double service_rate(const Lane& ln, double n) { return n / service_time(ln, n); }

// Stage grid for per-request service time t(n) = base + slope * min(n, B)
// (ops.queueing._make_stage_grid).
Grid make_stage_grid(double base, double slope, int32_t B, int32_t K) {
  Grid g;
  g.B = B;
  g.K = K;
  g.cml.resize(K);
  double acc = 0.0;
  for (int32_t k = 1; k <= K; ++k) {
    double n_eff = std::min<double>(k, B);
    acc += std::log(n_eff) - std::log(base + slope * n_eff);
    g.cml[k - 1] = acc;
  }
  return g;
}

Grid make_grid(const Lane& ln) {
  // aggregated lane: prefill and decode folded into one stage
  // (ops.queueing._agg_base_slope)
  const double nd = num_decodes(ln);
  const double base = (ln.in_tokens > 0.0 ? ln.gamma : 0.0) + nd * ln.alpha;
  const double slope =
      (ln.in_tokens > 0.0 ? ln.delta * ln.in_tokens : 0.0) + nd * ln.beta;
  return make_stage_grid(base, slope, ln.max_batch, ln.occupancy_cap);
}

Stats solve_stats(double lam, const Grid& g) {
  // logp[0] = 0, logp[k] = k*log(lam) - cml[k-1]
  const double loglam = std::log(lam);
  // max over logp in O(log K): logp is concave in k (its increments
  // loglam - logmu(k) are nonincreasing because mu(n) is nondecreasing),
  // so the argmax is the last k whose increment is still nonnegative —
  // binary-searchable on logmu(k) = cml[k-1] - cml[k-2]. logp[0] = 0 is
  // included via the k_peak = 0 case.
  double m = 0.0;
  if (g.K >= 1 && loglam >= g.cml[0]) {  // logmu(1) = cml[0]
    int32_t lo = 1, hi = g.K;  // invariant: logmu(lo) <= loglam
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) / 2;
      const double logmu = g.cml[mid - 1] - g.cml[mid - 2];
      if (logmu <= loglam)
        lo = mid;
      else
        hi = mid - 1;
    }
    m = std::max(lo * loglam - g.cml[lo - 1], 0.0);
  }

  double z = std::exp(-m);          // state 0
  double sum_k = 0.0;               // sum k * w
  double mass_gt_b = 0.0;           // states k > B, summed directly
  double sum_k_le_b = 0.0;
  double w_cap = 0.0;               // state K
  // logp[k] is concave in k (mu(n) is nondecreasing), so the mass sits
  // in one contiguous window around the max; states whose normalized
  // log-weight is below -45 contribute < 3e-20 — invisible in the f64
  // sums — and exp() dominates this kernel's cost, so skip them. (A
  // binary-searched window was tried and is SLOWER: the sizing bisection
  // probes rates near saturation where the distribution is flat and the
  // window spans most of K, so the branchy search only added overhead.)
  // State K is always exponentiated: p_block must reflect it even when
  // tiny.
  constexpr double kUnderflow = -45.0;
  for (int32_t k = 1; k <= g.K; ++k) {
    const double lp = k * loglam - g.cml[k - 1] - m;
    if (lp < kUnderflow && k != g.K) continue;
    double w = std::exp(lp);
    z += w;
    sum_k += k * w;
    if (k <= g.B)
      sum_k_le_b += k * w;
    else
      mass_gt_b += w;  // never 1 - mass_le_b: the complement cancels at
                       // low load and B amplifies the rounding residue
    if (k == g.K) w_cap = w;
  }
  const double in_system = sum_k / z;
  const double in_servers = sum_k_le_b / z + g.B * (mass_gt_b / z);
  const double p_block = w_cap / z;
  const double tput = lam * (1.0 - p_block);
  const double resp = in_system / tput;
  const double serv = in_servers / tput;
  Stats s;
  s.wait = std::max(resp - serv, 0.0);
  s.serv = serv;
  s.in_servers = in_servers;
  s.tput = tput;
  return s;
}

double concurrency(const Lane& ln, double serv) {
  // analyzer.queue.effective_concurrency
  const double tokens = ln.out_tokens - 1.0;
  const double numer = serv - (ln.gamma + ln.alpha * tokens);
  const double denom = ln.delta * ln.in_tokens + ln.beta * tokens;
  const double nmax = ln.max_batch;
  if (denom <= 0.0) return numer > 0.0 ? nmax : 0.0;
  return std::clamp(numer / denom, 0.0, nmax);
}

// wait_margin scales the queueing-wait component of TTFT to its SLO
// percentile for sizing (queue.size_with_targets); 1.0 gives the mean.
void ttft_itl_at(double lam, const Lane& ln, const Grid& g, double wait_margin,
                 double* ttft, double* itl) {
  Stats s = solve_stats(lam, g);
  double conc = concurrency(ln, s.serv);
  double prefill =
      ln.in_tokens > 0.0 ? ln.gamma + ln.delta * ln.in_tokens * conc : 0.0;
  *ttft = wait_margin * s.wait + prefill;
  *itl = ln.alpha + ln.beta * conc;
}

// Bisection for an increasing metric-of-rate; mirrors
// ops.queueing._bisect_increasing (reference indicator semantics at
// pkg/analyzer/utils.go:44-50). `y_at` maps a rate to the metric value.
template <typename F>
void bisect(double lam_min, double lam_max, double target, double y_lo,
            double y_hi, F&& y_at, int32_t n_iters, double* lam_out,
            bool* ok_out) {
  const bool feasible = target >= y_lo * (1.0 - kFeasSlack);
  if (target >= y_hi) {
    *lam_out = lam_max;
    *ok_out = feasible;
    return;
  }
  double lo = lam_min, hi = lam_max;
  for (int32_t i = 0; i < n_iters; ++i) {
    const double mid = 0.5 * (lo + hi);
    if (y_at(mid) > target)
      hi = mid;
    else
      lo = mid;
  }
  *lam_out = feasible ? 0.5 * (lo + hi) : lam_min;
  *ok_out = feasible;
}

void size_lane(const Lane& ln, int32_t n_iters, double ttft_tail_margin,
               uint8_t* feasible,
               double* lambda_star, double* rate_star, int32_t* num_replicas,
               double* cost, double* itl_out, double* ttft_out, double* rho) {
  const Grid g = make_grid(ln);
  const double lam_min = service_rate(ln, 1.0) * kRateEps;
  const double lam_max = service_rate(ln, ln.max_batch) * (1.0 - kRateEps);

  double ttft_lo, itl_lo, ttft_hi, itl_hi;
  ttft_itl_at(lam_min, ln, g, ttft_tail_margin, &ttft_lo, &itl_lo);
  ttft_itl_at(lam_max, ln, g, ttft_tail_margin, &ttft_hi, &itl_hi);

  double lam_ttft = lam_max, lam_itl = lam_max;
  bool ok_ttft = true, ok_itl = true;
  if (ln.target_ttft > 0.0)
    bisect(
        lam_min, lam_max, ln.target_ttft, ttft_lo, ttft_hi,
        [&](double lam) {
          double t, i;
          ttft_itl_at(lam, ln, g, ttft_tail_margin, &t, &i);
          return t;
        },
        n_iters, &lam_ttft, &ok_ttft);
  if (ln.target_itl > 0.0)
    bisect(
        lam_min, lam_max, ln.target_itl, itl_lo, itl_hi,
        [&](double lam) {
          double t, i;
          ttft_itl_at(lam, ln, g, 1.0, &t, &i);
          return i;
        },
        n_iters, &lam_itl, &ok_itl);
  const double lam_tps =
      ln.target_tps > 0.0 ? lam_max * (1.0 - kStabilitySafety) : lam_max;

  const double lam_star = std::min({lam_ttft, lam_itl, lam_tps});
  *feasible = (ok_ttft && ok_itl) ? 1 : 0;
  *lambda_star = lam_star;

  const double tput_star = solve_stats(lam_star, g).tput;
  *rate_star = tput_star * 1000.0;  // req/sec

  const double total = ln.target_tps > 0.0 ? ln.target_tps / ln.out_tokens
                                           : ln.total_rate;
  int32_t replicas =
      static_cast<int32_t>(std::ceil(total / *rate_star));
  replicas = std::max(replicas, ln.min_replicas);
  replicas = std::max(replicas, 1);
  *num_replicas = replicas;
  *cost = replicas * ln.cost_per_replica;

  double per_replica = total / replicas / 1000.0;  // req/msec
  per_replica = std::max(per_replica, lam_min);
  const Stats s = solve_stats(per_replica, g);
  const double conc = concurrency(ln, s.serv);
  const double prefill =
      ln.in_tokens > 0.0 ? ln.gamma + ln.delta * ln.in_tokens * conc : 0.0;
  *itl_out = ln.alpha + ln.beta * conc;
  *ttft_out = s.wait + prefill;
  *rho = std::clamp(s.in_servers / ln.max_batch, 0.0, 1.0);
}

// -- rate-only refold ---------------------------------------------------------
//
// The λ-only fast path (ops.queueing.fleet_refold): given the cached
// rate-independent bisection outputs (lambda_star, rate_star, feasible —
// functions of profiles and SLO targets only), recompute the offered-load
// fold and the per-replica operating point. ONE stationary solve instead
// of the bisection's ~66. The DECISION SURFACE (num_replicas, cost) is
// computed in f32 — the identical IEEE divide/ceil/int-cast/multiply the
// jitted `fold_replicas` runs — so a native refold and a jax refold of
// the same lane agree bit-for-bit on what the controller actuates; the
// operating point (itl/ttft/rho) uses this file's f64 stationary solve
// and agrees within the documented 1e-4 relative tolerance.

int32_t fold_replicas_f32(float total, float rate_star, int32_t min_replicas) {
  // ops.queueing.fold_replicas: f32 divide, ceil, int32 cast, fused
  // max(r, max(min_replicas, 1)) clamp
  const float q = total / rate_star;
  const float c = std::ceil(q);
  int32_t replicas =
      c >= 2147483648.0f ? INT32_MAX : static_cast<int32_t>(c);
  return std::max(replicas, std::max(min_replicas, 1));
}

float offered_load_f32(double target_tps, double out_tokens,
                       double total_rate) {
  // ops.queueing.offered_load, in the f32 the jitted kernels use
  const float tps = static_cast<float>(target_tps);
  return tps > 0.0f ? tps / static_cast<float>(out_tokens)
                    : static_cast<float>(total_rate);
}

void refold_lane(const Lane& ln, double rate_star_in, int32_t* num_replicas,
                 double* cost, double* itl_out, double* ttft_out,
                 double* rho) {
  const Grid g = make_grid(ln);
  const double lam_min = service_rate(ln, 1.0) * kRateEps;

  const float total =
      offered_load_f32(ln.target_tps, ln.out_tokens, ln.total_rate);
  const int32_t replicas = fold_replicas_f32(
      total, static_cast<float>(rate_star_in), ln.min_replicas);
  *num_replicas = replicas;
  *cost = static_cast<float>(replicas) *
          static_cast<float>(ln.cost_per_replica);

  double per_replica = static_cast<double>(total) / replicas / 1000.0;
  per_replica = std::max(per_replica, lam_min);
  const Stats s = solve_stats(per_replica, g);
  const double conc = concurrency(ln, s.serv);
  const double prefill =
      ln.in_tokens > 0.0 ? ln.gamma + ln.delta * ln.in_tokens * conc : 0.0;
  *itl_out = ln.alpha + ln.beta * conc;
  *ttft_out = s.wait + prefill;
  *rho = std::clamp(s.in_servers / ln.max_batch, 0.0, 1.0);
}

// -- disaggregated (prefill/decode tandem) lanes ------------------------------
//
// One replica is an atomic unit of prefill + decode engines
// (JetStream-style). Scalar semantics: inferno_tpu/analyzer/disagg.py;
// batched equivalent: ops.queueing.tandem_fleet_size. Same math here in
// double precision so `native` controllers cover disagg variants too.

struct TandemLane {
  double alpha, beta, gamma, delta;
  double in_tokens, out_tokens;
  int32_t prefill_batch, decode_batch;
  int32_t prefill_cap, decode_cap;
  double prefill_slices, decode_slices;
  double target_ttft, target_itl, target_tps;
  double total_rate;  // req/sec
  int32_t min_replicas;
  double cost_per_replica;
};

double tandem_num_decodes(const TandemLane& ln) {
  // analyzer.disagg._decode_rates: max(out_tokens - 1, 1)
  return std::max(ln.out_tokens - 1.0, 1.0);
}

double stage_concurrency(double serv, double base, double slope, double nmax) {
  // ops.queueing._stage_concurrency
  const double numer = serv - base;
  if (slope <= 0.0) return numer > 0.0 ? nmax : 0.0;
  return std::clamp(numer / slope, 0.0, nmax);
}

// TTFT depends only on the prefill stage (DisaggAnalyzer._ttft_at).
double tandem_ttft_at(double lam_unit, const TandemLane& ln, const Grid& gp,
                      double wait_margin) {
  const double p_slope = ln.delta * ln.in_tokens;
  const Stats p = solve_stats(lam_unit / ln.prefill_slices, gp);
  const double pconc = stage_concurrency(p.serv, ln.gamma, p_slope, gp.B);
  return wait_margin * p.wait + ln.gamma + p_slope * pconc;
}

struct TandemEval {
  double ttft, itl, rho, tput;  // whole-unit metrics; tput req/msec
};

TandemEval tandem_eval(double lam_unit, const TandemLane& ln, const Grid& gp,
                       const Grid& gd) {
  const double nd = tandem_num_decodes(ln);
  const double p_slope = ln.delta * ln.in_tokens;
  const Stats p = solve_stats(lam_unit / ln.prefill_slices, gp);
  const double pconc = stage_concurrency(p.serv, ln.gamma, p_slope, gp.B);

  // decode stage sees the prefill stage's departures
  const double through_unit = p.tput * ln.prefill_slices;
  const Stats d = solve_stats(through_unit / ln.decode_slices, gd);
  const double dconc = stage_concurrency(d.serv / nd, ln.alpha, ln.beta, gd.B);

  TandemEval e;
  e.ttft = p.wait + ln.gamma + p_slope * pconc;
  e.itl = ln.alpha + ln.beta * dconc;
  e.rho = std::clamp(
      std::max(p.in_servers / gp.B, d.in_servers / gd.B), 0.0, 1.0);
  e.tput = d.tput * ln.decode_slices;
  return e;
}

void size_tandem_lane(const TandemLane& ln, int32_t n_iters,
                      double ttft_tail_margin, uint8_t* feasible,
                      double* lambda_star, double* rate_star,
                      int32_t* num_replicas, double* cost, double* itl_out,
                      double* ttft_out, double* rho) {
  const double nd = tandem_num_decodes(ln);
  const double p_slope = ln.delta * ln.in_tokens;
  const Grid gp =
      make_stage_grid(ln.gamma, p_slope, ln.prefill_batch, ln.prefill_cap);
  const Grid gd = make_stage_grid(nd * ln.alpha, nd * ln.beta,
                                  ln.decode_batch, ln.decode_cap);

  // stable range of the whole unit: the binding stage saturates first
  const double pb = ln.prefill_batch, db = ln.decode_batch;
  const double mu_p_full = pb / (ln.gamma + p_slope * pb);
  const double mu_d_full = db / (nd * (ln.alpha + ln.beta * db));
  const double unit_max =
      std::min(mu_p_full * ln.prefill_slices, mu_d_full * ln.decode_slices);
  const double lam_min = unit_max * kRateEps;
  const double lam_max = unit_max * (1.0 - kRateEps);

  const double ttft_lo = tandem_ttft_at(lam_min, ln, gp, ttft_tail_margin);
  const double ttft_hi = tandem_ttft_at(lam_max, ln, gp, ttft_tail_margin);
  const double itl_lo = tandem_eval(lam_min, ln, gp, gd).itl;
  const double itl_hi = tandem_eval(lam_max, ln, gp, gd).itl;

  double lam_ttft = lam_max, lam_itl = lam_max;
  bool ok_ttft = true, ok_itl = true;
  if (ln.target_ttft > 0.0)
    bisect(
        lam_min, lam_max, ln.target_ttft, ttft_lo, ttft_hi,
        [&](double lam) { return tandem_ttft_at(lam, ln, gp, ttft_tail_margin); },
        n_iters, &lam_ttft, &ok_ttft);
  if (ln.target_itl > 0.0)
    bisect(
        lam_min, lam_max, ln.target_itl, itl_lo, itl_hi,
        [&](double lam) { return tandem_eval(lam, ln, gp, gd).itl; }, n_iters,
        &lam_itl, &ok_itl);
  const double lam_tps =
      ln.target_tps > 0.0 ? lam_max * (1.0 - kStabilitySafety) : lam_max;

  const double lam_star = std::min({lam_ttft, lam_itl, lam_tps});
  *feasible = (ok_ttft && ok_itl) ? 1 : 0;
  *lambda_star = lam_star;

  *rate_star = tandem_eval(lam_star, ln, gp, gd).tput * 1000.0;  // req/sec

  const double total = ln.target_tps > 0.0 ? ln.target_tps / ln.out_tokens
                                           : ln.total_rate;
  int32_t replicas = static_cast<int32_t>(std::ceil(total / *rate_star));
  replicas = std::max(replicas, ln.min_replicas);
  replicas = std::max(replicas, 1);
  *num_replicas = replicas;
  *cost = replicas * ln.cost_per_replica;

  double per_unit = total / replicas / 1000.0;  // req/msec
  per_unit = std::max(per_unit, lam_min);
  const TandemEval e = tandem_eval(per_unit, ln, gp, gd);
  *itl_out = e.itl;
  *ttft_out = e.ttft;
  *rho = e.rho;
}

// Tandem analogue of refold_lane (ops.queueing.tandem_refold): f32 fold
// against the cached per-unit capacity, one two-stage evaluation for the
// operating point.
void refold_tandem_lane(const TandemLane& ln, double rate_star_in,
                        int32_t* num_replicas, double* cost, double* itl_out,
                        double* ttft_out, double* rho) {
  const double nd = tandem_num_decodes(ln);
  const double p_slope = ln.delta * ln.in_tokens;
  const Grid gp =
      make_stage_grid(ln.gamma, p_slope, ln.prefill_batch, ln.prefill_cap);
  const Grid gd = make_stage_grid(nd * ln.alpha, nd * ln.beta,
                                  ln.decode_batch, ln.decode_cap);
  const double pb = ln.prefill_batch, db = ln.decode_batch;
  const double mu_p_full = pb / (ln.gamma + p_slope * pb);
  const double mu_d_full = db / (nd * (ln.alpha + ln.beta * db));
  const double unit_max =
      std::min(mu_p_full * ln.prefill_slices, mu_d_full * ln.decode_slices);
  const double lam_min = unit_max * kRateEps;

  const float total =
      offered_load_f32(ln.target_tps, ln.out_tokens, ln.total_rate);
  const int32_t replicas = fold_replicas_f32(
      total, static_cast<float>(rate_star_in), ln.min_replicas);
  *num_replicas = replicas;
  *cost = static_cast<float>(replicas) *
          static_cast<float>(ln.cost_per_replica);

  double per_unit = static_cast<double>(total) / replicas / 1000.0;
  per_unit = std::max(per_unit, lam_min);
  const TandemEval e = tandem_eval(per_unit, ln, gp, gd);
  *itl_out = e.itl;
  *ttft_out = e.ttft;
  *rho = e.rho;
}

// Shared worker-pool dispatch: run(i) over lanes, serial when one worker.
template <typename F>
void for_each_lane(int32_t n_lanes, int32_t n_threads, F&& run) {
  const int32_t workers =
      std::max<int32_t>(1, std::min<int32_t>(n_threads, n_lanes));
  if (workers == 1) {
    for (int32_t i = 0; i < n_lanes; ++i) run(i);
    return;
  }
  std::atomic<int32_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int32_t w = 0; w < workers; ++w) {
    pool.emplace_back([&]() {
      for (int32_t i = next.fetch_add(1); i < n_lanes; i = next.fetch_add(1))
        run(i);
    });
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Returns 0 on success. All arrays have n_lanes elements.
int inferno_fleet_size(
    int32_t n_lanes, const double* alpha, const double* beta,
    const double* gamma, const double* delta, const double* in_tokens,
    const double* out_tokens, const int32_t* max_batch,
    const int32_t* occupancy_cap, const double* target_ttft,
    const double* target_itl, const double* target_tps,
    const double* total_rate, const int32_t* min_replicas,
    const double* cost_per_replica, int32_t n_iters, double ttft_tail_margin,
    int32_t n_threads, uint8_t* feasible, double* lambda_star, double* rate_star,
    int32_t* num_replicas, double* cost, double* itl, double* ttft,
    double* rho) {
  if (n_lanes < 0 || n_iters <= 0) return 1;
  auto run = [&](int32_t i) {
    Lane ln;
    ln.alpha = alpha[i];
    ln.beta = beta[i];
    ln.gamma = gamma[i];
    ln.delta = delta[i];
    ln.in_tokens = in_tokens[i];
    ln.out_tokens = out_tokens[i];
    ln.max_batch = max_batch[i];
    ln.occupancy_cap = occupancy_cap[i];
    ln.target_ttft = target_ttft[i];
    ln.target_itl = target_itl[i];
    ln.target_tps = target_tps[i];
    ln.total_rate = total_rate[i];
    ln.min_replicas = min_replicas[i];
    ln.cost_per_replica = cost_per_replica[i];
    if (ln.max_batch <= 0 || ln.occupancy_cap < ln.max_batch ||
        ln.out_tokens < 1.0 || service_time(ln, 1.0) <= 0.0 ||
        service_time(ln, ln.max_batch) <= 0.0) {
      feasible[i] = 0;
      lambda_star[i] = rate_star[i] = cost[i] = itl[i] = ttft[i] = rho[i] = 0.0;
      num_replicas[i] = 0;
      return;
    }
    size_lane(ln, n_iters, ttft_tail_margin, &feasible[i], &lambda_star[i], &rate_star[i],
              &num_replicas[i], &cost[i], &itl[i], &ttft[i], &rho[i]);
  };

  for_each_lane(n_lanes, n_threads, run);
  return 0;
}

// λ-only refold of aggregated lanes (ops.queueing.fleet_refold): the
// cached bisection outputs come IN (lambda_star_in / rate_star_in /
// feasible_in, from a previous full solve) and pass through to the
// outputs unchanged; only the offered-load fold and the operating point
// are recomputed. Returns 0 on success; all arrays n_lanes elements.
int inferno_fleet_refold(
    int32_t n_lanes, const double* alpha, const double* beta,
    const double* gamma, const double* delta, const double* in_tokens,
    const double* out_tokens, const int32_t* max_batch,
    const int32_t* occupancy_cap, const double* target_ttft,
    const double* target_itl, const double* target_tps,
    const double* total_rate, const int32_t* min_replicas,
    const double* cost_per_replica, const double* lambda_star_in,
    const double* rate_star_in, const uint8_t* feasible_in,
    int32_t n_threads, uint8_t* feasible, double* lambda_star,
    double* rate_star, int32_t* num_replicas, double* cost, double* itl,
    double* ttft, double* rho) {
  if (n_lanes < 0) return 1;
  auto run = [&](int32_t i) {
    Lane ln;
    ln.alpha = alpha[i];
    ln.beta = beta[i];
    ln.gamma = gamma[i];
    ln.delta = delta[i];
    ln.in_tokens = in_tokens[i];
    ln.out_tokens = out_tokens[i];
    ln.max_batch = max_batch[i];
    ln.occupancy_cap = occupancy_cap[i];
    ln.target_ttft = target_ttft[i];
    ln.target_itl = target_itl[i];
    ln.target_tps = target_tps[i];
    ln.total_rate = total_rate[i];
    ln.min_replicas = min_replicas[i];
    ln.cost_per_replica = cost_per_replica[i];
    if (ln.max_batch <= 0 || ln.occupancy_cap < ln.max_batch ||
        ln.out_tokens < 1.0 || service_time(ln, 1.0) <= 0.0 ||
        service_time(ln, ln.max_batch) <= 0.0 || !(rate_star_in[i] > 0.0)) {
      feasible[i] = 0;
      lambda_star[i] = rate_star[i] = cost[i] = itl[i] = ttft[i] = rho[i] = 0.0;
      num_replicas[i] = 0;
      return;
    }
    feasible[i] = feasible_in[i];
    lambda_star[i] = lambda_star_in[i];
    rate_star[i] = rate_star_in[i];
    refold_lane(ln, rate_star_in[i], &num_replicas[i], &cost[i], &itl[i],
                &ttft[i], &rho[i]);
  };

  for_each_lane(n_lanes, n_threads, run);
  return 0;
}

// Disaggregated lanes. Returns 0 on success; all arrays n_lanes elements.
int inferno_tandem_size(
    int32_t n_lanes, const double* alpha, const double* beta,
    const double* gamma, const double* delta, const double* in_tokens,
    const double* out_tokens, const int32_t* prefill_batch,
    const int32_t* decode_batch, const int32_t* prefill_cap,
    const int32_t* decode_cap, const double* prefill_slices,
    const double* decode_slices, const double* target_ttft,
    const double* target_itl, const double* target_tps,
    const double* total_rate, const int32_t* min_replicas,
    const double* cost_per_replica, int32_t n_iters, double ttft_tail_margin,
    int32_t n_threads, uint8_t* feasible, double* lambda_star,
    double* rate_star, int32_t* num_replicas, double* cost, double* itl,
    double* ttft, double* rho) {
  if (n_lanes < 0 || n_iters <= 0) return 1;
  auto run = [&](int32_t i) {
    TandemLane ln;
    ln.alpha = alpha[i];
    ln.beta = beta[i];
    ln.gamma = gamma[i];
    ln.delta = delta[i];
    ln.in_tokens = in_tokens[i];
    ln.out_tokens = out_tokens[i];
    ln.prefill_batch = prefill_batch[i];
    ln.decode_batch = decode_batch[i];
    ln.prefill_cap = prefill_cap[i];
    ln.decode_cap = decode_cap[i];
    ln.prefill_slices = prefill_slices[i];
    ln.decode_slices = decode_slices[i];
    ln.target_ttft = target_ttft[i];
    ln.target_itl = target_itl[i];
    ln.target_tps = target_tps[i];
    ln.total_rate = total_rate[i];
    ln.min_replicas = min_replicas[i];
    ln.cost_per_replica = cost_per_replica[i];
    const double nd = tandem_num_decodes(ln);
    if (ln.prefill_batch <= 0 || ln.decode_batch <= 0 ||
        ln.prefill_cap < ln.prefill_batch || ln.decode_cap < ln.decode_batch ||
        ln.prefill_slices < 1.0 || ln.decode_slices < 1.0 ||
        ln.out_tokens < 1.0 ||
        ln.gamma + ln.delta * ln.in_tokens <= 0.0 ||
        ln.gamma + ln.delta * ln.in_tokens * ln.prefill_batch <= 0.0 ||
        nd * (ln.alpha + ln.beta) <= 0.0 ||
        nd * (ln.alpha + ln.beta * ln.decode_batch) <= 0.0) {
      feasible[i] = 0;
      lambda_star[i] = rate_star[i] = cost[i] = itl[i] = ttft[i] = rho[i] = 0.0;
      num_replicas[i] = 0;
      return;
    }
    size_tandem_lane(ln, n_iters, ttft_tail_margin, &feasible[i],
                     &lambda_star[i], &rate_star[i], &num_replicas[i],
                     &cost[i], &itl[i], &ttft[i], &rho[i]);
  };

  for_each_lane(n_lanes, n_threads, run);
  return 0;
}

// λ-only refold of disaggregated lanes (ops.queueing.tandem_refold):
// tandem analogue of inferno_fleet_refold, same pass-through contract.
int inferno_tandem_refold(
    int32_t n_lanes, const double* alpha, const double* beta,
    const double* gamma, const double* delta, const double* in_tokens,
    const double* out_tokens, const int32_t* prefill_batch,
    const int32_t* decode_batch, const int32_t* prefill_cap,
    const int32_t* decode_cap, const double* prefill_slices,
    const double* decode_slices, const double* target_ttft,
    const double* target_itl, const double* target_tps,
    const double* total_rate, const int32_t* min_replicas,
    const double* cost_per_replica, const double* lambda_star_in,
    const double* rate_star_in, const uint8_t* feasible_in,
    int32_t n_threads, uint8_t* feasible, double* lambda_star,
    double* rate_star, int32_t* num_replicas, double* cost, double* itl,
    double* ttft, double* rho) {
  if (n_lanes < 0) return 1;
  auto run = [&](int32_t i) {
    TandemLane ln;
    ln.alpha = alpha[i];
    ln.beta = beta[i];
    ln.gamma = gamma[i];
    ln.delta = delta[i];
    ln.in_tokens = in_tokens[i];
    ln.out_tokens = out_tokens[i];
    ln.prefill_batch = prefill_batch[i];
    ln.decode_batch = decode_batch[i];
    ln.prefill_cap = prefill_cap[i];
    ln.decode_cap = decode_cap[i];
    ln.prefill_slices = prefill_slices[i];
    ln.decode_slices = decode_slices[i];
    ln.target_ttft = target_ttft[i];
    ln.target_itl = target_itl[i];
    ln.target_tps = target_tps[i];
    ln.total_rate = total_rate[i];
    ln.min_replicas = min_replicas[i];
    ln.cost_per_replica = cost_per_replica[i];
    const double nd = tandem_num_decodes(ln);
    if (ln.prefill_batch <= 0 || ln.decode_batch <= 0 ||
        ln.prefill_cap < ln.prefill_batch || ln.decode_cap < ln.decode_batch ||
        ln.prefill_slices < 1.0 || ln.decode_slices < 1.0 ||
        ln.out_tokens < 1.0 ||
        ln.gamma + ln.delta * ln.in_tokens <= 0.0 ||
        ln.gamma + ln.delta * ln.in_tokens * ln.prefill_batch <= 0.0 ||
        nd * (ln.alpha + ln.beta) <= 0.0 ||
        nd * (ln.alpha + ln.beta * ln.decode_batch) <= 0.0 ||
        !(rate_star_in[i] > 0.0)) {
      feasible[i] = 0;
      lambda_star[i] = rate_star[i] = cost[i] = itl[i] = ttft[i] = rho[i] = 0.0;
      num_replicas[i] = 0;
      return;
    }
    feasible[i] = feasible_in[i];
    lambda_star[i] = lambda_star_in[i];
    rate_star[i] = rate_star_in[i];
    refold_tandem_lane(ln, rate_star_in[i], &num_replicas[i], &cost[i],
                       &itl[i], &ttft[i], &rho[i]);
  };

  for_each_lane(n_lanes, n_threads, run);
  return 0;
}

}  // extern "C"
