// The rate bisection of the sizing programs, for every lane of a bucket, in
// one launch on Hopper (sm_90a).
//
// Replaces, with stats_kernel.cu, the TPU kernel `_stats_kernel` of
// inferno_tpu/ops/pallas_queueing.py: on the TPU the bisection is one
// `lax.fori_loop` of a jitted program with the pallas_call in its body
// (inferno_tpu/ops/queueing.py `_bisect_increasing`); here the whole loop is
// this kernel. Its plain torch version is `_bisect_plain` in
// inferno_tpu_torch/ops/queueing.py (`_bisect_increasing` composed with the
// metric and one stationary solve a step); the Python wrapper is
// inferno_tpu_torch/ops/cuda_queueing.py::bisect.
//
// Per lane: feasible = target >= y_lo * (1 - 1e-6); clamp_hi = target >= y_hi;
// then n_iters fixed steps (no early exit) of
//   mid = 0.5 * (lo + hi); too_high = y(mid) > target;
//   lo = too_high ? lo : mid; hi = too_high ? mid : hi;
// and lam = feasible ? (clamp_hi ? lam_max : 0.5 * (lo + hi)) : lam_min.
// y is one of four metrics (enum Metric), each one or two stationary solves
// (lane_solve.cuh) followed by the concurrency inversion, in the plain
// version's op order:
//   AGG_TTFT  margin * wait + (in_tokens > 0 ? gamma + delta*in * conc : 0)
//   AGG_ITL   alpha + beta * conc
//   TAN_TTFT  prefill solve at mid / prefill_slices; margin * wait + gamma + slope * conc
//   TAN_ITL   prefill solve, then the decode solve at its throughput
//             * prefill_slices / decode_slices; alpha + beta * conc(serv / nd)
// The per-lane constants come in as rows of a [C, P] tensor, computed in torch
// by the plain version's own expressions (queueing.py `_agg_bisect_consts`,
// `_tandem_bisect_consts`); the row indices below must match them.
//
// What bounds it on this card: operations. Every step touches each element of
// the row (both rows for TAN_ITL) about 11 times, n_iters * P * K * 11 f32
// operations, one expf each; the row's bytes are read once, into registers,
// and stay there for all the steps. The steps of a lane are sequential, so a
// small bucket is bound by the latency of n_iters solves instead.
//
// Build: as stats_kernel.cu (--fmad=false, no fast math). The per-step scalar
// arithmetic is the plain version's op for op, so the launch reproduces the
// per-step composition on stats_kernel bit for bit.

#include <cuda_runtime.h>

#include "lane_solve.cuh"

namespace {

using namespace inferno;

enum Metric : int { AGG_TTFT = 0, AGG_ITL = 1, TAN_TTFT = 2, TAN_ITL = 3 };

// rows of the aggregated lanes' constants (queueing.py `_agg_bisect_consts`)
enum AggRow : int { A_BASE, A_SLOPE, A_NMAX, A_GAMMA, A_DIN, A_IN, A_ALPHA, A_BETA };
// rows of the tandem lanes' constants (queueing.py `_tandem_bisect_consts`)
enum TanRow : int { T_PS, T_DS, T_ND, T_GAMMA, T_SLOPE, T_ALPHA, T_BETA };

// 1 - 1e-6 as torch rounds the Python scalar: the double, rounded to f32
constexpr float FEASIBLE_SLACK = static_cast<float>(1.0 - 1e-6);

struct Stage {
    const float* cml;
    const float* nmax;
    const float* log_mu_full;
    const float* tail_len;
};

struct BisectArgs {
    Stage gp;  // the lane's grid (the prefill stage's for tandem lanes)
    Stage gd;  // the decode stage's grid (TAN_ITL only)
    const float* consts;
    const float* lam_min;
    const float* lam_max;
    const float* target;
    const float* y_lo;
    const float* y_hi;
    float* lam_out;
    unsigned char* ok_out;
    int P;
    int K;
    int n_iters;
    float wait_margin;
};

// min with torch.minimum semantics: a NaN in either operand propagates
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

// _stage_concurrency: invert t(n) = base + slope * n to the concurrency
// giving `serv`, clipped to [0, nmax]
__device__ __forceinline__ float stage_concurrency(float serv, float base, float slope,
                                                   float nmax) {
    const float numer = serv - base;
    const float safe = nan_min(nan_max(numer / (slope > 0.0f ? slope : 1.0f), 0.0f), nmax);
    return slope > 0.0f ? safe : (numer > 0.0f ? nmax : 0.0f);
}

template <int METRIC, int K_FIXED>
__global__ void __launch_bounds__(BLOCK_THREADS) bisect_kernel(const BisectArgs a) {
    constexpr int T = threads_per_lane<K_FIXED>();
    constexpr bool TANDEM = METRIC == TAN_TTFT || METRIC == TAN_ITL;
    __shared__ float scratch[2 * (BLOCK_THREADS / 32)];
    const LaneGroup<T> g(a.P);
    const int r = g.row;
    auto cst = [&](int i) { return a.consts[static_cast<size_t>(i) * a.P + r]; };

    // the rows, read once and held for every step
    RowOf<K_FIXED> rp;
    rp.load(a.gp.cml + static_cast<size_t>(r) * a.K, a.K, g.t, a.gp.nmax[r]);
    const float p_lmf = a.gp.log_mu_full[r];
    const float p_tail = a.gp.tail_len[r];
    RowOf<K_FIXED> rd;
    float d_lmf = 0.0f;
    float d_tail = 0.0f;
    if constexpr (METRIC == TAN_ITL) {
        rd.load(a.gd.cml + static_cast<size_t>(r) * a.K, a.K, g.t, a.gd.nmax[r]);
        d_lmf = a.gd.log_mu_full[r];
        d_tail = a.gd.tail_len[r];
    }

    // the metric's constants, in registers for the whole loop
    float c0, c1, c2, c3, c4;
    if constexpr (METRIC == AGG_TTFT) {
        c0 = cst(A_GAMMA);
        c1 = cst(A_DIN);
        c2 = cst(A_IN);
        c3 = 0.0f;
        c4 = 0.0f;
    } else if constexpr (METRIC == AGG_ITL) {
        c0 = cst(A_ALPHA);
        c1 = cst(A_BETA);
        c2 = c3 = c4 = 0.0f;
    } else if constexpr (METRIC == TAN_TTFT) {
        c0 = cst(T_PS);
        c1 = cst(T_GAMMA);
        c2 = cst(T_SLOPE);
        c3 = c4 = 0.0f;
    } else {
        c0 = cst(T_PS);
        c1 = cst(T_DS);
        c2 = cst(T_ND);
        c3 = cst(T_ALPHA);
        c4 = cst(T_BETA);
    }
    const float base = TANDEM ? 0.0f : cst(A_BASE);
    const float slope = TANDEM ? 0.0f : cst(A_SLOPE);
    const float nmax_b = TANDEM ? 0.0f : cst(A_NMAX);
    const float margin = a.wait_margin;

    auto y_at = [&](float lam) -> float {
        if constexpr (!TANDEM) {
            const Stats s = lane_solve<T>(rp, lam, p_lmf, p_tail, scratch);
            const float conc = stage_concurrency(s.serv, base, slope, nmax_b);
            if constexpr (METRIC == AGG_TTFT) {
                const float prefill = c2 > 0.0f ? c0 + c1 * conc : 0.0f;
                return margin * s.wait + prefill;
            } else {
                return c0 + c1 * conc;
            }
        } else {
            const Stats sp = lane_solve<T>(rp, lam / c0, p_lmf, p_tail, scratch);
            if constexpr (METRIC == TAN_TTFT) {
                const float pconc = stage_concurrency(sp.serv, c1, c2, rp.nmax);
                return margin * sp.wait + c1 + c2 * pconc;
            } else {
                // the decode stage sees the prefill stage's departures
                const float through_unit = sp.tput * c0;
                const Stats sd =
                    lane_solve<T>(rd, through_unit / c1, d_lmf, d_tail, scratch);
                const float dconc = stage_concurrency(sd.serv / c2, c3, c4, rd.nmax);
                return c3 + c4 * dconc;
            }
        }
    };

    const float lam_min = a.lam_min[r];
    const float lam_max = a.lam_max[r];
    const float target = a.target[r];
    const bool feasible = target >= a.y_lo[r] * FEASIBLE_SLACK;
    const bool clamp_hi = target >= a.y_hi[r];
    float lo = lam_min;
    float hi = lam_max;
#pragma unroll 1
    for (int it = 0; it < a.n_iters; ++it) {
        const float mid = 0.5f * (lo + hi);
        const bool too_high = y_at(mid) > target;
        lo = too_high ? lo : mid;
        hi = too_high ? mid : hi;
    }
    float lam = 0.5f * (lo + hi);
    lam = clamp_hi ? lam_max : lam;
    lam = feasible ? lam : lam_min;
    if (g.active && g.t == 0) {
        a.lam_out[r] = lam;
        a.ok_out[r] = feasible ? 1 : 0;
    }
}

template <int METRIC, int K_FIXED>
int launch(const BisectArgs& a, cudaStream_t stream) {
    bisect_kernel<METRIC, K_FIXED><<<blocks_for<K_FIXED>(a.P), BLOCK_THREADS, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int METRIC>
int launch_k(const BisectArgs& a, cudaStream_t stream) {
    switch (a.K) {
        case 128: return launch<METRIC, 128>(a, stream);
        case 512: return launch<METRIC, 512>(a, stream);
        case 2048: return launch<METRIC, 2048>(a, stream);
        default: return launch<METRIC, 0>(a, stream);
    }
}

}  // namespace

// Launch on `stream` (a cudaStream_t). The decode-stage pointers are read by
// metric 3 (TAN_ITL) only. Returns cudaGetLastError() after the launch (0 when
// it was accepted), or cudaErrorInvalidValue for an unknown metric.
extern "C" int inferno_bisect_launch(
    int metric, const float* cml_p, const float* nmax_p, const float* log_mu_full_p,
    const float* tail_len_p, const float* cml_d, const float* nmax_d,
    const float* log_mu_full_d, const float* tail_len_d, const float* consts,
    const float* lam_min, const float* lam_max, const float* target, const float* y_lo,
    const float* y_hi, float* lam_out, unsigned char* ok_out, int P, int K, int n_iters,
    float wait_margin, void* stream) {
    const BisectArgs a{
        Stage{cml_p, nmax_p, log_mu_full_p, tail_len_p},
        Stage{cml_d, nmax_d, log_mu_full_d, tail_len_d},
        consts, lam_min, lam_max, target, y_lo, y_hi, lam_out, ok_out,
        P, K, n_iters, wait_margin,
    };
    const auto s = static_cast<cudaStream_t>(stream);
    switch (metric) {
        case AGG_TTFT: return launch_k<AGG_TTFT>(a, s);
        case AGG_ITL: return launch_k<AGG_ITL>(a, s);
        case TAN_TTFT: return launch_k<TAN_TTFT>(a, s);
        case TAN_ITL: return launch_k<TAN_ITL>(a, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
