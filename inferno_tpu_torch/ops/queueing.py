"""Batched queueing analysis and SLO sizing on torch tensors.

Port of `inferno_tpu/ops/queueing.py`. Every (server, slice-shape) pair is
a lane of a [P]-shaped batch and the whole fleet is sized at once:

* the stationary distribution is log-space: since
  log p[k] = k·log(lam) − Σ_{j≤k} log mu(j), the service-rate cumsum is
  independent of the arrival rate and is hoisted out of the search;
* bisection is a fixed 32-step loop (no early exit) over all lanes at
  once: a Python loop with one stationary solve a step in the plain
  version (`_bisect_plain`), one launch of `bisect_kernel` on the card,
  which takes several steps a round and stops at each lane's fixed point
  with the same bits (`_bisect_speculative_plain` is its schedule);
* the grid covers only the head states k = 0..max_batch; the queue tail
  beyond max_batch is a geometric series folded in closed form
  (`_fold_tail`), exactly as in the reference;
* callers bucket lanes by max batch (parallel.fleet).

Two hand-written CUDA kernels serve this module (`use_kernel=True`): the
stationary solve, whose plain torch version is `_solve_stats` and whose
wrapper is `ops.cuda_queueing.solve_stats` (`_get_solver`), and the whole
bisection, whose plain version is `_bisect_plain` and whose wrapper is
`ops.cuda_queueing.bisect` (`_bisect`). The reference's op order is kept
everywhere so f32 results track XLA's; tensors stay f32 (i32 for counts)
and every constant is built in f32.

Left out against the reference: the `jax.jit` factories
(`make_fleet_size_fn`, `make_tandem_size_fn`, `make_fleet_size_packed_fn`);
torch runs eagerly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from inferno_tpu_torch.config.defaults import SLO_MARGIN, STABILITY_SAFETY_FRACTION

# match the scalar analyzer (analyzer/queue.py RATE_EPSILON)
_RATE_EPSILON = 1e-3

DEFAULT_BISECT_ITERS = 32  # f32 interval resolution saturates ~30 halvings

_F32 = torch.float32
_I32 = torch.int32


class FleetParams(NamedTuple):
    """Structure-of-arrays description of all (server, slice-shape) pairs.

    All float tensors are f32[P]; int tensors i32[P], on one device.
    Rates are req/sec, times msec (analyzer conventions).
    """

    alpha: torch.Tensor  # decode base, msec
    beta: torch.Tensor  # decode slope, msec/req
    gamma: torch.Tensor  # prefill base, msec
    delta: torch.Tensor  # prefill slope, msec/(token*req)
    in_tokens: torch.Tensor  # avg input tokens
    out_tokens: torch.Tensor  # avg output tokens (>= 1)
    max_batch: torch.Tensor  # per-lane max batch size N
    occupancy_cap: torch.Tensor  # K = N + max queue
    target_ttft: torch.Tensor  # msec; 0 disables
    target_itl: torch.Tensor  # msec; 0 disables
    target_tps: torch.Tensor  # tokens/sec; 0 disables
    total_rate: torch.Tensor  # offered load, req/sec
    min_replicas: torch.Tensor  # i32
    cost_per_replica: torch.Tensor  # cents/hr (chips x chip cost x slices)


class FleetResult(NamedTuple):
    feasible: torch.Tensor  # bool[P]: SLOs achievable on this pair
    lambda_star: torch.Tensor  # binding rate, req/msec
    rate_star: torch.Tensor  # max throughput per replica at SLO, req/sec
    num_replicas: torch.Tensor  # i32[P]
    cost: torch.Tensor  # cents/hr
    itl: torch.Tensor  # expected per-replica ITL at operating point, msec
    ttft: torch.Tensor  # expected per-replica TTFT, msec
    rho: torch.Tensor  # expected utilization


class _Grid(NamedTuple):
    """Rate-independent precomputation shared by every solve.

    The explicit grid covers only the head states k = 1..max_batch; the
    geometric queue tail (states max_batch+1..cap, all serving at the
    full-batch rate) is folded into per-lane closed forms at solve time.
    """

    cml: torch.Tensor  # [P, K] cumsum of log mu(k) on the head grid; +inf beyond max_batch
    kk: torch.Tensor  # [1, K+1] state indices as f32
    nmax: torch.Tensor  # [P] max_batch as f32
    log_mu_full: torch.Tensor  # [P] log mu at full batch (the tail service rate)
    tail_len: torch.Tensor  # [P] number of queue states: cap - max_batch, >= 0


_FLEET_INT_FIELDS = frozenset(("max_batch", "occupancy_cap", "min_replicas"))
_TANDEM_INT_FIELDS = frozenset(
    ("prefill_batch", "decode_batch", "prefill_cap", "decode_cap", "min_replicas")
)


def _params_from_numpy(cls, int_fields, np_params, device) -> NamedTuple:
    # np.array copies: the tensors never share (possibly read-only) host memory
    return cls(**{
        name: torch.from_numpy(
            np.array(getattr(np_params, name), np.int32 if name in int_fields else np.float32)
        ).to(device)
        for name in cls._fields
    })


def fleet_params_from_numpy(np_params, device) -> "FleetParams":
    """The port's FleetParams from any object with the reference's
    FleetParams fields (numpy arrays, or jax arrays after `np.asarray`):
    f32 floats and i32 counts on `device`. A float64 column is cast to
    f32 here, so it never reaches a solve."""
    return _params_from_numpy(FleetParams, _FLEET_INT_FIELDS, np_params, device)


def _num_decodes(p: FleetParams) -> torch.Tensor:
    # out_tokens - 1, except the decode-only single-token case which still
    # pays one decode (analyzer.queue.service_rates)
    nd = p.out_tokens - 1.0
    return torch.where((p.in_tokens == 0) & (p.out_tokens == 1), 1.0, nd)


def _service_rate(p: FleetParams, n: torch.Tensor) -> torch.Tensor:
    """mu(n) in req/msec; `n` broadcasts against the lane axis."""
    prefill = torch.where(p.in_tokens > 0, p.gamma + p.delta * p.in_tokens * n, 0.0)
    decode = _num_decodes(p) * (p.alpha + p.beta * n)
    return n / (prefill + decode)


def _make_stage_grid(
    base: torch.Tensor,
    slope: torch.Tensor,
    nmax_i: torch.Tensor,
    cap_i: torch.Tensor,
    k_max: int,
) -> _Grid:
    """Birth-death grid for a batch server with per-request service time
    t(n) = base + slope * min(n, nmax); occupancy capped at `cap`.

    Only the head states k <= nmax live on the grid; the queue tail
    (nmax < k <= cap, constant service rate) is carried as the per-lane
    (log_mu_full, tail_len) pair and folded in closed form by
    `_solve_stats`. A max batch beyond the padded grid is truncated to
    the grid edge, as in the reference."""
    dev = base.device
    k = torch.arange(1, k_max + 1, dtype=_F32, device=dev)[None, :]  # [1, K]
    nmax = torch.clamp(nmax_i.to(_F32), max=float(k_max))
    cap = torch.maximum(cap_i.to(_F32), nmax)
    n_eff = torch.minimum(k, nmax[:, None])
    t = base[:, None] + slope[:, None] * n_eff
    log_mu = torch.log(n_eff) - torch.log(t)
    valid = k <= nmax[:, None]
    log_mu = torch.where(valid, log_mu, math.inf)  # +inf => p[k] = 0 beyond nmax
    kk = torch.arange(0, k_max + 1, dtype=_F32, device=dev)[None, :]
    # each lane's running sum in one order whatever the bucket's width: on
    # CUDA, torch's scan along the last dim picks its thread layout by the
    # number of rows, which re-associates a row's sum; a scan along the
    # first dim walks each column in order (on the CPU both dims walk a
    # row in order, so the CPU result is unchanged)
    return _Grid(
        cml=torch.cumsum(log_mu.T, dim=0).T.contiguous(),
        kk=kk,
        nmax=nmax,
        log_mu_full=torch.log(nmax) - torch.log(base + slope * nmax),
        tail_len=cap - nmax,
    )


def _agg_base_slope(p: FleetParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregated-lane service time t(n) = base + slope*n: prefill and
    decode folded into one stage (mu(n) of analyzer.queue.service_rates)."""
    nd = _num_decodes(p)
    base = torch.where(p.in_tokens > 0, p.gamma, 0.0) + nd * p.alpha
    slope = torch.where(p.in_tokens > 0, p.delta * p.in_tokens, 0.0) + nd * p.beta
    return base, slope


def _make_grid(p: FleetParams, k_max: int) -> _Grid:
    base, slope = _agg_base_slope(p)
    return _make_stage_grid(base, slope, p.max_batch, p.occupancy_cap, k_max)


def _fold_tail(
    m_head: torch.Tensor, logp_n: torch.Tensor, logq: torch.Tensor, tail_len: torch.Tensor
):
    """Closed-form geometric queue tail p[N+j] = p[N]·q^j, j = 1..L,
    with q = lam/mu(N) and L = tail_len. Returns

        (M, z_tail, jsum_tail, p_block)

    where M = the global log-normalization shift (max of the head's
    `m_head` and the tail's peak log-weight) and the other three are the
    tail's probability mass, j-weighted mass (= queue length, since head
    states hold no queue), and blocking-state weight, all scaled by
    exp(-M) like the head terms must be.

    Valid on both sides of saturation: for q < 1 sums anchor at p[N], for
    q >= 1 they anchor at the blocking state so nothing overflows. Near
    q = 1 the shared ratio r = exp(-|log q|) keeps 1-r cancellation-free
    via expm1. The CUDA kernel's `fold_tail` (ops/csrc/fold_tail.cuh) is
    the same arithmetic in the same order."""
    neg = logq < 0.0  # below saturation: tail decays from p[N]
    alogq = torch.clamp(torch.abs(logq), min=1e-6)
    logr = -alogq
    r = torch.exp(logr)
    r_l = torch.exp(tail_len * logr)  # r^L
    r_lm1 = torch.exp((tail_len - 1.0) * logr)  # r^(L-1)
    one_m_r = -torch.expm1(logr)
    # partial geometric sums over i = 0..L-1: g0 = sum r^i, g1 = sum i r^i
    g0 = (1.0 - r_l) / one_m_r
    g1 = r * (1.0 - tail_len * r_lm1 + (tail_len - 1.0) * r_l) / (one_m_r * one_m_r)

    # log-weight of the tail's largest term: p[N] for q < 1, p[N+L] for q >= 1
    tail_peak = logp_n + torch.clamp(tail_len * logq, min=0.0)
    m_total = torch.maximum(m_head, torch.where(tail_len > 0, tail_peak, -math.inf))
    a = torch.exp(logp_n - m_total)  # p[N] / exp(M)
    b = torch.exp(logp_n + tail_len * logq - m_total)  # p[N+L] / exp(M)

    # q < 1 (r = q):  sum q^j = g0 + r^L - 1,  sum j q^j = g1 + L r^L
    # q >= 1 (r = 1/q), relative to the blocking state b:
    #   sum q^(j-L) = g0,  sum j q^(j-L) = L g0 - g1
    z_tail = torch.where(neg, a * (g0 + r_l - 1.0), b * g0)
    jsum_tail = torch.where(
        neg, a * (g1 + tail_len * r_l), b * (tail_len * g0 - g1)
    )
    p_block = torch.where(neg, a * r_l, b)
    # an empty tail (cap == max_batch) blocks at state N itself
    empty = tail_len <= 0.0
    z_tail = torch.where(empty, 0.0, z_tail)
    jsum_tail = torch.where(empty, 0.0, jsum_tail)
    p_block = torch.where(empty, a, p_block)
    return m_total, z_tail, jsum_tail, p_block


def _solve_stats(lam: torch.Tensor, grid: _Grid):
    """Stationary statistics at arrival rates `lam` (req/msec) for all
    lanes: (wait, serv, in_servers, throughput).

    The plain torch version of the CUDA kernel in ops/csrc/stats_kernel.cu.
    Head states (k <= max_batch) are summed over the explicit grid; the
    queue tail is folded via `_fold_tail`."""
    log_lam = torch.log(lam)[:, None]
    body = grid.kk[:, 1:] * log_lam - grid.cml  # [P, K]; -inf beyond max_batch
    m_head = torch.clamp(torch.amax(body, dim=1), min=0.0)  # include the k=0 term
    # log-weight of the full-batch state N (the tail anchor)
    logp_n = torch.amax(
        torch.where(grid.kk[:, 1:] == grid.nmax[:, None], body, -math.inf), dim=1
    )
    m, z_tail, jsum_tail, p_block_u = _fold_tail(
        m_head, logp_n, torch.log(lam) - grid.log_mu_full, grid.tail_len
    )
    e = torch.exp(body - m[:, None])
    z = torch.exp(-m) + torch.sum(e, dim=1) + z_tail
    sk_head = torch.sum(grid.kk[:, 1:] * e, dim=1)
    # every tail state holds exactly nmax in service; queue length comes
    # directly from the tail sum (never in_system - in_servers: that
    # difference is f32 cancellation noise at low load)
    in_servers = (sk_head + grid.nmax * z_tail) / z
    queue_len = jsum_tail / z
    p_block = p_block_u / z
    throughput = lam * (1.0 - p_block)
    serv = in_servers / throughput
    wait = queue_len / throughput
    return wait, serv, in_servers, throughput


def _stage_concurrency(
    serv: torch.Tensor, base: torch.Tensor, slope: torch.Tensor, nmax: torch.Tensor
) -> torch.Tensor:
    """Invert t(n) = base + slope*n to the concurrency n giving `serv`
    (analyzer.queue.effective_concurrency / disagg._effective_concurrency)."""
    numer = serv - base
    # jnp.clip(x, 0, nmax) == minimum(maximum(x, 0), nmax)
    safe = torch.minimum(
        torch.clamp(numer / torch.where(slope > 0, slope, 1.0), min=0.0), nmax
    )
    return torch.where(slope > 0, safe, torch.where(numer > 0, nmax, 0.0))


def _concurrency(p: FleetParams, serv: torch.Tensor) -> torch.Tensor:
    """Effective concurrency from avg service time
    (analyzer.queue.effective_concurrency). Note: plain gamma even for
    in_tokens == 0 lanes, matching the scalar inversion."""
    tokens = p.out_tokens - 1.0
    return _stage_concurrency(
        serv,
        p.gamma + p.alpha * tokens,
        p.delta * p.in_tokens + p.beta * tokens,
        p.max_batch.to(_F32),
    )


def _get_solver(use_kernel: bool):
    """The stationary-solve implementation: the plain torch version
    (default) or the hand-written CUDA kernel (ops.cuda_queueing), whose
    wrapper itself takes the plain version for CPU tensors."""
    if not use_kernel:
        return _solve_stats
    from inferno_tpu_torch.ops import cuda_queueing

    return cuda_queueing.solve_stats


def _ttft_itl_at(
    lam: torch.Tensor, p: FleetParams, grid: _Grid, solve=_solve_stats,
    wait_margin: float = 1.0,
):
    """(ttft, itl) at rates `lam`; `wait_margin` scales the queueing-wait
    component of TTFT to its SLO percentile (queue.size_with_targets —
    sizing bisects with SLO_MARGIN, reporting uses the mean)."""
    wait, serv, _, _ = solve(lam, grid)
    conc = _concurrency(p, serv)
    prefill = torch.where(p.in_tokens > 0, p.gamma + p.delta * p.in_tokens * conc, 0.0)
    return wait_margin * wait + prefill, p.alpha + p.beta * conc


def _bisect_increasing(
    lam_min: torch.Tensor,
    lam_max: torch.Tensor,
    target: torch.Tensor,
    y_lo: torch.Tensor,
    y_hi: torch.Tensor,
    y_at,  # callable: lam -> metric value (vectorized over lanes)
    n_iters: int,
):
    """Vectorized bisection for an increasing metric-of-rate: a fixed
    `n_iters`-step loop, no early exit.

    Returns (lam_star, feasible): lanes whose target is below the value at
    lam_min are infeasible; targets above the value at lam_max clamp to
    lam_max (the reference's -1/+1 indicator semantics,
    pkg/analyzer/utils.go:44-50)."""
    feasible = target >= y_lo * (1.0 - 1e-6)
    clamp_hi = target >= y_hi
    lo, hi = lam_min, lam_max
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        too_high = y_at(mid) > target
        lo, hi = torch.where(too_high, lo, mid), torch.where(too_high, mid, hi)
    lam = 0.5 * (lo + hi)
    lam = torch.where(clamp_hi, lam_max, lam)
    lam = torch.where(feasible, lam, lam_min)
    return lam, feasible


# The four metrics the sizing programs bisect on, and the number of rows of
# per-lane constants each takes (csrc/bisect_kernel.cu's enums match).
AGG_TTFT, AGG_ITL, TAN_TTFT, TAN_ITL = range(4)
BISECT_METRICS = {AGG_TTFT: 8, AGG_ITL: 8, TAN_TTFT: 7, TAN_ITL: 7}


class BisectCase(NamedTuple):
    """One bisection of a sizing program over all lanes of a bucket: the
    inputs of `_bisect_increasing` with its metric named by `metric` and
    evaluated from `consts` (`_bisect_metric`) instead of a closure."""

    metric: int  # AGG_TTFT, AGG_ITL, TAN_TTFT or TAN_ITL
    lam_min: torch.Tensor  # [P] req/msec
    lam_max: torch.Tensor  # [P] req/msec
    target: torch.Tensor  # [P] the SLO
    y_lo: torch.Tensor  # [P] the metric at lam_min
    y_hi: torch.Tensor  # [P] the metric at lam_max
    consts: torch.Tensor  # f32[C, P]: `_agg_bisect_consts` or `_tandem_bisect_consts`
    gp: _Grid  # the lane's grid (the prefill stage's for tandem lanes)
    gd: _Grid | None  # the decode stage's grid (TAN_ITL only)
    wait_margin: float  # scales the queueing wait of TTFT metrics


def _agg_bisect_consts(p: FleetParams) -> torch.Tensor:
    """Per-lane constants of the aggregated metrics, by the expressions of
    `_concurrency` and `_ttft_itl_at`: [base, slope, max batch, gamma,
    delta*in_tokens, in_tokens, alpha, beta]."""
    tokens = p.out_tokens - 1.0
    return torch.stack([
        p.gamma + p.alpha * tokens,
        p.delta * p.in_tokens + p.beta * tokens,
        p.max_batch.to(_F32),
        p.gamma,
        p.delta * p.in_tokens,
        p.in_tokens,
        p.alpha,
        p.beta,
    ])


def _tandem_bisect_consts(p: TandemParams) -> torch.Tensor:
    """Per-lane constants of the tandem metrics, by the expressions of
    `_tandem_ttft_at` and `_tandem_eval`: [prefill_slices, decode_slices,
    decodes, gamma, delta*in_tokens, alpha, beta]."""
    return torch.stack([
        p.prefill_slices,
        p.decode_slices,
        _tandem_num_decodes(p),
        p.gamma,
        p.delta * p.in_tokens,
        p.alpha,
        p.beta,
    ])


def _bisect_metric(case: BisectCase, lam: torch.Tensor, solve) -> torch.Tensor:
    """The case's metric at rates `lam`: `_ttft_itl_at`, `_tandem_ttft_at`
    or `_tandem_eval`'s ITL, op for op, from the per-lane constants."""
    c = case.consts
    if case.metric in (AGG_TTFT, AGG_ITL):
        wait, serv, _, _ = solve(lam, case.gp)
        conc = _stage_concurrency(serv, c[0], c[1], c[2])
        if case.metric == AGG_TTFT:
            prefill = torch.where(c[5] > 0, c[3] + c[4] * conc, 0.0)
            return case.wait_margin * wait + prefill
        return c[6] + c[7] * conc
    pwait, pserv, _, ptput = solve(lam / c[0], case.gp)
    if case.metric == TAN_TTFT:
        pconc = _stage_concurrency(pserv, c[3], c[4], case.gp.nmax)
        return case.wait_margin * pwait + c[3] + c[4] * pconc
    # the decode stage sees the prefill stage's departures
    _, dserv, _, _ = solve(ptput * c[0] / c[1], case.gd)
    dconc = _stage_concurrency(dserv / c[2], c[5], c[6], case.gd.nmax)
    return c[5] + c[6] * dconc


def _bisect_plain(case: BisectCase, n_iters: int, solve=_solve_stats):
    """The plain version of the bisection kernel: `_bisect_increasing` with
    one `solve` a step (two for TAN_ITL). With `solve` the stationary-solve
    kernel's wrapper it is the per-step composition the kernel replaces."""
    return _bisect_increasing(
        case.lam_min, case.lam_max, case.target, case.y_lo, case.y_hi,
        lambda lam: _bisect_metric(case, lam, solve), n_iters,
    )


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int32) == b.view(torch.int32)


def _bisect_speculative_plain(
    case: BisectCase, n_iters: int, depth: int, early_exit: bool, solve=_solve_stats
):
    """The bisection kernel's schedule (csrc/bisect_kernel.cu) in torch:
    rounds of `depth` steps (the last one takes what is left). A round
    evaluates the metric at every midpoint of the binary tree its steps
    could visit, each from the round's (lo, hi) by the sequential
    expression down its path (heap order: node n's children are 2n+1, too
    high, and 2n+2), then walks the path its decisions pick. With
    `early_exit` a lane is done when a round's last step leaves (lo, hi)
    unchanged in every bit (a fixed point), or from the start where its
    result does not read the loop (infeasible, or clamped at lam_max); the
    loop stops once every lane is done. Returns (lam_star, feasible,
    steps): steps are each lane's steps up to the round it was done in
    (n_iters without an exit), the kernel's at the granularity of one lane.
    Bit for bit `_bisect_plain(case, n_iters, solve)`."""
    feasible = case.target >= case.y_lo * (1.0 - 1e-6)
    clamp_hi = case.target >= case.y_hi
    lo, hi = case.lam_min, case.lam_max
    done = (~feasible | clamp_hi) if early_exit else torch.zeros_like(feasible)
    steps = torch.zeros_like(lo, dtype=_I32)
    run = 0
    while run < n_iters and not bool(done.all()):
        d = min(depth, n_iters - run)
        too_high = []
        for h in range(1, 2**d):  # heap index of node h - 1
            a, b = lo, hi
            for i in range(h.bit_length() - 2, -1, -1):
                mid = 0.5 * (a + b)
                a, b = (mid, b) if (h >> i) & 1 else (a, mid)
            too_high.append(_bisect_metric(case, 0.5 * (a + b), solve) > case.target)
        too_high = torch.stack(too_high)
        node = torch.zeros_like(lo, dtype=torch.int64)
        for _ in range(d):
            th = too_high.gather(0, node[None])[0]
            mid = 0.5 * (lo + hi)
            prev_lo, prev_hi = lo, hi
            lo, hi = torch.where(th, lo, mid), torch.where(th, mid, hi)
            node = 2 * node + torch.where(th, 1, 2)
        run += d
        steps = torch.where(done, steps, run)
        if early_exit:
            done = done | (_same_bits(lo, prev_lo) & _same_bits(hi, prev_hi))
    lam = 0.5 * (lo + hi)
    lam = torch.where(clamp_hi, case.lam_max, lam)
    lam = torch.where(feasible, lam, case.lam_min)
    return lam, feasible, steps


def _bisect_steps_needed(case: BisectCase, n_iters: int, solve=_solve_stats) -> torch.Tensor:
    """Each lane's steps to its fixed point, i32[P]: the steps of the
    sequential bisection before the first one that leaves (lo, hi)
    unchanged in every bit (n_iters if none does), 0 where the result does
    not read the loop (infeasible, or clamped at lam_max). The work the
    lane's answer needs, whatever schedule computes it."""
    feasible = case.target >= case.y_lo * (1.0 - 1e-6)
    fixed = ~feasible | (case.target >= case.y_hi)
    needed = torch.where(fixed, 0, n_iters).to(_I32)
    lo, hi = case.lam_min, case.lam_max
    for it in range(n_iters):
        if bool(fixed.all()):
            break
        mid = 0.5 * (lo + hi)
        too_high = _bisect_metric(case, mid, solve) > case.target
        new_lo, new_hi = torch.where(too_high, lo, mid), torch.where(too_high, mid, hi)
        same = _same_bits(new_lo, lo) & _same_bits(new_hi, hi)
        needed = torch.where(~fixed & same, it, needed)
        fixed = fixed | same
        lo, hi = new_lo, new_hi
    return needed


def _bisect(case: BisectCase, n_iters: int, use_kernel: bool, real_lanes: int | None = None):
    """(lam_star, feasible) of one bisection: the bisection kernel
    (ops.cuda_queueing.bisect, which itself takes the plain version for
    CPU tensors) or the plain version. `real_lanes`: the lanes past it are
    pad copies of lane 0 (the kernel skips them)."""
    if not use_kernel:
        return _bisect_plain(case, n_iters)
    from inferno_tpu_torch.ops import cuda_queueing

    return cuda_queueing.bisect(case, n_iters, real_lanes=real_lanes)


def offered_load(total_rate, target_tps, out_tokens, xp=torch):
    """Effective offered load per lane: TPS targets replace the arrival
    rate (reference: pkg/core/allocation.go:133-141). `xp` selects the
    array namespace: torch inside the sizing programs, np on host
    replays, with the identical f32 expression."""
    return xp.where(target_tps > 0, target_tps / out_tokens, total_rate)


_I32_MAX = 2147483647
_I32_MIN = -2147483648
_TWO_31 = 2147483648.0


def _saturating_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 with XLA's conversion semantics: out-of-range values
    saturate (inf and 3e10 -> 2147483647, -inf -> -2147483648) and NaN
    becomes 0. A bare `.to(torch.int32)` gives -2147483648 for all of
    those on the CPU, and something else again on CUDA."""
    big = x >= _TWO_31
    small = x < -_TWO_31
    nan = torch.isnan(x)
    safe = torch.where(big | small | nan, 0.0, x).to(_I32)
    out = torch.where(big, torch.full_like(safe, _I32_MAX), safe)
    return torch.where(small, torch.full_like(safe, _I32_MIN), out)


def fold_replicas(total, rate_star, min_replicas, xp=torch, scratch=None):
    """Replica count for offered load `total` at per-replica capacity
    `rate_star`: the exact ceil/max fold of `fleet_size` (f32 divide,
    ceil, int32 cast, min-replica and >=1 clamps). `xp=np` is the
    reference's host path, kept verbatim (its `scratch` buffer lets the
    quotient/ceil reuse a caller array); the torch path casts with XLA's
    saturating semantics (`_saturating_int32`).

    The two clamps fuse into one (max(max(r, m), 1) == max(r, max(m, 1))
    exactly, on int32)."""
    if xp is np:
        floor = np.maximum(min_replicas, 1)
        if scratch is not None:
            q = np.divide(total, rate_star, out=scratch)
            np.ceil(q, out=q)
            return np.maximum(q.astype("int32"), floor)
        replicas = np.ceil(total / rate_star).astype("int32")
        return np.maximum(replicas, floor)
    floor = torch.clamp(min_replicas, min=1)
    replicas = _saturating_int32(torch.ceil(total / rate_star))
    return torch.maximum(replicas, floor)


def fleet_analyze(
    lam: torch.Tensor, params: FleetParams, k_max: int, use_kernel: bool = False
):
    """Per-replica operating point at arrival rates `lam` (req/msec):
    (ttft, itl, rho, throughput req/msec)."""
    solve = _get_solver(use_kernel)
    grid = _make_grid(params, k_max)
    wait, serv, in_servers, tput = solve(lam, grid)
    conc = _concurrency(params, serv)
    prefill = torch.where(
        params.in_tokens > 0, params.gamma + params.delta * params.in_tokens * conc, 0.0
    )
    itl = params.alpha + params.beta * conc
    rho = torch.clamp(in_servers / grid.nmax, 0.0, 1.0)
    return wait + prefill, itl, rho, tput


def _operating_point(params, grid, solve, lam_min, total, rate_star):
    """The rate-dependent tail shared by `fleet_size` and `fleet_refold`:
    the offered-load fold and the per-replica operating point, in the
    reference's op order."""
    replicas = fold_replicas(total, rate_star, params.min_replicas)
    cost = replicas.to(_F32) * params.cost_per_replica
    per_replica_rate = total / replicas.to(_F32) / 1000.0  # req/msec
    per_replica_rate = torch.maximum(per_replica_rate, lam_min)
    wait, serv, in_servers, _ = solve(per_replica_rate, grid)
    conc = _concurrency(params, serv)
    prefill = torch.where(
        params.in_tokens > 0, params.gamma + params.delta * params.in_tokens * conc, 0.0
    )
    return (
        replicas, cost, params.alpha + params.beta * conc, wait + prefill,
        torch.clamp(in_servers / grid.nmax, 0.0, 1.0),
    )


def _agg_bisections(
    params: FleetParams, grid: _Grid, solve, ttft_tail_margin: float
) -> tuple[BisectCase, BisectCase]:
    """The TTFT and ITL bisections of `fleet_size`: the rate range, and the
    metrics at both its ends (one solve per end)."""
    one = torch.ones_like(params.alpha)
    lam_min = _service_rate(params, one) * _RATE_EPSILON
    lam_max = _service_rate(params, grid.nmax) * (1.0 - _RATE_EPSILON)
    ttft_lo, itl_lo = _ttft_itl_at(lam_min, params, grid, solve, ttft_tail_margin)
    ttft_hi, itl_hi = _ttft_itl_at(lam_max, params, grid, solve, ttft_tail_margin)
    consts = _agg_bisect_consts(params)
    return (
        BisectCase(AGG_TTFT, lam_min, lam_max, params.target_ttft, ttft_lo, ttft_hi,
                   consts, grid, None, ttft_tail_margin),
        BisectCase(AGG_ITL, lam_min, lam_max, params.target_itl, itl_lo, itl_hi,
                   consts, grid, None, 1.0),
    )


def fleet_size(
    params: FleetParams,
    k_max: int,
    n_iters: int = DEFAULT_BISECT_ITERS,
    use_kernel: bool = False,
    ttft_tail_margin: float = SLO_MARGIN,
    real_lanes: int | None = None,
) -> FleetResult:
    """Size every lane: max per-replica rate meeting TTFT/ITL/TPS targets,
    replica count for the offered load, cost, and the expected per-replica
    operating point (reference: pkg/analyzer/queueanalyzer.go:185-255 +
    pkg/core/allocation.go:126-157). TTFT targets bind at SLO_PERCENTILE
    via `ttft_tail_margin`. Runs 4 stationary solves and 2 bisections of
    `n_iters` steps (one launch each on the kernels). `real_lanes`: the
    lanes past it pad the bucket with copies of lane 0 (parallel.fleet),
    which the bisection kernel gives lane 0's result without solving."""
    solve = _get_solver(use_kernel)
    grid = _make_grid(params, k_max)
    ttft_case, itl_case = _agg_bisections(params, grid, solve, ttft_tail_margin)
    lam_min, lam_max = ttft_case.lam_min, ttft_case.lam_max
    lam_ttft, ok_ttft = _bisect(ttft_case, n_iters, use_kernel, real_lanes)
    lam_itl, ok_itl = _bisect(itl_case, n_iters, use_kernel, real_lanes)
    lam_ttft = torch.where(params.target_ttft > 0, lam_ttft, lam_max)
    ok_ttft = torch.where(params.target_ttft > 0, ok_ttft, True)
    lam_itl = torch.where(params.target_itl > 0, lam_itl, lam_max)
    ok_itl = torch.where(params.target_itl > 0, ok_itl, True)
    lam_tps = torch.where(
        params.target_tps > 0, lam_max * (1.0 - STABILITY_SAFETY_FRACTION), lam_max
    )

    lam_star = torch.minimum(torch.minimum(lam_ttft, lam_itl), lam_tps)
    feasible = ok_ttft & ok_itl

    # throughput at the binding rate -> per-replica capacity (req/sec)
    tput_star = solve(lam_star, grid)[3]
    rate_star = tput_star * 1000.0

    # replicas for the offered load; TPS targets replace the offered rate
    total = offered_load(params.total_rate, params.target_tps, params.out_tokens)
    replicas, cost, itl, ttft, rho = _operating_point(
        params, grid, solve, lam_min, total, rate_star
    )
    return FleetResult(
        feasible=feasible,
        lambda_star=lam_star,
        rate_star=rate_star,
        num_replicas=replicas,
        cost=cost,
        itl=itl,
        ttft=ttft,
        rho=rho,
    )


def fleet_refold(
    params: FleetParams,
    k_max: int,
    lambda_star: torch.Tensor,
    rate_star: torch.Tensor,
    feasible: torch.Tensor,
    use_kernel: bool = False,
) -> FleetResult:
    """The rate-dependent half of `fleet_size`: given the cached
    rate-independent bisection outputs (lambda_star, rate_star, feasible),
    recompute the offered-load fold and the per-replica operating point.
    One stationary solve instead of the bisection's 66."""
    solve = _get_solver(use_kernel)
    grid = _make_grid(params, k_max)
    one = torch.ones_like(params.alpha)
    lam_min = _service_rate(params, one) * _RATE_EPSILON

    total = offered_load(params.total_rate, params.target_tps, params.out_tokens)
    replicas, cost, itl, ttft, rho = _operating_point(
        params, grid, solve, lam_min, total, rate_star
    )
    return FleetResult(
        feasible=feasible,
        lambda_star=lambda_star,
        rate_star=rate_star,
        num_replicas=replicas,
        cost=cost,
        itl=itl,
        ttft=ttft,
        rho=rho,
    )


# -- disaggregated (prefill/decode tandem) lanes ------------------------------
#
# One replica is an atomic unit of (prefill_slices + decode_slices)
# engines. The scalar semantics are analyzer.disagg (tandem of two
# birth-death chains under the finite-buffer independence approximation);
# this is the batched equivalent.


class TandemParams(NamedTuple):
    """Structure-of-arrays description of disaggregated lanes. Float
    tensors f32[P], int tensors i32[P]; rates req/sec, times msec."""

    alpha: torch.Tensor  # decode base, msec
    beta: torch.Tensor  # decode slope, msec/req
    gamma: torch.Tensor  # prefill base, msec
    delta: torch.Tensor  # prefill slope, msec/(token*req)
    in_tokens: torch.Tensor  # avg input tokens (> 0 for a prefill stage)
    out_tokens: torch.Tensor  # avg output tokens (>= 1)
    prefill_batch: torch.Tensor  # i32: per prefill engine
    decode_batch: torch.Tensor  # i32: per decode engine
    prefill_cap: torch.Tensor  # i32: prefill_batch + max queue
    decode_cap: torch.Tensor  # i32: decode_batch + max queue
    prefill_slices: torch.Tensor  # f32: prefill engines per replica unit
    decode_slices: torch.Tensor  # f32: decode engines per replica unit
    target_ttft: torch.Tensor  # msec; 0 disables
    target_itl: torch.Tensor  # msec; 0 disables
    target_tps: torch.Tensor  # tokens/sec; 0 disables
    total_rate: torch.Tensor  # offered load, req/sec
    min_replicas: torch.Tensor  # i32
    cost_per_replica: torch.Tensor  # cents/hr for one whole unit


def tandem_params_from_numpy(np_params, device) -> "TandemParams":
    """The port's TandemParams from any object with the reference's
    TandemParams fields; dtypes as in `fleet_params_from_numpy`."""
    return _params_from_numpy(TandemParams, _TANDEM_INT_FIELDS, np_params, device)


def _tandem_num_decodes(p: TandemParams) -> torch.Tensor:
    # analyzer.disagg._decode_rates: max(out_tokens - 1, 1)
    return torch.clamp(p.out_tokens - 1.0, min=1.0)


def _tandem_ttft_at(
    lam_unit: torch.Tensor, p: TandemParams, gp: _Grid, solve, wait_margin: float = 1.0
):
    """TTFT depends only on the prefill stage (DisaggAnalyzer._ttft_at), so
    the TTFT bisection skips the decode-stage solve entirely. `wait_margin`
    scales the prefill-queue wait to its SLO percentile for sizing."""
    p_slope = p.delta * p.in_tokens
    pwait, pserv, _, _ = solve(lam_unit / p.prefill_slices, gp)
    pconc = _stage_concurrency(pserv, p.gamma, p_slope, gp.nmax)
    return wait_margin * pwait + p.gamma + p_slope * pconc


def _tandem_eval(lam_unit: torch.Tensor, p: TandemParams, gp: _Grid, gd: _Grid, solve):
    """Whole-unit metrics at unit arrival rates `lam_unit` (req/msec):
    (ttft, itl, rho, unit throughput req/msec). Mirrors
    DisaggAnalyzer._ttft_at/_itl_at/analyze. Two stationary solves."""
    nd = _tandem_num_decodes(p)
    p_slope = p.delta * p.in_tokens
    pwait, pserv, p_inserv, ptput = solve(lam_unit / p.prefill_slices, gp)
    pconc = _stage_concurrency(pserv, p.gamma, p_slope, gp.nmax)
    ttft = pwait + p.gamma + p_slope * pconc

    # decode stage sees the prefill stage's departures
    through_unit = ptput * p.prefill_slices
    dwait, dserv, d_inserv, dtput = solve(through_unit / p.decode_slices, gd)
    dconc = _stage_concurrency(dserv / nd, p.alpha, p.beta, gd.nmax)
    itl = p.alpha + p.beta * dconc

    # utilization of the binding stage (DisaggAnalyzer.analyze)
    rho = torch.clamp(
        torch.maximum(p_inserv / gp.nmax, d_inserv / gd.nmax), 0.0, 1.0
    )
    return ttft, itl, rho, dtput * p.decode_slices


def _tandem_grids(params: TandemParams, k_max: int):
    """(prefill grid, decode grid, lam_min, lam_max) of a tandem bucket:
    the binding stage saturates first (analyzer.disagg.build_disagg_analyzer)."""
    nd = _tandem_num_decodes(params)
    p_slope = params.delta * params.in_tokens
    gp = _make_stage_grid(
        params.gamma, p_slope, params.prefill_batch, params.prefill_cap, k_max
    )
    gd = _make_stage_grid(
        nd * params.alpha, nd * params.beta, params.decode_batch, params.decode_cap,
        k_max,
    )
    pb = params.prefill_batch.to(_F32)
    db = params.decode_batch.to(_F32)
    mu_p_full = pb / (params.gamma + p_slope * pb)
    mu_d_full = db / (nd * (params.alpha + params.beta * db))
    unit_max = torch.minimum(
        mu_p_full * params.prefill_slices, mu_d_full * params.decode_slices
    )
    return gp, gd, unit_max * _RATE_EPSILON, unit_max * (1.0 - _RATE_EPSILON)


def _tandem_bisections(
    params: TandemParams, gp: _Grid, gd: _Grid, lam_min, lam_max, solve,
    ttft_tail_margin: float,
) -> tuple[BisectCase, BisectCase]:
    """The TTFT and ITL bisections of `tandem_fleet_size`, with the metrics
    at both ends of the rate range."""
    _, itl_lo, _, _ = _tandem_eval(lam_min, params, gp, gd, solve)
    _, itl_hi, _, _ = _tandem_eval(lam_max, params, gp, gd, solve)
    ttft_lo = _tandem_ttft_at(lam_min, params, gp, solve, ttft_tail_margin)
    ttft_hi = _tandem_ttft_at(lam_max, params, gp, solve, ttft_tail_margin)
    consts = _tandem_bisect_consts(params)
    return (
        BisectCase(TAN_TTFT, lam_min, lam_max, params.target_ttft, ttft_lo, ttft_hi,
                   consts, gp, None, ttft_tail_margin),
        BisectCase(TAN_ITL, lam_min, lam_max, params.target_itl, itl_lo, itl_hi,
                   consts, gp, gd, 1.0),
    )


def _tandem_operating_point(params, gp, gd, solve, lam_min, rate_star):
    total = offered_load(params.total_rate, params.target_tps, params.out_tokens)
    replicas = fold_replicas(total, rate_star, params.min_replicas)
    cost = replicas.to(_F32) * params.cost_per_replica
    # expected per-unit operating point
    per_unit = torch.maximum(total / replicas.to(_F32) / 1000.0, lam_min)
    ttft, itl, rho, _ = _tandem_eval(per_unit, params, gp, gd, solve)
    return replicas, cost, itl, ttft, rho


def tandem_fleet_size(
    params: TandemParams,
    k_max: int,
    n_iters: int = DEFAULT_BISECT_ITERS,
    use_kernel: bool = False,
    ttft_tail_margin: float = SLO_MARGIN,
    real_lanes: int | None = None,
) -> FleetResult:
    """Size every disaggregated lane: batched equivalent of
    build_disagg_analyzer + DisaggAnalyzer.size + create_allocation's
    arithmetic. `k_max` must cover both stages' max batch. Runs 10
    stationary solves and 2 bisections of `n_iters` steps, the TTFT one a
    prefill solve a step, the ITL one a prefill and a decode solve (one
    launch each on the kernels). `real_lanes` as for `fleet_size`."""
    solve = _get_solver(use_kernel)
    gp, gd, lam_min, lam_max = _tandem_grids(params, k_max)
    ttft_case, itl_case = _tandem_bisections(
        params, gp, gd, lam_min, lam_max, solve, ttft_tail_margin
    )
    lam_ttft, ok_ttft = _bisect(ttft_case, n_iters, use_kernel, real_lanes)
    lam_itl, ok_itl = _bisect(itl_case, n_iters, use_kernel, real_lanes)
    lam_ttft = torch.where(params.target_ttft > 0, lam_ttft, lam_max)
    ok_ttft = torch.where(params.target_ttft > 0, ok_ttft, True)
    lam_itl = torch.where(params.target_itl > 0, lam_itl, lam_max)
    ok_itl = torch.where(params.target_itl > 0, ok_itl, True)
    lam_tps = torch.where(
        params.target_tps > 0, lam_max * (1.0 - STABILITY_SAFETY_FRACTION), lam_max
    )

    lam_star = torch.minimum(torch.minimum(lam_ttft, lam_itl), lam_tps)
    feasible = ok_ttft & ok_itl

    # unit throughput at the binding rate -> per-unit capacity (req/sec)
    tput_star = _tandem_eval(lam_star, params, gp, gd, solve)[3]
    rate_star = tput_star * 1000.0

    replicas, cost, itl, ttft, rho = _tandem_operating_point(
        params, gp, gd, solve, lam_min, rate_star
    )
    return FleetResult(
        feasible=feasible,
        lambda_star=lam_star,
        rate_star=rate_star,
        num_replicas=replicas,
        cost=cost,
        itl=itl,
        ttft=ttft,
        rho=rho,
    )


def tandem_refold(
    params: TandemParams,
    k_max: int,
    lambda_star: torch.Tensor,
    rate_star: torch.Tensor,
    feasible: torch.Tensor,
    use_kernel: bool = False,
) -> FleetResult:
    """The rate-dependent half of `tandem_fleet_size` — the disaggregated
    analogue of `fleet_refold` (one two-stage evaluation)."""
    solve = _get_solver(use_kernel)
    gp, gd, lam_min, _ = _tandem_grids(params, k_max)
    replicas, cost, itl, ttft, rho = _tandem_operating_point(
        params, gp, gd, solve, lam_min, rate_star
    )
    return FleetResult(
        feasible=feasible,
        lambda_star=lambda_star,
        rate_star=rate_star,
        num_replicas=replicas,
        cost=cost,
        itl=itl,
        ttft=ttft,
        rho=rho,
    )


def pack_result(res: FleetResult, out: torch.Tensor | None = None) -> torch.Tensor:
    """Pack a FleetResult into one f32[8, P] tensor (single device-to-host
    copy); with `out` (an [8, P] view of a larger buffer) the fields are
    written into it in place."""
    if out is None:
        return torch.stack([f.to(_F32) for f in res])
    for row, f in zip(out, res):
        row.copy_(f)
    return out


def unpack_result(arr) -> FleetResult:
    """Inverse of pack_result (host side, numpy)."""
    return FleetResult(
        feasible=arr[0] > 0.5,
        lambda_star=arr[1],
        rate_star=arr[2],
        num_replicas=arr[3].astype("int32"),
        cost=arr[4],
        itl=arr[5],
        ttft=arr[6],
        rho=arr[7],
    )
