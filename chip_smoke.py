#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`inferno_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA machine

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles both kernels (ops/csrc/stats_kernel.cu, the stationary
   solve, and ops/csrc/bisect_kernel.cu, the fused bisection) with nvcc,
   one process per source, into one library in build/kernels/;
3. kernels against their plain torch versions on the card, on synthetic
   cases (P x K sweep over the register widths and a strided width,
   saturated rates, empty tails, caps and batches beyond the grid):
   the stationary solve within 5e-3 relative (wait and serv on the
   response-time scale, as tests/test_pallas.py), the bisection for all
   four metrics with feasibility exact and lam_star within 1e-4 relative
   on at least 99.9% of lanes (the lanes outside are counted); and a
   40-variant fleet through the kernels against the port's scalar f64
   analyzer (System.calculate_all), the repo's parity oracle;
4. main path at full width: a 10,000-variant edge fleet (about 24k lanes)
   through calculate_fleet(backend="cuda") + solve_unlimited, with both
   kernels' launch counters checked (4 stationary solves and 2 bisections
   per aggregated bucket, 10 and 2 per tandem bucket), and the decisions
   checked for sanity; then, at every bucket of that path, both kernels
   against their plain versions, their per-launch device times beside
   their bounds, and the per-step composition on the stationary-solve
   kernel against the fused bisection (lanes whose lam_star differs in
   any bit are counted);
5. the same fleet on the plain torch versions on the card: identical
   decisions (accelerator exactly, replicas under the ±1 boundary rule);
6. timings: cold and warm (median of 3, loads perturbed between passes)
   calculate_fleet + solve_unlimited for both backends;
7. where the warm pass goes: the bucket solves alone, and the device's
   busy time in one pass under torch.profiler.

It prints a JSON line describing each kernel, then, as its last line,
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repo.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and f32 rate
# outside the tensor cores, for the least time the card could take
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations per (lane, k) element of the stationary solve: pass 1
# multiply, subtract, max, masked max; pass 2 multiply, subtract,
# subtract, exp, add, multiply, add
OPS_PER_ELEMENT = 11
TOL = 5e-3
# the bisection: lam_star within LAM_RTOL on at least LAM_SHARE of lanes
LAM_RTOL = 1e-4
LAM_SHARE = 0.999
FLEET_KW = dict(
    shapes_per_variant=3, tandem_every=5, zero_load_every=7,
    pinned_every=11, infeasible_every=13,
)
# launches of each kernel per bucket of the main path: the stationary
# solves outside the bisections (rate bounds, tput_star, operating point)
# and the two bisections (TTFT, ITL)
STATS_LAUNCHES_PER_BUCKET = {"agg": 4, "tan": 10}
BISECT_LAUNCHES_PER_BUCKET = 2
METRIC_NAMES = {0: "agg TTFT", 1: "agg ITL", 2: "tan TTFT", 3: "tan ITL"}


def _stat_errors(ref, got):
    """(max relative error over the four statistics, max absolute error),
    wait and serv relative to the response-time scale."""
    import numpy as np

    ref = [r.double().cpu().numpy() for r in ref]
    got = [g.double().cpu().numpy() for g in got]
    for r, g in zip(ref, got):
        if not np.array_equal(np.isfinite(r), np.isfinite(g)):
            raise AssertionError("kernel and plain version disagree on finiteness")
        if not np.all(np.isfinite(r)):
            raise AssertionError("non-finite statistics")
    scale = np.abs(ref[0]) + np.abs(ref[1]) + 1e-6
    rel = 0.0
    for i, (r, g) in enumerate(zip(ref, got)):
        den = scale if i < 2 else np.abs(r) + 1e-6
        rel = max(rel, float(np.max(np.abs(r - g) / den)))
    absolute = max(float(np.max(np.abs(r - g))) for r, g in zip(ref, got))
    return rel, absolute


class _LamTally:
    """The bisection kernel against its plain version, over every case:
    feasibility must be identical on every lane; lanes whose lam_star is
    off by more than LAM_RTOL relative are counted."""

    def __init__(self):
        self.lanes = 0
        self.outside = 0
        self.max_abs = 0.0

    def add(self, ref, got):
        import numpy as np

        ref_lam, ref_ok = (t.cpu().numpy() for t in ref)
        lam, ok = (t.cpu().numpy() for t in got)
        if not np.array_equal(ref_ok, ok):
            raise AssertionError("bisection kernel and plain version disagree on feasibility")
        ref_lam = ref_lam.astype(np.float64)
        lam = lam.astype(np.float64)
        same_nan = np.isnan(ref_lam) & np.isnan(lam)
        with np.errstate(invalid="ignore", divide="ignore"):
            err = np.abs(lam - ref_lam)
            off = ~same_nan & ~(err <= LAM_RTOL * np.abs(ref_lam))
        self.lanes += lam.size
        self.outside += int(off.sum())
        if np.any(~same_nan):
            self.max_abs = max(self.max_abs, float(np.nanmax(err[~same_nan])))
        return int(off.sum())

    def check(self, what):
        print(f"{what}: {self.outside} of {self.lanes} lanes outside {LAM_RTOL:g} "
              f"relative (allowed {(1.0 - LAM_SHARE) * self.lanes:.1f})")
        if self.outside > (1.0 - LAM_SHARE) * self.lanes:
            raise AssertionError(f"{what}: too many lanes outside the tolerance")


def _synthetic_case(P, K, seed, mode, device):
    import numpy as np
    import torch

    from inferno_tpu_torch.ops.queueing import _make_stage_grid

    rng = np.random.default_rng(seed)
    base = rng.uniform(5.0, 60.0, P)
    slope = rng.uniform(0.05, 1.0, P)
    nmax = rng.integers(max(1, K // 4), K + 1, P)
    cap = nmax * 11
    if mode == "empty_tail":
        cap = nmax
    elif mode == "beyond_grid":
        nmax = rng.integers(K // 2, 2 * K + 1, P)  # batches past the grid edge
        cap = np.full(P, 4 * K)
    q = rng.uniform(0.05, 1.5, P)
    if mode == "saturated":
        q = rng.uniform(1.5, 20.0, P)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    grid = _make_stage_grid(f32(base), f32(slope), i32(nmax), i32(cap), K)
    lam = (f32(q) * torch.exp(grid.log_mu_full)).contiguous()
    return lam, grid


def _bisect_cases(kind, params, k, solve):
    """The (TTFT, ITL) bisections a sizing program of `kind` runs on
    `params` at grid width `k`, their rate bounds solved by `solve`."""
    from inferno_tpu_torch.config.defaults import SLO_MARGIN
    from inferno_tpu_torch.ops import queueing as q

    if kind == "agg":
        return q._agg_bisections(params, q._make_grid(params, k), solve, SLO_MARGIN)
    gp, gd, lam_min, lam_max = q._tandem_grids(params, k)
    return q._tandem_bisections(params, gp, gd, lam_min, lam_max, solve, SLO_MARGIN)


def _synthetic_bisect_cases(kind, P, K, seed, device):
    """Both bisections of a synthetic bucket: batches that fill the grid
    (some past its edge), some lanes without input tokens, targets spread
    over each lane's metric range and past both ends, some disabled (0)."""
    import numpy as np
    import torch

    from inferno_tpu_torch.ops import queueing as q

    rng = np.random.default_rng(seed)

    def f32(lo, hi):
        return rng.uniform(lo, hi, P).astype(np.float32)

    common = dict(
        alpha=f32(5, 25), beta=f32(0.1, 0.5), gamma=f32(2, 8), delta=f32(0.005, 0.03),
        out_tokens=rng.integers(1, 256, P).astype(np.float32),
        target_ttft=f32(200, 900), target_itl=f32(15, 40),
        target_tps=np.zeros(P, np.float32), total_rate=f32(0.5, 30),
        min_replicas=np.ones(P, np.int32), cost_per_replica=f32(1, 10),
    )
    batch = rng.integers(max(1, K // 4), K + K // 4 + 1, P).astype(np.int32)
    if kind == "agg":
        in_tokens = rng.integers(64, 512, P).astype(np.float32)
        in_tokens[::5] = 0.0
        params = q.fleet_params_from_numpy(q.FleetParams(
            in_tokens=in_tokens, max_batch=batch, occupancy_cap=batch * 11, **common,
        ), device)
    else:
        pb = rng.integers(max(1, K // 8), K // 2 + 1, P).astype(np.int32)
        params = q.tandem_params_from_numpy(q.TandemParams(
            in_tokens=rng.integers(64, 512, P).astype(np.float32),
            prefill_batch=pb, decode_batch=batch, prefill_cap=pb * 10,
            decode_cap=batch * 10, prefill_slices=rng.integers(1, 3, P).astype(np.float32),
            decode_slices=rng.integers(1, 4, P).astype(np.float32), **common,
        ), device)
    cases = []
    for case in _bisect_cases(kind, params, K, q._solve_stats):
        u = torch.as_tensor(rng.uniform(-0.2, 1.2, P).astype(np.float32), device=device)
        target = case.y_lo + u * (case.y_hi - case.y_lo)
        target[::7] = 0.0
        cases.append(case._replace(target=target.contiguous()))
    return cases


def _bucket_case(kind, k, sub, device):
    """A stationary solve at a main-path bucket's shape: the bucket's own
    grid at the midpoint of its rate range (the first bisection step)."""
    from inferno_tpu_torch.ops import queueing as q

    if kind == "agg":
        params = q.fleet_params_from_numpy(sub, device)
        grid = q._make_grid(params, k)
        one = params.alpha.new_ones(params.alpha.shape)
        lam_min = q._service_rate(params, one) * q._RATE_EPSILON
        lam_max = q._service_rate(params, grid.nmax) * (1.0 - q._RATE_EPSILON)
        return 0.5 * (lam_min + lam_max), grid
    params = q.tandem_params_from_numpy(sub, device)
    gp, _, lam_min, lam_max = q._tandem_grids(params, k)
    return 0.5 * (lam_min + lam_max) / params.prefill_slices, gp


def _device_ms(fn, n):
    """Per-call device time of `fn` over `n` back-to-back calls: the
    stream is held by a sleep kernel while the host enqueues them, so the
    events see device time only, not the host's launch overhead. The
    sleep grows until it outlasts the host's enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = int(2e8)  # ~0.1 s of spinning at H100 clocks
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        ev[1].record()
        for _ in range(n):
            fn()
        ev[2].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].synchronize()
        if enqueue_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / n, enqueue_ms
        cycles *= 4
    raise RuntimeError("the host could not enqueue ahead of the device")


def _profiled_device_ms(fn, n):
    """Per-call device time of `fn`, summed over the kernels it runs, from
    torch.profiler over `n` calls: for sequences of hundreds of small
    launches, which overflow the launch queue `_device_ms` relies on."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return busy / 1e3 / n


def _bound(P, K):
    nbytes = P * K * 4 + 4 * P * 4 + 4 * P * 4  # cml, 4 lane vectors in, out
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = P * K * OPS_PER_ELEMENT / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bisect_bound(case, n_iters):
    """The least time for one bisection: its rows (two for tandem ITL)
    and per-lane inputs read once, its outputs written once; and
    n_iters stationary solves a row, OPS_PER_ELEMENT f32 operations an
    element each."""
    rows = 2 if case.gd is not None else 1
    P, K = case.gp.cml.shape
    c = case.consts.shape[0]
    nbytes = rows * P * K * 4 + P * 4 * (5 + c + 3 * rows) + P * 5
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_iters * rows * P * K * OPS_PER_ELEMENT / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _size_fleet(system, backend):
    import torch

    from inferno_tpu_torch.parallel import calculate_fleet
    from inferno_tpu_torch.solver import solve_unlimited

    t0 = time.perf_counter()
    n = calculate_fleet(system, backend=backend)
    solve_unlimited(system)
    torch.cuda.synchronize()
    return n, (time.perf_counter() - t0) * 1e3


def _check_decisions(system):
    """The main path's output is sane: every server with a feasible
    candidate holds an allocation of finite, positive cost."""
    import math

    allocated = 0
    for name, server in system.servers.items():
        best = server.all_allocations
        if len(best) and server.allocation is None:
            raise AssertionError(f"{name}: candidates but no allocation")
        a = server.allocation
        if a is None:
            continue
        for v in (a.cost, a.itl, a.ttft, a.rho, a.max_arrv_rate_per_replica):
            if not math.isfinite(v):
                raise AssertionError(f"{name}: non-finite allocation {a}")
        if a.accelerator and (a.num_replicas < 1 or a.cost <= 0):
            raise AssertionError(f"{name}: bad allocation {a}")
        allocated += 1
    return allocated


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "inferno_tpu_torch")):
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from inferno_tpu_torch.config.types import SystemSpec
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.ops import queueing as q
    from inferno_tpu_torch.parallel import build_fleet, build_tandem_fleet, reset_fleet_state
    from inferno_tpu_torch.parallel.fleet import _solve_all, bucket_slots
    from inferno_tpu_torch.testing.fleet import (
        assert_same_decisions,
        fleet_system_spec,
        perturb_loads,
    )

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    n_iters = q.DEFAULT_BISECT_ITERS

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    path = cuda_queueing.build()
    print(f"build: {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    if cuda_queueing.BUILD_LOG:
        print(cuda_queueing.BUILD_LOG.rstrip())

    # 3a. stationary-solve kernel against its plain version, synthetic cases
    # (K = 96 and 256 run the strided body, the others the register body)
    cases = [(P, K, "mixed") for P in (1, 13, 30000) for K in (128, 512, 2048)]
    cases += [(4096, 512, "saturated"), (4096, 128, "empty_tail"), (4096, 128, "beyond_grid"),
              (4096, 256, "mixed"), (13, 96, "beyond_grid")]
    for i, (P, K, mode) in enumerate(cases):
        lam, grid = _synthetic_case(P, K, 100 + i, mode, dev)
        got = cuda_queueing.solve_stats(lam, grid)
        torch.cuda.synchronize()
        rel, ab = _stat_errors(q._solve_stats(lam, grid), got)
        torch.cuda.synchronize()
        print(f"stats_kernel vs plain: P={P} K={K} {mode}: max rel {rel:.3g}, max abs {ab:.3g}")
        if rel > TOL:
            raise AssertionError(f"kernel disagrees with plain version: {rel} > {TOL}")

    # 3b. bisection kernel against its plain version, synthetic cases
    tally = _LamTally()
    for i, (kind, P, K) in enumerate(
        (kind, P, K) for kind in ("agg", "tan") for P in (1, 13, 4096)
        for K in (128, 512, 2048, 256)
    ):
        for case in _synthetic_bisect_cases(kind, P, K, 200 + i, dev):
            got = cuda_queueing.bisect(case, n_iters)
            torch.cuda.synchronize()
            off = tally.add(q._bisect_plain(case, n_iters), got)
            print(f"bisect_kernel vs plain: {METRIC_NAMES[case.metric]} P={P} K={K}: "
                  f"{off} lanes outside {LAM_RTOL:g}, {int(got[1].sum())} feasible")
    tally.check("bisect_kernel vs plain, synthetic cases")

    # 3c. a small fleet through the kernels against the port's scalar f64
    # analyzer, the repo's parity oracle (before the main path, so the
    # timed passes below never rebuild the snapshot's structure)
    small = fleet_system_spec(40, **FLEET_KW)
    oracle = System(SystemSpec.from_dict(small.to_dict()))
    oracle.calculate_all()
    fleet = System(small)
    _size_fleet(fleet, "cuda")
    for sname, s_server in oracle.servers.items():
        f_allocs = fleet.servers[sname].all_allocations
        if set(f_allocs) != set(s_server.all_allocations):
            raise AssertionError(f"{sname}: candidate sets differ from the scalar oracle")
        for acc, s in s_server.all_allocations.items():
            f = f_allocs[acc]
            if (abs(f.num_replicas - s.num_replicas) > 1
                    or abs(f.max_arrv_rate_per_replica - s.max_arrv_rate_per_replica)
                    > 2e-2 * abs(s.max_arrv_rate_per_replica)
                    or abs(f.cost - s.cost) > 2e-2 * abs(s.cost)):
                raise AssertionError(f"{sname}/{acc}: {f} vs scalar {s}")
    print("40-variant fleet: cuda backend agrees with the scalar f64 analyzer")

    # 4. main path at full width, through the kernels
    spec = fleet_system_spec(10000, **FLEET_KW)
    reset_fleet_state()
    system = System(spec)
    cuda_queueing.LAUNCHES = 0
    cuda_queueing.BISECT_LAUNCHES = 0
    lanes, cold_cuda = _size_fleet(system, "cuda")
    launches = cuda_queueing.LAUNCHES
    bisect_launches = cuda_queueing.BISECT_LAUNCHES
    slots = bucket_slots(build_fleet(system), build_tandem_fleet(system))
    expected = sum(STATS_LAUNCHES_PER_BUCKET[s[0]] for s in slots)
    expected_bisect = BISECT_LAUNCHES_PER_BUCKET * len(slots)
    buckets = [(s[0], s[1], len(s[3]), s[4]) for s in slots]
    print(f"main path: {len(system.servers)} variants, {lanes} lanes, buckets "
          f"(kind, K, lanes, padded) {buckets}")
    print(f"main path: stats_kernel launches {launches}, expected {expected}; "
          f"bisect_kernel launches {bisect_launches}, expected {expected_bisect}")
    if launches != expected or bisect_launches != expected_bisect:
        raise AssertionError(
            f"kernel launches {launches}/{bisect_launches} != expected "
            f"{expected}/{expected_bisect}"
        )
    allocated = _check_decisions(system)
    print(f"main path: {allocated} servers allocated")

    # 4b. both kernels against their plain versions at the main path's
    # shapes, and per-launch device times there; 4c. the per-step
    # composition on the stationary-solve kernel against the fused kernel
    per_bucket = []
    per_bisect = []
    max_abs = 0.0
    bucket_tally = _LamTally()
    bit_diff = bit_lanes = 0
    for kind, k, sub, idx, width in slots:
        lam, grid = _bucket_case(kind, k, sub, dev)
        got = cuda_queueing.solve_stats(lam, grid)
        rel, ab = _stat_errors(q._solve_stats(lam, grid), got)
        if rel > TOL:
            raise AssertionError(f"{kind} K={k}: kernel vs plain {rel} > {TOL}")
        max_abs = max(max_abs, ab)
        # few enough calls that their launches fit the device's launch queue
        k_ms, k_enq = _device_ms(lambda: cuda_queueing.solve_stats(lam, grid), 100)
        p_ms, p_enq = _device_ms(lambda: q._solve_stats(lam, grid), 5)
        b_ms, b_by = _bound(width, k)
        per_bucket.append(dict(kind=kind, K=k, P=width, ms=k_ms, plain_ms=p_ms,
                               bound_ms=b_ms, bound_by=b_by, rel=rel))
        print(f"bucket {kind} K={k} P={width}: stats_kernel {k_ms * 1e3:.2f} us, plain "
              f"{p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}), max rel "
              f"{rel:.3g} (host enqueue of the timed runs: {k_enq:.1f} ms, "
              f"{p_enq:.1f} ms)")

        params = (q.fleet_params_from_numpy(sub, dev) if kind == "agg"
                  else q.tandem_params_from_numpy(sub, dev))
        for case in _bisect_cases(kind, params, k, cuda_queueing.solve_stats):
            got = cuda_queueing.bisect(case, n_iters)
            off = bucket_tally.add(q._bisect_plain(case, n_iters), got)
            steps = q._bisect_plain(case, n_iters, solve=cuda_queueing.solve_stats)
            if not torch.equal(steps[1], got[1]):
                raise AssertionError("fused and per-step bisections disagree on feasibility")
            diff = int((steps[0].view(torch.int32) != got[0].view(torch.int32)).sum())
            bit_diff += diff
            bit_lanes += width
            f_ms, f_enq = _device_ms(lambda: cuda_queueing.bisect(case, n_iters), 20)
            s_ms = _profiled_device_ms(
                lambda: q._bisect_plain(case, n_iters, solve=cuda_queueing.solve_stats), 3)
            pl_ms = _profiled_device_ms(lambda: q._bisect_plain(case, n_iters), 3)
            b_ms, b_by = _bisect_bound(case, n_iters)
            per_bisect.append(dict(kind=kind, K=k, P=width, metric=case.metric, ms=f_ms,
                                   steps_ms=s_ms, plain_ms=pl_ms, bound_ms=b_ms,
                                   bound_by=b_by))
            print(f"bucket {kind} K={k} P={width} {METRIC_NAMES[case.metric]}: "
                  f"bisect_kernel {f_ms * 1e3:.2f} us, per-step composition on "
                  f"stats_kernel {s_ms * 1e3:.2f} us, plain {pl_ms * 1e3:.2f} us (device "
                  f"time), bound {b_ms * 1e3:.2f} us ({b_by}); {off} lanes outside "
                  f"{LAM_RTOL:g}, {diff} lanes differ in a bit from the per-step "
                  f"composition (host enqueue of the timed runs: {f_enq:.1f} ms)")
    bucket_tally.check("bisect_kernel vs plain, main-path buckets")
    print(f"fused vs per-step bisection on stats_kernel, main-path buckets: {bit_diff} of "
          f"{bit_lanes} lanes' lam_star differ in any bit")
    # the reported shapes: the bucket with the most bytes (the largest cml),
    # the bisection with the largest bound
    top = max(per_bucket, key=lambda b: b["P"] * b["K"])
    top_bisect = max(per_bisect, key=lambda b: b["bound_ms"])

    # 5. the same fleet on the plain versions
    reset_fleet_state()
    plain = System(SystemSpec.from_dict(spec.to_dict()))  # loads of its own
    cuda_queueing.LAUNCHES = 0
    cuda_queueing.BISECT_LAUNCHES = 0
    _, cold_torch = _size_fleet(plain, "torch")
    if cuda_queueing.LAUNCHES or cuda_queueing.BISECT_LAUNCHES:
        raise AssertionError("backend 'torch' launched a kernel")
    boundary = assert_same_decisions(system, plain)
    print(f"cuda vs torch backend: decisions identical ({boundary} ±1 boundary lanes)")

    # 6. timings: warm passes, loads perturbed before each, backends in turns
    warm = {"cuda": [], "torch": []}
    for rep in range(3):
        order = ("cuda", "torch") if rep % 2 == 0 else ("torch", "cuda")
        for backend in order:
            target = system if backend == "cuda" else plain
            perturb_loads(target)
            warm[backend].append(_size_fleet(target, backend)[1])
    for backend, cold in (("cuda", cold_cuda), ("torch", cold_torch)):
        print(f"calculate_fleet + solve_unlimited, backend {backend}: cold {cold:.1f} ms, "
              f"warm median {statistics.median(warm[backend]):.1f} ms "
              f"(passes {', '.join(f'{t:.1f}' for t in warm[backend])})")

    # 7. where the warm pass goes: the bucket solves alone (host clock),
    # and the device's busy time in one profiled pass per backend
    plan, tandem = build_fleet(plain), build_tandem_fleet(plain)
    for backend in ("cuda", "torch"):
        solves = []
        for _ in range(3):
            t0 = time.perf_counter()
            _solve_all(plan, tandem, dev, n_iters, backend == "cuda")
            torch.cuda.synchronize()
            solves.append((time.perf_counter() - t0) * 1e3)
        target = system if backend == "cuda" else plain
        perturb_loads(target)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _size_fleet(target, backend)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        med = statistics.median(warm[backend])
        print(f"warm pass, backend {backend}: bucket solves {statistics.median(solves):.1f} ms "
              f"of {med:.1f} ms; device busy {busy:.1f} ms in a profiled pass "
              f"({100.0 * busy / med:.1f}% of the warm median)")

    replaces = "inferno_tpu/ops/pallas_queueing.py:84"
    print(json.dumps({"kernels": [
        {
            "name": "stats_kernel",
            "route": "cuda",
            "source": "inferno_tpu_torch/ops/csrc/stats_kernel.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max_abs,
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": None,
        },
        {
            "name": "bisect_kernel",
            "route": "cuda",
            "source": "inferno_tpu_torch/ops/csrc/bisect_kernel.cu",
            "replaces": replaces,
            "launches": bisect_launches,
            "max_abs_err": bucket_tally.max_abs,
            "ms": top_bisect["ms"],
            "plain_ms": top_bisect["plain_ms"],
            "bound_ms": top_bisect["bound_ms"],
            "bound_by": top_bisect["bound_by"],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
