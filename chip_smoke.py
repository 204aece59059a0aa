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
   through calculate_fleet(backend="cuda") + solve_unlimited (the first
   cycle of the incremental path: every lane dirty), with both
   kernels' launch counters checked (4 stationary solves and 2 bisections
   per aggregated bucket, 10 and 2 per tandem bucket), and the decisions
   checked for sanity; then, at every bucket of that path, both kernels
   against their plain versions, their per-launch device times beside
   their bounds, and the per-step composition on the stationary-solve
   kernel against the fused bisection (lanes whose lam_star differs in
   any bit are counted);
5. the same fleet on the plain torch versions on the card: identical
   decisions (accelerator exactly, replicas under the ±1 boundary rule);
6. timings of the full path (INCREMENTAL_CYCLE=0, as measured before
   the incremental cycle was ported): cold and warm (median of 3, loads
   perturbed between passes) calculate_fleet + solve_unlimited for both
   backends;
7. where the warm full pass goes: the bucket solves alone, and the
   device's busy time in one pass under torch.profiler;
8. the incremental cycle on the 10k edge fleet, backend "cuda", from a
   full pass: (a) an unchanged cycle launches nothing and skips every
   server; (b) 1% of arrival rates moved launches refolds only, one
   stats_kernel launch per aggregated refold bucket and two per tandem
   bucket, no bisect_kernel launch; (c) the token mix changed on 20
   servers runs the full sizing program for those lanes' buckets only;
   (d) ten cycles mixing (b), (c) and current-allocation changes. After
   every cycle the decision surface (accelerator, replicas, cost, value,
   spot replicas) is bit-identical to a full pass of the same inputs on a
   fresh System (INCREMENTAL_CYCLE=0), the operating point within 1e-4,
   and no lane's lambda_star or rate_star differs in any bit between the
   two; the same count is reported for backend "torch";
9. the event cycle: calculate_fleet(event_dirty=10 names) reproduces the
   poll cycle's decisions exactly, reading 10 servers;
10. limited mode and the spot tier at 10k: the capacity bench's fleet at
   pool budgets of 100%, 80% and 50% of its unlimited solve, and the spot
   fixture's fleet at 80% with a spot budget of 10% of the pool, each
   through calculate_fleet + Optimizer.optimize: the vectorized greedy
   bit-identical to the scalar one (allocations and degradation events),
   backends "cuda" and "torch" identical when their sizings show no ceil
   boundary; degradation counts per step printed;
11. timings of the incremental path on the 100k fleet of the reference's
   incremental bench (1% λ-dirty steady cycle, median of 3; cold full
   solve after reset_results; device busy ms of one profiled 1% cycle) and
   of the 10k limited solve;
12. the reconcile loop on the card: the port's `Reconciler` (default
   config, backend auto, which resolves to cuda, with KEEP_ACCELERATOR
   false so that shapes are picked) over a 5,000-variant
   `fleet_cluster` + `fleet_fake_prom` (above the scan's 4,096-server
   limit: the production witness path), loads from --seed, every third
   variant with a second (v5e-16) profile, through five cycles: cold;
   unchanged; 1% of arrival rates moved; an event cycle with the movers
   marked in the DirtyQueue; limited mode (OPTIMIZER_MODE limited,
   TPU_CAPACITY at 80% of the unlimited solve's chips), with one profiled
   steady cycle before it. Every cycle's allocations equal those of an
   INCREMENTAL_CYCLE=0 full pass of the same SystemSpec on a fresh System
   (bit for bit); the cold cycle launches both kernels and the λ-only
   cycles stats_kernel only; cycles 1 and 3 decide as a backend-"torch"
   reconciler on the card does (ROADMAP's ±1 boundary rule). Printed per
   cycle: span times, the profile document's counters, scanned servers,
   launches; and the device's busy time in the profiled cycle;
13. the profile corrector's surrogate refit on the card: a 32-observation
   window whose residual is out of band makes `corrected_parms` report
   surrogate_used, with the fit's tensors on cuda; the refit's DecodeParms
   match the same fit on the CPU from the same initial weights (the
   default: the reference's seed-0 weights) within 1e-2 relative; both
   fits timed.

The card's name and power limit (nvidia-smi) are printed first and again
before the kernels line.

It prints a JSON line describing each kernel (its `launches`, times and
errors are phase 4's main-path pass; phase 12 prints its own window's
launches), then, as its last line,
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repo. `--seed` seeds
phase 12's loads (default 0).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def _stamp(label):
    print(f"[{time.perf_counter() - T0:.1f} s] {label}")

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


# phase 11's timed steady 1% cycles
STEADY_CYCLES = 3
# the incremental phases: launches of each kernel per bucket of a dispatch
# (a refold bucket runs one operating-point solve, two stages for tandem)
REFOLD_STATS_LAUNCHES = {"agg": 1, "tan": 2}
OP_RTOL = 1e-4


def _sync():
    import torch

    torch.cuda.synchronize()


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


class _SlotSpy:
    """Records every bucket a dispatch solves (`parallel.fleet.solve_slots`
    is the one dispatch of both paths) without changing what runs."""

    def __init__(self):
        from inferno_tpu_torch.parallel import fleet

        self.mod = fleet
        self.real = fleet.solve_slots
        self.slots = []

    def __enter__(self):
        def spy(slots, *args, **kwargs):
            self.slots.extend(slots)
            return self.real(slots, *args, **kwargs)

        self.mod.solve_slots = spy
        return self

    def __exit__(self, *exc):
        self.mod.solve_slots = self.real

    def plan(self):
        return [(s.kind, s.k, len(s.idx), s.width, "full" if s.cached is None else "refold")
                for s in self.slots]

    def expected(self):
        """(stats_kernel, bisect_kernel) launches the recorded buckets make."""
        stats = bisect = 0
        for s in self.slots:
            if s.cached is None:
                stats += STATS_LAUNCHES_PER_BUCKET[s.kind]
                bisect += BISECT_LAUNCHES_PER_BUCKET
            else:
                stats += REFOLD_STATS_LAUNCHES[s.kind]
        return stats, bisect


class _StageClock:
    """Host ms of an incremental cycle's stages, each ending where its
    result is on the host: the dirty scan (`FleetSnapshot.scan_update` /
    `scan_event_update`), the gathered solve (`fleet.solve_slots`: params
    upload, launches, the one result copy) and the unlimited solve's
    replay (`solve_unlimited`). The rest of a cycle is the bucketing and
    the writeback."""

    def __init__(self):
        from inferno_tpu_torch import solver
        from inferno_tpu_torch.parallel import fleet, snapshot

        self.targets = [(snapshot.FleetSnapshot, "scan_update", "scan"),
                        (snapshot.FleetSnapshot, "scan_event_update", "scan"),
                        (fleet, "solve_slots", "solve"),
                        (solver, "solve_unlimited", "replay")]
        self.ms = {}

    def __enter__(self):
        self.saved = []
        for owner, name, stage in self.targets:
            real = getattr(owner, name)
            self.saved.append((owner, name, real))

            def timed(*args, _real=real, _stage=stage, **kwargs):
                t0 = time.perf_counter()
                out = _real(*args, **kwargs)
                _sync()
                self.ms[_stage] = self.ms.get(_stage, 0.0) + (time.perf_counter() - t0) * 1e3
                return out

            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            setattr(owner, name, real)


def _staged_cycle(system, backend, **kw):
    """`_cycle` with its stages timed: (spy, counts, ms, {stage: ms})."""
    with _StageClock() as clock:
        spy, counts, ms = _cycle(system, backend, **kw)
    stages = dict(clock.ms)
    stages["rest"] = ms - sum(stages.values())
    return spy, counts, ms, stages


def _cycle(system, backend, **kw):
    """One counted incremental cycle: calculate_fleet + solve_unlimited with
    both kernels' counters zeroed just before and read just after, and the
    buckets it dispatched."""
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import calculate_fleet
    from inferno_tpu_torch.solver import solve_unlimited

    cuda_queueing.LAUNCHES = 0
    cuda_queueing.BISECT_LAUNCHES = 0
    with _SlotSpy() as spy:
        _, ms = _timed(lambda: (calculate_fleet(system, backend=backend, **kw),
                                solve_unlimited(system)))
    return spy, (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES), ms


def _decisions(system):
    out = {}
    for name, server in system.servers.items():
        a = server.allocation
        out[name] = None if a is None else (
            a.accelerator, a.num_replicas, a.cost, a.value, a.spot_replicas,
            a.itl, a.ttft, a.rho,
        )
    return out


def _full_pass(src, spec, backend):
    """The full path (INCREMENTAL_CYCLE=0 and the legacy lane walk,
    FLEET_SNAPSHOT=0, so the incremental state and snapshot stay
    untouched) on a fresh System of the same inputs, solved in the spec's
    optimizer mode: loads are shared with the spec, current allocations
    copied from `src` (None: the spec's own)."""
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.parallel import calculate_fleet
    from inferno_tpu_torch.solver import Optimizer

    prior = {k: os.environ.get(k) for k in ("INCREMENTAL_CYCLE", "FLEET_SNAPSHOT")}
    os.environ.update(INCREMENTAL_CYCLE="0", FLEET_SNAPSHOT="0")
    try:
        ref = System(spec)
        for r, s_ in zip(ref.servers.values(), src.servers.values() if src else ()):
            cur = s_.cur_allocation
            r.cur_allocation.accelerator = cur.accelerator
            r.cur_allocation.num_replicas = cur.num_replicas
            r.cur_allocation.cost = cur.cost
        calculate_fleet(ref, backend=backend)
        Optimizer(spec.optimizer).optimize(ref, calculate=False)
        return ref
    finally:
        for key, val in prior.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def _lane_bit_diffs(full):
    """Lanes whose lambda_star or rate_star differ in any bit between the
    incremental state's tables and the full pass just made (its plans and
    results are the solve memo's), matched by (server, accelerator)."""
    import numpy as np

    from inferno_tpu_torch.parallel import fleet, incremental

    memo = fleet._solve_memo["last"]
    want = {}
    for plan, res in ((memo["plan"], memo["results"][0]), (memo["tandem"], memo["results"][1])):
        if plan is None:
            continue
        lam = np.asarray(res.lambda_star, np.float32).view(np.int32)
        rate = np.asarray(res.rate_star, np.float32).view(np.int32)
        for i, key in enumerate(plan.lanes):
            want[key] = (int(lam[i]), int(rate[i]))
    st = incremental._state
    snap = fleet._get_snapshot()
    got = {}
    for kind in ("agg", "tan"):
        kt, t = snap.kind_table(kind), st.kinds[kind]
        if kt.mask is None or not len(kt.mask):
            continue
        rows = np.flatnonzero(kt.mask & t.valid)
        lam = t.res.lambda_star[rows].view(np.int32)
        rate = t.res.rate_star[rows].view(np.int32)
        for j, r in enumerate(rows):
            got[kt.lanes[r]] = (int(lam[j]), int(rate[j]))
    if set(got) != set(want):
        raise AssertionError("incremental and full passes size different lane sets")
    return sum(got[k] != want[k] for k in want), len(want)


def _compare_to_full(system, spec, backend, label, strict=True):
    """The incremental cycle just run against a full pass of the same
    inputs: (decision mismatches, worst operating-point rel error, lanes
    differing in a bit, lanes). Raises on any difference when `strict`."""
    full = _full_pass(system, spec, backend)
    bits, lanes = _lane_bit_diffs(full)
    got, want = _decisions(system), _decisions(full)
    mismatch = 0
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if (g is None) != (w is None) or (w is not None and g[:5] != w[:5]):
            mismatch += 1
            continue
        if w is None:
            continue
        for gv, wv in zip(g[5:], w[5:]):
            worst = max(worst, abs(gv - wv) / max(abs(wv), 1e-6))
    print(f"  {label}: vs a full pass on a fresh System: {mismatch} decisions differ, "
          f"operating point max rel {worst:.3g}, {bits} of {lanes} lanes' "
          f"lambda_star/rate_star differ in a bit")
    if strict and (mismatch or bits or worst > OP_RTOL):
        raise AssertionError(f"{label}: incremental cycle differs from the full pass")
    return mismatch, worst, bits, lanes


def _move_rates(system, rng, fraction):
    """Scale the arrival rate of `fraction` of the loaded servers."""
    loaded = [s for s in system.servers.values() if s.load is not None and s.load.arrival_rate > 0]
    picks = rng.choice(len(loaded), max(int(len(system.servers) * fraction), 1), replace=False)
    for i in picks:
        loaded[i].load.arrival_rate *= float(rng.uniform(0.6, 1.7))
    return [loaded[i].name for i in picks]


def _move_token_mix(system, rng, n):
    """Change the token mix of n loaded servers. The load is edited in place
    (it is shared with the spec, so the full pass sees it) and the server
    object is replaced by a copy, as a controller's fresh objects are: the
    identity-witness scan of a fleet this size re-reads replaced servers."""
    import copy

    loaded = [name for name, s in system.servers.items()
              if s.load is not None and s.load.arrival_rate > 0]
    names = [loaded[i] for i in rng.choice(len(loaded), n, replace=False)]
    for name in names:
        load = system.servers[name].load
        load.avg_in_tokens = float(rng.integers(16, 600))
        load.avg_out_tokens = float(rng.integers(8, 400))
        system.servers[name] = copy.copy(system.servers[name])
    return names


def _move_current(system, rng, n):
    """Replace the current allocation of n servers (a fresh object with new
    replicas and cost, as a controller reads it back)."""
    names = list(system.servers)
    for i in rng.choice(len(names), n, replace=False):
        server = system.servers[names[i]]
        cur = server.cur_allocation.clone()
        cur.num_replicas = int(rng.integers(0, 6))
        cur.cost = float(rng.uniform(0, 200))
        server.cur_allocation = cur


def _check_launches(label, spy, counts, refold_only=None):
    expected = spy.expected()
    kinds = {p[4] for p in spy.plan()}
    print(f"  {label}: dispatch (kind, K, lanes, padded, program) {spy.plan()}")
    print(f"  {label}: stats_kernel launches {counts[0]}, bisect_kernel {counts[1]}; "
          f"expected {expected[0]} and {expected[1]}")
    if tuple(counts) != expected:
        raise AssertionError(f"{label}: launches {counts} != expected {expected}")
    if refold_only is not None and kinds - ({"refold"} if refold_only else {"full"}):
        raise AssertionError(f"{label}: dispatched {kinds}")


def _phase8(spec):
    """8. the incremental cycle on the 10k edge fleet, backend cuda."""
    import numpy as np

    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import reset_fleet_state

    reset_fleet_state()
    system = System(spec)
    rng = np.random.default_rng(8)
    total = [0, 0]

    def run(label, **kw):
        spy, counts, ms = _cycle(system, "cuda", **kw)
        total[0] += counts[0]
        total[1] += counts[1]
        fd = system.fleet_dirty
        print(f"  {label}: {ms:.1f} ms, {len(fd.dirty_pos)} dirty servers, {fd.dirty_lanes} "
              f"lanes solved ({fd.refold_lanes} refolded), {fd.skipped_servers} skipped, "
              f"{fd.scanned_servers} scanned")
        return spy, counts

    print("8. incremental cycle, 10k edge fleet, backend cuda")
    spy, counts = run("full pass")
    _check_launches("full pass", spy, counts, refold_only=False)
    _compare_to_full(system, spec, "cuda", "full pass")

    spy, counts = run("(a) unchanged")
    if counts != (0, 0) or system.fleet_dirty.skipped_servers != len(system.servers):
        raise AssertionError("(a): an unchanged cycle launched a kernel or re-solved a server")
    _compare_to_full(system, spec, "cuda", "(a) unchanged")

    _move_rates(system, rng, 0.01)
    spy, counts = run("(b) 1% of rates moved")
    _check_launches("(b)", spy, counts, refold_only=True)
    if counts[1]:
        raise AssertionError("(b): a λ-only cycle ran a bisection")
    _compare_to_full(system, spec, "cuda", "(b) 1% of rates moved")

    moved = _move_token_mix(system, rng, 20)
    spy, counts = run("(c) token mix of 20 servers")
    _check_launches("(c)", spy, counts, refold_only=False)
    dirty = {list(system.servers)[p] for p in system.fleet_dirty.dirty_pos.tolist()}
    if dirty != set(moved):
        raise AssertionError(f"(c): dirty servers {sorted(dirty)} != moved {sorted(moved)}")
    _compare_to_full(system, spec, "cuda", "(c) token mix of 20 servers")

    for i in range(10):
        _move_rates(system, rng, 0.01)
        if i % 2 == 0:
            _move_token_mix(system, rng, 5)
        _move_current(system, rng, 20)
        spy, counts = run(f"(d) mixed cycle {i}")
        _check_launches(f"(d) mixed cycle {i}", spy, counts)
        _compare_to_full(system, spec, "cuda", f"(d) mixed cycle {i}")
    print(f"phase 8 (cuda): stats_kernel launches {total[0]}, bisect_kernel {total[1]}")
    if not (total[0] and total[1]):
        raise AssertionError("phase 8 did not launch both kernels")
    cuda_queueing.LAUNCHES = cuda_queueing.BISECT_LAUNCHES = 0

    # backend torch on the card: torch's own reductions may split a row by
    # tensor shape, so lanes that differ are reported, not required to be 0
    reset_fleet_state()
    tsys = System(spec)
    trng = np.random.default_rng(80)
    report = []
    for label, mover in (("full pass", None),
                         ("(b)", lambda: _move_rates(tsys, trng, 0.01)),
                         ("(c)", lambda: _move_token_mix(tsys, trng, 20))):
        if mover is not None:
            mover()
        if _cycle(tsys, "torch")[1] != (0, 0):
            raise AssertionError("backend 'torch' launched a kernel")
        report.append(_compare_to_full(tsys, spec, "torch", f"torch {label}", strict=False))
    print(f"phase 8 (torch on the card): {sum(r[2] for r in report)} lane bit differences, "
          f"{sum(r[0] for r in report)} decision differences over {len(report)} cycles (reported)")
    return total


def _phase9(spec_fn):
    """9. the event cycle reproduces the poll cycle's decisions exactly."""
    import numpy as np

    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.parallel import reset_fleet_state

    def run(events):
        reset_fleet_state()
        system = System(spec_fn())
        _cycle(system, "cuda")
        names = [n for n, s in system.servers.items() if s.load.arrival_rate > 0]
        rng = np.random.default_rng(9)
        moved = [names[i] for i in rng.choice(len(names), 10, replace=False)]
        for name in moved:
            system.servers[name].load.arrival_rate *= float(rng.uniform(1.2, 1.6))
        spy, counts, ms = _cycle(system, "cuda", event_dirty=moved if events else None)
        fd = system.fleet_dirty
        print(f"  {'event' if events else 'poll'} cycle: {ms:.1f} ms, scanned_servers "
              f"{fd.scanned_servers}, dirty {len(fd.dirty_pos)}, launches {counts}")
        return _decisions(system), fd.scanned_servers, set(moved)

    print("9. event cycle vs poll cycle, 10k edge fleet, backend cuda")
    ev, ev_scanned, moved = run(True)
    poll, poll_scanned, _ = run(False)
    if ev_scanned != len(moved) or poll_scanned != len(poll):
        raise AssertionError(f"scanned {ev_scanned} / {poll_scanned} servers")
    if ev != poll:
        raise AssertionError("event cycle differs from the poll cycle")
    print(f"event ≡ poll: identical decisions on {len(poll)} servers; scanned_servers "
          f"{ev_scanned} (event) vs {poll_scanned} (poll)")


def _candidate_boundary(a, b):
    """Candidate sets of two sized Systems under the round's rule; returns
    the number of ±1 ceil-boundary candidates (rate_star within 1e-4)."""
    boundary = 0
    for name, sa in a.servers.items():
        ca, cb = sa.all_allocations, b.servers[name].all_allocations
        if set(ca) != set(cb):
            raise AssertionError(f"{name}: candidate sets differ")
        for acc in ca:
            x, y = ca[acc], cb[acc]
            if (x.num_replicas, x.spot_replicas) != (y.num_replicas, y.spot_replicas):
                rx, ry = x.max_arrv_rate_per_replica, y.max_arrv_rate_per_replica
                if abs(rx - ry) > 1e-4 * max(abs(rx), abs(ry)):
                    raise AssertionError(f"{name}/{acc}: {x} vs {y}")
                boundary += 1
    return boundary


def _limited_surface(system):
    import dataclasses

    alloc = {n: None if s.allocation is None else (
        s.allocation.accelerator, s.allocation.num_replicas, s.allocation.batch_size,
        s.allocation.cost, s.allocation.value, s.allocation.spot_replicas,
        s.allocation.spot_discount) for n, s in system.servers.items()}
    events = {k: dataclasses.asdict(v) for k, v in system.degradations.items()}
    return alloc, events


def _limited_case(label, spec):
    """One limited-mode fleet: vectorized (cuda) ≡ scalar bit for bit,
    cuda ≡ torch; returns the vectorized solve's host ms."""
    from collections import Counter

    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
    from inferno_tpu_torch.solver import Optimizer
    from inferno_tpu_torch.solver.greedy import solve_greedy

    def sized(backend):
        reset_fleet_state()
        system = System(spec)
        calculate_fleet(system, backend=backend)
        return system

    reset_fleet_state()
    vec = System(spec)
    _, size_ms = _timed(lambda: calculate_fleet(vec, backend="cuda"))
    _, solve_ms = _timed(lambda: Optimizer(spec.optimizer).optimize(vec, calculate=False))
    ms = size_ms + solve_ms
    if vec.fleet_candidates is None or not vec.fleet_candidates.num_rows:
        raise AssertionError(f"{label}: the vectorized solve did not use its candidate table")
    scalar = sized("cuda")
    solve_greedy(scalar, spec.optimizer)
    if _limited_surface(vec) != _limited_surface(scalar):
        raise AssertionError(f"{label}: vectorized and scalar greedy differ")
    torch_sys = sized("torch")
    Optimizer(spec.optimizer).optimize(torch_sys, calculate=False)
    boundary = _candidate_boundary(vec, torch_sys)
    same = _limited_surface(vec) == _limited_surface(torch_sys)
    if boundary == 0 and not same:
        raise AssertionError(f"{label}: cuda and torch decisions differ with no boundary lane")
    steps = Counter(e.step for e in vec.degradations.values())
    allocated = sum(1 for s in vec.servers.values() if s.allocation is not None)
    spot = sum(s.allocation.spot_replicas for s in vec.servers.values() if s.allocation)
    print(f"  {label}: {ms:.1f} ms (calculate_fleet {size_ms:.1f} + optimize {solve_ms:.1f}, "
          f"cuda, a fresh state); vec ≡ scalar bit for "
          f"bit; cuda vs torch: {boundary} boundary candidates, decisions "
          f"{'identical' if same else 'differ (boundary cascade)'}; {allocated} allocated, "
          f"{spot} spot replicas; degradations {dict(sorted(steps.items()))}")
    return ms


def _phase10():
    """10. limited mode and the spot tier at 10k."""
    import dataclasses

    from inferno_tpu_torch.config.types import CapacitySpec, OptimizerSpec, SpotPoolSpec
    from inferno_tpu_torch.testing.fleet import fleet_capacity, fleet_system_spec

    print("10. limited mode and spot, 10k")
    spec = fleet_system_spec(10000, shapes_per_variant=2, priority_classes=3, split_pools=True)
    cap = fleet_capacity(spec, 1.0, backend="cuda")
    times = {}
    for fraction in (1.0, 0.8, 0.5):
        spec.capacity = CapacitySpec(chips={p: int(c * fraction) for p, c in cap.items()})
        spec.optimizer = OptimizerSpec(unlimited=False)
        times[fraction] = _limited_case(f"capacity fleet at {fraction:.0%}", spec)
    # the spot fixture's fleet: every shape in the v5e pool, the cheap
    # hazard (risk premium below the discount) with 10% of the pool as spot
    spot = fleet_system_spec(10000, shapes_per_variant=3, priority_classes=3)
    spot_cap = fleet_capacity(spot, 0.8, backend="cuda")
    tier = SpotPoolSpec(discount=0.5, hazard_per_hr=0.001, blast_radius=0.5, recovery_s=180.0,
                        chips=int(0.1 * spot_cap["v5e"]))
    spot.capacity = CapacitySpec(chips=spot_cap, spot={"v5e": tier})
    spot.optimizer = OptimizerSpec(unlimited=False)
    _limited_case(f"spot fleet at 80%, spot budget {tier.chips} chips", spot)
    print(f"  spot tier: {dataclasses.asdict(tier)}")
    return times


def _phase11(smi, limited_ms):
    """11. timings of the incremental path, 100k variants, backend cuda."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.parallel import incremental, reset_fleet_state
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    print(f"11. timings, 100k fleet of the incremental bench, backend cuda, on {smi}")
    reset_fleet_state()
    system = System(fleet_system_spec(100000, shapes_per_variant=1))
    _, counts, first_ms = _cycle(system, "cuda")
    rng = np.random.default_rng(11)
    steady = []
    for _ in range(STEADY_CYCLES + 1):
        _move_rates(system, rng, 0.01)
        steady.append(_staged_cycle(system, "cuda"))
    steady = steady[1:]  # the first 1% cycle meets new refold bucket shapes
    incremental.reset_results()
    _, cold_counts, cold_ms, cold_stages = _staged_cycle(system, "cuda")
    _move_rates(system, rng, 0.01)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_counts, prof_ms = _cycle(system, "cuda")
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    lanes = system.fleet_dirty.dirty_lanes

    def split(stages):
        return ", ".join(f"{k} {stages.get(k, 0.0):.1f}" for k in ("scan", "solve", "replay", "rest"))

    times = [c[2] for c in steady]
    med = sorted(steady, key=lambda c: c[2])[len(steady) // 2]
    print(f"  first pass (snapshot, state and every lane): {first_ms:.1f} ms")
    print(f"  steady 1% λ-dirty cycle: median {statistics.median(times):.1f} ms of {len(times)} "
          f"({', '.join(f'{t:.1f}' for t in times)}); launches {med[1]}; stages of the "
          f"median cycle (ms): {split(med[3])}")
    print(f"  cold full solve after reset_results: {cold_ms:.1f} ms; launches {cold_counts}; "
          f"stages (ms): {split(cold_stages)}")
    print(f"  profiled 1% cycle: {prof_ms:.1f} ms on the host clock, device busy {busy:.2f} ms "
          f"({100.0 * busy / prof_ms:.1f}%), {lanes} lanes, launches {prof_counts}")
    print(f"  10k limited solve (capacity fleet at 80%, calculate_fleet + optimize): "
          f"{limited_ms:.1f} ms")


def _incremental_phases(smi):
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    def edge():
        return fleet_system_spec(10000, **FLEET_KW)

    _phase8(edge())
    _phase9(edge)
    times = _phase10()
    _stamp("phases 8-10 done")
    _phase11(smi, times[0.8])


# phase 12: the reconcile loop's fleet (above the scan's 4,096-server
# full-signature limit) and its 1% movers
RECONCILE_VARIANTS = 5000
RECONCILE_MOVE = 0.01
# phase 13: the corrector's refit on the card against the CPU
REFIT_RTOL = 1e-2


class _CaptureSystems:
    """Records every System the reconciler builds, with a copy of its
    SystemSpec taken before the solve, without changing what runs."""

    def __init__(self):
        from inferno_tpu_torch.controller import reconciler

        self.mod = reconciler
        self.real = reconciler.System
        self.systems, self.specs = [], []

    def __enter__(self):
        from inferno_tpu_torch.config.types import SystemSpec

        def make(spec):
            self.specs.append(SystemSpec.from_dict(spec.to_dict()))
            system = self.real(spec)
            self.systems.append(system)
            return system

        self.mod.System = make
        return self

    def __exit__(self, *exc):
        self.mod.System = self.real


def _reconcile_fleet(n, seed):
    """The phase-12 cluster and load table: `fleet_cluster(n)` with max
    batch sizes drawn from the seed (lanes in more than one K bucket) and a
    second, v5e-16 profile on every third variant; arrival rate, token mix
    and occupancy drawn from the seed, with observed latencies on the CR
    profile's line (the corrector stays in band)."""
    import numpy as np

    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
    from inferno_tpu_torch.controller.crd import AcceleratorProfile
    from inferno_tpu_torch.testing.fleet import FLEET_NS, fleet_cluster, fleet_model

    rng = np.random.default_rng(seed)
    cluster = fleet_cluster(n)
    batches = rng.choice([48, 96, 256, 512], n)
    for i, va in enumerate(cluster.list_variant_autoscalings()):
        va.spec.accelerators[0].max_batch_size = int(batches[i])
        if i % 3 == 0:
            va.spec.accelerators.append(AcceleratorProfile(
                acc="v5e-16", acc_count=1, max_batch_size=int(2 * batches[i]),
                at_tokens=128, decode_parms=DecodeParms(alpha=8.0, beta=0.04),
                prefill_parms=PrefillParms(gamma=3.0, delta=0.008),
            ))
        cluster.add_variant_autoscaling(va)
    rows = {}
    for i in range(n):
        running = float(rng.uniform(1.0, 8.0))
        in_tok = float(rng.choice([64.0, 128.0, 512.0, 1024.0]))
        rows[(fleet_model(i), FLEET_NS)] = {
            "running": running, "arrival_rps": float(rng.uniform(0.5, 30.0)),
            "in_tokens": in_tok, "out_tokens": float(rng.choice([64.0, 128.0, 256.0])),
            "ttft_s": (5.0 + 0.02 * in_tok * running) / 1e3,
            "itl_s": (18.0 + 0.3 * running) / 1e3, "max_batch": float(batches[i]),
        }
    return cluster, rows


def _move_rows(rows, rng, fraction):
    """Scale the arrival rate of `fraction` of the rows; returns the new
    table and the moved variants' server names."""
    from inferno_tpu_torch.testing.fleet import fleet_variant

    keys = sorted(rows)
    picks = rng.choice(len(keys), max(int(len(keys) * fraction), 1), replace=False)
    out = {k: dict(v) for k, v in rows.items()}
    names = []
    for i in picks:
        out[keys[i]]["arrival_rps"] *= float(rng.uniform(0.6, 1.7))
        names.append(f"{fleet_variant(int(keys[i][0].rsplit('-', 1)[1]))}:{keys[i][1]}")
    return out, names


def _same_records(a, b, label):
    """DecisionRecords of two reconcilers under ROADMAP's rule: reason and
    shape exactly, replicas exactly or ±1 where lambda_max agrees within
    1e-4 relative. Returns the number of boundary variants."""
    boundary = 0
    if [r.variant for r in a] != [r.variant for r in b]:
        raise AssertionError(f"{label}: different variants")
    for x, y in zip(a, b):
        if (x.reason, x.accelerator) != (y.reason, y.accelerator):
            raise AssertionError(f"{label}: {x.variant}: {x.reason}/{x.accelerator} vs "
                                 f"{y.reason}/{y.accelerator}")
        if x.replicas != y.replicas:
            close = abs(x.lambda_max_rpm - y.lambda_max_rpm) <= 1e-4 * max(
                abs(x.lambda_max_rpm), abs(y.lambda_max_rpm))
            if abs(x.replicas - y.replicas) != 1 or not close:
                raise AssertionError(f"{label}: {x.variant}: replicas {x.replicas} vs "
                                     f"{y.replicas}")
            boundary += 1
    return boundary


def _phase12(seed, smi):
    """12. reconcile cycles of the port's controller on the card."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import reset_fleet_state
    from inferno_tpu_torch.testing.fleet import fleet_fake_prom

    n = RECONCILE_VARIANTS
    print(f"12. reconcile loop, {n} variants (fleet_cluster + fleet_fake_prom, seed {seed}), "
          f"on {smi}")
    # one decision log line a variant a cycle would flood the output
    os.environ["LOG_LEVEL"] = "warn"
    rng = np.random.default_rng(seed + 12)
    cluster, rows0 = _reconcile_fleet(n, seed)
    reset_fleet_state()
    # the default config (backend auto) apart from KEEP_ACCELERATOR=false,
    # so that the variants with two profiles are free to change shape
    rec = Reconciler(cluster, fleet_fake_prom(rows0), ReconcilerConfig(keep_accelerator=False))
    if rec.config.compute_backend != "cuda":
        raise AssertionError(f"auto resolved to {rec.config.compute_backend!r}")
    rows1, _ = _move_rows(rows0, rng, RECONCILE_MOVE)
    rows2, movers = _move_rows(rows1, rng, RECONCILE_MOVE)
    rows3, _ = _move_rows(rows2, rng, RECONCILE_MOVE)
    plan = [
        ("1 cold", rows0, None, False, "both"),
        ("2 unchanged", rows0, None, False, "none"),
        ("3 1% of rates moved", rows1, None, False, "stats"),
        ("4 event cycle, movers marked", rows2, movers, False, "stats"),
        ("  profiled steady 1% cycle", rows3, None, True, "stats"),
        ("5 limited mode, capacity 80%", rows3, None, False, None),
    ]
    records, surfaces = {}, []
    # one window over the six cycles: zeroed here, read after the last;
    # each cycle's own launches are the counters' rise across it, and the
    # full passes they are held against run after the window
    cuda_queueing.LAUNCHES = 0
    cuda_queueing.BISECT_LAUNCHES = 0
    for label, rows, marked, profiled, expect in plan:
        if label.startswith("5"):
            chips = sum(r.replicas * (16 if r.accelerator == "v5e-16" else 4)
                        for r in records["4"] if r.accelerator)
            cluster.set_configmap("inferno-system", "inferno-autoscaler-config", {
                "OPTIMIZER_MODE": "limited",
                "TPU_CAPACITY": json.dumps({"v5e": int(0.8 * chips)}),
            })
        rec.prom = fleet_fake_prom(rows)
        if marked is not None:
            from inferno_tpu_torch.controller.watch import SOURCE_WATCH

            rec.dirty_queue.mark(marked, source=SOURCE_WATCH, wake=False)
        before = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
        with _CaptureSystems() as cap:
            if profiled:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    report, ms = _timed(rec.run_cycle)
            else:
                report, ms = _timed(rec.run_cycle)
        counts = (cuda_queueing.LAUNCHES - before[0], cuda_queueing.BISECT_LAUNCHES - before[1])
        if not report.optimization_ok or report.errors:
            raise AssertionError(f"cycle {label}: {report.errors[:3]}")
        records[label.split()[0]] = report.decisions
        system, spec = cap.systems[-1], cap.specs[-1]
        spans = {c.name: c.duration_ms for c in report.trace.children}
        c = report.profile["counters"]
        fd = system.fleet_dirty
        print(f"  cycle {label}: {ms:.1f} ms; spans (ms) "
              + ", ".join(f"{k} {spans.get(k, 0.0):.1f}"
                          for k in ("collect", "analyze", "solve", "actuate"))
              + f"; counters dirty_lanes {c.get('dirty_lanes', 0)}, skipped_servers "
              f"{c.get('skipped_servers', 0)}, jit_dispatches {c.get('jit_dispatches', 0)}, "
              f"jit_compiles {c.get('jit_compiles', 0)}, solve_replayed_servers "
              f"{c.get('solve_replayed_servers', 0)}; scanned_servers "
              f"{fd.scanned_servers if fd is not None else 'full path'}; "
              f"launches stats_kernel {counts[0]}, bisect_kernel {counts[1]}; "
              f"{report.variants_applied} applied")
        if profiled:
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3
            print(f"    device busy {busy:.2f} ms of a {ms:.1f} ms cycle "
                  f"({100.0 * busy / ms:.2f}%) under torch.profiler")
        if expect == "both" and not (counts[0] and counts[1]):
            raise AssertionError(f"cycle {label}: launches {counts}, expected both kernels")
        if expect == "stats" and (not counts[0] or counts[1]):
            raise AssertionError(f"cycle {label}: launches {counts}, expected stats_kernel only")
        if expect == "none" and counts != (0, 0):
            raise AssertionError(f"cycle {label}: launches {counts}, expected none")
        if label.startswith("1"):
            shapes = {}
            for r in report.decisions:
                shapes[r.accelerator] = shapes.get(r.accelerator, 0) + 1
            print(f"    shapes chosen {dict(sorted(shapes.items()))}")
        surfaces.append((label, _limited_surface(system), spec))
    total = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
    rec.close()
    print(f"phase 12 (cuda, six cycles): stats_kernel launches {total[0]}, "
          f"bisect_kernel {total[1]}")
    if not (total[0] and total[1]):
        raise AssertionError(f"phase 12 launches {total}: a kernel of the path never ran")
    for label, surface, spec in surfaces:
        full = _limited_surface(_full_pass(None, spec, "cuda"))
        if surface != full:
            raise AssertionError(f"cycle {label}: differs from a full pass of its SystemSpec")
        steps = {}
        for e in surface[1].values():
            steps[e["step"]] = steps.get(e["step"], 0) + 1
        print(f"  cycle {label.strip()} ≡ an INCREMENTAL_CYCLE=0 full pass of the same "
              f"SystemSpec ({len(surface[0])} servers, allocations bit for bit"
              + (f"; degradations {dict(sorted(steps.items()))}" if steps else "") + ")")

    # backend torch on the card: cycles 1 and 3 decide alike
    reset_fleet_state()
    tcluster, _ = _reconcile_fleet(n, seed)
    trec = Reconciler(tcluster, fleet_fake_prom(rows0),
                      ReconcilerConfig(compute_backend="torch", keep_accelerator=False))
    for label, rows in (("1", rows0), ("3", rows1)):
        trec.prom = fleet_fake_prom(rows)
        cuda_queueing.LAUNCHES = cuda_queueing.BISECT_LAUNCHES = 0
        report, ms = _timed(trec.run_cycle)
        if cuda_queueing.LAUNCHES or cuda_queueing.BISECT_LAUNCHES:
            raise AssertionError("backend 'torch' launched a kernel")
        boundary = _same_records(records[label], report.decisions, f"cycle {label} cuda vs torch")
        print(f"  cycle {label}, backend torch: {ms:.1f} ms; decisions as backend cuda "
              f"({boundary} ±1 boundary variants)")
    trec.close()
    reset_fleet_state()


def _phase13():
    """13. the profile corrector's surrogate refit on the card."""
    import numpy as np
    import torch

    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
    from inferno_tpu_torch.models import corrector
    from inferno_tpu_torch.parallel import train

    print("13. profile corrector: surrogate refit on the card")
    # observed ITL bends mildly with batch and runs about 2.3x the CR
    # line (alpha 5, beta 0.1): out of band, with a positive linearization
    rng = np.random.default_rng(13)
    window = [(float(b), (8.0 + 0.4 * b + 0.02 * b * b) * float(rng.uniform(0.97, 1.03)))
              for b in rng.uniform(2.0, 16.0, size=32)]
    seen = []
    real = train.fit_surrogate

    def spy(*args, **kwargs):
        state, losses = real(*args, **kwargs)
        opt_state = next(iter(state.optimizer.state.values()))
        seen.append((next(state.model.parameters()).device.type,
                     opt_state["exp_avg"].device.type, losses[-1]))
        return state, losses

    out = {}
    train.fit_surrogate = spy
    try:
        for device in ("cuda", "cpu"):
            # both from the default initial weights (the reference's)
            c = corrector.ProfileCorrector(device=None if device == "cuda" else "cpu")
            for conc, itl in window:
                c.observe("v", corrector.Observation(
                    concurrency=conc, in_tokens=16, out_tokens=64, itl_ms=itl, ttft_ms=3.0))
            (dec, _, state), ms = _timed(lambda: c.corrected_parms(
                "v", DecodeParms(alpha=5.0, beta=0.1), PrefillParms(gamma=2.0, delta=0.01)))
            if not state.surrogate_used:
                raise AssertionError(f"{device}: the refit fell back to ratio scaling")
            out[device] = (dec, ms, seen[-1])
    finally:
        train.fit_surrogate = real
    (gd, gms, gseen), (cd, cms, cseen) = out["cuda"], out["cpu"]
    if gseen[:2] != ("cuda", "cuda"):
        raise AssertionError(f"the fit ran on {gseen[:2]}, not on the card")
    rel = max(abs(gd.alpha - cd.alpha) / abs(cd.alpha), abs(gd.beta - cd.beta) / abs(cd.beta))
    print(f"  surrogate_used; fit tensors on {gseen[0]} (AdamW state on {gseen[1]}); refit "
          f"DecodeParms cuda alpha {gd.alpha:.6g} beta {gd.beta:.6g}, cpu alpha {cd.alpha:.6g} "
          f"beta {cd.beta:.6g}: max rel {rel:.3g} (tolerance {REFIT_RTOL:g}); final loss "
          f"{gseen[2]:.6g} / {cseen[2]:.6g}")
    print(f"  refit time (80 AdamW steps + linearization): cuda {gms:.1f} ms, cpu {cms:.1f} ms")
    if rel > REFIT_RTOL:
        raise AssertionError(f"refit on the card differs from the CPU fit: {rel}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of phase 12's loads")
    args = parser.parse_args()
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
    for kind, k, sub, idx, width, _ in slots:
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

    # 6. timings of the full path: warm passes, loads perturbed before each,
    # backends in turns
    os.environ["INCREMENTAL_CYCLE"] = "0"
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
    del os.environ["INCREMENTAL_CYCLE"]

    # 8.-11. the incremental cycle, the event cycle, limited mode and spot
    _stamp("phases 1-7 done")
    _incremental_phases(smi)

    # 12. the reconcile loop; 13. the corrector's refit
    _stamp("phases 8-11 done")
    _phase12(args.seed, smi)
    _stamp("phase 12 done")
    _phase13()
    _stamp("phase 13 done")

    replaces = "inferno_tpu/ops/pallas_queueing.py:84"
    print(smi)  # again near the end: a reader of the output's tail sees the card
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
