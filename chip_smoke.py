#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`inferno_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA machine

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the stationary-solve kernel (ops/csrc/stats_kernel.cu)
   with nvcc into build/kernels/;
3. kernel against its plain torch version on the card: synthetic grids
   (P x K sweep, saturated rates, empty tails, caps and batches beyond the
   grid) and the grids of every bucket of the main path, 5e-3 relative
   (wait and serv on the response-time scale, as tests/test_pallas.py);
   and a 40-variant fleet through the kernel against the port's scalar
   f64 analyzer (System.calculate_all), the repo's parity oracle;
4. main path at full width: a 10,000-variant edge fleet (about 24k lanes)
   through calculate_fleet(backend="cuda") + solve_unlimited, with the
   kernel's launch count checked against 68 per aggregated bucket and
   106 per tandem bucket, and the decisions checked for sanity;
5. the same fleet on the plain torch version on the card: identical
   decisions (accelerator exactly, replicas under the ±1 boundary rule);
6. timings: cold and warm (median of 3, loads perturbed between passes)
   calculate_fleet + solve_unlimited for both backends, and per-launch
   device times of the kernel and its plain version at the main path's
   bucket shapes;
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
FLEET_KW = dict(
    shapes_per_variant=3, tandem_every=5, zero_load_every=7,
    pinned_every=11, infeasible_every=13,
)
LAUNCHES_PER_BUCKET = {"agg": 68, "tan": 106}


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


def _bound(P, K):
    nbytes = P * K * 4 + 4 * P * 4 + 4 * P * 4  # cml, 4 lane vectors in, out
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = P * K * OPS_PER_ELEMENT / PEAK_F32_OPS_PER_S * 1e3
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
    from inferno_tpu_torch.ops.queueing import _solve_stats
    from inferno_tpu_torch.parallel import build_fleet, build_tandem_fleet, reset_fleet_state
    from inferno_tpu_torch.ops.queueing import DEFAULT_BISECT_ITERS
    from inferno_tpu_torch.parallel.fleet import _solve_all, bucket_slots
    from inferno_tpu_torch.testing.fleet import (
        assert_same_decisions,
        fleet_system_spec,
        perturb_loads,
    )

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")

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

    # 3a. kernel against its plain version, synthetic cases
    cases = [(P, K, "mixed") for P in (1, 13, 30000) for K in (128, 512, 2048)]
    cases += [(4096, 512, "saturated"), (4096, 128, "empty_tail"), (4096, 128, "beyond_grid")]
    for i, (P, K, mode) in enumerate(cases):
        lam, grid = _synthetic_case(P, K, 100 + i, mode, dev)
        got = cuda_queueing.solve_stats(lam, grid)
        torch.cuda.synchronize()
        rel, ab = _stat_errors(_solve_stats(lam, grid), got)
        torch.cuda.synchronize()
        print(f"kernel vs plain: P={P} K={K} {mode}: max rel {rel:.3g}, max abs {ab:.3g}")
        if rel > TOL:
            raise AssertionError(f"kernel disagrees with plain version: {rel} > {TOL}")

    # 3b. a small fleet through the kernel against the port's scalar f64
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

    # 4. main path at full width, through the kernel
    spec = fleet_system_spec(10000, **FLEET_KW)
    reset_fleet_state()
    system = System(spec)
    cuda_queueing.LAUNCHES = 0
    lanes, cold_cuda = _size_fleet(system, "cuda")
    launches = cuda_queueing.LAUNCHES
    slots = bucket_slots(build_fleet(system), build_tandem_fleet(system))
    expected = sum(LAUNCHES_PER_BUCKET[s[0]] for s in slots)
    buckets = [(s[0], s[1], len(s[3]), s[4]) for s in slots]
    print(f"main path: {len(system.servers)} variants, {lanes} lanes, buckets "
          f"(kind, K, lanes, padded) {buckets}")
    print(f"main path: stats_kernel launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != expected {expected}")
    allocated = _check_decisions(system)
    print(f"main path: {allocated} servers allocated")

    # 4b. kernel against its plain version at the main path's shapes, and
    # per-launch device times there
    per_bucket = []
    max_abs = 0.0
    for kind, k, sub, idx, width in slots:
        lam, grid = _bucket_case(kind, k, sub, dev)
        got = cuda_queueing.solve_stats(lam, grid)
        rel, ab = _stat_errors(_solve_stats(lam, grid), got)
        if rel > TOL:
            raise AssertionError(f"{kind} K={k}: kernel vs plain {rel} > {TOL}")
        max_abs = max(max_abs, ab)
        # few enough calls that their launches fit the device's launch queue
        k_ms, k_enq = _device_ms(lambda: cuda_queueing.solve_stats(lam, grid), 100)
        p_ms, p_enq = _device_ms(lambda: _solve_stats(lam, grid), 5)
        b_ms, b_by = _bound(width, k)
        per_bucket.append(dict(kind=kind, K=k, P=width, ms=k_ms, plain_ms=p_ms,
                               bound_ms=b_ms, bound_by=b_by, rel=rel))
        print(f"bucket {kind} K={k} P={width}: kernel {k_ms * 1e3:.2f} us, plain "
              f"{p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}), max rel "
              f"{rel:.3g} (host enqueue of the timed runs: {k_enq:.1f} ms, "
              f"{p_enq:.1f} ms)")
    # the reported shape: the bucket with the most bytes (the largest cml)
    top = max(per_bucket, key=lambda b: b["P"] * b["K"])

    # 5. the same fleet on the plain version
    reset_fleet_state()
    plain = System(SystemSpec.from_dict(spec.to_dict()))  # loads of its own
    cuda_queueing.LAUNCHES = 0
    _, cold_torch = _size_fleet(plain, "torch")
    if cuda_queueing.LAUNCHES:
        raise AssertionError("backend 'torch' launched the kernel")
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
            _solve_all(plan, tandem, dev, DEFAULT_BISECT_ITERS, backend == "cuda")
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

    print(json.dumps({"kernels": [{
        "name": "stats_kernel",
        "route": "cuda",
        "source": "inferno_tpu_torch/ops/csrc/stats_kernel.cu",
        "replaces": "inferno_tpu/ops/pallas_queueing.py:84",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
