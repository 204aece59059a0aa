#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`inferno_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA machine

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the three kernels (ops/csrc/stats_kernel.cu, the
   stationary solve, ops/csrc/bisect_kernel.cu, the fused bisection, once
   per metric, and ops/csrc/plan_rows_kernel.cu, the planner's rows) with
   nvcc, one process per object, all at once, into one library in
   inferno_tpu_torch/ops/_build/;
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
   against their plain versions and their per-launch device times beside
   their bounds; for each of the 12 bisections its depth, launch shape
   (registers, spill, blocks an SM, waves), mean steps run, its time
   beside the fixed schedule (depth 1, no exit, every padded lane: the
   kernel's schedule before rounds and exits) taken in turns, its time
   at every depth, and its bound counted by each lane's steps to its
   fixed point (the 32-step bound beside it); and the fused
   bisection against the per-step composition on the stationary-solve
   kernel, which must agree in every bit of every lane (4c), with the 12
   launches' sum below the fixed schedule's;
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
   fits timed. The default corrector refits at dp = the visible cards
   (torch.cuda.device_count()), the CPU fit at the same dp. Then that
   window and a 37-observation one at dp 4, as on a host of four devices
   (the batch rounded down to a multiple of 4, as the reference's refit
   on four devices rounds it, and stepped on the one card): the batch
   size exactly, the step losses within 1e-4 relative and the DecodeParms
   within 1e-2 of the CPU's dp-4 refit, and the refit ms at dp 1 and dp 4
   printed.

14. the planner on the card: (a) a 168-step diurnal week (3600 s steps,
   seed 0) of the 10k edge fleet through calculate_fleet_batch(backend=
   "cuda"), cold: one counter window around it shows one full sizing of
   every bucket (4 + 2 launches per aggregated bucket, 10 + 2 per tandem
   bucket) and nothing per row; six evenly spaced timesteps bit-identical
   (choice, replicas, chips, cost, value) to an INCREMENTAL_CYCLE=0
   calculate_fleet(cuda) + solve_unlimited at that row's rates; the whole
   week on backend "torch" on the card equal under ROADMAP's ±1 boundary
   rule; the prep's and the per-row solve's host ms, and the device's busy
   time in a profiled cold prep; (b) a 200-seed flash-crowd Monte Carlo of
   a 10k one-shape fleet over 168 steps through replay_montecarlo(cuda),
   its rows on the card (plan_rows_kernel launches counted: one a chunk,
   and one more if the zero-load table was built): three kept members
   bit-identical to their serial replay on the numpy path of a prep of
   their own (`rows_on_card` False), their envelope inputs equal to
   aggregate_replay of that replay, and an 8-seed
   sub-ensemble at chunk_steps=7 identical to the default chunking, and
   with mesh=fleet_mesh(devices=["cuda:0"] * 4) identical to unsharded,
   its prep launching each kernel exactly 4x the unsharded prep's; (c)
   storm replays of a 200-variant fleet (48 steps of 600 s, the canonical
   spot tier): pre-positioning strictly cuts violation-seconds at a cost
   overhead of at most 10%, and the cuda and torch reports (single storm
   and a 50-seed ensemble) are equal, or differ only through ±1 boundary
   cells of the placements; (d) plan_rows_kernel at the flash-crowd
   cell's chunk shape (155 rows of a 10k two-shape fleet, zero-load
   servers among them): every slab output, the accumulator's bucket
   demand and its cost sums bit for bit against the numpy path of the same
   prep, one launch a chunk; the launch's device time (the cost and the
   demand, as the Monte Carlo planner asks) beside its byte bound, and
   the whole chunk on both paths on the host clock;
15. the flight recorder: the port's Reconciler (backend auto, cuda) over
   phase 12's 5,000-variant cluster records three cycles (cold, 1% λ,
   limited at 80%) into a temporary directory; read_artifact loads all
   three with no warnings and nothing dropped; replay_cycle_parity(cuda)
   matches every cycle (all variants compared, the limited cycle's
   capacity_limited ones skipped and counted); `planner --trace` reports
   coverage 1.0 and every sampled parity matching; `obs.report` exits 0.
16. the fleet twin with its step cost on the card: (a) the reference's
   twin bench configuration (1,000 engines of the default EngineProfile,
   ramp_burst at 800 req/s for 92 s, seed 0, barriers every 2,000 ms)
   through TwinPlant on its default backend (torch, device None = the
   card), one cold and three warm passes, in turns with the numpy plant,
   after the step cost alone on seeded random profiles against numpy:
   results bit-identical to the numpy plant and to the serial oracle
   (scalar engines, sync-stepped), step-cost evaluations on the card
   equal to rounds (none on numpy); the warm medians, the oracle's time,
   the speedup over it (printed, not gated) and the device's busy time in
   one profiled torch pass; (b) the twin CLI's headline (`--policies
   reactive,predictive --engines 1000`) on the card, its JSON report equal
   to the same CLI's on `--backend numpy`; (c) `--engines 200 --kills
   30:10,45:6`, and `--replay` of phase 15's artifact (its first variant,
   64 engines), each equal between the two backends;
17. one closed emulated loop: an EmulatedEngine under 40 req/s, scraped by
   MiniProm, reconciled by the port's Reconciler on backend cuda with
   direct scaling: the loaded cycle scales the deployment out, the idle
   cycle back to 1, with stats_kernel launched in the loop.
18. the transformer profiling blocks at full width, random weights from a
   seed: (a) Llama-3.1-8B and Gemma-2-9B at depth 2 (one sliding and one
   global Gemma layer), B=4, context 256: four decode and four mixed
   steps replayed from a CUDA graph bit-identical to eager; one bf16 step
   within 5% (relative L2 of x and of the cache slot written) of the same
   weights in float32 on the card, and a mixed step's decode rows within
   2.5% of a pure decode step; (b) a reduced Llama-3.1-8B sweep through
   tools/profile_gpu's own functions (depths 2/4/8; decode B 1/16/64/128
   at context 1,024; mixed B 1/16/48 x T 128/512; prefill B=1 x T
   128/512), fitted by models/profiles.build_profile_json: α, β, γ, δ,
   maxBatchSize and the layer-linearity r2 (decode above 0.95), each
   decode point's share of its byte bound, one full-depth (32-layer)
   point against the depth line's extrapolation, the peak device memory;
   (c) one int8 decode point (L=2, B=16, eager dequant) beside bf16.
19. the controller over real sockets on backend cuda, every MiniProm
   scraped by hand: (a) the port's MiniApiServer behind RestKubeClient,
   an emulated engine over HTTP (2 s of closed-loop load), the port's
   Reconciler with direct_scale false publishing gauges on its
   MetricsServer, MiniProm scraping /metrics, ExternalMetricsAdapter and
   HpaEmulator enacting them through /scale: the loaded cycle launches
   both kernels (counted against the buckets it dispatched) and the HPA
   scales 1 -> N, the idle cycle and the HPA bring it back to 1; (b) the
   disaggregated loop (a prefill/decode emulated engine, JetStream
   vocabulary, a LeaderWorkerSet of 3-slice groups): the loaded cycle's
   tandem bucket launches the tandem plan's kernels (10 stats_kernel, 2
   bisect_kernel) and the groups scale out atomically, then back to one;
   (c) a 200-variant fleet_cluster collected from fleet_targets over
   MiniProm HTTP (seven arrival rates): at most 10 Prometheus queries a
   cycle, and the decisions on cuda equal one cycle on backend torch on
   the CPU under ROADMAP's ±1 rule; host ms a cycle and its spans printed;
20. backend native (the port's C++ solver, built with g++ from
   inferno_tpu_torch/native/queueing.cc; a failed build fails the phase)
   beside backend cuda on phase 4's 10k edge fleet: lane by lane equal
   feasibility, replicas within ±1, rate_star and itl within 5e-3
   relative; the solve's host ms (plans to results) and a cold full
   calculate_fleet + solve_unlimited pass of each, with the card's name
   and power limit and os.cpu_count().
21. the sharded programs: (a) phase 4's 10k edge fleet on backend cuda
   with `fleet_mesh(devices=["cuda:0"] * 4)` (the lanes split, the four
   shards run in turn on the one card) and with `fleet_mesh()` (every
   visible card), on the full path (INCREMENTAL_CYCLE=0) and the
   incremental path (cold, then 1% of arrival rates moved): 0 lanes
   differing in any bit from the unsharded solve and identical
   decisions, else it raises; the launches of both kernels per shard
   (the unsharded pass's, times the shards); warm full passes, sharded
   and unsharded; (b) the public entries parallel.solve_fleet and
   solve_tandem_fleet (backend cuda) on the plans of a cold full pass:
   0 lanes differing in any bit from what calculate_fleet(cuda) solved
   for them, with the main path's launches for buckets of their kind
   (4 + 2 an aggregated bucket, 10 + 2 a tandem one), and with the
   4-shard mesh the same bits at exactly 4x the launches; (c) six rows
   of the diurnal week through calculate_fleet_batch with the 4-shard
   mesh equal to the unsharded prep; (d) graft_entry.entry() on the card
   (4 + 2 launches) against the plain version under the ±1 rule; (e)
   graft_entry.dryrun_multichip(device_count) on NCCL ranks, whose (1, 1)
   training steps equal the one-device steps bit for bit on one card.
22. the installed copy on the card: a wheel of the tree (built offline
   with `pip wheel --no-deps --no-build-isolation`) installed with `pip
   install --target` into a temporary directory; a subprocess whose
   PYTHONPATH holds only that directory (the checkout off sys.path) builds
   the kernel library with nvcc inside the installed package
   (`inferno_tpu_torch/ops/_build/`, build seconds printed beside the
   card's name and power limit) and sizes phase 4's 10k edge fleet on
   backend cuda (INCREMENTAL_CYCLE=0); 0 of its 24,156 lanes differ in any
   bit from the checkout's pass, the decisions are identical, and both
   launch the main path's 42 + 12, else it raises.
23. the port as it ships: Dockerfile.torch's build command (the
   prebuild of both libraries, then the wheel) run as it stands on a copy
   of the port's files with no card visible; the wheel installed with `pip
   install --no-deps --target`, its tree snapshotted (path, size, sha256)
   and made read-only; `python -m inferno_tpu_torch.controller.main` run
   from it in a fresh process (PYTHONPATH the target alone, no CUDA
   directory on PATH) under the H100 overlay's manager env, against a
   `fleet_cluster` of P23_VARIANTS variants in a MiniApiServer behind TLS
   (an openssl cert for IP:127.0.0.1, reached through
   KUBERNETES_SERVICE_HOST/PORT and SSL_CERT_FILE) and MiniProm over HTTP
   at phase 19c's seven rates; three cycles, counted on its /debug/profile
   (a ConfigMap edit wakes the loop after each), /healthz and /readyz
   answering, SIGTERM and exit 0 within 30 s. It raises unless the process
   built nothing (BUILD_LOG empty), loaded the shipped kernel library from
   the target, imported the package from there, launched both kernels and
   left the installed tree unchanged, and unless every VA's status in the
   API server equals the process's last decisions, which equal those of
   the checkout's Reconciler in process under the same env (ROADMAP's ±1
   rule). Printed: the build and install seconds, the shipped libraries,
   the time to the first status write, each cycle's spans and Prometheus
   queries, the process's RSS and device memory, the launches.

The card's name and power limit (nvidia-smi) are printed first and again
before the kernels line.

It prints a JSON line describing each kernel (the sizing kernels'
`launches`, times and errors are phase 4's main-path pass, phase 12
printing its own window's launches; plan_rows_kernel's launches are
phase 14(b)'s 200-seed ensemble, its times and errors phase 14(d)'s
chunk), then, as its last line,
{"ok": true, "device": {...}}. It exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repo. `--seed` seeds
phase 12's loads (default 0).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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


def _bisect_bound(case, needed, real):
    """The least time for one bisection: the rows (two for tandem ITL) and
    per-lane inputs of its `real` lanes read once (the pad lanes past them
    copy lane 0), every lane's outputs written once; and, on the real
    lanes, each lane's steps to its fixed point (`needed`, from
    `_bisect_steps_needed` on the plain version: what this run's data
    needs), one stationary solve a row a step, OPS_PER_ELEMENT f32
    operations an element each."""
    rows = 2 if case.gd is not None else 1
    P, K = case.gp.cml.shape
    c = case.consts.shape[0]
    nbytes = real * (rows * K * 4 + 4 * (5 + c + 3 * rows)) + P * 5
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    steps = int(needed[:real].sum())
    t_ops = steps * rows * K * OPS_PER_ELEMENT / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bisect_bound_all_steps(case, n_iters):
    """The bound as counted before the early exit: n_iters steps on every
    lane, pad lanes included (printed beside `_bisect_bound`)."""
    rows = 2 if case.gd is not None else 1
    P, K = case.gp.cml.shape
    c = case.consts.shape[0]
    nbytes = rows * P * K * 4 + P * 4 * (5 + c + 3 * rows) + P * 5
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_iters * rows * P * K * OPS_PER_ELEMENT / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bisect_launch(kind, k, width, real, case, n_iters, tally):
    """One bisection of the main path at its bucket's shape (`width` lanes,
    the first `real` of them real): the kernel on the main path's schedule
    (the depth `bisect` picks, the early exit, the real lanes) against its
    plain version (into `tally`) and, bit for bit, against the per-step
    composition on stats_kernel, as the fixed schedule is too (depth 1, no
    exit, every padded lane); the launch shapes; the steps it ran; its
    device time beside the fixed schedule's, in turns, and at every depth; its
    bounds. Returns the launch's record."""
    import torch

    from inferno_tpu_torch.ops import cuda_queueing as cq
    from inferno_tpu_torch.ops import queueing as q

    dev = case.lam_min.device
    depth = cq.bisect_depth(case.metric, k, real, dev)
    steps = torch.empty(width, dtype=torch.int32, device=dev)
    got = cq.bisect(case, n_iters, real_lanes=real, steps_out=steps)
    off = tally.add(q._bisect_plain(case, n_iters), got)
    ref = q._bisect_plain(case, n_iters, solve=cq.solve_stats)

    def differ(out):
        lam, ok = out
        return int(((lam.view(torch.int32) != ref[0].view(torch.int32)) | (ok != ref[1])).sum())

    bit_diff = differ(got)
    if differ(cq.bisect(case, n_iters, depth=1, early_exit=False)):
        raise AssertionError("the fixed schedule differs from the per-step composition")
    needed = q._bisect_steps_needed(case, n_iters)
    b_ms, b_by = _bisect_bound(case, needed, real)
    b_all_ms, b_all_by = _bisect_bound_all_steps(case, n_iters)
    shapes = [cq.bisect_shape(case.metric, k, d, dev)
              for d in range(1, cq.BISECT_MAX_DEPTH + 1)]
    shape, shape1 = shapes[depth - 1], shapes[0]

    def new():
        return cq.bisect(case, n_iters, real_lanes=real)

    def old():
        return cq.bisect(case, n_iters, depth=1, early_exit=False)

    turns = [_device_ms(fn, 20)[0] for fn in (old, new, new, old)]
    new_ms, old_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    by_depth = {
        d: _device_ms(lambda: cq.bisect(case, n_iters, real_lanes=real, depth=d), 20)[0]
        for d in range(1, cq.BISECT_MAX_DEPTH + 1)
    }
    s_ms = _profiled_device_ms(
        lambda: q._bisect_plain(case, n_iters, solve=cq.solve_stats), 3)
    pl_ms = _profiled_device_ms(lambda: q._bisect_plain(case, n_iters), 3)
    ran = float(steps[:real].float().mean())
    need = float(needed[:real].float().mean())
    print(f"bucket {kind} K={k} P={width} ({real} real) {METRIC_NAMES[case.metric]}: "
          f"depth {depth} ({shape.threads} threads a block, "
          f"{shape.lanes_per_block if shape.cluster == 1 else f'a cluster of {shape.cluster}'}"
          f"{' lanes a block' if shape.cluster == 1 else ' blocks a lane'}, {shape.registers} "
          f"registers, {shape.spill_bytes} bytes of spill, {shape.blocks_per_sm} blocks an SM, "
          f"{cq.waves(real, shape.resident_lanes)} wave(s); lanes resident at depths 1-4: "
          f"{'/'.join(str(s.resident_lanes) for s in shapes)}); the fixed schedule: depth 1, "
          f"{shape1.registers} registers, {cq.waves(width, shape1.resident_lanes)} wave(s) of "
          f"{width} lanes; steps run {ran:.2f} a lane (to the fixed points {need:.2f}); "
          f"bisect_kernel {new_ms * 1e3:.2f} us, the fixed schedule {old_ms * 1e3:.2f} us (in "
          f"turns: {', '.join(f'{t * 1e3:.2f}' for t in turns)}); by depth "
          f"{', '.join(f'{d}: {t * 1e3:.2f}' for d, t in by_depth.items())} us; per-step "
          f"composition on stats_kernel {s_ms * 1e3:.2f} us, plain {pl_ms * 1e3:.2f} us "
          f"(device time); bound {b_ms * 1e3:.2f} us ({b_by}; all 32 steps on every lane: "
          f"{b_all_ms * 1e3:.2f} us, {b_all_by}); {off} lanes outside {LAM_RTOL:g}, "
          f"{bit_diff} lanes differ in a bit from the per-step composition")
    return dict(kind=kind, K=k, P=width, real=real, metric=case.metric, depth=depth,
                ms=new_ms, old_ms=old_ms, by_depth=by_depth, steps_ms=s_ms, plain_ms=pl_ms,
                bound_ms=b_ms, bound_by=b_by, bound_all_ms=b_all_ms, bit_diff=bit_diff)


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
# phase 13: the corrector's refit on the card against the CPU, at the
# default dp and at REFIT_DP (the batch rounded as on REFIT_DP devices)
REFIT_RTOL = 1e-2
REFIT_DP = 4
REFIT_LOSS_RTOL = 1e-4


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
              f"{c.get('skipped_servers', 0)}, dispatches {c.get('dispatches', 0)}, "
              f"dispatch_ms {c.get('dispatch_ms', 0.0):.1f}, kernel_library_loads "
              f"{c.get('kernel_library_loads', 0)}, solve_replayed_servers "
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


def _refit_window(seed, n):
    """Observed ITL that bends mildly with batch and runs about 2.3x the
    CR line (alpha 5, beta 0.1): out of band, with a positive
    linearization."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(float(b), (8.0 + 0.4 * b + 0.02 * b * b) * float(rng.uniform(0.97, 1.03)))
            for b in rng.uniform(2.0, 16.0, size=n)]


def _refit(window, **placement):
    """One corrector refit of `window` (`ProfileCorrector(**placement)`,
    from the default initial weights, the reference's). Returns the
    corrected DecodeParms, the refit's host ms and what the fit saw: its
    batch size, its step losses and where its tensors and AdamW state
    lay."""
    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
    from inferno_tpu_torch.models import corrector
    from inferno_tpu_torch.parallel import train

    seen = []
    real = train.fit_surrogate

    def spy(x, y, *args, **kwargs):
        state, losses = real(x, y, *args, **kwargs)
        opt_state = next(iter(state.optimizer.state.values()))
        seen.append({"batch_size": kwargs["batch_size"], "losses": losses,
                     "params": next(state.model.parameters()).device.type,
                     "adamw": opt_state["exp_avg"].device.type})
        return state, losses

    c = corrector.ProfileCorrector(**placement)
    for conc, itl in window:
        c.observe("v", corrector.Observation(
            concurrency=conc, in_tokens=16, out_tokens=64, itl_ms=itl, ttft_ms=3.0))
    train.fit_surrogate = spy
    try:
        (dec, _, state), ms = _timed(lambda: c.corrected_parms(
            "v", DecodeParms(alpha=5.0, beta=0.1), PrefillParms(gamma=2.0, delta=0.01)))
    finally:
        train.fit_surrogate = real
    if not state.surrogate_used or not seen:
        raise AssertionError(f"{placement}: the refit fell back to ratio scaling "
                             f"({c.refit_errors} refit errors)")
    return dec, ms, seen[-1]


def _rel_parms(a, b):
    return max(abs(a.alpha - b.alpha) / abs(b.alpha), abs(a.beta - b.beta) / abs(b.beta))


def _phase13():
    """13. the profile corrector's surrogate refit on the card: the
    default corrector (dp = the visible cards) against the CPU at that dp,
    then dp 4 on the card against the CPU's dp-4 refit."""
    import numpy as np
    import torch

    from inferno_tpu_torch.models import corrector
    from inferno_tpu_torch.parallel.train import dp_batch_size

    print("13. profile corrector: surrogate refit on the card")
    window = _refit_window(13, 32)
    cards = torch.cuda.device_count()
    default_dp = corrector.ProfileCorrector().refit_dp()
    if default_dp != cards:
        raise AssertionError(f"the default refit's dp is {default_dp}, not the {cards} "
                             f"visible cards")
    gd, gms, gseen = _refit(window)
    cd, cms, cseen = _refit(window, device="cpu", dp=cards)
    if (gseen["params"], gseen["adamw"]) != ("cuda", "cuda"):
        raise AssertionError(f"the fit ran on {gseen['params']}/{gseen['adamw']}, not the card")
    rel = _rel_parms(gd, cd)
    print(f"  surrogate_used; default dp {default_dp} = {cards} visible cards (batch "
          f"{gseen['batch_size']}); fit tensors on {gseen['params']} (AdamW state on "
          f"{gseen['adamw']}); refit DecodeParms cuda alpha {gd.alpha:.6g} beta {gd.beta:.6g}, "
          f"cpu alpha {cd.alpha:.6g} beta {cd.beta:.6g}: max rel {rel:.3g} (tolerance "
          f"{REFIT_RTOL:g}); final loss {gseen['losses'][-1]:.6g} / {cseen['losses'][-1]:.6g}")
    print(f"  refit time (80 AdamW steps + linearization): cuda {gms:.1f} ms, cpu {cms:.1f} ms")
    if rel > REFIT_RTOL:
        raise AssertionError(f"refit on the card differs from the CPU fit: {rel}")

    # dp 4, as the reference's refit on four local devices: the batch
    # rounds down to a multiple of 4, and the one card steps on it
    for n in (32, 37):
        win = window if n == 32 else _refit_window(37, 37)
        rounded = dp_batch_size(256, n, REFIT_DP)
        d1, ms1, seen1 = _refit(win, device="cuda:0")
        d4, ms4, seen4 = _refit(win, device="cuda:0", dp=REFIT_DP)
        dc, _, seenc = _refit(win, device="cpu", dp=REFIT_DP)
        batches = (seen1["batch_size"], seen4["batch_size"], seenc["batch_size"])
        if batches != (min(n, 256), rounded, rounded):
            raise AssertionError(f"window {n}: batches {batches} at dp 1, {REFIT_DP} (card) "
                                 f"and {REFIT_DP} (cpu), not {min(n, 256)}, {rounded}")
        loss_rel = float(np.max(np.abs(np.subtract(seen4["losses"], seenc["losses"]))
                                / np.abs(seenc["losses"])))
        parms_rel = _rel_parms(d4, dc)
        print(f"  window {n}: dp {REFIT_DP} on the card (batch {rounded}) vs the CPU's dp "
              f"{REFIT_DP}: step losses max rel {loss_rel:.3g} (tolerance {REFIT_LOSS_RTOL:g}); "
              f"alpha {d4.alpha:.6g} beta {d4.beta:.6g} vs alpha {dc.alpha:.6g} beta "
              f"{dc.beta:.6g}: max rel {parms_rel:.3g} (tolerance {REFIT_RTOL:g}); dp 1 alpha "
              f"{d1.alpha:.6g} beta {d1.beta:.6g} (batch {seen1['batch_size']})")
        print(f"  window {n}: refit ms (80 AdamW steps + linearization): dp 1 {ms1:.1f} ms, "
              f"dp {REFIT_DP} {ms4:.1f} ms")
        if loss_rel > REFIT_LOSS_RTOL:
            raise AssertionError(f"window {n}: dp-{REFIT_DP} steps on the card differ from "
                                 f"the CPU's: {loss_rel}")
        if parms_rel > REFIT_RTOL:
            raise AssertionError(f"window {n}: dp-{REFIT_DP} refit on the card differs from "
                                 f"the CPU's: {parms_rel}")


# phase 14: the planner on the card. (a) the reference's planner bench
# (bench.py:2115) on the 10k edge fleet; (b) its Monte Carlo bench
# (bench.py:2251); (c) its storm bench (bench.py:761); (d) the planner's
# row kernel at the flash-crowd cell's chunk: 2,000,000 // 12,858 lanes
PLANNER_VARIANTS = 10000
PLANNER_STEPS = 168
PLANNER_PARITY_STEPS = 6
MC_VARIANTS = 10000
MC_SEEDS = 200
MC_KEEP = (0, 99, 199)
MC_SUB_SEEDS = 8
MC_SUB_CHUNK = 7
MC_SUB_SHARDS = 4
PLAN_ROWS = 155
STORM_VARIANTS = 200
STORM_STEPS = 48
STORM_STEP_S = 600.0
STORM_SEEDS = 50
# phase 15: the recorded reconcile cycles (phase 12's cluster)
RECORD_VARIANTS = RECONCILE_VARIANTS


class _PrepClock:
    """Host ms of a batched solve's two halves, each ending in a
    synchronize: the prep (`FleetBatchPrep.__init__`: snapshot, plans and
    the grid solve on the card) and the per-row solve (`FleetBatchPrep.
    solve`: host numpy over [rows, lanes] slabs). Keeps the last prep."""

    def __init__(self):
        from inferno_tpu_torch.parallel import fleet

        self.cls = fleet.FleetBatchPrep
        self.ms = {}
        self.prep = None

    def __enter__(self):
        self.real = (self.cls.__init__, self.cls.solve)
        real_init, real_solve = self.real

        def init(prep, *args, **kwargs):
            t0 = time.perf_counter()
            real_init(prep, *args, **kwargs)
            _sync()
            self.ms["prep"] = self.ms.get("prep", 0.0) + (time.perf_counter() - t0) * 1e3
            self.prep = prep

        def solve(prep, *args, **kwargs):
            t0 = time.perf_counter()
            out = real_solve(prep, *args, **kwargs)
            self.ms["rows"] = self.ms.get("rows", 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        self.cls.__init__, self.cls.solve = init, solve
        return self

    def __exit__(self, *exc):
        self.cls.__init__, self.cls.solve = self.real


def _phase14a(smi):
    """14(a). a diurnal week of the 10k edge fleet through calculate_fleet_batch."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import (
        calculate_fleet,
        calculate_fleet_batch,
        prepare_fleet_batch,
        reset_fleet_state,
    )
    from inferno_tpu_torch.planner.scenarios import base_rates_from_system, diurnal
    from inferno_tpu_torch.solver import solve_unlimited
    from inferno_tpu_torch.testing.fleet import assert_same_batch, fleet_system_spec

    n, steps = PLANNER_VARIANTS, PLANNER_STEPS
    print(f"14. planner on the card, {smi}")
    print(f"14(a). diurnal week: {n}-variant edge fleet, {steps} steps of 3600 s, seed 0, "
          "calculate_fleet_batch(backend='cuda'), cold")
    system = System(fleet_system_spec(n, **FLEET_KW))
    trace = diurnal(base_rates_from_system(system), steps, 3600.0, seed=0)
    reset_fleet_state()
    # one counter window around the cold week
    cuda_queueing.LAUNCHES = 0
    cuda_queueing.BISECT_LAUNCHES = 0
    with _SlotSpy() as spy, _PrepClock() as clock:
        res, week_ms = _timed(lambda: calculate_fleet_batch(system, trace.rates, backend="cuda"))
    counts = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
    plan = spy.plan()
    print(f"  prep dispatch (kind, K, lanes, padded, program) {plan}")
    print(f"  launches over the cold week: stats_kernel {counts[0]}, bisect_kernel {counts[1]}; "
          f"one full sizing of its {len(plan)} buckets makes {spy.expected()[0]} and "
          f"{spy.expected()[1]}")
    buckets = [(p[0], p[1]) for p in plan]
    if (counts != spy.expected() or {p[4] for p in plan} != {"full"}
            or len(set(buckets)) != len(buckets)):
        raise AssertionError(f"14(a): launches {counts} are not one full sizing of "
                             f"every bucket")
    prep = clock.prep
    print(f"  week {week_ms:.1f} ms = prep {clock.ms['prep']:.1f} ms (snapshot, plans, grid "
          f"solve on the card) + per-row solve {clock.ms['rows']:.1f} ms ({steps} rows x "
          f"{prep.n_lanes} feasible lanes, host numpy; {clock.ms['rows'] / steps:.2f} ms a "
          f"row)")

    # sampled timesteps against the live path on a fresh System
    picks = sorted({int(t) for t in np.linspace(0, steps - 1, PLANNER_PARITY_STEPS)})
    acc_idx = {a: i for i, a in enumerate(res.accelerators)}
    live = System(fleet_system_spec(n, **FLEET_KW))
    os.environ["INCREMENTAL_CYCLE"] = "0"
    try:
        for t in picks:
            for j, server in enumerate(live.servers.values()):
                if server.load is not None:
                    server.load.arrival_rate = float(trace.rates[t, j])
            _, ms = _timed(lambda: (calculate_fleet(live, backend="cuda"),
                                    solve_unlimited(live)))
            bad = 0
            for j, server in enumerate(live.servers.values()):
                a = server.allocation
                if a is None or not a.accelerator:
                    want = (-1, 0, 0, 0.0, 0.0)
                else:
                    model = live.models[server.model_name]
                    want = (acc_idx[a.accelerator], a.num_replicas,
                            a.num_replicas * model.slices_per_replica(a.accelerator)
                            * live.accelerators[a.accelerator].chips, a.cost, a.value)
                got = (int(res.choice[t, j]), int(res.replicas[t, j]), int(res.chips[t, j]),
                       float(res.cost[t, j]), float(res.value[t, j]))
                bad += got != want
            print(f"  timestep {t}: {bad} of {n} servers differ from an INCREMENTAL_CYCLE=0 "
                  f"calculate_fleet(cuda) + solve_unlimited ({ms:.1f} ms)")
            if bad:
                raise AssertionError(f"14(a): timestep {t} differs from the live path")
    finally:
        del os.environ["INCREMENTAL_CYCLE"]

    # the whole week on the plain versions on the card
    reset_fleet_state()
    with _PrepClock() as tclock:
        tres, tms = _timed(lambda: calculate_fleet_batch(system, trace.rates, backend="torch"))
    boundary = assert_same_batch(prep, res, tclock.prep, tres)
    print(f"  backend torch on the card: week {tms:.1f} ms (prep {tclock.ms['prep']:.1f}); "
          f"{boundary} ±1 boundary cells of {res.replicas.size}, all else identical")

    # the device's busy time in one cold prep
    reset_fleet_state()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, pms = _timed(lambda: prepare_fleet_batch(system, backend="cuda"))
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    print(f"  profiled cold prep: {pms:.1f} ms on the host clock, device busy {busy:.2f} ms "
          f"({100.0 * busy / pms:.2f}%)")
    reset_fleet_state()


def _phase14b():
    """14(b). the Monte Carlo ensemble of the reference's bench."""
    import numpy as np

    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import fleet_mesh, prepare_fleet_batch, reset_fleet_state
    from inferno_tpu_torch.parallel.fleet import _batch_chunk_steps
    from inferno_tpu_torch.planner.montecarlo import replay_montecarlo
    from inferno_tpu_torch.planner.replay import aggregate_replay
    from inferno_tpu_torch.planner.scenarios import (
        GENERATORS,
        base_rates_from_system,
        ensemble_seeds,
    )
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    n, steps, seeds = MC_VARIANTS, PLANNER_STEPS, MC_SEEDS
    print(f"14(b). Monte Carlo: {n} variants (shapes_per_variant=1), flash_crowd, {steps} "
          f"steps, {seeds} seeds, replay_montecarlo(backend='cuda')")
    reset_fleet_state()
    system = System(fleet_system_spec(n, shapes_per_variant=1))
    keep = tuple(k for k in MC_KEEP if k < seeds)
    cuda_queueing.PLAN_ROWS_LAUNCHES = 0
    mc, ms = _timed(lambda: replay_montecarlo(
        system, "flash_crowd", steps, 3600.0, seeds=seeds, backend="cuda",
        per_seed=True, keep_seeds=keep))
    plan_launches = cuda_queueing.PLAN_ROWS_LAUNCHES
    prof = mc["profile"]
    print(f"  ensemble {ms:.1f} ms, {1e3 * seeds / ms:.1f} seeds/s; profile (ms) "
          + ", ".join(f"{k} {v}" for k, v in prof.items() if isinstance(v, (int, float))))
    # the serial witness: the numpy rows of a prep of its own, so the card's
    # rows are held to a result the kernel took no part in
    witness = prepare_fleet_batch(system, backend="cuda")
    if not witness.rows_on_card:
        raise AssertionError("14(b): a cuda prep without a spot tier keeps its rows on the host")
    witness.rows_on_card = False
    chunks = seeds * -(-steps // _batch_chunk_steps(None, witness.n_lanes))
    print(f"  plan_rows_kernel launches {plan_launches}: {chunks} chunks, binding rows "
          f"{mc['binding_rows']}")
    # one launch a chunk, one more if a slab met the zero-load table before
    # it was built, and one a binding flush
    if not chunks <= plan_launches <= (chunks + 1 if not mc["binding_rows"] else math.inf):
        raise AssertionError(f"14(b): plan_rows_kernel launched {plan_launches} times for "
                             f"{chunks} chunks")
    base = base_rates_from_system(system)
    members = ensemble_seeds("flash_crowd", 0, seeds)
    for k in keep:
        trace = GENERATORS["flash_crowd"](base, steps, 3600.0, seed=members[k])
        res = witness.solve(trace.rates)
        if not (np.array_equal(mc["_kept"][k]["choice"], res.choice)
                and np.array_equal(mc["_kept"][k]["replicas"], res.replicas)):
            raise AssertionError(f"14(b): member {k} differs from its serial replay")
        serial = aggregate_replay(system, res, 3600.0, False)
        for pool, stats in serial["pools"].items():
            got = mc["pools"][pool]["per_seed"]
            for key in ("peak", "p95", "mean"):
                if got[key][k] != stats[key]:
                    raise AssertionError(f"14(b): member {k} pool {pool} {key}")
        if (mc["per_seed"]["violation_seconds"][k] != serial["violation_seconds"]
                or mc["per_seed"]["cost_total_usd"][k] != serial["cost"]["total_usd"]):
            raise AssertionError(f"14(b): member {k} violation-seconds or cost")
        print(f"  member {k} (seed {members[k]}): choice and replicas bit-identical to its "
              f"serial replay on the numpy rows; envelope inputs equal to aggregate_replay "
              f"(total ${serial['cost']['total_usd']:.2f})")
    sub, launches = {}, {}
    mesh = fleet_mesh(devices=["cuda:0"] * MC_SUB_SHARDS)
    for label, chunk, m in (("default", None, None), ("chunked", MC_SUB_CHUNK, None),
                            ("sharded", None, mesh)):
        reset_fleet_state()
        cuda_queueing.LAUNCHES = 0
        cuda_queueing.BISECT_LAUNCHES = 0
        doc = replay_montecarlo(system, "flash_crowd", steps, 3600.0, seeds=MC_SUB_SEEDS,
                                backend="cuda", per_seed=True, chunk_steps=chunk, mesh=m)
        launches[label] = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
        doc.pop("profile")
        sub[label] = doc
    if sub["default"] != sub["chunked"]:
        raise AssertionError("14(b): chunk_steps changed the ensemble's report")
    print(f"  {MC_SUB_SEEDS}-seed sub-ensemble at chunk_steps={MC_SUB_CHUNK} identical to the "
          "default chunking")
    base = launches["default"]
    print(f"  {MC_SUB_SEEDS}-seed sub-ensemble with mesh= {MC_SUB_SHARDS} shards on cuda:0: "
          f"report {'identical to' if sub['sharded'] == sub['default'] else 'DIFFERS from'} "
          f"the unsharded one; prep launches stats_kernel {launches['sharded'][0]}, "
          f"bisect_kernel {launches['sharded'][1]} (unsharded {base[0]}, {base[1]})")
    if sub["sharded"] != sub["default"]:
        raise AssertionError("14(b): replay_montecarlo(mesh=) changed the ensemble's report")
    if launches["sharded"] != (base[0] * MC_SUB_SHARDS, base[1] * MC_SUB_SHARDS) or not all(base):
        raise AssertionError(f"14(b): the sharded prep launched {launches['sharded']}, expected "
                             f"{MC_SUB_SHARDS} x {base}")
    reset_fleet_state()
    return plan_launches


def _phase14d(smi):
    """14(d). plan_rows_kernel against the numpy path of the same prep at
    the flash-crowd cell's chunk shape; its time beside its bound. Returns
    the kernel's record for the kernels line."""
    import numpy as np
    import torch

    from inferno_tpu_torch.config.defaults import ACCEL_PENALTY_FACTOR
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import prepare_fleet_batch, reset_fleet_state
    from inferno_tpu_torch.parallel.fleet import BATCH_OUTPUTS
    from inferno_tpu_torch.planner.montecarlo import _EnvelopeAccumulator
    from inferno_tpu_torch.planner.scenarios import GENERATORS, base_rates_from_system
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    reset_fleet_state()
    system = System(fleet_system_spec(MC_VARIANTS, shapes_per_variant=2))
    prep = prepare_fleet_batch(system, backend="cuda")
    rates = GENERATORS["flash_crowd"](base_rates_from_system(system), PLAN_ROWS, 3600.0,
                                      seed=1).rates
    zero_cells = int((rates == 0).sum())
    print(f"14(d). plan_rows_kernel: {PLAN_ROWS} rows x {prep.n_servers} variants, "
          f"{prep.n_lanes} lanes, {zero_cells} zero-rate cells")
    if prep.all_seg1 or not zero_cells:
        raise AssertionError("14(d): the slab has no multi-lane segment or no zero-rate cell")

    # an accumulator for each path (each picks its demand path when made)
    accs = {}
    for on_card in (False, True):
        prep.rows_on_card = on_card
        accs[on_card] = _EnvelopeAccumulator(prep, system, PLAN_ROWS, chunk_steps=PLAN_ROWS)

    def chunk(on_card, keep=None):
        """One chunk through the accumulator, as replay_montecarlo feeds it:
        (its demand, cost sums and binding rows); `keep` gets a copy of
        every slab output."""
        prep.rows_on_card = on_card
        acc = accs[on_card]

        def consume(slab):
            if keep is not None:
                keep.update((f, getattr(slab, f).copy()) for f in BATCH_OUTPUTS)
            acc.feed(slab)

        prep.solve(rates, chunk_steps=PLAN_ROWS, consume=consume,
                   needs=BATCH_OUTPUTS if keep is not None else acc.needs,
                   buckets=acc.ledger)
        return (np.hstack([acc.pool_demand, acc.quota_demand]), acc.cost_usd_hr.copy(),
                list(acc.binding_rows))

    chunk(True)  # the card's columns and the zero-load table
    card_out, host_out = {}, {}
    cuda_queueing.PLAN_ROWS_LAUNCHES = 0
    card = chunk(True, card_out)
    launches = cuda_queueing.PLAN_ROWS_LAUNCHES
    host = chunk(False, host_out)
    prep.rows_on_card = True
    if launches != 1:
        raise AssertionError(f"14(d): one chunk launched plan_rows_kernel {launches} times")
    max_abs = 0.0
    pairs = [(f, card_out[f], host_out[f]) for f in BATCH_OUTPUTS]
    pairs += [("demand", card[0], host[0]), ("cost sums", card[1], host[1])]
    for name, got, want in pairs:
        if got.shape != want.shape or got.tobytes() != want.tobytes():
            raise AssertionError(f"14(d): {name} differs from the numpy path in a bit")
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        max_abs = max(max_abs, float(np.nanmax(diff)) if diff.size else 0.0)
    if card[2] != host[2]:
        raise AssertionError("14(d): the binding rows differ from the numpy path")
    print(f"  every slab output ({', '.join(BATCH_OUTPUTS)}), the bucket demand "
          f"({card[0].shape[1]} columns, {int(card[0].sum())} chips) and the cost sums "
          "bit-identical to the numpy path of the same prep")

    # the launch as the Monte Carlo planner makes it: the cost and the demand
    rows = prep._card_rows
    dev = rows.device
    slab = torch.from_numpy(rates).to(dev)
    out = {"cost": torch.empty(rates.shape, dtype=torch.float32, device=dev)}
    buckets = rows.bucket_map(accs[True].ledger)
    demand = torch.empty((PLAN_ROWS, buckets.n), dtype=torch.int64, device=dev)

    def launch():
        cuda_queueing.plan_rows(slab, rows.lanes, ACCEL_PENALTY_FACTOR, rows.zero, out,
                                buckets, demand)

    k_ms, k_enq = _device_ms(launch, 100)
    nbytes = (slab.numel() * (8 + 4) + demand.numel() * 8
              + sum(t.numel() * t.element_size() for t in rows.lanes)
              + sum(t.numel() * t.element_size() for t in buckets[:3]))
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3

    def wall_ms(on_card):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            chunk(on_card)
            times.append((time.perf_counter() - t0) * 1e3)
        prep.rows_on_card = True
        return statistics.median(times)

    card_ms, host_ms = wall_ms(True), wall_ms(False)
    print(f"  plan_rows_kernel {k_ms * 1e3:.2f} us a launch (host enqueue of the timed runs "
          f"{k_enq:.1f} ms), bound {b_ms * 1e3:.2f} us ({nbytes} bytes over "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s); the whole chunk through the accumulator "
          f"(host clock, median of 5): card {card_ms:.2f} ms, numpy {host_ms:.2f} ms; on {smi}")
    reset_fleet_state()
    return dict(launches=launches, max_abs_err=max_abs, ms=k_ms, plain_ms=host_ms,
                bound_ms=b_ms, bound_by="bytes")


def _phase14c():
    """14(c). spot-storm replays at the reference bench's configuration."""
    import dataclasses

    from inferno_tpu_torch.config.types import CapacitySpec, SpotPoolSpec
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.parallel import calculate_fleet_batch, reset_fleet_state
    from inferno_tpu_torch.planner.scenarios import base_rates_from_system, diurnal
    from inferno_tpu_torch.spot.scenarios import (
        _risk_blind,
        build_storms,
        replay_spot_storm,
        replay_spot_storm_ensemble,
    )
    from inferno_tpu_torch.testing.fleet import assert_same_batch, fleet_system_spec

    tier = SpotPoolSpec(discount=0.3, hazard_per_hr=0.005, blast_radius=0.06,
                        recovery_s=1800.0)
    print(f"14(c). storms: {STORM_VARIANTS} variants, {STORM_STEPS} steps of {STORM_STEP_S:.0f} s, "
          f"tier {dataclasses.asdict(tier)}")
    spec = fleet_system_spec(STORM_VARIANTS, shapes_per_variant=2)
    spec.capacity = CapacitySpec(chips={}, spot={"v5e": tier})
    trace = diurnal(base_rates_from_system(System(spec)), STORM_STEPS, STORM_STEP_S, seed=0)
    storm = build_storms(["spot_reclaim"], ["v5e"], STORM_STEPS, STORM_STEP_S, seed=7)[0]
    storm = dataclasses.replace(storm, events=tuple(
        dataclasses.replace(e, fraction=min(e.fraction, tier.blast_radius))
        for e in storm.events))
    reports = {}
    for backend in ("cuda", "torch"):
        reset_fleet_state()
        single, sms = _timed(lambda: replay_spot_storm(spec, trace, storm, backend=backend))
        ens, ems = _timed(lambda: replay_spot_storm_ensemble(
            spec, trace, "spot_reclaim", seeds=STORM_SEEDS, backend=backend))
        reports[backend] = (single, ens)
        print(f"  {backend}: replay_spot_storm {sms:.1f} ms, {STORM_SEEDS}-seed ensemble "
              f"{ems:.1f} ms")
    single, ens = reports["cuda"]
    reactive, prepos = single["reactive"], single["prepositioned"]
    print(f"  violation-seconds reactive {reactive['violation_seconds']}, pre-positioned "
          f"{prepos['violation_seconds']}; cost delta {single['cost_delta_pct']}%; ensemble "
          f"saving probability {ens['saving_probability']}, violation_s_saved "
          f"{ens['violation_s_saved']}")
    if not (prepos["violation_seconds"] < reactive["violation_seconds"]
            and single["cost_delta_pct"] <= 10.0):
        raise AssertionError("14(c): pre-positioning did not cut violation-seconds within "
                             "10% cost")
    # the two backends' placements under ROADMAP's rule; with no ±1
    # boundary cell between them the reports must be equal
    boundary = 0
    for spot_cfg in (_risk_blind(dict(spec.capacity.spot)), dict(spec.capacity.spot)):
        placed = dataclasses.replace(spec, capacity=dataclasses.replace(spec.capacity,
                                                                        spot=spot_cfg))
        out = []
        for backend in ("cuda", "torch"):
            reset_fleet_state()
            with _PrepClock() as clock:
                res = calculate_fleet_batch(System(placed), trace.rates, backend=backend)
            out.append((clock.prep, res))
        boundary += assert_same_batch(*out[0], *out[1])
    same = reports["cuda"] == reports["torch"]
    print(f"  cuda vs torch: {boundary} ±1 boundary cells in the two placements; storm "
          f"reports (single and ensemble) {'equal' if same else 'differ'}")
    if boundary == 0 and not same:
        raise AssertionError("14(c): cuda and torch storm reports differ with no boundary cell")
    reset_fleet_state()


def _phase15(seed, smi, tmp):
    """15. the flight recorder on the card and the replay of what it
    recorded; the artifact stays in `tmp`/recorder for phase 16."""
    import contextlib
    import io

    import numpy as np

    from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
    from inferno_tpu_torch.obs import report as obs_report
    from inferno_tpu_torch.obs.recorder import read_artifact
    from inferno_tpu_torch.parallel import reset_fleet_state
    from inferno_tpu_torch.planner import __main__ as planner_cli
    from inferno_tpu_torch.planner.replay import replay_cycle_parity
    from inferno_tpu_torch.testing.fleet import fleet_fake_prom

    n = RECORD_VARIANTS
    print(f"15. flight recorder: {n} variants (phase 12's cluster, seed {seed}), on {smi}")
    os.environ["LOG_LEVEL"] = "warn"
    rng = np.random.default_rng(seed + 15)
    cluster, rows0 = _reconcile_fleet(n, seed)
    rows1, _ = _move_rows(rows0, rng, RECONCILE_MOVE)
    reset_fleet_state()
    d = os.path.join(tmp, "recorder")
    rec = Reconciler(cluster, fleet_fake_prom(rows0), ReconcilerConfig(
        keep_accelerator=False, flight_recorder_dir=d))
    if rec.config.compute_backend != "cuda" or rec.recorder is None:
        raise AssertionError("15: expected backend cuda with a recorder")
    limited = set()
    for k, (label, rows) in enumerate((("cold", rows0), ("1% λ", rows1),
                                       ("limited at 80%", rows1))):
        if k == 2:
            chips = sum(r.replicas * (16 if r.accelerator == "v5e-16" else 4)
                        for r in report.decisions if r.accelerator)
            cluster.set_configmap("inferno-system", "inferno-autoscaler-config", {
                "OPTIMIZER_MODE": "limited",
                "TPU_CAPACITY": json.dumps({"v5e": int(0.8 * chips)}),
            })
        rec.prom = fleet_fake_prom(rows)
        report, ms = _timed(rec.run_cycle)
        if not report.optimization_ok or report.errors:
            raise AssertionError(f"15: cycle {label}: {report.errors[:3]}")
        held = sum(r.reason == "capacity_limited" for r in report.decisions)
        if k == 2:
            limited = held
        print(f"  cycle {k + 1} {label}: {ms:.1f} ms; {held} capacity_limited decisions")
    _, close_ms = _timed(rec.close)
    dropped = rec.recorder.dropped
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"  close {close_ms:.1f} ms; artifact {size} bytes in {len(os.listdir(d))} "
          f"files; dropped {dropped}")
    rt = read_artifact(d)
    if rt.num_cycles != 3 or rt.warnings or dropped:
        raise AssertionError(f"15: read {rt.num_cycles} cycles, warnings {rt.warnings}, "
                             f"dropped {dropped}")
    for k in range(rt.num_cycles):
        parity, pms = _timed(lambda: replay_cycle_parity(rt, k, backend="cuda"))
        want = (n - limited, limited) if k == 2 else (n, 0)
        print(f"  replay_cycle_parity(cycle {k + 1}, cuda): match {parity['match']}, "
              f"compared {parity['compared']}, skipped {parity['skipped']} "
              f"({pms:.1f} ms)")
        if not parity["match"] or (parity["compared"], parity["skipped"]) != want:
            raise AssertionError(f"15: cycle {k + 1} parity {parity['mismatches'][:3]}")
    out = os.path.join(tmp, "trace.json")
    _, tms = _timed(lambda: planner_cli.main(["--trace", d, "--out", out]))
    with open(out) as fh:
        doc = json.load(fh)
    cov = doc["recorded"]["drift"]["coverage"]
    sampled = [p["match"] for p in doc["parity_sampled"]]
    print(f"  planner --trace (backend {doc['fleet']['backend']}): coverage {cov}, sampled "
          f"parity {sampled} ({tms:.1f} ms)")
    if cov != 1.0 or not sampled or not all(sampled):
        raise AssertionError("15: planner --trace drift or parity")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, rms = _timed(lambda: obs_report.main([d]))
    print(f"  obs.report: exit {rc}, {len(buf.getvalue().splitlines())} lines "
          f"({rms:.1f} ms)")
    if rc != 0:
        raise AssertionError(f"15: obs.report exited {rc}")
    reset_fleet_state()


TWIN_ENGINES = 1000
TWIN_RATE_RPS = 800.0
TWIN_DURATION_S = 92.0
TWIN_BARRIER_MS = 2000.0
TWIN_WARM = 3


def _twin_cli(argv):
    """The port's twin CLI with `argv`; its JSON report as written."""
    from inferno_tpu_torch.twin.__main__ import main as twin_main

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        rc = twin_main([*argv, "--out", out])
        if rc != 0:
            raise AssertionError(f"16: twin CLI {argv} exited {rc}")
        with open(out) as fh:
            return fh.read()


def _phase16(smi, tmp):
    """16. the fleet twin with its step cost on the card."""
    import numpy as np

    from inferno_tpu_torch.emulator.engine import EngineProfile
    from inferno_tpu_torch.obs.recorder import read_artifact
    from inferno_tpu_torch.twin import (
        TwinPlant,
        build_trace,
        parity_diff,
        route_round_robin,
        run_serial_oracle,
    )
    from inferno_tpu_torch.twin import plant as twin_plant

    evals = twin_plant.STEP_COST_EVALS
    E = TWIN_ENGINES
    profile = EngineProfile()
    trace = build_trace("ramp_burst", TWIN_RATE_RPS, TWIN_DURATION_S, 0)
    end_ms = trace.duration_s * 1000.0
    eng = route_round_robin(trace, E)
    edges = list(np.arange(TWIN_BARRIER_MS, end_ms, TWIN_BARRIER_MS)) + [end_ms]
    print(f"16. fleet twin: {E} engines, ramp_burst {TWIN_RATE_RPS:g} req/s for "
          f"{TWIN_DURATION_S:g} s (seed 0, {trace.requests} requests), barriers every "
          f"{TWIN_BARRIER_MS:g} ms, on {smi}")

    # the step cost alone on seeded random profiles (awkward mantissas: a
    # regrouped sum would show in the last bit) against numpy
    rng = np.random.default_rng(16)
    profiles = [EngineProfile(
        alpha=float(rng.uniform(5, 40)), beta=float(rng.uniform(0.05, 1.5)),
        beta2=float(rng.uniform(0, 0.02)), gamma=float(rng.uniform(1, 30)),
        delta=float(rng.uniform(0.001, 0.2)), max_batch=512) for _ in range(E)]
    host, card = TwinPlant(profiles, E, backend="numpy"), TwinPlant(profiles, E)
    values = differ = 0
    for _ in range(50):
        idx = np.sort(rng.choice(E, size=int(rng.integers(1, E + 1)), replace=False))
        batch = rng.integers(1, 513, size=len(idx))
        new_count = np.minimum(rng.integers(0, 4, size=len(idx)), batch)
        new_count[::5] = batch[::5]
        new_in_sum = (new_count * rng.integers(1, 900, size=len(idx))).astype(np.float64)
        args = (idx, batch.astype(np.float64), new_count, new_in_sum, batch)
        want, got = host._step_cost_vec(*args), card._step_cost_vec(*args)
        values += len(idx)
        differ += int((got.view(np.int64) != want.view(np.int64)).sum())
    print(f"  (a) step cost on the card vs numpy, {E} random profiles, 50 random rounds: "
          f"{differ} of {values} values differ in a bit")
    if differ:
        raise AssertionError("16: the card's step cost is not bit-equal to numpy's")

    def run(backend):
        t0 = time.perf_counter()
        plant = (TwinPlant(profile, E) if backend == "torch"
                 else TwinPlant(profile, E, backend="numpy"))
        plant.inject_bulk(eng, trace.arr_ms, trace.in_tokens, trace.out_tokens)
        rounds = sum(plant.advance_to(t) for t in edges)
        plant.drain_completions()
        _sync()
        return plant, rounds, (time.perf_counter() - t0) * 1e3

    # (a) cold, counted; then warm passes, the backends in turns
    evals.update(torch=0, numpy=0)
    plant, rounds, cold_torch = run("torch")
    counted = dict(evals)
    if plant.backend != "torch" or plant.device.type != "cuda":
        raise AssertionError(f"16: default plant on {plant.backend}/{plant.device}")
    if counted != {"torch": rounds, "numpy": 0}:
        raise AssertionError(f"16: step-cost evaluations {counted} for {rounds} rounds")
    ref, ref_rounds, cold_numpy = run("numpy")
    warm = {"torch": [], "numpy": []}
    for rep in range(TWIN_WARM):
        for backend in (("numpy", "torch") if rep % 2 == 0 else ("torch", "numpy")):
            p, r, ms = run(backend)
            if r != rounds or parity_diff(p.results(), plant.results()):
                raise AssertionError(f"16: warm {backend} pass differs")
            warm[backend].append(ms)
    med = {b: statistics.median(v) for b, v in warm.items()}
    print(f"  (a) step-cost evaluations on the card {counted['torch']} = rounds {rounds} "
          f"(numpy 0); {plant.report()['completed']} completed, events "
          f"{plant.events_total}")
    for backend, cold in (("torch", cold_torch), ("numpy", cold_numpy)):
        print(f"  (a) plant {backend}: cold {cold:.1f} ms, warm median {med[backend]:.1f} ms "
              f"(passes {', '.join(f'{t:.1f}' for t in warm[backend])}), "
              f"{1e3 * med[backend] / rounds:.1f} us a round")
    diffs = parity_diff(plant.results(), ref.results())
    if diffs or ref_rounds != rounds or plant.report() != ref.report():
        raise AssertionError(f"16: torch plant vs numpy plant: {diffs[:3]}")
    oracle, oracle_ms = _timed(lambda: run_serial_oracle(
        profile, eng, trace.arr_ms, trace.in_tokens, trace.out_tokens, end_ms,
        barrier_ms=TWIN_BARRIER_MS))
    diffs = parity_diff(plant.results(), oracle)
    if diffs:
        raise AssertionError(f"16: torch plant vs serial oracle: {diffs[:3]}")
    busy = _profiled_device_ms(lambda: run("torch"), 1)
    print(f"  (a) serial oracle {oracle_ms:.1f} ms; speedup over it: torch "
          f"{oracle_ms / min(warm['torch']):.2f}x, numpy "
          f"{oracle_ms / min(warm['numpy']):.2f}x (best warm passes); bit-identical to "
          f"the numpy plant and to the oracle")
    print(f"  (a) device busy {busy:.1f} ms in a profiled torch pass "
          f"({100.0 * busy / med['torch']:.2f}% of the warm median)")

    # (b) the CLI's headline on the card against the same CLI on numpy
    head = ["--policies", "reactive,predictive", "--engines", str(E)]
    evals.update(torch=0, numpy=0)
    on_card, card_ms = _timed(lambda: _twin_cli(head))
    if not evals["torch"] or evals["numpy"]:
        raise AssertionError(f"16: CLI default evaluated {evals}")
    on_host, host_ms = _timed(lambda: _twin_cli([*head, "--backend", "numpy"]))
    if on_card != on_host:
        raise AssertionError("16: the CLI's reports differ between torch and numpy")
    doc = json.loads(on_card)
    print(f"  (b) twin CLI {' '.join(head)}: torch {card_ms:.1f} ms "
          f"({evals['torch']} step-cost evaluations), numpy {host_ms:.1f} ms; reports "
          f"equal; violation-s reactive {doc['reactive']['slo_violation_s']} vs "
          f"predictive {doc['predictive']['slo_violation_s']}, cost "
          f"{doc['reactive']['cost']} vs {doc['predictive']['cost']}")

    # (c) a spot storm, and a replay of phase 15's artifact
    rt = read_artifact(os.path.join(tmp, "recorder"))
    variant = rt.variant_ids()[0]
    for label, argv in (
        ("--engines 200 --kills 30:10,45:6", ["--engines", "200", "--kills", "30:10,45:6"]),
        (f"--replay <phase 15> --variant {variant} --engines 64",
         ["--replay", os.path.join(tmp, "recorder"), "--variant", variant,
          "--engines", "64"]),
    ):
        on_card, card_ms = _timed(lambda: _twin_cli(argv))
        on_host, host_ms = _timed(lambda: _twin_cli([*argv, "--backend", "numpy"]))
        if on_card != on_host:
            raise AssertionError(f"16: {label}: reports differ between torch and numpy")
        doc = json.loads(on_card)
        block = doc.get("reactive", doc)
        print(f"  (c) twin CLI {label}: torch {card_ms:.1f} ms, numpy {host_ms:.1f} ms; "
              f"reports equal ({block['completed']} completed, "
              f"{block['preempted_requests']} preempted)")


def _phase17():
    """17. one closed emulated loop under the port's controller on backend cuda."""
    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
    from inferno_tpu_torch.controller import InMemoryCluster, Reconciler, ReconcilerConfig
    from inferno_tpu_torch.controller.crd import (
        ACCELERATOR_LABEL,
        TYPE_OPTIMIZATION_READY,
        AcceleratorProfile,
        ConfigMapKeyRef,
        VariantAutoscaling,
        VariantAutoscalingSpec,
    )
    from inferno_tpu_torch.emulator import (
        EmulatedEngine,
        EngineProfile,
        LoadGenerator,
        MiniProm,
        RateSpec,
    )
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import reset_fleet_state

    model, ns, cfg_ns = "emulated/llama", "workloads", "inferno-system"
    fast = EngineProfile(alpha=5.0, beta=0.1, gamma=2.0, delta=0.01, max_batch=8)
    print("17. closed emulated loop: EmulatedEngine -> MiniProm -> the port's "
          "Reconciler (backend cuda) -> the deployment")
    cluster = InMemoryCluster()
    cluster.set_configmap(cfg_ns, "accelerator-unit-costs", {
        "v5e-4": json.dumps({"cost": 10.0})})
    cluster.set_configmap(cfg_ns, "service-classes-config", {"premium.yaml": (
        "name: Premium\npriority: 1\ndata:\n"
        f"  - model: {model}\n    slo-ttft: 200\n    slo-tpot: 8\n")})
    cluster.set_configmap(cfg_ns, "inferno-autoscaler-config", {})
    cluster.add_variant_autoscaling(VariantAutoscaling(
        name="emulated-llama", namespace=ns, labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=model,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=[AcceleratorProfile(
                acc="v5e-4", acc_count=1, max_batch_size=fast.max_batch, at_tokens=16,
                decode_parms=DecodeParms(alpha=fast.alpha, beta=fast.beta),
                prefill_parms=PrefillParms(gamma=fast.gamma, delta=fast.delta))],
        ),
    ))
    cluster.add_deployment(ns, "emulated-llama", replicas=1)
    reset_fleet_state()
    engine = EmulatedEngine(fast)
    engine.start()
    prom_srv = MiniProm.for_engines({model: [engine]}, labels={"namespace": ns})
    prom_srv.start()
    try:
        rec = Reconciler(kube=cluster, prom=prom_srv.client(), config=ReconcilerConfig(
            config_namespace=cfg_ns, compute_backend="cuda", direct_scale=True))
        gen = LoadGenerator([engine], RateSpec(phases=((3.0, 40.0),)),
                            in_tokens=16, out_tokens=64)
        gen.start()
        gen.join(20)
        time.sleep(0.5)  # let in-flight requests finish
        cuda_queueing.LAUNCHES = 0
        cuda_queueing.BISECT_LAUNCHES = 0
        report, out_ms = _timed(rec.run_cycle)
        va = cluster.get_variant_autoscaling(ns, "emulated-llama")
        desired = va.status.desired_optimized_alloc.num_replicas
        arrival = va.status.current_alloc.load.arrival_rate
        deployed = cluster.get_deployment(ns, "emulated-llama")["spec"]["replicas"]
        if (report.errors or va.status.condition(TYPE_OPTIMIZATION_READY).status != "True"
                or desired <= 1 or arrival <= 600.0 or deployed != desired):
            raise AssertionError(f"17: scale-out: errors {report.errors}, desired "
                                 f"{desired}, arrival {arrival} req/min, deployed {deployed}")
        # idle: the engine's telemetry windows and the scrape history cleared
        engine.completions.clear()
        engine.arrivals.clear()
        prom_srv.history.clear()
        prom_srv.scrape_once()
        prom_srv.scrape_once()
        report2, in_ms = _timed(rec.run_cycle)
        launches = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
        va = cluster.get_variant_autoscaling(ns, "emulated-llama")
        idle = va.status.desired_optimized_alloc.num_replicas
        if report2.errors or idle != 1:
            raise AssertionError(f"17: scale-in: errors {report2.errors}, desired {idle}")
        if launches[0] < 1:
            raise AssertionError(f"17: no stats_kernel launch in the loop: {launches}")
        print(f"  loaded cycle {out_ms:.1f} ms: {arrival:.1f} req/min observed, 1 -> "
              f"{desired} replicas (deployment {deployed}); idle cycle {in_ms:.1f} ms: "
              f"-> {idle}; launches (stats_kernel, bisect_kernel) {launches}")
    finally:
        prom_srv.stop()
        engine.stop()
    reset_fleet_state()


# phase 18: the transformer profiling blocks at full width. (a) depth-2
# parity checks of both families; (b) a reduced Llama-3.1-8B sweep through
# profile_gpu's own functions, fitted by models.profiles, and one decode
# point at full depth; (c) one int8 decode point beside bf16
P18_BATCH, P18_CONTEXT, P18_STEPS, P18_CHUNK = 4, 256, 4, 64
# relative L2 error of x after ONE step and of the cache slot it wrote:
# bf16 against the same weights in float32 on the card (bf16 rounds each
# product, norm and activation at 2^-8 relative, some ten of them in series
# per layer: 0.9% at half width on the CPU), and a mixed step's decode rows
# against a pure decode step in bf16 (the products run at other shapes, so
# they round elsewhere: 0.5% there). One step: the random-weight stack
# amplifies a perturbation of its input, so over steps fed back through
# tanh(logits) the difference roughly doubles each step (5.0% and 3.5%
# after four at half width) and measures that gain, not the port
P18_BF16_TOL = 5e-2
P18_MIXED_TOL = 2.5e-2
P18_DEPTHS = (2, 4, 8)
P18_SWEEP = ["--decode-batches", "1", "16", "64", "128", "--mixed-batches", "1", "16", "48",
             "--mixed-tokens", "128", "512", "--prefill-batches", "1",
             "--prefill-tokens", "128", "512", "--max-cache-gb", "40"]
P18_FULL_BATCH = 16
# a stack of identical layers is linear in depth: the floor the repo's own
# test of committed profiles holds their decode fits to
P18_MIN_R2 = 0.95


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _as_float32(params):
    return {k: (_as_float32(v) if isinstance(v, dict) else v.float())
            for k, v in params.items()}


def _phase18a(dev):
    """18a. graph replay == eager, bf16 vs float32, mixed rows vs decode."""
    import torch

    from inferno_tpu_torch.models import gemma_block, llama_block
    from inferno_tpu_torch.tools.profile_gpu import replayable

    # the float32 reference runs in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, ctx, steps, t = P18_BATCH, P18_CONTEXT, P18_STEPS, P18_CHUNK
    for model, blk, dims in (
        ("llama-3.1-8b", llama_block, llama_block.MODEL_PRESETS["llama-3.1-8b"]),
        ("gemma-2-9b", gemma_block, gemma_block.GEMMA_PRESETS["gemma-2-9b"]),
    ):
        gen = torch.Generator(device=dev).manual_seed(18)
        params = blk.init_stack(gen, dims, 2, "bfloat16", device=dev)

        def noise(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.1).to(torch.bfloat16)

        x0 = noise(b, 1, dims.hidden)
        c0 = [noise(b, dims.n_kv_heads, ctx + steps, dims.head_dim) for _ in range(4)]
        chunk = noise(t, dims.hidden)
        decode = blk.make_decode_fn(dims, 2, steps)
        mixed = blk.make_mixed_fn(dims, 2, steps)
        eager = {
            "decode": decode(params, x0, [c.clone() for c in c0], ctx),
            "mixed": mixed(params, x0, [c.clone() for c in c0], chunk, ctx),
        }
        for name, fn in (("decode", decode), ("mixed", mixed)):
            x = x0.clone()
            caches = [c.clone() for c in c0]
            pos = torch.zeros((), dtype=torch.int64, device=dev)
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            extra = (chunk,) if name == "mixed" else ()
            run = replayable(lambda: fn.step(params, x, caches, *extra, pos, acc), dev)
            x.copy_(x0)
            for c, c_init in zip(caches, c0):
                c.copy_(c_init)
            pos.fill_(ctx)
            acc.zero_()
            for _ in range(steps):
                run()
            s_e, x_e, c_e = eager[name]
            same = (torch.equal(acc + torch.sum(x.float()), s_e) and torch.equal(x, x_e)
                    and all(torch.equal(a, e) for a, e in zip(caches, c_e)))
            print(f"  {model}: {name}, {steps} graph replays vs eager: "
                  f"{'bit-identical' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"18a {model}: {name} graph replay differs from eager")
        # the accuracy checks: one step (see P18_BF16_TOL), the slot it wrote
        written = slice(ctx, ctx + 1)
        decode1 = blk.make_decode_fn(dims, 2, 1)
        s_d, x_d, c_d = decode1(params, x0, [c.clone() for c in c0], ctx)
        s_f, x_f, c_f = decode1(_as_float32(params), x0.float(), [c.float() for c in c0], ctx)
        s_m, x_m, c_m = blk.make_mixed_fn(dims, 2, 1)(params, x0, [c.clone() for c in c0],
                                                      chunk, ctx)
        torch.cuda.synchronize()
        bf16_x = _rel(x_d, x_f)
        bf16_c = max(_rel(a[:, :, written], f[:, :, written]) for a, f in zip(c_d, c_f))
        mix_x = _rel(x_m, x_d)
        mix_c = max(_rel(a[:, :, written], d[:, :, written]) for a, d in zip(c_m, c_d))
        x4 = [_rel(eager["decode"][1], decode(_as_float32(params), x0.float(),
                                              [c.float() for c in c0], ctx)[1]),
              _rel(eager["mixed"][1], eager["decode"][1])]
        finite = all(bool(torch.isfinite(v).all()) for v in (s_d, s_m, s_f, x_d, x_m)
                     + eager["decode"][:2] + eager["mixed"][:2])
        print(f"  {model}: bf16 vs float32 (B={b}, context {ctx}, one step): x "
              f"{bf16_x:.3g}, written cache {bf16_c:.3g} (tolerance {P18_BF16_TOL:g}); "
              f"scalar {float(s_d):.6g} vs {float(s_f):.6g}")
        print(f"  {model}: mixed step's decode rows (chunk {t}) vs pure decode, bf16, one "
              f"step: x {mix_x:.3g}, written cache {mix_c:.3g} (tolerance "
              f"{P18_MIXED_TOL:g}); after {steps} steps x {x4[0]:.3g} vs float32, "
              f"{x4[1]:.3g} mixed vs decode (not gated)")
        if not finite or max(bf16_x, bf16_c) > P18_BF16_TOL or max(mix_x, mix_c) > P18_MIXED_TOL:
            raise AssertionError(f"18a {model}: finite {finite}, bf16 {bf16_x}/{bf16_c}, "
                                 f"mixed {mix_x}/{mix_c}")
        del params, eager, c0, c_f, c_d, c_m, x_f
        torch.cuda.empty_cache()


def _decode_step_bytes(dims, n_layers, batch, context, steps):
    """Bytes one decode step must move, each input read once and each
    output written once: the weights (layers, final norm, LM head), the
    visible cache slots [0, pos] (averaged over the steps from `context`),
    the slot written and x in and out."""
    weights = (n_layers * dims.layer_params_bytes(2) + 2 * dims.hidden
               + 2 * dims.hidden * dims.vocab)
    kv_read = n_layers * 2 * batch * (context + (steps + 1) / 2) * dims.kv_dim * 2
    kv_write = n_layers * 2 * batch * dims.kv_dim * 2
    return weights + kv_read + kv_write + 2 * 2 * batch * dims.hidden


def _phase18bc(dev, smi):
    """18b. the reduced Llama-3.1-8B sweep, its fit and a full-depth point;
    18c. one int8 decode point beside bf16."""
    import dataclasses

    import torch

    from inferno_tpu_torch.models import llama_block, profiles
    from inferno_tpu_torch.tools import profile_gpu as pg

    dims = llama_block.MODEL_PRESETS["llama-3.1-8b"]
    args = pg.build_parser().parse_args(P18_SWEEP)
    decode, prefill, mixed = [], [], []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for n_layers in P18_DEPTHS:
        pg.profile_depth(llama_block, dims, n_layers, args, decode, prefill, mixed,
                         lambda: None, set(), dev)
    sweep_s = time.perf_counter() - t0
    dims_meta = dataclasses.asdict(dims)
    dims_meta["n_layers_full"] = dims_meta.pop("n_layers")
    meta = {"model": "llama-3.1-8b", "dims": dims_meta, "device": pg.device_meta(dev),
            "dtype": "bfloat16", "weight_dtype": "bfloat16",
            "decode_context": args.context, "timing": "cuda-events"}
    raw = {"meta": meta, "decode": decode, "prefill": prefill, "mixed": mixed}
    doc = profiles.build_profile_json(
        raw, "h100-1", n_chips=1, hbm_per_chip_gb=meta["device"]["total_memory_gb"],
        weight_bytes_per_param=2.0)
    fit, dp, pp = doc["fit"], doc["decodeParms"], doc["prefillParms"]
    print(f"  {smi}")
    print(f"  18b sweep (depths {list(P18_DEPTHS)}, {len(decode)} decode + {len(mixed)} mixed "
          f"+ {len(prefill)} prefill points) in {sweep_s:.1f} s")
    print(f"  llama-3.1-8b h100-1 fit: alpha {dp['alpha']} ms, beta {dp['beta']} ms, gamma "
          f"{pp['gamma']} ms, delta {pp['delta']} ms, maxBatchSize {doc['maxBatchSize']} "
          f"(atTokens {doc['atTokens']}, {meta['device']['total_memory_gb']} GiB); layer "
          f"linearity r2 decode {fit['decode_layer_linearity_r2']}, mixed "
          f"{fit.get('mixed_layer_linearity_r2')}, prefill {fit['prefill_layer_linearity_r2']}; "
          f"{fit['ttft_calibration']}, {fit['ttft_fit']}")
    times = [s["step_ms"] for s in decode + mixed] + [s["prefill_ms"] for s in prefill]
    ok = (all(math.isfinite(v) and v > 0 for v in times) and dp["alpha"] > 0 and pp["delta"] > 0 and doc["maxBatchSize"] > 0
          and fit["decode_layer_linearity_r2"] > P18_MIN_R2)
    if not ok:
        raise AssertionError(f"18b: implausible sweep or fit: {doc}")
    for s in decode:
        bound = _decode_step_bytes(dims, s["n_layers"], s["batch"], args.context,
                                   args.decode_steps) / PEAK_BYTES_PER_S * 1e3
        print(f"  decode L={s['n_layers']} B={s['batch']} context {args.context}: "
              f"{s['step_ms']:.4f} ms, byte bound {bound:.4f} ms at 3.35 TB/s "
              f"({100 * bound / s['step_ms']:.1f}%)")

    # one decode point at full depth against the depth line's extrapolation
    full = pg.build_parser().parse_args(["--decode-batches", str(P18_FULL_BATCH)])
    full.mixed_batches, full.prefill_batches = [], []
    full_pts = []
    pg.profile_depth(llama_block, dims, dims.n_layers, full, full_pts, [], [],
                     lambda: None, set(), dev)
    c, m, _, _ = profiles._per_group_line_fits(decode, "step_ms", ("batch",))[(P18_FULL_BATCH,)]
    pred = c + m * dims.n_layers
    got = full_pts[0]["step_ms"]
    bound = _decode_step_bytes(dims, dims.n_layers, P18_FULL_BATCH, args.context,
                               args.decode_steps) / PEAK_BYTES_PER_S * 1e3
    print(f"  full depth L={dims.n_layers} B={P18_FULL_BATCH}: {got:.4f} ms measured, "
          f"{pred:.4f} ms extrapolated from depths {list(P18_DEPTHS)} "
          f"({100 * (got - pred) / pred:+.2f}%); byte bound {bound:.4f} ms "
          f"({100 * bound / got:.1f}%)")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 18c. int8 weights, cast to bf16 before each product in eager torch
    q8 = pg.build_parser().parse_args(["--decode-batches", "16", "--weight-dtype", "int8"])
    q8.mixed_batches, q8.prefill_batches = [], []
    q8_pts = []
    pg.profile_depth(llama_block, dims, 2, q8, q8_pts, [], [], lambda: None, set(), dev)
    bf16_ms = next(s["step_ms"] for s in decode if s["n_layers"] == 2 and s["batch"] == 16)
    print(f"  18c decode L=2 B=16: int8 weights (eager dequant) {q8_pts[0]['step_ms']:.4f} ms "
          f"vs bf16 {bf16_ms:.4f} ms ({q8_pts[0]['step_ms'] / bf16_ms:.2f}x)")
    if not math.isfinite(q8_pts[0]["step_ms"]):
        raise AssertionError(f"18c: {q8_pts}")


def _phase18(smi):
    """18. the transformer profiling blocks on the card."""
    import torch

    dev = torch.device("cuda")
    # the products accumulate in float32, as the reference's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("18. transformer profiling blocks: (a) depth-2 parity at full width")
    _phase18a(dev)
    print("18. (b) reduced llama-3.1-8b sweep through profile_gpu, (c) int8")
    _phase18bc(dev, smi)


# phase 19: the controller over real sockets on backend cuda. (a) the
# production actuation path (gauges -> MiniProm -> adapter -> HPA ->
# /scale) around an emulated engine under load, then idle; (b) the
# disaggregated loop's atomic LeaderWorkerSet groups; (c) a 200-variant
# fleet cycle collected over MiniProm HTTP, against backend torch on the CPU
P19_LOAD_S = 2.0
P19_VARIANTS = 200
P19_QUERY_BUDGET = 10  # tests/test_fleet_cycle.py:433
# phase 20: the C++ solver on the host beside the card, on phase 4's fleet
P20_RTOL = 5e-3  # tests/test_native.py:80-103


def _post_load(port, model, seconds, concurrency=6):
    """Closed-loop OpenAI-style completions from `concurrency` threads."""
    import threading
    import urllib.request

    stop_at = time.time() + seconds
    url = f"http://127.0.0.1:{port}/v1/chat/completions"
    body = json.dumps({"model": model, "messages": [{"role": "user", "content": "x " * 64}],
                       "max_tokens": 32}).encode()

    def worker():
        while time.time() < stop_at:
            req = urllib.request.Request(url, data=body,
                                         headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=30).read()
            except OSError:
                return

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _hand_prom(targets):
    """A MiniProm scraped by hand: its HTTP endpoint serves, no scraper
    thread runs, one scrape is taken here and the phase takes the others;
    a 60 s window holds every rate still between them."""
    import threading

    from inferno_tpu_torch.emulator.miniprom import MiniProm

    prom = MiniProm(targets, window_seconds=60.0)
    threading.Thread(target=prom._httpd.serve_forever, daemon=True).start()
    prom.scrape_once()
    return prom


def _post_json(url, body):
    import urllib.request

    req = urllib.request.Request(url, method="POST", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req).read()


def _spans(report):
    return ", ".join(f"{c.name} {c.duration_ms:.1f}" for c in report.trace.children)


def _counted_cycle(rec):
    """One run_cycle with both counters zeroed just before and read just
    after, and the buckets it dispatched: (report, ms, launches, spy)."""
    from inferno_tpu_torch.ops import cuda_queueing

    cuda_queueing.LAUNCHES = 0
    cuda_queueing.BISECT_LAUNCHES = 0
    with _SlotSpy() as spy:
        report, ms = _timed(rec.run_cycle)
    launches = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
    if report.errors or not report.optimization_ok:
        raise AssertionError(f"cycle failed: {report.errors[:3]}")
    if launches != spy.expected():
        raise AssertionError(f"launches {launches} != the dispatched buckets' "
                             f"{spy.expected()} ({spy.plan()})")
    return report, ms, launches, spy


def _phase19a():
    """19a. gauges -> MiniProm -> adapter -> HPA -> /scale, on backend cuda."""
    from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
    from inferno_tpu_torch.controller.kube import RestKubeClient
    from inferno_tpu_torch.controller.metrics import MetricsEmitter, MetricsServer
    from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
    from inferno_tpu_torch.emulator.engine import EngineProfile
    from inferno_tpu_torch.emulator.server import EmulatorServer
    from inferno_tpu_torch.parallel import reset_fleet_state
    from inferno_tpu_torch.testing import MiniApiServer
    from inferno_tpu_torch.testing.hpa import ExternalMetricsAdapter, HpaEmulator

    model, ns, cfg_ns, name = "meta-llama/Llama-3.1-8B", "workloads", "inferno-system", "llama"
    print("19a. MiniApiServer + RestKubeClient, an emulated engine over HTTP scraped by "
          "MiniProm, the port's Reconciler (backend cuda, direct_scale false) publishing "
          "gauges on its MetricsServer, MiniProm -> ExternalMetricsAdapter -> HpaEmulator "
          "-> /scale")
    api = MiniApiServer().start()
    engine = EmulatorServer(model_id=model, time_scale=0.02, profile=EngineProfile(
        alpha=18.0, beta=0.3, gamma=5.0, delta=0.02, max_batch=64))
    engine.start()
    emitter = MetricsEmitter()
    msrv = MetricsServer(emitter.registry, port=0, host="127.0.0.1")
    msrv.start()
    prom = _hand_prom([(f"http://127.0.0.1:{engine.port}/metrics", {"namespace": ns}),
                       f"http://127.0.0.1:{msrv.port}/metrics"])
    try:
        cms = f"{api.url}/api/v1/namespaces/{cfg_ns}/configmaps"
        _post_json(cms, {"metadata": {"name": "accelerator-unit-costs", "namespace": cfg_ns},
                         "data": {"v5e-4": json.dumps({"cost": 10.0})}})
        _post_json(cms, {"metadata": {"name": "service-classes-config", "namespace": cfg_ns},
                         "data": {"premium.yaml": (
                             "name: Premium\npriority: 1\ndata:\n"
                             f"  - model: {model}\n    slo-ttft: 500\n    slo-tpot: 24\n")}})
        _post_json(cms, {"metadata": {"name": "inferno-autoscaler-config",
                                      "namespace": cfg_ns}, "data": {}})
        _post_json(f"{api.url}/apis/llmd.ai/v1alpha1/namespaces/{ns}/variantautoscalings", {
            "apiVersion": "llmd.ai/v1alpha1", "kind": "VariantAutoscaling",
            "metadata": {"name": name, "namespace": ns, "labels": {
                "inference.optimization/acceleratorName": "v5e-4"}},
            "spec": {"modelID": model, "sloClassRef": {
                "name": "service-classes-config", "key": "Premium"},
                "modelProfile": {"accelerators": [{
                    "acc": "v5e-4", "accCount": 1, "maxBatchSize": 64, "atTokens": 128,
                    "perfParms": {"decodeParms": {"alpha": "18.0", "beta": "0.3"},
                                  "prefillParms": {"gamma": "5.0", "delta": "0.02"}}}]}}})
        _post_json(f"{api.url}/apis/apps/v1/namespaces/{ns}/deployments", {
            "metadata": {"name": name, "namespace": ns}, "spec": {"replicas": 1},
            "status": {"replicas": 1, "readyReplicas": 1}})
        kube = RestKubeClient(base_url=api.url, token="", namespace=cfg_ns)
        reset_fleet_state()
        rec = Reconciler(kube, HttpPromClient(PromConfig(base_url=prom.url, allow_http=True)),
                         ReconcilerConfig(config_namespace=cfg_ns, compute_backend="cuda",
                                          direct_scale=False), emitter=emitter)
        hpa = HpaEmulator(kube=kube, adapter=ExternalMetricsAdapter(prom=HttpPromClient(
            PromConfig(base_url=prom.url, allow_http=True))), namespace=ns, name=name)

        _post_load(engine.port, model, P19_LOAD_S)
        prom.scrape_once()
        report, ms, launches, spy = _counted_cycle(rec)
        va = kube.get_variant_autoscaling(ns, name)
        desired = va.status.desired_optimized_alloc.num_replicas
        before = kube.get_deployment(ns, name)["spec"]["replicas"]
        prom.scrape_once()  # the gauges reach the scrape store
        applied = hpa.step()
        scaled = kube.get_deployment(ns, name)["spec"]["replicas"]
        print(f"  loaded cycle {ms:.1f} ms (spans {_spans(report)}): "
              f"{va.status.current_alloc.load.arrival_rate:.1f} req/min observed, desired "
              f"{desired}; deployment {before} before the HPA, {scaled} after (metric "
              f"{hpa.last_metric}); launches stats_kernel {launches[0]}, bisect_kernel "
              f"{launches[1]} ({spy.plan()}); {report.prom_queries} queries")
        if not (launches[0] and launches[1]):
            raise AssertionError(f"19a: loaded cycle launches {launches}")
        if desired <= 1 or before != 1 or applied != desired or scaled != desired:
            raise AssertionError(f"19a: scale-out: desired {desired}, deployment {before} "
                                 f"-> {scaled}, HPA applied {applied}")
        # idle: the engine's counters stand still between two fresh scrapes
        prom.history.clear()
        prom.scrape_once()
        prom.scrape_once()
        report2, ms2, launches2, _ = _counted_cycle(rec)
        idle = kube.get_variant_autoscaling(ns, name).status.desired_optimized_alloc
        prom.scrape_once()
        applied2 = hpa.step()
        final = kube.get_deployment(ns, name)["spec"]["replicas"]
        cur = kube.get_variant_autoscaling(ns, name).status.current_alloc.num_replicas
        print(f"  idle cycle {ms2:.1f} ms (spans {_spans(report2)}): desired "
              f"{idle.num_replicas} (the controller saw {cur} current), HPA -> {final}; "
              f"launches {launches2}")
        if idle.num_replicas != 1 or applied2 != 1 or final != 1 or cur != desired:
            raise AssertionError(f"19a: scale-in: desired {idle.num_replicas}, HPA "
                                 f"{applied2}, deployment {final}, current {cur}")
        rec.close()
    finally:
        prom.stop()
        msrv.stop()
        engine.stop()
        api.stop()
    reset_fleet_state()


def _phase19b():
    """19b. the disaggregated loop: tandem sizing on the card, atomic groups."""
    from inferno_tpu_torch.config.types import DecodeParms, DisaggSpec, PrefillParms
    from inferno_tpu_torch.controller import InMemoryCluster, Reconciler, ReconcilerConfig
    from inferno_tpu_torch.controller.crd import (
        ACCELERATOR_LABEL,
        AcceleratorProfile,
        ConfigMapKeyRef,
        VariantAutoscaling,
        VariantAutoscalingSpec,
    )
    from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
    from inferno_tpu_torch.emulator.disagg import DisaggEngine, DisaggProfile
    from inferno_tpu_torch.emulator.server import EmulatorServer
    from inferno_tpu_torch.parallel import reset_fleet_state

    model, ns, cfg_ns, name = "meta-llama/Llama-3.1-8B", "workloads", "inferno-system", "disagg"
    spec = DisaggSpec(prefill_slices=1, decode_slices=2, prefill_max_batch=8)
    prof = DisaggProfile(alpha=18.0, beta=0.3, gamma=5.0, delta=0.02, prefill_max_batch=8,
                         decode_max_batch=64, prefill_engines=1, decode_engines=2,
                         kv_transfer_ms=2.0)
    print("19b. disaggregated loop: a prefill/decode emulated engine (JetStream vocabulary) "
          "over HTTP -> MiniProm -> the port's Reconciler (backend cuda) -> LeaderWorkerSet "
          "groups")
    cluster = InMemoryCluster()
    cluster.set_configmap(cfg_ns, "accelerator-unit-costs", {
        "v5e-4": json.dumps({"cost": 10.0})})
    cluster.set_configmap(cfg_ns, "service-classes-config", {"premium.yaml": (
        "name: Premium\npriority: 1\ndata:\n"
        f"  - model: {model}\n    slo-ttft: 500\n    slo-tpot: 24\n")})
    cluster.set_configmap(cfg_ns, "inferno-autoscaler-config", {})
    cluster.add_variant_autoscaling(VariantAutoscaling(
        name=name, namespace=ns, labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=model,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=[AcceleratorProfile(
                acc="v5e-4", acc_count=1, max_batch_size=64, at_tokens=128,
                decode_parms=DecodeParms(alpha=prof.alpha, beta=prof.beta),
                prefill_parms=PrefillParms(gamma=prof.gamma, delta=prof.delta),
                disagg=spec)],
        ),
    ))
    cluster.add_leader_worker_set(ns, name, replicas=1, size=spec.slices_per_unit)
    srv = EmulatorServer(model_id=model, engine_name="jetstream",
                         engine=DisaggEngine(prof, time_scale=0.02))
    srv.start()
    prom = _hand_prom([(f"http://127.0.0.1:{srv.port}/metrics", {"namespace": ns})])
    try:
        reset_fleet_state()
        rec = Reconciler(cluster, HttpPromClient(PromConfig(base_url=prom.url,
                                                            allow_http=True)),
                         ReconcilerConfig(config_namespace=cfg_ns, compute_backend="cuda",
                                          direct_scale=True, engine="jetstream",
                                          profile_correction=False))
        _post_load(srv.port, model, P19_LOAD_S)
        prom.scrape_once()
        report, ms, launches, spy = _counted_cycle(rec)
        units = cluster.get_variant_autoscaling(ns, name).status.desired_optimized_alloc
        lws = cluster.get_leader_worker_set(ns, name)
        tan = [s for s in spy.slots if s.kind == "tan" and s.cached is None]
        print(f"  loaded cycle {ms:.1f} ms (spans {_spans(report)}): {units.num_replicas} "
              f"units -> LWS replicas {lws['spec']['replicas']} of size "
              f"{lws['spec']['leaderWorkerTemplate']['size']} ({cluster.pod_count(ns, name)} "
              f"pods); launches stats_kernel {launches[0]}, bisect_kernel {launches[1]} "
              f"({spy.plan()})")
        if not tan or launches != (STATS_LAUNCHES_PER_BUCKET["tan"] * len(tan),
                                   BISECT_LAUNCHES_PER_BUCKET * len(tan)):
            raise AssertionError(f"19b: the tandem plan's kernels: {launches}, {spy.plan()}")
        if (units.num_replicas <= 1 or lws["spec"]["replicas"] != units.num_replicas
                or lws["spec"]["leaderWorkerTemplate"]["size"] != spec.slices_per_unit
                or cluster.pod_count(ns, name) != units.num_replicas * spec.slices_per_unit):
            raise AssertionError(f"19b: scale-out: {units.num_replicas} units, {lws}")
        prom.history.clear()
        prom.scrape_once()
        prom.scrape_once()
        report2, ms2, launches2, _ = _counted_cycle(rec)
        lws = cluster.get_leader_worker_set(ns, name)
        print(f"  idle cycle {ms2:.1f} ms: LWS replicas {lws['spec']['replicas']}; "
              f"launches {launches2}")
        if lws["spec"]["replicas"] != 1:
            raise AssertionError(f"19b: scale-in: {lws['spec']}")
        rec.close()
    finally:
        prom.stop()
        srv.stop()
    reset_fleet_state()


def _phase19c():
    """19c. a 200-variant fleet cycle over MiniProm HTTP: cuda vs torch on the CPU."""
    from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
    from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
    from inferno_tpu_torch.parallel import reset_fleet_state
    from inferno_tpu_torch.testing.fleet import FLEET_NS, fleet_cluster, fleet_targets

    n = P19_VARIANTS
    print(f"19c. {n}-variant fleet_cluster, fleet_targets scraped by MiniProm over HTTP, "
          "backend cuda against backend torch on the CPU")
    # seven arrival rates over the fleet: the i-th target of each rate's set
    by_rate = {r: fleet_targets(n, arrival_rps=r)
               for r in (2.0, 10.0, 25.0, 40.0, 60.0, 80.0, 120.0)}
    rates = sorted(by_rate)
    targets = [by_rate[rates[i % len(rates)]][i] for i in range(n)]
    prom = _hand_prom([(t, {"namespace": FLEET_NS}) for t in targets])
    try:
        # the targets' counters advance with wall time at their rates: the
        # clusters' construction spaces the second scrape from the first
        clusters = {backend: fleet_cluster(n) for backend in ("cuda", "torch")}
        prom.scrape_once()
        records = {}
        for backend, device in (("cuda", None), ("torch", "cpu")):
            reset_fleet_state()
            rec = Reconciler(clusters[backend], HttpPromClient(PromConfig(
                base_url=prom.url, allow_http=True)), ReconcilerConfig(
                compute_backend=backend, compute_device=device, keep_accelerator=False))
            if backend == "cuda":
                report, ms, launches, _ = _counted_cycle(rec)
            else:
                report, ms = _timed(rec.run_cycle)
                launches = None
                if report.errors or not report.optimization_ok:
                    raise AssertionError(f"19c torch: {report.errors[:3]}")
            records[backend] = report.decisions
            print(f"  backend {backend}{' (cpu)' if device else ''}: {ms:.1f} ms host a "
                  f"cycle, spans (ms) {_spans(report)}; {report.prom_queries} queries; "
                  f"{report.variants_applied} applied"
                  + (f"; launches stats_kernel {launches[0]}, bisect_kernel {launches[1]}"
                     if launches else ""))
            if report.prom_queries > P19_QUERY_BUDGET or report.variants_applied != n:
                raise AssertionError(f"19c {backend}: {report.prom_queries} queries, "
                                     f"{report.variants_applied} applied")
            if launches is not None and not (launches[0] and launches[1]):
                raise AssertionError(f"19c: launches {launches}")
            rec.close()
        boundary = _same_records(records["cuda"], records["torch"], "19c cuda vs torch")
        moved = sum(r.replicas > 1 for r in records["cuda"])
        print(f"  decisions: cuda as torch on the CPU ({boundary} ±1 boundary variants; "
              f"{moved} of {n} above one replica)")
        if moved < n // 4:
            raise AssertionError(f"19c: only {moved} variants scaled")
    finally:
        prom.stop()
    reset_fleet_state()


def _phase19():
    """19. the controller over real sockets on backend cuda."""
    os.environ["LOG_LEVEL"] = "warn"
    _phase19a()
    _phase19b()
    _phase19c()


def _phase20(smi):
    """20. backend native (the C++ solver, on the host) beside backend cuda
    on phase 4's 10k edge fleet."""
    import numpy as np

    from inferno_tpu_torch import native
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.parallel import build_fleet, build_tandem_fleet, reset_fleet_state
    from inferno_tpu_torch.parallel.fleet import _check_backend, _solve_or_replay
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    print(f"20. backend native beside backend cuda, 10k edge fleet; {smi}; "
          f"os.cpu_count() {os.cpu_count()}")
    t0 = time.perf_counter()
    native._load()  # builds with g++ (raises if it cannot)
    print(f"  native library {os.path.relpath(native._lib_path(), ROOT)} built/loaded in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    reset_fleet_state()
    spec = fleet_system_spec(10000, **FLEET_KW)
    system = System(spec)
    for server in system.servers.values():
        server.all_allocations = {}
    plan, tandem = build_fleet(system), build_tandem_fleet(system)
    out, ms = {}, {}
    dev = _check_backend("cuda", None)
    for backend, device in (("native", None), ("cuda", dev), ("native", None), ("cuda", dev)):
        reset_fleet_state()  # no solve memo: each pass solves
        res, t = _timed(lambda: _solve_or_replay(plan, tandem, device, backend))
        out[backend] = res
        ms.setdefault(backend, []).append(t)
    lanes = 0
    for label, a, b in (("agg", out["native"][0], out["cuda"][0]),
                        ("tan", out["native"][1], out["cuda"][1])):
        a = [np.asarray(f) for f in a]
        b = [np.asarray(f) for f in b]
        fa, fb = a[0].astype(bool), b[0].astype(bool)
        if not np.array_equal(fa, fb):
            raise AssertionError(f"20 {label}: feasibility differs in {int((fa != fb).sum())} lanes")
        reps = np.abs(a[3][fa].astype(np.int64) - b[3][fa].astype(np.int64))
        rs = np.abs(a[2][fa] - b[2][fa]) / np.abs(a[2][fa])
        itl = np.abs(a[5][fa] - b[5][fa]) / np.abs(a[5][fa])
        print(f"  {label}: {len(fa)} lanes, {int(fa.sum())} feasible; replicas differ in "
              f"{int((reps != 0).sum())} (max {int(reps.max(initial=0))}); rate_star max rel "
              f"{rs.max(initial=0):.3g}, itl max rel {itl.max(initial=0):.3g}")
        if reps.max(initial=0) > 1 or rs.max(initial=0) > P20_RTOL or itl.max(initial=0) > P20_RTOL:
            raise AssertionError(f"20 {label}: native vs cuda outside the tolerances")
        lanes += len(fa)
    # a cold full pass through each backend (INCREMENTAL_CYCLE=0 for both:
    # native never takes the incremental cycle; the fleet state is reset
    # before each)
    os.environ["INCREMENTAL_CYCLE"] = "0"
    passes = {}
    for backend in ("native", "cuda", "native", "cuda"):
        reset_fleet_state()
        passes.setdefault(backend, []).append(_size_fleet(System(spec), backend)[1])
    del os.environ["INCREMENTAL_CYCLE"]
    reset_fleet_state()
    print(f"  {lanes} lanes solved (plans to results, host ms, two passes each): native "
          f"{', '.join(f'{t:.1f}' for t in ms['native'])}, cuda "
          f"{', '.join(f'{t:.1f}' for t in ms['cuda'])}; cold calculate_fleet + "
          f"solve_unlimited (INCREMENTAL_CYCLE=0): native {', '.join(f'{t:.1f}' for t in passes['native'])}, "
          f"cuda {', '.join(f'{t:.1f}' for t in passes['cuda'])}; {smi}; "
          f"os.cpu_count() {os.cpu_count()}")


# phase 21: the lane mesh on the card (one card: the shards run in turn
# on it), the port's graft entry, and the dry run on NCCL
P21_SHARDS = 4
P21_WEEK_ROWS = 6
P21_MOVE = 0.01


def _result_bit_diffs(a, b):
    """Lanes of two host FleetResults that differ in any bit of any field."""
    import numpy as np

    bad = np.zeros(len(a[0]), bool)
    for fa, fb in zip(a, b):
        fa, fb = np.ascontiguousarray(fa), np.ascontiguousarray(fb)
        bad |= (fa.view(np.uint8).reshape(len(fa), -1)
                != fb.view(np.uint8).reshape(len(fb), -1)).any(axis=1)
    return int(bad.sum())


def _memo_results():
    """The host results (agg, tandem) of the last full pass (solve memo)."""
    from inferno_tpu_torch.parallel import fleet

    return fleet._solve_memo["last"]["results"]


def _state_tables():
    """Copies of the incremental state's result tables, per lane kind."""
    from inferno_tpu_torch.parallel import incremental

    return {k: [getattr(t.res, f).copy() for f in incremental._RESULT_FIELDS]
            for k, t in incremental._state.kinds.items()}


def _phase21_full(spec, mesh, label):
    """A cold full pass (INCREMENTAL_CYCLE=0) on a fresh System: launches,
    host results, decisions, and three warm passes (loads perturbed)."""
    from inferno_tpu_torch.config.types import SystemSpec
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
    from inferno_tpu_torch.solver import solve_unlimited
    from inferno_tpu_torch.testing.fleet import perturb_loads

    reset_fleet_state()
    system = System(SystemSpec.from_dict(spec.to_dict()))
    os.environ["INCREMENTAL_CYCLE"] = "0"
    try:
        cuda_queueing.LAUNCHES = 0
        cuda_queueing.BISECT_LAUNCHES = 0
        _, cold = _timed(lambda: (calculate_fleet(system, backend="cuda", mesh=mesh),
                                  solve_unlimited(system)))
        counts = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
        results = _memo_results()
        decisions = _decisions(system)
        warm = []
        for _ in range(3):
            perturb_loads(system)
            warm.append(_timed(lambda: (calculate_fleet(system, backend="cuda", mesh=mesh),
                                        solve_unlimited(system)))[1])
    finally:
        del os.environ["INCREMENTAL_CYCLE"]
    print(f"  {label}: full pass cold {cold:.1f} ms, warm {', '.join(f'{t:.1f}' for t in warm)} "
          f"ms; launches stats_kernel {counts[0]}, bisect_kernel {counts[1]}")
    return counts, results, decisions, warm


def _phase21_incremental(spec, mesh, label):
    """Cold, then 1% λ moved (seed 21): each cycle's launches, dispatched
    buckets, state tables and decisions."""
    import numpy as np

    from inferno_tpu_torch.config.types import SystemSpec
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.parallel import reset_fleet_state

    reset_fleet_state()
    system = System(SystemSpec.from_dict(spec.to_dict()))
    rng = np.random.default_rng(21)
    out = []
    for step in ("cold", "1% λ"):
        if step != "cold":
            _move_rates(system, rng, P21_MOVE)
        spy, counts, ms = _cycle(system, "cuda", mesh=mesh)
        out.append((counts, spy.expected(), _state_tables(), _decisions(system), ms))
        print(f"  {label}, incremental {step}: {ms:.1f} ms; launches stats_kernel "
              f"{counts[0]}, bisect_kernel {counts[1]} ({len(spy.slots)} buckets)")
    return out


def _phase21_entries(spec, mesh):
    """21(b). the public solve entries on the card: solve_fleet and
    solve_tandem_fleet on the plans of a cold full pass give what
    calculate_fleet(cuda) solved for them, bit for bit, launching both
    kernels as the main path does for buckets of their kind; over `mesh`
    the same bits at mesh.size x the launches."""
    from inferno_tpu_torch.config.types import SystemSpec
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import (
        calculate_fleet,
        fleet,
        reset_fleet_state,
        solve_fleet,
        solve_tandem_fleet,
    )

    reset_fleet_state()
    system = System(SystemSpec.from_dict(spec.to_dict()))
    os.environ["INCREMENTAL_CYCLE"] = "0"
    try:
        calculate_fleet(system, backend="cuda")
    finally:
        del os.environ["INCREMENTAL_CYCLE"]
    memo = fleet._solve_memo["last"]
    entries = (("agg", solve_fleet, memo["plan"], memo["results"][0]),
               ("tan", solve_tandem_fleet, memo["tandem"], memo["results"][1]))
    for kind, entry, plan, want in entries:
        n = len(fleet.bucket_slots(*((plan, None) if kind == "agg" else (None, plan))))
        per_pass = (STATS_LAUNCHES_PER_BUCKET[kind] * n, BISECT_LAUNCHES_PER_BUCKET * n)
        for m in (None, mesh):
            size = 1 if m is None else m.size
            cuda_queueing.LAUNCHES = 0
            cuda_queueing.BISECT_LAUNCHES = 0
            res, ms = _timed(lambda: entry(plan, mesh=m))
            counts = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
            diff = _result_bit_diffs(res, want)
            print(f"  21(b) {entry.__name__}({kind} plan, {plan.num_lanes} lanes, {n} buckets"
                  f"{'' if m is None else f', mesh of {size}'}): {diff} lanes differ in a bit "
                  f"from calculate_fleet(cuda)'s solve; launches stats_kernel {counts[0]}, "
                  f"bisect_kernel {counts[1]} (expected {size} x {per_pass}); {ms:.1f} ms")
            if diff:
                raise AssertionError(f"21(b): {entry.__name__} differs from calculate_fleet")
            if counts != (per_pass[0] * size, per_pass[1] * size):
                raise AssertionError(f"21(b): {entry.__name__} launched {counts}, expected "
                                     f"{size} x {per_pass}")
    reset_fleet_state()


def _phase21(smi):
    """21. the lane mesh on the card, the graft entry, the NCCL dry run."""
    import numpy as np
    import torch

    from inferno_tpu_torch import graft_entry
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.ops import queueing as q
    from inferno_tpu_torch.parallel import calculate_fleet_batch, fleet_mesh, reset_fleet_state
    from inferno_tpu_torch.planner.scenarios import base_rates_from_system, diurnal
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    count = torch.cuda.device_count()
    print(f"21. the lane mesh on the card ({count} visible), {smi}")
    spec = fleet_system_spec(10000, **FLEET_KW)
    meshes = [(None, "unsharded"),
              (fleet_mesh(devices=["cuda:0"] * P21_SHARDS), f"{P21_SHARDS} shards on cuda:0"),
              (fleet_mesh(), f"fleet_mesh() ({count} device)")]

    # (a) the full path
    full = {label: _phase21_full(spec, mesh, label) for mesh, label in meshes}
    base_counts, base_res, base_dec, base_warm = full["unsharded"]
    for mesh, label in meshes[1:]:
        counts, res, dec, warm = full[label]
        size = 1 if mesh is None or mesh.size <= 1 else mesh.size
        diff = sum(_result_bit_diffs(a, b) for a, b in zip(res, base_res) if a is not None)
        lanes = sum(len(a[0]) for a in res if a is not None)
        same = dec == base_dec
        print(f"  {label}: {diff} of {lanes} lanes differ in a bit from the unsharded pass; "
              f"decisions {'identical' if same else 'DIFFER'} ({sum(d is not None for d in dec.values())} "
              f"servers allocated); launches per shard {counts[0] / size:g} + "
              f"{counts[1] / size:g}; warm median sharded "
              f"{statistics.median(warm):.1f} ms, unsharded {statistics.median(base_warm):.1f} ms")
        if diff or not same:
            raise AssertionError(f"21(a) {label}: the sharded full pass differs from the unsharded")
        if counts != (base_counts[0] * size, base_counts[1] * size):
            raise AssertionError(f"21(a) {label}: launches {counts}, expected {size} x {base_counts}")

    # (a) the incremental path: cold, then one 1% λ cycle
    incr = {label: _phase21_incremental(spec, mesh, label) for mesh, label in meshes}
    for mesh, label in meshes[1:]:
        size = 1 if mesh is None or mesh.size <= 1 else mesh.size
        for step, got, want in zip(("cold", "1% λ"), incr[label], incr["unsharded"]):
            counts, expected, tables, dec, _ = got
            diff = sum(_result_bit_diffs(tables[k], want[2][k]) for k in tables)
            lanes = sum(len(t[0]) for t in tables.values())
            print(f"  {label}, incremental {step}: {diff} of {lanes} lanes differ in a bit; "
                  f"decisions {'identical' if dec == want[3] else 'DIFFER'}; launches per "
                  f"shard {counts[0] / size:g} + {counts[1] / size:g} (the buckets make "
                  f"{expected[0]} + {expected[1]})")
            if diff or dec != want[3]:
                raise AssertionError(f"21(a) {label} {step}: sharded cycle differs")
            if counts != (expected[0] * size, expected[1] * size):
                raise AssertionError(f"21(a) {label} {step}: launches {counts}, expected "
                                     f"{size} x {expected}")
    mesh4 = meshes[1][0]

    # (b) the public entries solve_fleet / solve_tandem_fleet
    _phase21_entries(spec, mesh4)

    # (c) six timesteps of the week through the prep, sharded and not
    system = System(spec)
    trace = diurnal(base_rates_from_system(system), 168, 3600.0, seed=0)
    rows = trace.rates[:: 168 // P21_WEEK_ROWS][:P21_WEEK_ROWS]
    got = {}
    for mesh, label in meshes[:2]:
        reset_fleet_state()
        got[label], ms = _timed(lambda: calculate_fleet_batch(System(spec), rows,
                                                              backend="cuda", mesh=mesh))
        print(f"  21(c) {label}: {P21_WEEK_ROWS} week rows in {ms:.1f} ms")
    for field in ("choice", "replicas", "chips", "cost", "value"):
        a, b = getattr(got[meshes[1][1]], field), getattr(got["unsharded"], field)
        if not np.array_equal(a, b):
            raise AssertionError(f"21(c): the sharded prep's {field} differs")
    print(f"  21(c) the week prep over {P21_SHARDS} shards equals the unsharded one on "
          f"{P21_WEEK_ROWS} rows (choice, replicas, chips, cost, value)")
    reset_fleet_state()

    # (d) the graft entry on the card against its plain version
    fn, args = graft_entry.entry()
    cuda_queueing.LAUNCHES = 0
    cuda_queueing.BISECT_LAUNCHES = 0
    res, ms = _timed(lambda: fn(*args))
    counts = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
    plain = q.fleet_size(args[0], graft_entry.K_MAX, use_kernel=False)
    boundary = _entry_match(res, plain)
    print(f"  21(d) graft_entry.entry(): 64 lanes at K={graft_entry.K_MAX} in {ms:.1f} ms, "
          f"launches {counts[0]} + {counts[1]}; equal to the plain version ({boundary} ±1 "
          f"boundary lanes)")
    if counts != (4, 2):
        raise AssertionError(f"21(d): entry launched {counts}, expected (4, 2)")

    # (e) the dry run on NCCL, one rank a card
    report, ms = _timed(lambda: graft_entry.dryrun_multichip(count, timeout=300))
    print(f"  21(e) dryrun_multichip({count}) on {report['backend']}: mesh (dp, tp) = "
          f"({report['dp']}, {report['tp']}), losses {report['losses'][0]:.6f} -> "
          f"{report['losses'][-1]:.6f} (one device: {report['single_losses'][0]:.6f} -> "
          f"{report['single_losses'][-1]:.6f}), fleet and tandem lanes "
          f"{report['fleet_lanes']} / {report['tandem_lanes']}; {ms:.1f} ms")
    if report["backend"] != "nccl" or (count == 1 and report["losses"] != report["single_losses"]):
        raise AssertionError("21(e): the (1, 1) step differs from the one-device step")


def _entry_match(got, want):
    """The port's rule for sizing results (kernel against plain version):
    feasibility exact, replicas exact except ±1 where rate_star agrees
    within 1e-4, rate_star and lambda_star within 1e-4, cost 1e-5 and
    itl/ttft/rho within 5e-3 off the boundary lanes; returns the boundary
    lanes."""
    import numpy as np

    g = {k: v.cpu().numpy() for k, v in got._asdict().items()}
    w = {k: v.cpu().numpy() for k, v in want._asdict().items()}
    if not np.array_equal(g["feasible"], w["feasible"]):
        raise AssertionError("21(d): feasibility differs")
    for name in ("rate_star", "lambda_star"):
        np.testing.assert_allclose(g[name], w[name], rtol=1e-4, err_msg=name)
    diff = g["num_replicas"].astype(np.int64) - w["num_replicas"].astype(np.int64)
    boundary = (np.abs(diff) == 1) & np.isclose(g["rate_star"], w["rate_star"], rtol=1e-4, atol=0)
    if not np.all((diff == 0) | boundary):
        raise AssertionError("21(d): replicas differ off the ±1 boundary")
    keep = ~boundary
    np.testing.assert_allclose(g["cost"][keep], w["cost"][keep], rtol=1e-5)
    for name in ("itl", "ttft", "rho"):
        np.testing.assert_allclose(g[name][keep], w[name][keep], rtol=TOL, err_msg=name)
    return int(boundary.sum())


# phase 22: the installed copy on the card. The child runs from a `pip
# install --target` of a wheel of the tree, with the checkout off sys.path.
P22_PIP_TIMEOUT_S = 300
P22_RUN_TIMEOUT_S = 600
_P22_CHILD = """
import os, pickle, sys, time
target, repo, out = sys.argv[1:4]
assert not any(os.path.abspath(p or ".").startswith(repo) for p in sys.path), sys.path
import torch
import inferno_tpu_torch
from inferno_tpu_torch.core.system import System
from inferno_tpu_torch.ops import cuda_queueing
from inferno_tpu_torch.parallel import calculate_fleet, fleet
from inferno_tpu_torch.solver import solve_unlimited
from inferno_tpu_torch.testing.fleet import fleet_system_spec

package = os.path.join(target, "inferno_tpu_torch")
assert inferno_tpu_torch.__file__.startswith(package + os.sep), inferno_tpu_torch.__file__
t0 = time.perf_counter()
lib = cuda_queueing.build()  # nvcc, inside the installed package
build_s = time.perf_counter() - t0
assert os.path.dirname(lib) == os.path.join(package, "ops", "_build"), lib
os.environ["INCREMENTAL_CYCLE"] = "0"
system = System(fleet_system_spec(10000, **FLEET_KW))
cuda_queueing.LAUNCHES = 0
cuda_queueing.BISECT_LAUNCHES = 0
calculate_fleet(system, backend="cuda")
solve_unlimited(system)
torch.cuda.synchronize()
counts = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
decisions = {}
for name, server in system.servers.items():
    a = server.allocation
    decisions[name] = None if a is None else (
        a.accelerator, a.num_replicas, a.cost, a.value, a.spot_replicas, a.itl, a.ttft, a.rho)
with open(out, "wb") as f:
    pickle.dump(dict(lib=lib, build_s=build_s, build_log=cuda_queueing.BUILD_LOG,
                     counts=counts, results=fleet._solve_memo["last"]["results"],
                     decisions=decisions), f)
"""


def _install_copy(tmp):
    """A wheel of the checkout's tree (a copy without caches or built
    libraries), installed with `pip install --target`; returns the target."""
    import shutil

    src = os.path.join(tmp, "src")
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "_build")
    for pkg in ("inferno_tpu", "inferno_tpu_torch"):
        shutil.copytree(os.path.join(ROOT, pkg), os.path.join(src, pkg), ignore=ignore)
    shutil.copy(os.path.join(ROOT, "pyproject.toml"), src)
    wheels, target = os.path.join(tmp, "wheels"), os.path.join(tmp, "site")
    pip = [sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-input"]
    subprocess.run([*pip, "wheel", "--no-deps", "--no-build-isolation", "--no-index",
                    "-w", wheels, src],
                   check=True, capture_output=True, text=True, timeout=P22_PIP_TIMEOUT_S)
    (wheel,) = [os.path.join(wheels, w) for w in os.listdir(wheels) if w.endswith(".whl")]
    subprocess.run([*pip, "install", "--no-deps", "--no-index", "--target", target, wheel],
                   check=True, capture_output=True, text=True, timeout=P22_PIP_TIMEOUT_S)
    return target


def _phase22(smi, main_counts):
    """22. the installed copy on the card: nvcc builds the kernel library
    inside the installed package, and its pass over phase 4's 10k edge
    fleet equals the checkout's bit for bit."""
    import pickle

    from inferno_tpu_torch.config.types import SystemSpec
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
    from inferno_tpu_torch.solver import solve_unlimited
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    print(f"22. the installed copy on the card, {smi}")
    spec = fleet_system_spec(10000, **FLEET_KW)
    with tempfile.TemporaryDirectory(prefix="inferno-install-") as tmp:
        t0 = time.perf_counter()
        target = _install_copy(tmp)
        print(f"  wheel built and installed with pip --target in "
              f"{time.perf_counter() - t0:.1f} s")
        work, out = os.path.join(tmp, "work"), os.path.join(tmp, "child.pkl")
        os.mkdir(work)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = target
        code = f"FLEET_KW = {FLEET_KW!r}\n" + _P22_CHILD
        proc = subprocess.run([sys.executable, "-c", code, target, ROOT, out], cwd=work,
                              env=env, capture_output=True, text=True,
                              timeout=P22_RUN_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"22: the installed copy failed (rc={proc.returncode}):\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(out, "rb") as f:
            child = pickle.load(f)
    print(f"  the installed copy built {os.path.relpath(child['lib'], target)} (under the "
          f"--target directory) in {child['build_s']:.1f} s; {smi}")
    print("  " + child["build_log"].splitlines()[0])

    # the checkout's pass, the same way
    reset_fleet_state()
    system = System(SystemSpec.from_dict(spec.to_dict()))
    os.environ["INCREMENTAL_CYCLE"] = "0"
    try:
        cuda_queueing.LAUNCHES = 0
        cuda_queueing.BISECT_LAUNCHES = 0
        calculate_fleet(system, backend="cuda")
        solve_unlimited(system)
        _sync()
        counts = (cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES)
        results = _memo_results()
        decisions = _decisions(system)
    finally:
        del os.environ["INCREMENTAL_CYCLE"]
    reset_fleet_state()
    diff = sum(_result_bit_diffs(a, b) for a, b in zip(child["results"], results)
               if a is not None)
    lanes = sum(len(a[0]) for a in results if a is not None)
    same = child["decisions"] == decisions
    print(f"  installed vs checkout: {diff} of {lanes} lanes differ in a bit; decisions "
          f"{'identical' if same else 'DIFFER'} ({sum(d is not None for d in decisions.values())} "
          f"servers allocated); launches stats_kernel + bisect_kernel {child['counts'][0]} + "
          f"{child['counts'][1]} installed, {counts[0]} + {counts[1]} checkout, "
          f"{main_counts[0]} + {main_counts[1]} on the main path (phase 4)")
    if diff or not same:
        raise AssertionError("22: the installed copy's pass differs from the checkout's")
    if not (tuple(child["counts"]) == counts == tuple(main_counts)):
        raise AssertionError(f"22: launches {child['counts']} / {counts}, expected {main_counts}")


# phase 23: the port as it ships. Dockerfile.torch's build command runs on a
# copy of the port's files, the wheel is installed with `pip install
# --no-deps --target`, and `python -m inferno_tpu_torch.controller.main`
# runs from that read-only copy (no nvcc on PATH) under the H100 overlay's
# manager env, against a 2,000-variant cluster over sockets: a MiniApiServer
# behind TLS (RestKubeClient speaks https only) and MiniProm over HTTP.
# cut from the 5k reconcile cell: the controller's status writes and
# workload reads are serial HTTPS round trips (about 22 ms a variant a cycle
# against the MiniApiServer on the card's host), so three cycles of 5,000
# would not fit the phase's limit (PERF.md section 4)
P23_VARIANTS = 2000
P23_CYCLES = 3
# the shipped ConfigMap's interval (deploy/manifests/configmaps.yaml): the
# phase wakes the loop after each cycle with a ConfigMap edit (the watch
# path) instead of waiting it out, and /readyz keeps its 3x budget
P23_INTERVAL = "60s"
P23_TIMEOUT_S = 300  # the whole phase, build included
P23_STOP_S = 30  # SIGTERM to exit
# the overlay's memory limit must hold the controller's peak RSS with this
# margin (deploy/overlays/h100/manager-patch.yaml; PERF.md section 4)
P23_MEMORY_MARGIN = 0.5
P23_PROM_WINDOW_S = 900.0  # two scrapes hold every rate still for the phase
P23_PORT_FILES = ("pyproject.toml", "README.md", "inferno_tpu_torch")
_P23_CHILD = """
import atexit, json, resource, runpy, sys
out = sys.argv[1]
sys.argv = sys.argv[:1]


def _rss_kb():
    with open("/proc/self/status") as f:
        return int(dict(line.split(":", 1) for line in f if ":" in line)["VmRSS"].split()[0])


rss_start_kb = _rss_kb()
# a forked child's ru_maxrss starts from its parent's: kept to show it
maxrss_start_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
import torch  # what the entry imports first; its share of the RSS is read here
rss_torch_kb = _rss_kb()


def _dump():
    import inferno_tpu_torch
    from inferno_tpu_torch.ops import cuda_queueing

    lib = cuda_queueing._lib
    with open(out, "w") as f:
        json.dump(dict(
            build_log=cuda_queueing.BUILD_LOG,
            lib=None if lib is None else lib._name,
            launches=[cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES],
            package=inferno_tpu_torch.__file__,
            max_memory_reserved=torch.cuda.max_memory_reserved(),
            ru_maxrss_kb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
            maxrss_start_kb=maxrss_start_kb, rss_start_kb=rss_start_kb,
            rss_torch_kb=rss_torch_kb, rss_exit_kb=_rss_kb(),
        ), f)


atexit.register(_dump)
runpy.run_module("inferno_tpu_torch.controller.main", run_name="__main__")
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tree_snapshot(root):
    """{relative path: (size, sha256)} of every file, and None for every
    directory, under `root`."""
    import hashlib

    snap = {}
    for d, dirs, files in os.walk(root):
        for name in dirs:
            snap[os.path.relpath(os.path.join(d, name), root)] = None
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                snap[os.path.relpath(path, root)] = (
                    os.path.getsize(path), hashlib.sha256(f.read()).hexdigest())
    return snap


def _chmod_tree(root, writable):
    """`chmod -R a-w` (or u+w again, so that the temporary directory can go)."""
    import stat

    for d, _, files in os.walk(root):
        for path in [d] + [os.path.join(d, name) for name in files]:
            mode = os.stat(path).st_mode
            os.chmod(path, (mode | stat.S_IWUSR) if writable
                     else mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))


def _overlay_env():
    """The manager container's env and command under deploy/overlays/h100:
    the base manifest's env with the overlay patch's entries merged in by
    name (a strategic merge patch's rule for env); the downward-API
    POD_NAMESPACE takes the Deployment's own namespace."""
    import yaml

    with open(os.path.join(ROOT, "deploy", "manifests", "manager.yaml")) as f:
        base = yaml.safe_load(f)
    with open(os.path.join(ROOT, "deploy", "overlays", "h100", "manager-patch.yaml")) as f:
        patch = yaml.safe_load(f)

    def manager(doc):
        (c,) = [c for c in doc["spec"]["template"]["spec"]["containers"]
                if c["name"] == "manager"]
        return c

    env = {}
    for entry in manager(base)["env"] + manager(patch)["env"]:
        if "value" in entry:
            env[entry["name"]] = entry["value"]
        elif entry["valueFrom"]["fieldRef"]["fieldPath"] == "metadata.namespace":
            env[entry["name"]] = base["metadata"]["namespace"]
        else:
            raise AssertionError(f"23: no value for the overlay's {entry['name']}")
    return env, manager(patch)["command"]


def _tls_api(tmp):
    """A MiniApiServer behind TLS (a self-signed cert for IP:127.0.0.1, made
    with openssl); returns (server, cert path)."""
    import ssl

    from inferno_tpu_torch.testing import MiniApiServer

    cert, key = os.path.join(tmp, "api.crt"), os.path.join(tmp, "api.key")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
                    key, "-out", cert, "-days", "1", "-subj", "/CN=127.0.0.1",
                    "-addext", "subjectAltName=IP:127.0.0.1"],
                   check=True, capture_output=True)
    api = MiniApiServer()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    api._httpd.socket = ctx.wrap_socket(api._httpd.socket, server_side=True)
    return api, cert


def _load_api(api, cluster):
    """The in-memory cluster's VariantAutoscalings, Deployments and
    ConfigMaps, checked against the CRD schema and stored in the API server
    as its POST handler stores them; returns their number."""
    objects = [("VariantAutoscaling", va.namespace, va.name, va.to_dict())
               for va in cluster.list_variant_autoscalings()]
    objects += [("Deployment", ns, name, dep) for (ns, name), dep in cluster._deployments.items()]
    objects += [("ConfigMap", ns, name, {"metadata": {"name": name, "namespace": ns},
                                         "data": data})
                for (ns, name), data in cluster._configmaps.items()]
    for kind, ns, name, body in objects:
        api.validate(kind, body)
        with api.store.lock:
            stored = api._stamp(kind, ns, name, body)
            api.store.objects[(kind, ns, name)] = stored
            api.store.record(kind, "ADDED", stored)
    return len(objects)


def _get(url):
    """(status, body) of a GET."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.read()


def _rss_kb(pid):
    """VmRSS of a process, in kB."""
    with open(f"/proc/{pid}/status") as f:
        fields = dict(line.split(":", 1) for line in f if ":" in line)
    return int(fields["VmRSS"].split()[0])


def _p23_build(tmp):
    """Dockerfile.torch's build command on a copy of the port's files (no
    built library, no cache), with no card visible; then the wheel installed
    with pip --no-deps --target. Returns (target, the shipped libraries
    {path in the package: (bytes, sha256)})."""
    import hashlib
    import shutil

    with open(os.path.join(ROOT, "Dockerfile.torch")) as f:
        (cmd,) = [line[len("RUN "):].strip() for line in f
                  if line.startswith("RUN python -m inferno_tpu_torch.tools.prebuild")]
    src = os.path.join(tmp, "src")
    os.mkdir(src)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "_build")
    for name in P23_PORT_FILES:
        path = os.path.join(ROOT, name)
        if os.path.isdir(path):
            shutil.copytree(path, os.path.join(src, name), ignore=ignore)
        else:
            shutil.copy(path, src)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # a build box without a card
    t0 = time.perf_counter()
    proc = subprocess.run(["sh", "-c", cmd], cwd=src, env=env, capture_output=True, text=True,
                          timeout=P23_TIMEOUT_S)
    build_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"23: the build command failed (rc={proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("inferno_tpu_torch/")]
    (wheel,) = [os.path.join(src, "dist", w) for w in os.listdir(os.path.join(src, "dist"))]
    target = os.path.join(tmp, "site")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-input",
                    "install", "--no-deps", "--no-index", "--target", target, wheel],
                   check=True, capture_output=True, text=True, timeout=P22_PIP_TIMEOUT_S)
    install_s = time.perf_counter() - t0
    shipped = {}
    for d in ("ops/_build", "native"):
        for name in sorted(os.listdir(os.path.join(target, "inferno_tpu_torch", d))):
            if not name.endswith(".so"):
                continue
            digests = []
            for tree in (target, src):
                with open(os.path.join(tree, "inferno_tpu_torch", d, name), "rb") as f:
                    digests.append(hashlib.sha256(f.read()).hexdigest())
            if digests[0] != digests[1]:
                raise AssertionError(f"23: {name} in the wheel is not the one built")
            path = os.path.join(target, "inferno_tpu_torch", d, name)
            shipped[os.path.join("inferno_tpu_torch", d, name)] = (os.path.getsize(path),
                                                                   digests[0])
    print(f"  build command ({cmd!r}): {build_s:.1f} s with no card visible, of which the "
          f"libraries (path, bytes, seconds): {'; '.join(lines)}")
    print(f"  wheel {os.path.basename(wheel)} installed with pip --no-deps --target in "
          f"{install_s:.1f} s; it ships "
          + ", ".join(f"{k} ({v[0]} bytes)" for k, v in shipped.items()))
    return target, shipped


def _p23_checkout_records(env, prom_url, cluster):
    """One in-process cycle of the checkout's Reconciler under the same env
    (so the same ReconcilerConfig) over the same cluster contents and
    MiniProm: its decision records."""
    from inferno_tpu_torch.controller import Reconciler
    from inferno_tpu_torch.controller.main import prom_config_from_env, reconciler_config_from_env
    from inferno_tpu_torch.controller.promclient import HttpPromClient
    from inferno_tpu_torch.parallel import reset_fleet_state

    saved = dict(os.environ)
    os.environ.update(env)
    try:
        config = reconciler_config_from_env()
        prom_config = prom_config_from_env()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    if config.compute_backend != env["COMPUTE_BACKEND"] or prom_config.base_url != prom_url:
        raise AssertionError(f"23: checkout config {config.compute_backend}, "
                             f"{prom_config.base_url}")
    reset_fleet_state()
    rec = Reconciler(cluster, HttpPromClient(prom_config), config)
    report, ms, launches, _ = _counted_cycle(rec)
    rec.close()
    reset_fleet_state()
    print(f"  the checkout's Reconciler in process (backend {config.compute_backend}, the "
          f"same env, the same MiniProm, an in-memory copy of the cluster): {ms:.1f} ms host "
          f"a cycle, spans (ms) {_spans(report)}; launches stats_kernel {launches[0]}, "
          f"bisect_kernel {launches[1]}")
    return report.decisions


def _p23_compare(api, child_decisions, checkout):
    """Every VA's status in the API server against the child's last
    decision records (exactly), and those against the checkout's records
    (ROADMAP's ±1 rule); returns (boundary variants, variants above one
    replica)."""
    from types import SimpleNamespace

    by_variant = {d["variant"]: SimpleNamespace(**{
        k: d[k] for k in ("variant", "reason", "accelerator", "replicas", "lambda_max_rpm")})
        for d in child_decisions}
    if sorted(by_variant) != sorted(r.variant for r in checkout):
        raise AssertionError("23: the controller and the checkout decided other variants")
    # the API server lists by name, the in-memory cluster in insertion order
    mine = [by_variant[r.variant] for r in checkout]
    boundary = _same_records(checkout, mine, "23 shipped vs checkout")
    with api.store.lock:
        vas = [obj for (kind, _, _), obj in api.store.objects.items()
               if kind == "VariantAutoscaling"]
    if len(vas) != len(mine):
        raise AssertionError(f"23: {len(vas)} VAs, {len(mine)} decisions")
    for obj in vas:
        meta = obj["metadata"]
        want = by_variant[f"{meta['name']}:{meta['namespace']}"]
        alloc = obj.get("status", {}).get("desiredOptimizedAlloc", {})
        if (alloc.get("numReplicas"), alloc.get("accelerator")) != (want.replicas,
                                                                    want.accelerator):
            raise AssertionError(f"23: {meta['name']}: status {alloc} vs the decision "
                                 f"{want.replicas}/{want.accelerator}")
    return boundary, sum(d.replicas > 1 for d in mine)


def _p23_cluster(n, config_ns):
    """`fleet_cluster(n)` with the loop's interval set in its ConfigMap."""
    from inferno_tpu_torch.testing.fleet import fleet_cluster

    cluster = fleet_cluster(n)
    cm = dict(cluster._configmaps[(config_ns, "inferno-autoscaler-config")])
    cm["GLOBAL_OPT_INTERVAL"] = P23_INTERVAL
    cluster.set_configmap(config_ns, "inferno-autoscaler-config", cm)
    return cluster


def _p23_poke(api, config_ns, cert):
    """An edit of the controller's ConfigMap through the API server (an
    annotation): its watch event wakes the reconcile loop."""
    import ssl
    import urllib.request

    url = (f"https://127.0.0.1:{api.port}/api/v1/namespaces/{config_ns}/configmaps/"
           "inferno-autoscaler-config")
    body = {"metadata": {"annotations": {"inferno.test/poke": str(time.time())}}}
    req = urllib.request.Request(url, method="PATCH", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/merge-patch+json"})
    urllib.request.urlopen(req, context=ssl.create_default_context(cafile=cert),
                           timeout=30).read()


def _p23_watch(proc, base, deadline, poke):
    """Poll the controller's /debug/profile and /debug/decisions until
    P23_CYCLES cycles are done (a cycle's decision trace is stored after
    its profile document); after each but the last, `poke()` wakes the
    loop. Returns the profile documents, the process's VmRSS read as each
    cycle ended, its highest VmRSS over the polls (every 0.2 s), when the
    first cycle was seen to end, and the last cycle's trace."""
    profiles, rss, ends = [], [], []
    peak = 0
    probe = f"{base}/debug/decisions?cycles=1&variant=none"
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"23: the controller exited (rc={proc.returncode})")
        if time.perf_counter() > deadline:
            raise AssertionError(f"23: {len(profiles)} of {P23_CYCLES} cycles in "
                                 f"{P23_TIMEOUT_S} s")
        time.sleep(0.2)
        peak = max(peak, _rss_kb(proc.pid))
        try:
            docs = json.loads(_get(f"{base}/debug/profile")[1])["cycles"]
            traced = json.loads(_get(probe)[1])["cycles"]
        except OSError:
            continue  # not listening yet
        if not traced or traced[-1]["seq"] != len(docs) or len(docs) == len(profiles):
            continue
        profiles.extend(docs[len(profiles):])
        rss.append(_rss_kb(proc.pid))
        ends.append(time.time())
        _stamp(f"23: cycle {len(profiles)} of the controller done")
        if len(profiles) >= P23_CYCLES:
            (last,) = json.loads(_get(f"{base}/debug/decisions?cycles=1")[1])["cycles"]
            return profiles[:P23_CYCLES], rss, peak, ends[0], last
        poke()


def _phase23(smi):
    """23. the shipped controller: the image's build command, a read-only
    --target install, `controller.main` over sockets at P23_VARIANTS."""
    import threading

    from inferno_tpu_torch.emulator.miniprom import MiniProm
    from inferno_tpu_torch.testing.fleet import FLEET_NS, fleet_targets

    n = P23_VARIANTS
    print(f"23. the shipped controller: Dockerfile.torch's build command, a read-only "
          f"pip --target install, python -m inferno_tpu_torch.controller.main at {n} "
          f"variants over sockets; {smi}")
    deadline = time.perf_counter() + P23_TIMEOUT_S
    env, command = _overlay_env()
    if command != ["python", "-m", "inferno_tpu_torch.controller.main"]:
        raise AssertionError(f"23: the overlay runs {command}")
    with tempfile.TemporaryDirectory(prefix="inferno-ship-") as tmp:
        target, shipped = _p23_build(tmp)
        before = _tree_snapshot(target)
        _chmod_tree(target, writable=False)
        api, cert = _tls_api(tmp)
        loaded = _load_api(api, _p23_cluster(n, env["CONFIG_NAMESPACE"]))
        first_write = []
        real_record = api.store.record

        def record(kind, event, obj):
            # the first status write that carries a decision (an earlier
            # one, in collect, writes conditions only)
            if (not first_write and kind == "VariantAutoscaling"
                    and obj.get("status", {}).get("desiredOptimizedAlloc", {}).get(
                        "lastRunTime")):
                first_write.append(time.time())
            real_record(kind, event, obj)

        api.store.record = record
        api.start()
        # seven arrival rates over the fleet, as in phase 19c
        by_rate = {r: fleet_targets(n, arrival_rps=r)
                   for r in (2.0, 10.0, 25.0, 40.0, 60.0, 80.0, 120.0)}
        rates = sorted(by_rate)
        prom = MiniProm([(by_rate[rates[i % len(rates)]][i], {"namespace": FLEET_NS})
                         for i in range(n)], window_seconds=P23_PROM_WINDOW_S)
        threading.Thread(target=prom._httpd.serve_forever, daemon=True).start()
        try:
            prom.scrape_once()
            time.sleep(1.0)
            prom.scrape_once()
            metrics_port, health_port = _free_port(), _free_port()
            env.update({"METRICS_PORT": str(metrics_port), "HEALTH_PORT": str(health_port),
                        "PROMETHEUS_BASE_URL": prom.url, "PROMETHEUS_ALLOW_HTTP": "true"})
            print(f"  cluster: {loaded} objects in a MiniApiServer behind TLS, reached "
                  f"through KUBERNETES_SERVICE_HOST/PORT and SSL_CERT_FILE; MiniProm over "
                  f"HTTP, {n} targets at seven arrival rates; the overlay's env "
                  f"{sorted((k, v) for k, v in env.items() if 'PORT' not in k)}")
            child, run = _p23_run(tmp, target, env, api, cert, deadline)
            if not first_write:
                raise AssertionError("23: the controller wrote no status")
            run["first_write"] = first_write[0]
            run["peak_kb"] = max(run["peak_kb"], child["rss_exit_kb"])
            _p23_report(run, child, target, smi)
            after = _tree_snapshot(target)
            changed = sorted(set(before) ^ set(after)
                             | {k for k in before if k in after and before[k] != after[k]})
            print(f"  installed tree: {len(before)} paths, {len(changed)} changed by the run")
            checkout = _p23_checkout_records(env, prom.url,
                                             _p23_cluster(n, env["CONFIG_NAMESPACE"]))
            boundary, moved = _p23_compare(api, run["last"]["decisions"], checkout)
        finally:
            prom.stop()
            api.stop()
            _chmod_tree(target, writable=True)

    print(f"  decisions: all {n} VAs' statuses in the API server equal the controller's "
          f"last decisions, and those equal the checkout's ({boundary} ±1 boundary "
          f"variants; {moved} of {n} above one replica)")
    lib_rel = child["lib"] and os.path.relpath(child["lib"], target)
    limit = _p23_memory_limit()
    print(f"  the overlay's memory limit {limit / 2**20:.0f} MiB against the peak RSS "
          f"{run['peak_kb'] / 1024:.1f} MiB with a {P23_MEMORY_MARGIN:.0%} margin")
    if child["build_log"] != "":
        raise AssertionError(f"23: the installed controller built: {child['build_log'][:300]}")
    if lib_rel not in shipped:
        raise AssertionError(f"23: loaded {child['lib']}, shipped {sorted(shipped)}")
    if not child["package"].startswith(os.path.join(target, "inferno_tpu_torch") + os.sep):
        raise AssertionError(f"23: the package came from {child['package']}")
    if changed:
        raise AssertionError(f"23: the run changed the installed tree: {changed[:10]}")
    if not (child["launches"][0] and child["launches"][1]):
        raise AssertionError(f"23: launches {child['launches']}")
    if run["probes"] != {"healthz": 200, "readyz": 200}:
        raise AssertionError(f"23: probes {run['probes']}")
    if moved < n // 4:
        raise AssertionError(f"23: only {moved} variants scaled")
    if run["peak_kb"] * 1024 * (1 + P23_MEMORY_MARGIN) > limit:
        raise AssertionError("23: the overlay's memory limit is below the peak RSS and "
                             "its margin")


def _p23_memory_limit():
    """The overlay's memory limit of the manager container, in bytes."""
    import yaml

    with open(os.path.join(ROOT, "deploy", "overlays", "h100", "manager-patch.yaml")) as f:
        patch = yaml.safe_load(f)
    (c,) = patch["spec"]["template"]["spec"]["containers"]
    value = c["resources"]["limits"]["memory"]
    return int(value[:-2]) * {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30}[value[-2:]]


def _p23_report(run, child, target, smi):
    """Print what the controller process did (before any check, so that a
    failed phase still shows its numbers)."""
    print(f"  time to first cycle: {run['first_write'] - run['t_start']:.2f} s from process "
          f"start to the first status write with a decision, "
          f"{run['first_cycle'] - run['t_start']:.2f} s to the end of the first cycle; "
          f"/healthz {run['probes']['healthz']}, /readyz {run['probes']['readyz']}; SIGTERM "
          f"-> exit 0 in {run['stop_s']:.2f} s")
    for i, (doc, vm_rss) in enumerate(zip(run["profiles"], run["rss"])):
        phases = ", ".join(f"{k} {v['wall_ms']:.1f}" for k, v in doc["phases"].items())
        print(f"  cycle {i + 1}: {doc['cycle']['wall_ms']:.1f} ms (spans, ms: {phases}); "
              f"{doc['counters'].get('prom_queries')} Prometheus queries; RSS {vm_rss} kB")
    print(f"  the controller process: kernel library "
          f"{child['lib'] and os.path.relpath(child['lib'], target)} (under the --target "
          f"directory); BUILD_LOG {child['build_log']!r}; package "
          f"{os.path.relpath(child['package'], target)}; launches stats_kernel "
          f"{child['launches'][0]}, bisect_kernel {child['launches'][1]}; peak RSS "
          f"{run['peak_kb']} kB ({run['peak_kb'] / 1024:.1f} MiB; VmRSS every 0.2 s and "
          f"at exit, {child['rss_exit_kb']} kB; {child['rss_start_kb']} kB at start, "
          f"{child['rss_torch_kb']} kB after `import torch`); ru_maxrss {child['ru_maxrss_kb']}"
          f" kB, {child['maxrss_start_kb']} kB of it at the start (inherited through the "
          f"fork); device memory reserved at peak "
          f"{child['max_memory_reserved'] / 2**20:.1f} MiB; {smi}")


def _p23_run(tmp, target, env, api, cert, deadline):
    """The controller entry as shipped: a fresh process in a temporary cwd
    whose PYTHONPATH is the --target directory alone and whose PATH has no
    CUDA directory, under `env`, against the TLS API server; P23_CYCLES
    cycles, then SIGTERM. Returns (what its atexit hook wrote, the run's
    readings)."""
    import signal

    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("PYTHONPATH", "LOG_LEVEL", "INCREMENTAL_CYCLE")}
    child_env.update(env)
    child_env.update({
        "PYTHONPATH": target,
        "PATH": os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                                if "cuda" not in p.lower()),
        "KUBERNETES_SERVICE_HOST": "127.0.0.1",
        "KUBERNETES_SERVICE_PORT": str(api.port),
        "SSL_CERT_FILE": cert,
        # site-packages that the process cannot write: no bytecode there
        "PYTHONDONTWRITEBYTECODE": "1",
    })
    work, out, log_path = (os.path.join(tmp, name)
                           for name in ("work", "child.json", "child.log"))
    os.mkdir(work)
    base = f"http://127.0.0.1:{env['METRICS_PORT']}"
    run = {}
    proc = None
    try:
        with open(log_path, "w") as log:
            run["t_start"] = time.time()
            proc = subprocess.Popen([sys.executable, "-c", _P23_CHILD, out], cwd=work,
                                    env=child_env, stdout=log, stderr=subprocess.STDOUT)
        run["profiles"], run["rss"], run["peak_kb"], run["first_cycle"], run["last"] = \
            _p23_watch(
            proc, base, deadline, lambda: _p23_poke(api, env["CONFIG_NAMESPACE"], cert))
        run["probes"] = {p: _get(f"http://127.0.0.1:{env['HEALTH_PORT']}/{p}")[0]
                         for p in ("healthz", "readyz")}
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=P23_STOP_S)
        run["stop_s"] = time.perf_counter() - t_term
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        tail = f.read()[-3000:]
    if rc != 0:
        raise AssertionError(f"23: the controller exited {rc} on SIGTERM:\n{tail}")
    if run["last"]["errors"] or not run["last"]["optimization_ok"]:
        raise AssertionError(f"23: the last cycle: {run['last']['errors'][:3]}")
    with open(out) as f:
        return json.load(f), run


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
        real = len(idx)
        for case in _bisect_cases(kind, params, k, cuda_queueing.solve_stats):
            per_bisect.append(_bisect_launch(kind, k, width, real, case, n_iters, bucket_tally))
    bucket_tally.check("bisect_kernel vs plain, main-path buckets")
    bit_diff = sum(b["bit_diff"] for b in per_bisect)
    bit_lanes = sum(b["P"] for b in per_bisect)
    print(f"fused vs per-step bisection on stats_kernel, main-path buckets: {bit_diff} of "
          f"{bit_lanes} lanes differ in any bit (lam_star or feasibility)")
    if bit_diff:
        raise AssertionError("the fused bisection differs from the per-step composition")
    new_sum = sum(b["ms"] for b in per_bisect)
    old_sum = sum(b["old_ms"] for b in per_bisect)
    print(f"bisect_kernel, the {len(per_bisect)} launches of a pass: {new_sum * 1e3:.2f} us, "
          f"the fixed schedule {old_sum * 1e3:.2f} us in turns in this run; bounds "
          f"{sum(b['bound_ms'] for b in per_bisect) * 1e3:.2f} us (steps to the fixed "
          f"points), {sum(b['bound_all_ms'] for b in per_bisect) * 1e3:.2f} us (all steps); "
          f"on {smi}")
    if new_sum >= old_sum:
        raise AssertionError("the bisections take no less time than the fixed schedule")
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

    # 14. the planner; 15. the flight recorder and trace replay; 16. the
    # fleet twin (replaying 15's artifact); 17. a closed emulated loop
    _phase14a(smi)
    plan_launches = _phase14b()
    _phase14c()
    plan_rows = _phase14d(smi)
    _stamp("phase 14 done")
    with tempfile.TemporaryDirectory() as tmp:
        _phase15(args.seed, smi, tmp)
        _stamp("phase 15 done")
        _phase16(smi, tmp)
    _stamp("phase 16 done")
    _phase17()
    _stamp("phase 17 done")

    # 18. the transformer profiling blocks at full width
    _phase18(smi)
    _stamp("phase 18 done")

    # 19. the controller over real sockets; 20. native beside the card
    _phase19()
    _stamp("phase 19 done")
    _phase20(smi)
    _stamp("phase 20 done")

    # 21. the lane mesh, the graft entry, the NCCL dry run
    _phase21(smi)
    _stamp("phase 21 done")

    # 22. the installed copy: its own kernel build, the checkout's bits
    _phase22(smi, (launches, bisect_launches))
    _stamp("phase 22 done")

    # 23. the shipped controller: prebuilt wheel, read-only install, 2k over sockets
    _phase23(smi)
    _stamp("phase 23 done")

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
        {
            "name": "plan_rows_kernel",
            "route": "cuda",
            "source": "inferno_tpu_torch/ops/csrc/plan_rows_kernel.cu",
            "replaces": "inferno_tpu/parallel/fleet.py::FleetBatchPrep._solve_chunk",
            "launches": plan_launches,
            "max_abs_err": plan_rows["max_abs_err"],
            "ms": plan_rows["ms"],
            "plain_ms": plan_rows["plain_ms"],
            "bound_ms": plan_rows["bound_ms"],
            "bound_by": plan_rows["bound_by"],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
