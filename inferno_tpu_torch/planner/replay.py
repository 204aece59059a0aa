"""Scenario replay + aggregation for the offline capacity planner.

`replay_scenario` drives one `ScenarioTrace` through the batched
time-axis solve (`parallel.fleet.calculate_fleet_batch` — one pass for
all T timesteps, no per-timestep allocation churn) and aggregates the
compact [T, servers] choice/replica/chip arrays into the planner's
answers:

* per-pool (generation) and per-quota-bucket chip-demand time series
  with peak / p95 / mean, using the exact bucket addressing of the
  capacity-constrained greedy (`solver.greedy_vec.capacity_buckets`);
* **first-bind timestamps**: the first timestep each configured pool or
  quota bucket's aggregate demand exceeds its budget. A pool with no
  configured budget (`System.capacity` has no entry) cannot bind and is
  reported demand-only — the planner's question for it is "how many
  chips WOULD I need", not "when do I run out";
* a **degradation estimate** for binding timesteps: servers fill their
  buckets in (priority asc, transition-value desc) order — the greedy's
  group order without the per-step regret reshuffling — and whoever
  doesn't fit counts as zeroed. This is an aggregate upper bound: the
  live solver would first walk the shape -> int8 -> replica ladder
  before zeroing, so the report names it `zeroed_upper_bound`;
* `violation_seconds` = sum over timesteps of step_seconds x the number
  of variants zeroed at that timestep;
* $-cost bands (p5/p50/p95/peak of the per-timestep fleet cost) and the
  horizon's total spend.

`forecast=True` additionally replays the scenario with every rate
replaced by max(observed, forecast upper band) — the reconciler's
forecast-bound sizing rule (`forecast.ArrivalForecaster`) applied
offline — so reactive vs forecast-bound capacity needs sit side by side
in one report.

RECORDED traces: `replay_recorded` turns a flight-recorder
artifact (`obs/recorder.py`, env FLIGHT_RECORDER_DIR on the live
controller) into the same [T, S] rate matrix and replays it against a
fleet System — by default the one reconstructed bit-faithfully from the
recording's own fleet snapshot (`system_from_recorded`), or any live
snapshot the caller supplies. Recorded variants are joined to the
fleet's servers on variant id; added/removed variants land in an
explicit drift report instead of silently vanishing. A recorded T=1
cycle replayed against its own snapshot reproduces the live
`calculate_fleet` decision bit-identically (`replay_cycle_parity`,
pinned in tests).

Port of `inferno_tpu/planner/replay.py`, verbatim apart from its imports
and the backend: every replay takes `backend` ("cuda", the default, or
"torch") and `device` (None = the CUDA card) and hands both to the
port's `calculate_fleet_batch`.
"""

from __future__ import annotations

import time

import numpy as np

from inferno_tpu_torch.parallel.fleet import FleetBatchResult, calculate_fleet_batch
from inferno_tpu_torch.planner.scenarios import ScenarioTrace
from inferno_tpu_torch.solver.greedy_vec import capacity_buckets

# decisions that never correspond to an unconstrained solve output: the
# parity check skips them (stabilization holds actuate a gated count,
# capacity degradation is the limited-mode ladder, errors decided nothing)
PARITY_SKIP_REASONS = frozenset({"error", "stabilization_hold", "capacity_limited"})


def forecast_bound_rates(
    rates: np.ndarray,
    step_seconds: float,
    horizon_s: float,
    config=None,
) -> np.ndarray:
    """The reconciler's forecast-bound sizing rule applied to a whole
    trace: each server's rate at step t becomes
    max(observed, forecast(horizon).upper) with the forecaster having
    seen the observations up to and including t. O(T x S) filter steps —
    offline-planner cost, not cycle cost."""
    from inferno_tpu_torch.forecast import ArrivalForecaster

    rates = np.asarray(rates, np.float64)
    eff = rates.copy()
    forecaster = ArrivalForecaster(config)
    n_steps, n_srv = rates.shape
    for s in range(n_srv):
        key = f"s{s}"
        for t in range(n_steps):
            forecaster.observe(key, t * step_seconds, float(rates[t, s]))
            fc = forecaster.forecast(key, horizon_s)
            if fc.valid and fc.upper > eff[t, s]:
                eff[t, s] = fc.upper
    return eff


def _series_stats(series: np.ndarray, include_series: bool) -> dict:
    out = {
        "peak": float(series.max(initial=0.0)),
        "p95": float(np.percentile(series, 95.0)) if len(series) else 0.0,
        "mean": float(series.mean()) if len(series) else 0.0,
    }
    if include_series:
        out["series"] = [float(v) for v in series]
    return out


def _bucket_demand(
    result: FleetBatchResult, bucket_of_rank: np.ndarray, n_buckets: int
) -> np.ndarray:
    """[T, n_buckets] chip demand: each timestep's winner chips summed by
    the bucket their accelerator rank maps to (-1 = no bucket)."""
    n_steps = result.num_steps
    if n_buckets == 0 or n_steps == 0:
        return np.zeros((n_steps, n_buckets), np.float64)
    valid = result.choice >= 0
    bucket = np.where(valid, bucket_of_rank[np.maximum(result.choice, 0)], -1)
    ok = bucket >= 0
    t_idx = np.broadcast_to(
        np.arange(n_steps, dtype=np.int64)[:, None], bucket.shape
    )
    flat = t_idx[ok] * n_buckets + bucket[ok]
    counts = np.bincount(
        flat, weights=result.chips[ok].astype(np.float64),
        minlength=n_steps * n_buckets,
    )
    return counts.reshape(n_steps, n_buckets)


def _first_bind(demand: np.ndarray, budget: float, step_seconds: float):
    over = np.flatnonzero(demand > budget)
    if not len(over):
        return None, None
    t = int(over[0])
    return t, t * step_seconds


def zeroed_fill_step(
    ledger,
    configured_pid: np.ndarray,
    pool_demand_t: np.ndarray,
    quota_demand_t: np.ndarray,
    choice_t: np.ndarray,
    chips_t: np.ndarray,
    value_t: np.ndarray,
    prio: np.ndarray,
) -> list[int]:
    """The aggregate degradation estimate for ONE binding timestep: fill
    servers into their capacity buckets in (priority asc, transition-
    value desc) order — the greedy's group order without the per-step
    regret reshuffling — and return the priorities of whoever does not
    fit (one entry per zeroed variant; empty = nothing zeroed). THE one
    implementation shared by `aggregate_replay` and the Monte Carlo
    envelope driver (planner/montecarlo.py), so per-seed violation
    counts are bit-identical across the two paths.

    Only buckets OVER budget at this step can zero anyone: demand in a
    non-binding bucket fits in any fill order, so servers drawing
    exclusively from non-binding buckets are skipped and only the
    binding buckets' budgets are tracked — same outcome as filling
    everything, at the contested subset's cost."""
    pool_budget = ledger.pool_remaining.astype(np.float64)
    quota_budget = ledger.quota_remaining.astype(np.float64)
    pool_bind = configured_pid & (pool_demand_t > pool_budget)
    quota_bind = quota_demand_t > quota_budget
    valid = (choice_t >= 0) & (chips_t > 0)
    rank_t = np.maximum(choice_t, 0)
    q1_t, q2_t = ledger.rank_q1[rank_t], ledger.rank_q2[rank_t]

    def quota_hit(q):
        if not len(quota_bind):  # no quota buckets configured
            return False
        return (q >= 0) & quota_bind[np.maximum(q, 0)]

    contested = valid & (
        pool_bind[ledger.rank_pid[rank_t]]
        | quota_hit(q1_t)
        | quota_hit(q2_t)
    )
    active = np.flatnonzero(contested)
    if not len(active):
        return []
    order = active[np.lexsort((-value_t[active], prio[active]))]
    # scalar fill over plain Python ints/floats (numpy-scalar
    # indexing per element is ~10x slower at 10k-variant scale)
    needs = chips_t[order].astype(np.float64).tolist()
    pids = ledger.rank_pid[rank_t[order]].tolist()
    q1s = q1_t[order].tolist()
    q2s = q2_t[order].tolist()
    prios = prio[order].tolist()
    pbind = pool_bind.tolist()
    qbind = quota_bind.tolist()
    prem = pool_budget.tolist()
    qrem = quota_budget.tolist()
    zeroed: list[int] = []
    for k in range(len(order)):
        need, pid, q1, q2 = needs[k], pids[k], q1s[k], q2s[k]
        fits = not pbind[pid] or prem[pid] >= need
        if fits and q1 >= 0 and qbind[q1]:
            fits = qrem[q1] >= need
        if fits and q2 >= 0 and qbind[q2]:
            fits = qrem[q2] >= need
        if fits:
            if pbind[pid]:
                prem[pid] -= need
            if q1 >= 0 and qbind[q1]:
                qrem[q1] -= need
            if q2 >= 0 and qbind[q2]:
                qrem[q2] -= need
        else:
            zeroed.append(prios[k])
    return zeroed


def aggregate_replay(
    system,
    result: FleetBatchResult,
    step_seconds: float,
    include_series: bool = False,
) -> dict:
    """Fold one replay's [T, S] arrays into the planner report block (see
    module docstring for the field semantics)."""
    ledger = capacity_buckets(system)
    n_steps = result.num_steps
    configured_pools = set(system.capacity)

    pool_demand = _bucket_demand(result, ledger.rank_pid, len(ledger.pools))
    pools = {}
    for i, pool in enumerate(ledger.pools):
        block = _series_stats(pool_demand[:, i], include_series)
        if pool in configured_pools:
            budget = float(ledger.pool_remaining[i])
            block["budget_chips"] = budget
            t, at_s = _first_bind(pool_demand[:, i], budget, step_seconds)
            block["first_bind_step"] = t
            block["first_bind_at_s"] = at_s
        pools[pool] = block

    quota_demand = np.zeros((n_steps, len(ledger.quota_keys)), np.float64)
    for qmap in (ledger.rank_q1, ledger.rank_q2):
        quota_demand += _bucket_demand(result, qmap, len(ledger.quota_keys))
    quotas = {}
    for i, key in enumerate(ledger.quota_keys):
        block = _series_stats(quota_demand[:, i], include_series)
        budget = float(ledger.quota_remaining[i])
        block["budget_chips"] = budget
        t, at_s = _first_bind(quota_demand[:, i], budget, step_seconds)
        block["first_bind_step"] = t
        block["first_bind_at_s"] = at_s
        quotas[key] = block

    # binding timesteps: any configured bucket over budget
    binding = np.zeros(n_steps, bool)
    for i, pool in enumerate(ledger.pools):
        if pool in configured_pools:
            binding |= pool_demand[:, i] > float(ledger.pool_remaining[i])
    for i in range(len(ledger.quota_keys)):
        binding |= quota_demand[:, i] > float(ledger.quota_remaining[i])

    prio = np.asarray(
        [s.priority(system) for s in system.servers.values()], np.int64
    )
    zeroed_steps = np.zeros(n_steps, np.int64)
    zeroed_by_prio: dict[int, int] = {}
    first_zero_step = None
    configured_pid = np.asarray(
        [p in configured_pools for p in ledger.pools], bool
    )
    for t in np.flatnonzero(binding):
        zeroed = zeroed_fill_step(
            ledger, configured_pid, pool_demand[t], quota_demand[t],
            result.choice[t], result.chips[t], result.value[t], prio,
        )
        if not zeroed:
            continue
        zeroed_steps[t] = len(zeroed)
        for p in zeroed:
            zeroed_by_prio[p] = zeroed_by_prio.get(p, 0) + 1
        if first_zero_step is None:
            first_zero_step = int(t)

    cost_usd_hr = result.cost.astype(np.float64).sum(axis=1) / 100.0
    cost = {
        "mean_usd_per_hr": float(cost_usd_hr.mean()) if n_steps else 0.0,
        "p5_usd_per_hr": float(np.percentile(cost_usd_hr, 5.0)) if n_steps else 0.0,
        "p50_usd_per_hr": float(np.percentile(cost_usd_hr, 50.0)) if n_steps else 0.0,
        "p95_usd_per_hr": float(np.percentile(cost_usd_hr, 95.0)) if n_steps else 0.0,
        "peak_usd_per_hr": float(cost_usd_hr.max(initial=0.0)),
        "total_usd": float(cost_usd_hr.sum() * step_seconds / 3600.0),
    }
    if include_series:
        cost["series_usd_per_hr"] = [float(v) for v in cost_usd_hr]

    return {
        "pools": pools,
        "quotas": quotas,
        "binding_steps": int(binding.sum()),
        "violation_seconds": float(zeroed_steps.sum() * step_seconds),
        "zeroed_upper_bound": {
            "variant_steps": int(zeroed_steps.sum()),
            "peak_concurrent": int(zeroed_steps.max(initial=0)),
            "first_zero_step": first_zero_step,
            "by_priority": {
                str(k): v for k, v in sorted(zeroed_by_prio.items())
            },
            "note": (
                "aggregate fill in (priority, -value) order, no shape/"
                "replica step-down modeled — an upper bound on what the "
                "degradation ladder would zero"
            ),
        },
        "cost": cost,
    }


# -- recorded-trace replay (flight-recorder artifacts) ------------------------


def system_from_recorded(recorded, cycle_index: int = -1):
    """Reconstruct the fleet System from the snapshot a recorded cycle's
    solve consumed (`SystemSpec.from_dict` of the recorded document —
    the same round-trip the ConfigMap path uses, so profiles incl.
    corrector output, SLOs, token mixes, and current allocations are
    bit-faithful)."""
    from inferno_tpu_torch.config.types import SystemSpec
    from inferno_tpu_torch.core import System

    return System(SystemSpec.from_dict(recorded.spec_doc_for(cycle_index)))


def recorded_rates(
    recorded, server_names: list[str], rate_field: str = "sizing_rpm"
) -> tuple[np.ndarray, dict]:
    """[T, S] rate matrix of a RecordedTrace aligned to `server_names`
    (the fleet System's server order), plus the drift report.

    `rate_field` is "sizing_rpm" (the λ sizing actually ran against —
    includes the forecast bound when predictive scaling was on) or
    "arrival_rpm" (the raw observed λ). A fleet server absent from a
    recorded cycle replays at rate 0 that step; both directions of
    membership drift are reported explicitly."""
    rates, present = recorded.column_matrix(rate_field, server_names)
    recorded_ids = set(recorded.variant_ids())
    fleet_ids = set(server_names)
    n_steps = len(recorded.cycles)
    coverage = float(present.mean()) if present.size else 0.0
    return rates, {
        "recorded_cycles": n_steps,
        "rate_field": rate_field,
        # variants in the fleet snapshot the recording never saw (added
        # since recording) and recorded variants missing from the fleet
        # (removed since recording)
        "added_variants": sorted(fleet_ids - recorded_ids),
        "removed_variants": sorted(recorded_ids - fleet_ids),
        "matched_variants": len(fleet_ids & recorded_ids),
        # fraction of (cycle, fleet-server) slots a recorded rate existed
        # for — 1.0 means every fleet server was recorded every cycle
        "coverage": round(coverage, 6),
    }


def replay_recorded(
    system,
    recorded,
    backend: str = "cuda",
    device=None,
    rate_field: str = "sizing_rpm",
    chunk_steps: int | None = None,
    include_series: bool = False,
    forecast: bool = False,
    forecast_horizon_s: float | None = None,
    forecast_config=None,
) -> dict:
    """Replay a recorded artifact against `system` (the current fleet
    snapshot): same report shape as a synthetic scenario — per-pool /
    per-quota demand, first binds, cost bands, optional forecast-bound
    pass over the real history — plus the variant-drift block and a
    ``profile`` block attributing the replay's own wall time (rate-matrix
    join + solve + aggregation). When the recorded cycles
    carry their own profile column, the recording's aggregate cost
    attribution rides along as ``recorded_profile`` — the live
    controller's cost next to the replay's."""
    names = list(system.servers)
    t0 = time.perf_counter()
    rates, drift = recorded_rates(recorded, names, rate_field)
    rates_ms = round((time.perf_counter() - t0) * 1000.0, 1)
    trace = ScenarioTrace(
        name="recorded",
        rates=rates,
        step_seconds=recorded.step_seconds(),
        seed=0,
        description=f"flight-recorder artifact {recorded.dir}",
    )
    out = replay_scenario(
        system, trace,
        backend=backend,
        device=device,
        chunk_steps=chunk_steps,
        include_series=include_series,
        forecast=forecast,
        forecast_horizon_s=forecast_horizon_s,
        forecast_config=forecast_config,
    )
    out["drift"] = drift
    out["source"] = "recorded"
    out["profile"] = {"rates_ms": rates_ms, **out.get("profile", {})}
    recorded_profile = recorded.profile_summary()
    if recorded_profile is not None:
        out["recorded_profile"] = recorded_profile
    return out


def replay_cycle_parity(
    recorded, cycle_index: int, backend: str = "cuda", system=None,
    device=None,
) -> dict:
    """Replay ONE recorded cycle (T=1) against its own fleet snapshot
    and compare the replayed choice/replicas with the recorded live
    decisions. With a faithful snapshot this is bit-identical for every
    unconstrained decision (`calculate_fleet_batch` T=1 ≡ the live
    `calculate_fleet` + `solve_unlimited`, tests/test_planner.py);
    records with reasons in PARITY_SKIP_REASONS are skipped and
    counted."""
    cyc = recorded.cycles[cycle_index]
    if system is None:
        system = system_from_recorded(recorded, cycle_index)
    names = list(system.servers)
    idx = {v: j for j, v in enumerate(names)}
    rates = np.zeros((1, len(names)), np.float64)
    for j, v in enumerate(cyc.variants):
        if v in idx:
            rates[0, idx[v]] = float(cyc.columns["sizing_rpm"][j])
    result = calculate_fleet_batch(
        system, rates, backend=backend, device=device
    )
    mismatches: list[dict] = []
    compared = skipped = missing = 0
    for j, v in enumerate(cyc.variants):
        if v not in idx:
            missing += 1
            continue
        reason = str(cyc.columns["reason"][j])
        if reason in PARITY_SKIP_REASONS:
            skipped += 1
            continue
        compared += 1
        s = idx[v]
        choice = int(result.choice[0, s])
        replayed_acc = result.accelerators[choice] if choice >= 0 else ""
        replayed_reps = int(result.replicas[0, s])
        rec_acc = str(cyc.columns["accelerator"][j])
        rec_reps = int(cyc.columns["replicas"][j])
        # spot placement replays bit-faithfully too: the snapshot
        # round-trips the tier config, so a spot-enabled replay must
        # reproduce the recorded split (a tier-less snapshot — incl.
        # every pre-spot artifact — computes no split and skips this)
        spot_ok = True
        if result.spot_replicas is not None:
            spot_ok = (
                int(result.spot_replicas[0, s])
                == int(cyc.columns["spot_replicas"][j])
            )
        if replayed_acc != rec_acc or replayed_reps != rec_reps or not spot_ok:
            mismatches.append({
                "variant": v,
                "reason": reason,
                "recorded": {
                    "accelerator": rec_acc, "replicas": rec_reps,
                    "spot_replicas": int(cyc.columns["spot_replicas"][j]),
                },
                "replayed": {
                    "accelerator": replayed_acc, "replicas": replayed_reps,
                    "spot_replicas": (
                        int(result.spot_replicas[0, s])
                        if result.spot_replicas is not None else 0
                    ),
                },
            })
    return {
        "cycle_index": cycle_index,
        "seq": cyc.seq,
        "compared": compared,
        "skipped": skipped,
        "missing_from_snapshot": missing,
        "mismatches": mismatches,
        "match": not mismatches,
    }


def replay_scenario(
    system,
    trace: ScenarioTrace,
    backend: str = "cuda",
    device=None,
    chunk_steps: int | None = None,
    include_series: bool = False,
    forecast: bool = False,
    forecast_horizon_s: float | None = None,
    forecast_config=None,
) -> dict:
    """Replay one scenario through the batched solve; optionally a second
    forecast-bound pass for the reactive-vs-forecast comparison.

    The report carries a ``profile`` block attributing where the replay's
    own wall time went: the batched solve vs the numpy
    aggregation vs the optional forecast passes — so a slow planner run
    is diagnosable from its report instead of re-run under a stopwatch."""
    profile: dict[str, float] = {}
    t0 = time.perf_counter()
    result = calculate_fleet_batch(
        system, trace.rates, backend=backend, device=device,
        chunk_steps=chunk_steps,
    )
    profile["solve_ms"] = round((time.perf_counter() - t0) * 1000.0, 1)
    t0 = time.perf_counter()
    reactive = aggregate_replay(
        system, result, trace.step_seconds, include_series
    )
    profile["aggregate_ms"] = round((time.perf_counter() - t0) * 1000.0, 1)
    out = {
        "scenario": trace.name,
        "description": trace.description,
        "seed": trace.seed,
        "steps": trace.steps,
        "step_seconds": trace.step_seconds,
        "variants": len(result.servers),
        "reactive": reactive,
    }
    if forecast:
        horizon = (
            trace.step_seconds if forecast_horizon_s is None else forecast_horizon_s
        )
        t0 = time.perf_counter()
        eff = forecast_bound_rates(
            trace.rates, trace.step_seconds, horizon, forecast_config
        )
        profile["forecast_filter_ms"] = round(
            (time.perf_counter() - t0) * 1000.0, 1
        )
        t0 = time.perf_counter()
        bound = calculate_fleet_batch(
            system, eff, backend=backend, device=device,
            chunk_steps=chunk_steps,
        )
        profile["forecast_solve_ms"] = round(
            (time.perf_counter() - t0) * 1000.0, 1
        )
        out["forecast_horizon_s"] = horizon
        t0 = time.perf_counter()
        out["forecast_bound"] = aggregate_replay(
            system, bound, trace.step_seconds, include_series
        )
        profile["forecast_aggregate_ms"] = round(
            (time.perf_counter() - t0) * 1000.0, 1
        )
    out["profile"] = profile
    return out
