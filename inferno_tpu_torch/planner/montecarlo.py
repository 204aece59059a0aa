"""Monte Carlo capacity planner: percentile envelopes over seeded
scenario ensembles.

One `replay_scenario` answers "what does THIS trace need"; the
capacity-planning question operators actually ask is probabilistic:
"how much reserved quota survives a 99% winter peak?" `replay_montecarlo`
answers it by replaying an S-member seeded ensemble of one scenario
family through the batched solve as one streamed tensor pass and
summarizing the per-seed replays into percentile envelopes:

* per-pool / per-quota-bucket **chip-demand envelopes** — p50/p95/p99/max
  across seeds of each seed's peak, p95, and mean demand (the same
  bucket addressing as the capacity-constrained greedy);
* **cost envelopes** (total spend, peak and mean $/hr) and
  **violation-seconds envelopes** (the `zeroed_upper_bound` fill of
  `aggregate_replay`, shared code, per seed);
* **tail risk**: the probability a configured bucket first-binds within
  the horizon (per bucket and any-bucket) and the p99 peak chip demand
  per pool — the "how much reserved quota do we need" number.

Why it is fast (the reference's bench asserts >= 10x over the serial
per-seed loop): the rate-independent half of the solve — snapshot/plan
derivation, the sizing grid on the card, the zero-load table — is prepared
ONCE (`parallel.fleet.prepare_fleet_batch`) and every seed streams
through `FleetBatchPrep.solve(consume=...)` in [rows, lanes] slabs of
the flattened (seeds x steps) axis, so per-(seed, timestep) work is
only the f32 replica fold, transition penalties, the segment argmin
and the bucket demand; nothing is ever materialized beyond one slab
(peak memory is the PLANNER_CHUNK_STEPS bound regardless of seed
count). Aggregation is exact: per-seed envelope inputs are
BIT-IDENTICAL to what `aggregate_replay` computes for the same seed's
trace (integer demand sums are order-independent; cost rows reuse the
same pairwise sum; the binding fill is one shared implementation) —
pinned in tests/test_torch_montecarlo.py, and on the card in
tests/test_torch_plan_rows_kernel.py.

Seed derivation follows the fixed-generator-index convention of the
traffic and storm generators (`scenarios.ensemble_seeds`): member 0 of an ensemble is exactly
the single-replay trace, and no (scenario, member) pair ever collides.

Port of `inferno_tpu/planner/montecarlo.py`. `replay_montecarlo` takes
`backend` ("cuda", the default, or "torch") and `device` (None = the CUDA
card) beside the reference's `mesh` (a `parallel.mesh.FleetMesh`), which
splits the prep's grid solve over its devices as the reference's does
(`SIZING_SHARDS` does not apply there). On backend "cuda" without a spot
tier the rows run on the card (`FleetBatchPrep.rows_on_card`): the
accumulator hands its bucket ledger to the prep, the kernel sums each
row's demand, and the accumulator keeps only the cost sum, the binding
test and the report; elsewhere the accumulator is the reference's. The
cycle profiler's span `plan_feed` times the envelope accumulator's fold of
each slab, beside `plan_fold` (the slab's per-row fold and argmin,
`parallel/fleet.py`); the report's `profile` counts both in its
`solve_ms`.
"""

from __future__ import annotations

import time

import numpy as np

# cycle-profiler hooks (obs/profiler.py): thread-local no-ops unless a
# profiler is active; observation only
from inferno_tpu_torch.obs import profiler as _prof
from inferno_tpu_torch.parallel.fleet import FleetBatchPrep, prepare_fleet_batch
from inferno_tpu_torch.planner.replay import zeroed_fill_step
from inferno_tpu_torch.planner.scenarios import (
    GENERATORS,
    base_rates_from_system,
    ensemble_seeds,
)
from inferno_tpu_torch.solver.greedy_vec import capacity_buckets

ENVELOPE_PERCENTILES = (50.0, 95.0, 99.0)

# binding rows (any configured bucket over budget) are re-solved in
# materializing mode for the exact degradation fill; they flush in
# batches of this many rows so an under-provisioned ensemble — where
# MOST rows bind, exactly the case the survival gate exists to detect —
# still holds the slab memory bound instead of accumulating
# O(binding_rows x servers) rates and outputs (monkeypatched small in
# tests to pin flush-boundary invariance)
BINDING_FLUSH_ROWS = 256


def percentile_envelope(values) -> dict:
    """{p50, p95, p99, max} across the seed axis — THE envelope shape
    every Monte Carlo output uses (spot storm ensembles included)."""
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "max": 0.0}
    out = {
        f"p{int(p)}": float(np.percentile(values, p))
        for p in ENVELOPE_PERCENTILES
    }
    out["max"] = float(values.max())
    return out


class _EnvelopeAccumulator:
    """Streaming consumer of `FleetBatchPrep.solve`: folds each slab's
    winners into per-row bucket chip demand and fleet cost, collecting
    binding rows for the (rare) exact degradation fill afterwards.

    Three paths, identical results:

    * rows solved on the card (`prep.rows_on_card`): the kernel sums the
      demand with its winners and hands it over as `slab.demand`; only
      the cost sum and the binding test run here;
    * single-lane fleets (`prep.all_seg1`): demand comes from one exact
      integer-valued f64 GEMM over the raw lane fold (`slab.lane_reps @
      W`), with sparse corrections where the zero-load overlay replaced
      the sized pick — the [rows, S] choice/chips surfaces are never
      materialized, which is what the >= 10x bench rides on;
    * general fleets: the same bincount as `aggregate_replay` over the
      slab's winner arrays.

    Demand values are integers (summed as such on the card, carried in
    f64 on the host: exact and order-independent below 2^53), so every
    path equals the per-seed `aggregate_replay` numbers BIT-identically."""

    def __init__(
        self,
        prep: FleetBatchPrep,
        system,
        n_rows: int,
        chunk_steps: int | None = None,
    ):
        self.prep = prep
        self.chunk_steps = chunk_steps
        ledger = capacity_buckets(system)
        self.ledger = ledger
        self.configured_pools = set(system.capacity)
        self.configured_pid = np.asarray(
            [p in self.configured_pools for p in ledger.pools], bool
        )
        self.prio = np.asarray(
            [s.priority(system) for s in system.servers.values()], np.int64
        )
        self.n_pools = len(ledger.pools)
        self.n_quotas = len(ledger.quota_keys)
        self.pool_demand = np.zeros((n_rows, self.n_pools), np.float64)
        self.quota_demand = np.zeros((n_rows, self.n_quotas), np.float64)
        self.cost_usd_hr = np.zeros(n_rows, np.float64)
        self.binding_rows: list[int] = []  # indices only (ints, cheap)
        self.zeroed_by_row: dict[int, int] = {}
        self._pending_rows: list[int] = []
        self._pending_rates: list[np.ndarray] = []
        self.base_row = 0  # set by the driver before each seed's solve
        self._pool_budget = ledger.pool_remaining.astype(np.float64)
        self._quota_budget = ledger.quota_remaining.astype(np.float64)
        self._any_budget = bool(self.configured_pid.any()) or self.n_quotas > 0

        # the card's rows bring each row's bucket demand with them
        # (`slab.demand`, from the kernel's own winners); the host's are
        # summed here, by one of the two numpy paths
        on_card = prep.rows_on_card
        self.fast = bool(prep.all_seg1 and prep.n_lanes) and not on_card
        if self.fast:
            # lane -> bucket chip-weight matrix: winner chips land in the
            # lane's pool column and each matching quota column; on a
            # single-lane-per-server fleet every feasible lane IS its
            # server's winner, so demand is one [rows, L] @ [L, B] GEMM
            L = prep.n_lanes
            B = self.n_pools + self.n_quotas
            W = np.zeros((L, B), np.float64)
            lanes = np.arange(L)
            rank = prep.lane_rank
            chips = prep.lane_chips.astype(np.float64)
            W[lanes, ledger.rank_pid[rank]] = chips
            for qmap in (ledger.rank_q1, ledger.rank_q2):
                q = qmap[rank]
                hit = q >= 0
                W[lanes[hit], self.n_pools + q[hit]] += chips[hit]
            self._W = W
            # server -> lane (seg1: one-to-one on servers with a lane)
            lane_of = np.full(prep.n_servers, -1, np.int64)
            lane_of[prep.seg_server] = lanes
            self._lane_of = lane_of
            self._zero_add = None  # built lazily with the zero table
        self.needs = (
            ("cost",) if self.fast or on_card else ("choice", "chips", "cost")
        )

    def _zero_bucket_add(self):
        """[S, B] bucket contribution of each server's ZERO-LOAD pick —
        what the overlay adds wherever a row's rate is zero (sized lane
        contributions are subtracted separately from the lane fold)."""
        if self._zero_add is None:
            table = self.prep.zero_columns()
            S = self.prep.n_servers
            B = self.n_pools + self.n_quotas
            add = np.zeros((S, B), np.float64)
            zc = table["choice"]
            chips = table["chips"].astype(np.float64)
            has = zc >= 0
            srv = np.flatnonzero(has)
            rank = zc[srv]
            add[srv, self.ledger.rank_pid[rank]] = chips[srv]
            for qmap in (self.ledger.rank_q1, self.ledger.rank_q2):
                q = qmap[rank]
                hit = q >= 0
                add[srv[hit], self.n_pools + q[hit]] += chips[srv][hit]
            self._zero_add = add
        return self._zero_add

    def feed(self, slab) -> None:
        with _prof.span("plan_feed"):
            self._feed(slab)

    def _feed(self, slab) -> None:
        r0 = self.base_row + slab.row0
        rows = slab.rows
        B = self.n_pools + self.n_quotas
        if slab.demand is not None:
            demand = slab.demand
        elif self.fast:
            demand = slab.lane_reps.astype(np.float64) @ self._W
            if slab.zmask is not None:
                # the overlay replaced the sized pick at these cells:
                # subtract the lane fold's contribution, add the
                # zero-load pick's. Columns zero for the WHOLE slab (the
                # common case: variants with zero base rate) fold to one
                # row-independent correction — the fold of a zero rate
                # does not depend on the row.
                zadd = self._zero_bucket_add()
                counts = slab.zmask.sum(axis=0)
                full = counts == rows
                partial = np.flatnonzero((counts > 0) & ~full)
                fcols = np.flatnonzero(full)
                if len(fcols):
                    delta = zadd[fcols].sum(axis=0)
                    lanes = self._lane_of[fcols]
                    lhit = lanes >= 0
                    if lhit.any():
                        delta = delta - (
                            slab.lane_reps[0, lanes[lhit]].astype(np.float64)
                            [:, None] * self._W[lanes[lhit]]
                        ).sum(axis=0)
                    demand += delta
                for c in partial:
                    zrows = np.flatnonzero(slab.zmask[:, c])
                    lane = self._lane_of[c]
                    delta = np.broadcast_to(zadd[c], (len(zrows), B)).copy()
                    if lane >= 0:
                        delta -= (
                            slab.lane_reps[zrows, lane].astype(np.float64)
                            [:, None] * self._W[lane]
                        )
                    demand[zrows] += delta
        else:
            demand = np.zeros((rows, B), np.float64)
            valid = slab.choice >= 0
            rank = np.maximum(slab.choice, 0)
            chips = slab.chips.astype(np.float64)
            t_idx = np.broadcast_to(
                np.arange(rows, dtype=np.int64)[:, None], rank.shape
            )
            maps = [(self.ledger.rank_pid, 0)]
            maps += [
                (qmap, self.n_pools)
                for qmap in (self.ledger.rank_q1, self.ledger.rank_q2)
            ]
            for qmap, off in maps:
                bucket = np.where(valid, qmap[rank], -1)
                ok = bucket >= 0
                if not ok.any():
                    continue
                flat = t_idx[ok] * B + bucket[ok] + off
                demand += np.bincount(
                    flat, weights=chips[ok], minlength=rows * B
                ).reshape(rows, B)
        self.pool_demand[r0 : r0 + rows] = demand[:, : self.n_pools]
        self.quota_demand[r0 : r0 + rows] = demand[:, self.n_pools :]
        # the same pairwise f64 sum over the S axis aggregate_replay runs
        self.cost_usd_hr[r0 : r0 + rows] = (
            slab.cost.astype(np.float64).sum(axis=1) / 100.0
        )
        if self._any_budget:
            binding = (
                demand[:, : self.n_pools][:, self.configured_pid]
                > self._pool_budget[self.configured_pid]
            ).any(axis=1)
            if self.n_quotas:
                binding |= (
                    demand[:, self.n_pools :] > self._quota_budget
                ).any(axis=1)
            hit = np.flatnonzero(binding)
            for i in hit:
                row = r0 + int(i)
                self.binding_rows.append(row)
                self._pending_rows.append(row)
                self._pending_rates.append(slab.rates[i].copy())
            # bounded accumulation: a heavily-binding ensemble flushes
            # its exact fills incrementally instead of holding every
            # binding row's rates (and, at fill time, outputs) at once
            if len(self._pending_rows) >= BINDING_FLUSH_ROWS:
                self._flush_binding()

    def _flush_binding(self) -> None:
        """Re-solve the pending binding rows through the SAME prep
        (bit-identical winner arrays) and fill them with the shared
        `zeroed_fill_step`; the demand rows they compare against were
        written by feed() before the rows were collected."""
        if not self._pending_rows:
            return
        rates = np.stack(self._pending_rates)
        res = self.prep.solve(
            rates, chunk_steps=self.chunk_steps, validate=False
        )
        for i, row in enumerate(self._pending_rows):
            zeroed = zeroed_fill_step(
                self.ledger, self.configured_pid,
                self.pool_demand[row], self.quota_demand[row],
                res.choice[i], res.chips[i], res.value[i], self.prio,
            )
            self.zeroed_by_row[row] = len(zeroed)
        self._pending_rows.clear()
        self._pending_rates.clear()

    def zeroed_counts(self) -> dict[int, int]:
        """{flat row -> zeroed variant count} for every binding row
        (flushing any still-pending batch first)."""
        self._flush_binding()
        return self.zeroed_by_row


def _bucket_stats(
    demand: np.ndarray,  # [seeds, T]
    budget: float | None,
    step_seconds: float,
    include_series: bool,
    per_seed: bool,
) -> dict:
    """Per-bucket envelope block from one bucket's [seeds, T] demand."""
    peak = demand.max(axis=1) if demand.shape[1] else np.zeros(len(demand))
    p95 = (
        np.percentile(demand, 95.0, axis=1)
        if demand.shape[1] else np.zeros(len(demand))
    )
    mean = demand.mean(axis=1) if demand.shape[1] else np.zeros(len(demand))
    block = {
        "peak_chips": percentile_envelope(peak),
        "p95_chips": percentile_envelope(p95),
        "mean_chips": percentile_envelope(mean),
    }
    if budget is not None:
        over = demand > budget
        bound = over.any(axis=1)
        first = np.where(bound, over.argmax(axis=1), -1)
        n = max(len(demand), 1)
        block["budget_chips"] = float(budget)
        block["first_bind_probability"] = round(float(bound.sum()) / n, 6)
        block["survival_fraction"] = round(1.0 - float(bound.sum()) / n, 6)
        bound_first = first[bound]
        block["first_bind_step"] = (
            percentile_envelope(bound_first) if len(bound_first) else None
        )
        block["first_bind_at_s"] = (
            percentile_envelope(bound_first * step_seconds)
            if len(bound_first) else None
        )
    if include_series:
        block["envelope_series"] = {
            **{
                f"p{int(p)}": [
                    float(v) for v in np.percentile(demand, p, axis=0)
                ]
                for p in ENVELOPE_PERCENTILES
            },
            "max": [float(v) for v in demand.max(axis=0)],
        }
    if per_seed:
        block["per_seed"] = {
            "peak": [float(v) for v in peak],
            "p95": [float(v) for v in p95],
            "mean": [float(v) for v in mean],
        }
        if budget is not None:
            block["per_seed"]["first_bind_step"] = [
                int(v) if v >= 0 else None for v in first
            ]
    return block


def replay_montecarlo(
    system,
    scenario: str,
    steps: int,
    step_seconds: float,
    seeds: int = 32,
    base_seed: int = 0,
    backend: str = "cuda",
    chunk_steps: int | None = None,
    include_series: bool = False,
    per_seed: bool = False,
    keep_seeds=(),
    mesh=None,
    device=None,
) -> dict:
    """Replay a `seeds`-member ensemble of one scenario family and fold
    it into the Monte Carlo envelope report (see module docstring).

    `keep_seeds` names ensemble member indices whose full [T, S]
    choice/replica arrays are materialized alongside the streamed
    envelopes (the bench's bit-parity samples); they ride the SAME
    prepared context and are returned under the non-JSON ``_kept`` key
    as ``{"choice": i32[T, S], "replicas": i32[T, S]}`` dicts — only
    the two parity surfaces, not a full result. `per_seed=True` adds
    the raw per-seed
    scalars the envelopes summarize (tests and the bench assert on
    these; they are exactly `aggregate_replay`'s numbers per seed)."""
    if scenario not in GENERATORS:
        raise ValueError(
            f"unknown scenario {scenario!r}; available: {sorted(GENERATORS)}"
        )
    gen = GENERATORS[scenario]
    seed_values = ensemble_seeds(scenario, base_seed, seeds)
    keep = {int(k) for k in keep_seeds}
    profile: dict[str, float] = {}

    t0 = time.perf_counter()
    prep = prepare_fleet_batch(system, mesh=mesh, backend=backend, device=device)
    profile["prepare_ms"] = round((time.perf_counter() - t0) * 1000.0, 1)

    base = base_rates_from_system(system)
    acc = _EnvelopeAccumulator(
        prep, system, seeds * steps, chunk_steps=chunk_steps
    )
    kept: dict[int, object] = {}
    gen_ms = solve_ms = 0.0
    for k, seed in enumerate(seed_values):
        t0 = time.perf_counter()
        trace = gen(base, steps, step_seconds, seed=seed)
        gen_ms += time.perf_counter() - t0
        if trace.rates.shape != (steps, prep.n_servers):
            raise ValueError(
                f"scenario {scenario!r} produced {trace.rates.shape}, "
                f"expected {(steps, prep.n_servers)}"
            )
        acc.base_row = k * steps
        t0 = time.perf_counter()
        if k in keep:
            sink = {
                "choice": np.full((steps, prep.n_servers), -1, np.int32),
                "replicas": np.zeros((steps, prep.n_servers), np.int32),
            }

            def tee(slab, _sink=sink):
                _sink["choice"][slab.row0 : slab.row0 + slab.rows] = slab.choice
                _sink["replicas"][slab.row0 : slab.row0 + slab.rows] = (
                    slab.replicas
                )
                acc.feed(slab)

            prep.solve(
                trace.rates, chunk_steps=chunk_steps, consume=tee,
                needs=("choice", "replicas", *acc.needs), validate=False,
                buckets=acc.ledger,
            )
            kept[k] = sink
        else:
            prep.solve(
                trace.rates, chunk_steps=chunk_steps, consume=acc.feed,
                needs=acc.needs, validate=False, buckets=acc.ledger,
            )
        solve_ms += time.perf_counter() - t0
    profile["generate_ms"] = round(gen_ms * 1000.0, 1)
    profile["solve_ms"] = round(solve_ms * 1000.0, 1)

    t0 = time.perf_counter()
    ledger = acc.ledger
    pool_3d = acc.pool_demand.reshape(seeds, steps, acc.n_pools)
    quota_3d = acc.quota_demand.reshape(seeds, steps, acc.n_quotas)
    cost_2d = acc.cost_usd_hr.reshape(seeds, steps)

    pools = {}
    for i, pool in enumerate(ledger.pools):
        budget = (
            float(ledger.pool_remaining[i])
            if pool in acc.configured_pools else None
        )
        pools[pool] = _bucket_stats(
            pool_3d[:, :, i], budget, step_seconds, include_series, per_seed
        )
    quotas = {}
    for i, key in enumerate(ledger.quota_keys):
        quotas[key] = _bucket_stats(
            quota_3d[:, :, i], float(ledger.quota_remaining[i]),
            step_seconds, include_series, per_seed,
        )

    # violation-seconds per seed: the shared zeroed fill over the
    # collected binding rows (flushed in bounded batches as they
    # accumulated; this drains the remainder)
    zeroed = acc.zeroed_counts()
    zeroed_per_seed = np.zeros(seeds, np.int64)
    for row, count in zeroed.items():
        zeroed_per_seed[row // steps] += count
    violation_per_seed = zeroed_per_seed.astype(np.float64) * step_seconds
    n = max(seeds, 1)

    # tail risk: a seed "binds" when any CONFIGURED bucket exceeds its
    # budget at any step of that seed's horizon
    bound_seed = np.zeros(seeds, bool)
    for row in acc.binding_rows:
        bound_seed[row // steps] = True

    cost_total = cost_2d.sum(axis=1) * step_seconds / 3600.0
    report = {
        "scenario": scenario,
        "seeds": seeds,
        "base_seed": base_seed,
        "seed_derivation": (
            "base + fixed generator offset + k * len(GENERATORS) "
            "(scenarios.ensemble_seeds; member 0 == the single replay)"
        ),
        "steps": steps,
        "step_seconds": step_seconds,
        "variants": prep.n_servers,
        "backend": backend,
        "pools": pools,
        "quotas": quotas,
        "cost": {
            "total_usd": percentile_envelope(cost_total),
            "peak_usd_per_hr": percentile_envelope(cost_2d.max(axis=1)),
            "mean_usd_per_hr": percentile_envelope(cost_2d.mean(axis=1)),
        },
        "violation_seconds": {
            **percentile_envelope(violation_per_seed),
            "probability_any": round(
                float((violation_per_seed > 0).sum()) / n, 6
            ),
        },
        "tail_risk": {
            # P(any configured bucket first-binds within the horizon)
            "first_bind_probability": round(float(bound_seed.sum()) / n, 6),
            # the reserved-quota answer: the p99 across seeds of each
            # seed's peak chip demand, per pool
            "p99_peak_chips": {
                pool: pools[pool]["peak_chips"]["p99"] for pool in pools
            },
        },
        "binding_rows": len(acc.binding_rows),
    }
    if per_seed:
        report["per_seed"] = {
            "violation_seconds": [float(v) for v in violation_per_seed],
            "cost_total_usd": [float(v) for v in cost_total],
            "cost_peak_usd_per_hr": [float(v) for v in cost_2d.max(axis=1)],
        }
    profile["aggregate_ms"] = round((time.perf_counter() - t0) * 1000.0, 1)
    report["profile"] = profile
    if kept:
        report["_kept"] = kept  # non-JSON bench/test handle (choice/replicas)
    return report


def survival_failures(report: dict, percentile: float) -> list[dict]:
    """Configured buckets of a Monte Carlo report that do NOT survive
    `percentile`% of seeds without binding — the planner CLI's
    "do we have enough reserved quota" gate (exit non-zero when this is
    non-empty)."""
    required = percentile / 100.0
    failures = []
    for kind in ("pools", "quotas"):
        for name, block in report.get(kind, {}).items():
            frac = block.get("survival_fraction")
            if frac is None:
                continue  # unconfigured bucket: demand-only, cannot bind
            if frac < required:
                failures.append({
                    "bucket": name,
                    "kind": kind,
                    "survival_fraction": frac,
                    "required": round(required, 6),
                    "budget_chips": block.get("budget_chips"),
                    "p99_peak_chips": block["peak_chips"]["p99"],
                })
    return failures
