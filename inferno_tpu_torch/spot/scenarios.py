"""Correlated eviction-storm scenarios for the offline planner.

Storms are CAPACITY shocks, not traffic shocks: the planner's rate
scenarios (`planner.scenarios`) describe what arrives, these describe
what *vanishes*. A `StormSchedule` is a seeded, reproducible list of
`StormEvent`s — correlated spot reclaims (one storm takes a fraction of
a whole pool's spot replicas at once) and zone outages (everything in a
pool/region goes dark) — generated with the same fixed-generator-index
seed derivation as the traffic generators, so the same (scenario, seed)
pair produces a bit-identical preemption schedule regardless of which
other scenarios ride along.

`replay_spot_storm` replays one traffic trace through
`calculate_fleet_batch` twice — once with the pool's risk model zeroed
(the *risk-blind spot-greedy* baseline: every price-eligible replica
rides spot, nothing pre-positioned) and once as configured (risk-model
trimming + reserved-headroom pre-positioning) — then drives the same
storm schedule through both placements and reports violation-seconds,
recovery time, and cost side by side. The solve itself is storm-free:
storms only remove already-placed replicas, which is exactly what a
reactive controller experiences between reconcile cycles.

Port of `inferno_tpu/spot/scenarios.py`, verbatim apart from its imports
and the backend: the replays take `backend` ("cuda", the default, or
"torch") and `device` (None = the CUDA card).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from inferno_tpu_torch.spot.market import headroom_chips


@dataclasses.dataclass(frozen=True)
class StormEvent:
    """One correlated capacity shock."""

    step: int  # first affected timestep
    pool: str
    region: str  # "" = the whole pool's spot tier; set = one zone
    fraction: float  # of the targeted replicas reclaimed at once
    recovery_steps: int  # timesteps until evicted replicas serve again
    kind: str  # "spot_reclaim" | "zone_outage"


@dataclasses.dataclass(frozen=True)
class StormSchedule:
    """A replayable eviction-storm scenario."""

    name: str
    events: tuple[StormEvent, ...]
    seed: int
    step_seconds: float
    description: str = ""


def spot_reclaim(
    pools: list[str],
    steps: int,
    step_seconds: float,
    seed: int = 0,
    storms: int = 2,
    fraction: tuple[float, float] = (0.3, 0.7),
    recovery_s: float = 900.0,
) -> StormSchedule:
    """Correlated spot reclaims: `storms` events, each taking a random
    `fraction` of one random pool's SPOT replicas simultaneously (the
    provider reclaiming preemptible capacity under demand pressure)."""
    rng = np.random.default_rng(seed)
    recovery_steps = max(1, math.ceil(recovery_s / step_seconds))
    events = []
    for _ in range(max(storms, 0)):
        if steps == 0 or not pools:
            break
        t0 = int(rng.integers(0, steps))
        pool = pools[int(rng.integers(0, len(pools)))]
        f = float(rng.uniform(*fraction))
        events.append(StormEvent(
            step=t0, pool=pool, region="", fraction=f,
            recovery_steps=recovery_steps, kind="spot_reclaim",
        ))
    return StormSchedule(
        name="spot_reclaim",
        events=tuple(sorted(events, key=lambda e: (e.step, e.pool))),
        seed=seed,
        step_seconds=step_seconds,
        description=f"{storms} correlated reclaims x {fraction} of a pool's "
                    f"spot replicas, {recovery_s:.0f}s recovery",
    )


def zone_outage(
    pools: list[str],
    steps: int,
    step_seconds: float,
    seed: int = 0,
    regions: tuple[str, ...] = ("r0", "r1"),
    recovery_s: float = 1800.0,
) -> StormSchedule:
    """One zone goes dark: every replica — reserved and spot alike — on
    shapes placed in the chosen (pool, region) is lost for the outage."""
    rng = np.random.default_rng(seed)
    recovery_steps = max(1, math.ceil(recovery_s / step_seconds))
    events = []
    if steps and pools and regions:
        t0 = int(rng.integers(0, steps))
        pool = pools[int(rng.integers(0, len(pools)))]
        region = regions[int(rng.integers(0, len(regions)))]
        events.append(StormEvent(
            step=t0, pool=pool, region=region, fraction=1.0,
            recovery_steps=recovery_steps, kind="zone_outage",
        ))
    return StormSchedule(
        name="zone_outage",
        events=tuple(events),
        seed=seed,
        step_seconds=step_seconds,
        description=f"one pool/region outage, {recovery_s:.0f}s recovery",
    )


STORM_GENERATORS = {
    "spot_reclaim": spot_reclaim,
    "zone_outage": zone_outage,
}


def storm_ensemble_seeds(name: str, base_seed: int, count: int) -> list[int]:
    """Generator seeds of a `count`-member storm ensemble: the planner's
    ONE fixed-generator-index derivation
    (`planner.scenarios.derive_ensemble_seeds`) over the storm table,
    so member 0 is exactly the schedule `build_storms` produces for the
    same (name, base_seed) and no (storm, member) pair ever shares a
    raw seed."""
    from inferno_tpu_torch.planner.scenarios import derive_ensemble_seeds

    return derive_ensemble_seeds(
        STORM_GENERATORS, name, base_seed, count, what="storm scenario"
    )


def build_storms(
    names, pools: list[str], steps: int, step_seconds: float, seed: int = 0
) -> list[StormSchedule]:
    """Instantiate the named storm generators (all of STORM_GENERATORS
    when `names` is empty) with per-scenario derived seeds. The offset
    is each generator's FIXED position in STORM_GENERATORS — not the
    position in the caller's selection — so the same (scenario, seed)
    pair produces a bit-identical preemption schedule regardless of
    which other scenarios ride along (the convention the traffic
    generators pinned)."""
    picked = list(names) or list(STORM_GENERATORS)
    unknown = [n for n in picked if n not in STORM_GENERATORS]
    if unknown:
        raise ValueError(
            f"unknown storm scenario(s) {unknown}; "
            f"available: {sorted(STORM_GENERATORS)}"
        )
    offset = {name: i for i, name in enumerate(STORM_GENERATORS)}
    return [
        STORM_GENERATORS[name](pools, steps, step_seconds, seed=seed + offset[name])
        for name in picked
    ]


# -- storm evaluation against a batched placement -----------------------------


def _rank_meta(system, accelerators: list[str]):
    """(pool, region, cost_per_chip_hr) per accelerator rank."""
    pools, regions, price = [], [], []
    for name in accelerators:
        acc = system.accelerators.get(name)
        pools.append(acc.pool if acc else "")
        regions.append(acc.region if acc else "")
        price.append(acc.spec.cost_per_chip_hr if acc else 0.0)
    return pools, regions, np.asarray(price, np.float64)


def evaluate_storms(
    system,
    result,
    schedule: StormSchedule,
    prepositioned: bool,
) -> dict:
    """Drive one storm schedule through a solved [T, S] placement.

    Per event, per timestep of its recovery window: a spot reclaim takes
    ``ceil(fraction x POOL spot replicas)`` replicas — correlation is at
    the pool, the provider's reclaim unit — apportioned across the
    pool's spot-placed variants by largest remainder of their individual
    shares (deterministic; ties break by server order); a zone outage
    takes every affected placement whole. A variant whose surviving
    replicas drop below its load-required count (`result.required`) is
    in violation for that step.

    ``prepositioned=True`` models the reserved-headroom pre-positioner:
    after the first storm step (the failover latency), evicted replicas
    restart on the ``ceil(blast_radius x spot chips)`` of reserved slack
    held per pool, granted in priority order until the headroom runs
    out; the held chips are also PRICED into the reported cost for the
    whole horizon (priced at each spot replica's own reserved chip
    rate). ``False`` is the reactive baseline: evicted replicas stay
    down for the full recovery window and nothing extra is paid.
    """
    if result.spot_replicas is None or result.required is None:
        raise ValueError(
            "storm evaluation needs a spot-enabled batch result "
            "(configure TPU_SPOT_POOLS / CapacitySpec.spot before the solve)"
        )
    n_steps, n_srv = result.replicas.shape
    step_s = schedule.step_seconds
    pools, regions, chip_price = _rank_meta(system, result.accelerators)
    rank = np.maximum(result.choice, 0)
    placed = result.choice >= 0
    reps = result.replicas.astype(np.int64)
    spot = result.spot_replicas.astype(np.int64)
    required = result.required.astype(np.int64)
    chips_per_rep = np.where(reps > 0, result.chips // np.maximum(reps, 1), 0)
    prio = np.asarray(
        [s.priority(system) for s in system.servers.values()], np.int64
    )
    prio_order = np.argsort(prio, kind="stable")

    # per-accelerator-rank pool membership, hoisted out of every loop:
    # [ranks] boolean per pool name, indexed by the winner rank matrix
    pool_mask = {
        pool: np.asarray([p == pool for p in pools], bool)
        for pool in sorted(set(pools))
    }

    # chips each pool's tier carries per step, and the headroom the
    # pre-positioner holds for it (the configured blast radius, NOT the
    # storm's realized fraction — the operator provisions for the model)
    spot_chips = spot * chips_per_rep
    lost = np.zeros((n_steps, n_srv), np.int64)
    # aligned with event_windows: each event's OWN loss contribution,
    # for per-event failover gating and recovery attribution
    event_losses: list[np.ndarray] = []
    event_windows: list[tuple[StormEvent, int, int]] = []
    for ev in schedule.events:
        t0 = ev.step
        t1 = min(n_steps, t0 + ev.recovery_steps)
        if t0 >= n_steps or t1 <= t0:
            continue
        in_pool = pool_mask.get(ev.pool, np.zeros(len(pools), bool))[rank]
        loss_ev = np.zeros((n_steps, n_srv), np.int64)
        if ev.kind == "zone_outage":
            in_zone = np.asarray(
                [regions[r] == ev.region for r in range(len(regions))], bool
            )[rank]
            affected = placed & in_pool & in_zone
            victim = np.ceil(ev.fraction * reps).astype(np.int64)
            loss_ev[t0:t1] = np.where(affected[t0:t1], victim[t0:t1], 0)
        else:
            # pool-correlated reclaim: the provider takes fraction x the
            # POOL's spot replicas in one storm; largest-remainder
            # apportionment spreads the whole-replica kills across the
            # spot-placed variants without the per-variant ceil()
            # over-eviction a naive model would inflict
            affected = placed & in_pool & (spot > 0)
            for t in range(t0, t1):
                quota = np.where(affected[t], ev.fraction * spot[t], 0.0)
                total = int(math.ceil(quota.sum()))
                if total <= 0:
                    continue
                base = np.minimum(np.floor(quota).astype(np.int64), spot[t])
                short = total - int(base.sum())
                if short > 0:
                    frac = np.where(spot[t] > base, quota - base, -1.0)
                    top = np.argsort(-frac, kind="stable")[:short]
                    extra = np.zeros(n_srv, np.int64)
                    extra[top[frac[top] >= 0.0]] = 1
                    base = base + extra
                loss_ev[t] = base
        lost += loss_ev
        event_losses.append(loss_ev)
        event_windows.append((ev, t0, t1))
    lost = np.minimum(lost, reps)

    restored = np.zeros_like(lost)
    if prepositioned and event_windows:
        blast = {
            pool: spec.blast_radius
            for pool, spec in getattr(system, "spot", {}).items()
        }
        # failover gating is PER EVENT: only replicas an event killed at
        # this very step (t == its onset) wait out the failover latency;
        # victims of already-running events keep their headroom
        onset_lost = np.zeros_like(lost)
        for loss_ev, (_, t0, _) in zip(event_losses, event_windows):
            onset_lost[t0] += loss_ev[t0]
        restorable = np.minimum(lost, np.maximum(lost - onset_lost, 0))
        for t in range(n_steps):
            if not restorable[t].any():
                continue
            # headroom chips held per pool at this step
            head = {
                pool: headroom_chips(
                    blast.get(pool, 0.0),
                    int(spot_chips[t][placed[t] & mask[rank[t]]].sum()),
                )
                for pool, mask in pool_mask.items()
                if pool in blast
            }
            for s in prio_order:
                if restorable[t, s] == 0 or chips_per_rep[t, s] == 0:
                    continue
                pool = pools[rank[t, s]]
                avail = head.get(pool, 0)
                give = min(
                    int(restorable[t, s]), avail // int(chips_per_rep[t, s])
                )
                if give > 0:
                    restored[t, s] = give
                    head[pool] = avail - give * int(chips_per_rep[t, s])

    serving = reps - lost + restored
    violating = placed & (serving < required) & (required > 0)
    violation_seconds = float(violating.sum() * step_s)
    evicted_replica_steps = int(lost.sum())

    # recovery time per event: steps from onset until none of the
    # variants THIS event evicted is violating (capped at the window
    # end) — overlapping storms must not inflate each other's recovery
    recoveries = []
    for loss_ev, (ev, t0, t1) in zip(event_losses, event_windows):
        own = violating[t0:t1] & (loss_ev[t0:t1] > 0)
        vio_steps = np.flatnonzero(own.any(axis=1))
        recoveries.append(
            float((int(vio_steps[-1]) + 1) * step_s) if len(vio_steps) else 0.0
        )

    cost_usd_hr = result.cost.astype(np.float64).sum(axis=1) / 100.0
    headroom_usd_hr = np.zeros(n_steps, np.float64)
    if prepositioned:
        spot_map = getattr(system, "spot", {})
        for pool, spec in spot_map.items():
            in_pool = np.asarray(
                [pools[r] == pool for r in range(len(pools))], bool
            )[rank]
            pool_spot_cost = np.where(
                placed & in_pool,
                spot_chips * chip_price[rank], 0.0,
            ).sum(axis=1)
            headroom_usd_hr += spec.blast_radius * pool_spot_cost / 100.0
    total_usd_hr = cost_usd_hr + headroom_usd_hr
    return {
        "prepositioned": prepositioned,
        "violation_seconds": violation_seconds,
        "violating_variant_steps": int(violating.sum()),
        "evicted_replica_steps": evicted_replica_steps,
        "restored_replica_steps": int(restored.sum()),
        "recovery_s_max": max(recoveries, default=0.0),
        "recovery_s_mean": (
            float(np.mean(recoveries)) if recoveries else 0.0
        ),
        "cost_mean_usd_per_hr": float(total_usd_hr.mean()) if n_steps else 0.0,
        "headroom_mean_usd_per_hr": (
            float(headroom_usd_hr.mean()) if n_steps else 0.0
        ),
        "total_usd": float(total_usd_hr.sum() * step_s / 3600.0),
        "events": [dataclasses.asdict(ev) for ev, _, _ in event_windows],
    }


def _risk_blind(spot_map: dict) -> dict:
    """The risk-blind spot-greedy baseline: the same tiers with the
    risk penalty zeroed, so every price-eligible replica rides spot and
    no headroom is held (evaluate_storms prices none either)."""
    return {
        pool: dataclasses.replace(spec, hazard_per_hr=0.0, penalty_factor=0.0)
        for pool, spec in spot_map.items()
    }


def _solve_placements(system_spec, trace, backend: str, chunk_steps, device):
    """The storm comparison's two placements, solved ONCE per trace:
    the risk-blind spot-greedy baseline and the configured risk model.
    Shared by the single-schedule replay and the seeded ensemble (whose
    members differ only in the storm schedule, never the placement)."""
    import dataclasses as dc

    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.parallel.fleet import calculate_fleet_batch

    spot_map = dict(system_spec.capacity.spot)
    if not spot_map:
        raise ValueError(
            "replay_spot_storm needs at least one spot tier "
            "(SystemSpec.capacity.spot / TPU_SPOT_POOLS)"
        )

    def solve(spot_cfg):
        spec = dc.replace(
            system_spec,
            capacity=dc.replace(system_spec.capacity, spot=spot_cfg),
        )
        system = System(spec)
        result = calculate_fleet_batch(
            system, trace.rates, backend=backend, device=device,
            chunk_steps=chunk_steps,
        )
        return system, result

    blind = solve(_risk_blind(spot_map))
    risk = solve(spot_map)
    return blind, risk


def _storm_verdict(sys_blind, res_blind, sys_risk, res_risk, schedule):
    reactive = evaluate_storms(sys_blind, res_blind, schedule, False)
    prepositioned = evaluate_storms(sys_risk, res_risk, schedule, True)
    cost_a, cost_b = reactive["total_usd"], prepositioned["total_usd"]
    return {
        "storm": schedule.name,
        "storm_seed": schedule.seed,
        "reactive": reactive,
        "prepositioned": prepositioned,
        "violation_s_saved": round(
            reactive["violation_seconds"] - prepositioned["violation_seconds"], 3
        ),
        "cost_delta_pct": round(
            100.0 * (cost_b - cost_a) / cost_a if cost_a else 0.0, 3
        ),
    }


def replay_spot_storm(
    system_spec,
    trace,
    schedule: StormSchedule,
    backend: str = "cuda",
    chunk_steps: int | None = None,
    device=None,
) -> dict:
    """The planner's storm report: one traffic trace solved twice — the
    risk-blind spot-greedy baseline vs the configured risk model with
    pre-positioned reserved headroom — and the same seeded storm
    schedule evaluated against both placements.

    `system_spec` is a `config.types.SystemSpec` whose capacity carries
    the spot tiers; `trace` a `planner.scenarios.ScenarioTrace`."""
    (sys_blind, res_blind), (sys_risk, res_risk) = _solve_placements(
        system_spec, trace, backend, chunk_steps, device
    )
    return {
        "scenario": trace.name,
        "steps": trace.steps,
        "step_seconds": trace.step_seconds,
        "variants": len(res_risk.servers),
        **_storm_verdict(sys_blind, res_blind, sys_risk, res_risk, schedule),
    }


def replay_spot_storm_ensemble(
    system_spec,
    trace,
    storm: str,
    seeds: int,
    base_seed: int = 0,
    backend: str = "cuda",
    chunk_steps: int | None = None,
    device=None,
) -> dict:
    """Storm scenarios as a seed axis (the Monte Carlo envelope of
    the planner): the two placements are
    solved ONCE — storms only remove already-placed replicas, so every
    ensemble member shares them — and `seeds` independently seeded
    schedules of the named storm generator are evaluated against both,
    folded into the planner's percentile envelopes
    (`planner.montecarlo.percentile_envelope`): violation-seconds,
    recovery time, total cost, and the pre-positioner's saving per
    member. Member k's schedule derives from
    `storm_ensemble_seeds(storm, base_seed, ...)[k]` — member 0 is the
    single-schedule replay's storm, so an ensemble is a strict superset
    of the canonical comparison."""
    from inferno_tpu_torch.planner.montecarlo import percentile_envelope

    if storm not in STORM_GENERATORS:
        raise ValueError(
            f"unknown storm scenario {storm!r}; "
            f"available: {sorted(STORM_GENERATORS)}"
        )
    (sys_blind, res_blind), (sys_risk, res_risk) = _solve_placements(
        system_spec, trace, backend, chunk_steps, device
    )
    pools = sorted(getattr(sys_risk, "spot", {}))
    gen = STORM_GENERATORS[storm]
    members = []
    for seed in storm_ensemble_seeds(storm, base_seed, seeds):
        schedule = gen(pools, trace.steps, trace.step_seconds, seed=seed)
        members.append(
            _storm_verdict(sys_blind, res_blind, sys_risk, res_risk, schedule)
        )

    def env(path) -> dict:
        return percentile_envelope([path(m) for m in members])

    report = {
        "scenario": trace.name,
        "storm": storm,
        "base_seed": base_seed,
        "seeds": seeds,
        "seed_derivation": (
            "base + fixed storm-generator offset + k * "
            "len(STORM_GENERATORS) (storm_ensemble_seeds; member 0 == "
            "the single replay)"
        ),
        "steps": trace.steps,
        "step_seconds": trace.step_seconds,
        "variants": len(res_risk.servers),
        "reactive": {
            "violation_seconds": env(
                lambda m: m["reactive"]["violation_seconds"]
            ),
            "recovery_s_max": env(lambda m: m["reactive"]["recovery_s_max"]),
            "total_usd": env(lambda m: m["reactive"]["total_usd"]),
        },
        "prepositioned": {
            "violation_seconds": env(
                lambda m: m["prepositioned"]["violation_seconds"]
            ),
            "recovery_s_max": env(
                lambda m: m["prepositioned"]["recovery_s_max"]
            ),
            "total_usd": env(lambda m: m["prepositioned"]["total_usd"]),
        },
        "violation_s_saved": env(lambda m: m["violation_s_saved"]),
        "cost_delta_pct": env(lambda m: m["cost_delta_pct"]),
        # the tail-risk saving: does pre-positioning still pay at the
        # WORST seeded storm, not just the canonical one
        "saving_probability": round(
            sum(m["violation_s_saved"] > 0 for m in members)
            / max(len(members), 1), 6,
        ),
        "per_seed": {
            "storm_seed": [m["storm_seed"] for m in members],
            "violation_s_saved": [m["violation_s_saved"] for m in members],
            "reactive_violation_s": [
                m["reactive"]["violation_seconds"] for m in members
            ],
            "prepositioned_violation_s": [
                m["prepositioned"]["violation_seconds"] for m in members
            ],
        },
    }
    return report
