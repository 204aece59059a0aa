"""Eviction-storm fault injection for the emulator closed loop.

Two levels, matching the two emulator tiers:

* `PreemptionInjector` drives the DISCRETE-EVENT engines: it watches the
  replicas' virtual clocks and `EmulatedEngine.preempt()`s the scheduled
  count at each storm time, so a `run_scenario` experiment sees real
  mid-request kills (failed in-flight work, refused submissions).
  Because the injector polls wall-clock-derived virtual time, tests
  driving it belong in the `slow` tier on loaded hosts — the same flake
  class as the other emu-vs-wall tests.

* `run_spot_storm_loop` / `run_spot_storm_comparison` are the
  DETERMINISTIC closed loop (the `run_autoscale_loop` plant pattern: no
  threads, no sleeps, no RNG inside the loop): a reactive controller
  serves a schedule from spot replicas while seeded storms reclaim a
  correlated fraction of them. ``spot-greedy`` mode rides the discount
  with nothing pre-positioned — evicted capacity is gone for a full
  spin-up. ``prepositioned`` holds `ceil(blast_radius x spot)` reserved
  headroom replicas (billed at the full price) that take over one
  failover latency after the storm, until replacements spin up. Two
  runs produce identical results, which is what lets a fast test — and
  `make bench-spot` — assert a STRICT ordering on violation-seconds.

Port copy of `inferno_tpu/spot/injection.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Sequence

import numpy as np

from inferno_tpu_torch.emulator.engine import EmulatedEngine, EngineProfile
from inferno_tpu_torch.emulator.loadgen import RateSpec


class PreemptionInjector:
    """Kill engine replicas at scheduled emulated times.

    `kills` is a sequence of ``(t_emu_s, count)``: at each emulated time
    (the max of the engines' virtual clocks), preempt `count` surviving
    replicas — lowest index first, so the victim set is deterministic
    given the schedule. Correlation is the schedule's job: one entry
    with count > 1 IS a correlated storm within the pool the engines
    emulate."""

    def __init__(
        self,
        engines: Sequence[EmulatedEngine],
        kills: Sequence[tuple[float, int]],
        poll_s: float = 0.002,
    ):
        self.engines = list(engines)
        self.kills = sorted((float(t), int(n)) for t, n in kills)
        self.poll_s = poll_s
        self.preempted_engines = 0
        self.preempted_requests = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _emu_s(self) -> float:
        return max((e.emu_ms for e in self.engines), default=0.0) / 1000.0

    def _run(self) -> None:
        pending = list(self.kills)
        while pending and not self._stop.is_set():
            now = self._emu_s()
            while pending and pending[0][0] <= now:
                _, count = pending.pop(0)
                for e in self.engines:
                    if count == 0:
                        break
                    if not e.preempted:
                        self.preempted_requests += e.preempt()
                        self.preempted_engines += 1
                        count -= 1
            time.sleep(self.poll_s)


# -- deterministic closed-loop storm comparison -------------------------------


@dataclasses.dataclass(frozen=True)
class SpotStormScenario:
    """A closed-loop eviction-storm experiment: a rate schedule served
    from spot replicas, seeded correlated storms, and the spot-tier
    economics under test. Times are schedule (emulated) seconds."""

    name: str
    rate: RateSpec
    lambda_max_rps: float  # per-replica sustainable ceiling
    spinup_s: float  # eviction -> replacement serving, schedule seconds
    storms: tuple[tuple[float, float], ...]  # (t_s, fraction of spot replicas)
    control_interval_s: float = 2.0
    plant_dt_s: float = 0.25
    initial_replicas: int = 4
    max_replicas: int = 64
    cost_per_replica_hr: float = 1.0  # reserved price; spot pays (1 - discount)
    discount: float = 0.3
    blast_radius: float = 0.25  # headroom the pre-positioner holds
    failover_s: float = 1.0  # storm -> headroom serving


def storm_scenario(
    profile: EngineProfile = EngineProfile(),
    seed: int = 0,
    duration_s: float = 120.0,
    storms: int = 2,
    fraction: tuple[float, float] = (0.04, 0.06),
    spinup_s: float = 8.0,
    discount: float = 0.3,
    blast_radius: float = 0.06,
) -> SpotStormScenario:
    """The canonical correlated-storm scenario: a ~32-replica spot fleet
    at steady traffic, with `storms` seeded reclaims of a random
    `fraction` of the spot replicas. Storm times avoid the first and
    last tenth of the horizon so every recovery window is observable.

    The constants are chosen so the comparison is non-degenerate on
    BOTH axes: the offered rate sits ~0.6 replica-ceilings below the
    sized capacity (a backlog can actually drain — a fleet sized
    exactly at capacity never recovers), the storm fraction stays
    within the configured blast radius (the pre-positioner's headroom
    genuinely absorbs it), and the headroom is a small fraction of the
    fleet, keeping the pre-positioned cost overhead under the 10%
    acceptance bound."""
    from inferno_tpu_torch.emulator.experiment import sustainable_rate_rps

    lam = sustainable_rate_rps(profile)
    rng = np.random.default_rng(seed)
    times = np.sort(
        rng.uniform(0.1 * duration_s, 0.9 * duration_s, storms), kind="stable"
    )
    fracs = rng.uniform(*fraction, storms)
    return SpotStormScenario(
        name=f"spot-storm-seed{seed}",
        rate=RateSpec(((duration_s, 31.4 * lam),)),
        lambda_max_rps=lam,
        spinup_s=spinup_s,
        storms=tuple(
            (float(t), float(f)) for t, f in zip(times, fracs)
        ),
        initial_replicas=32,
        max_replicas=64,
        discount=discount,
        blast_radius=blast_radius,
    )


def run_spot_storm_loop(
    scenario: SpotStormScenario, mode: str = "spot-greedy"
) -> dict[str, Any]:
    """Drive one placement policy through the storm schedule.

    ``spot-greedy``: every replica rides the spot tier at the discounted
    price; a storm's victims are simply gone until replacements finish
    the full spin-up. ``prepositioned``: same spot placement, plus
    ``ceil(blast_radius x spot)`` reserved headroom replicas held idle
    at the full price; storm victims fail over onto the headroom after
    `failover_s`, and the headroom frees again when replacements arrive.
    Violation accounting matches `emulator.experiment.run_autoscale_loop`:
    a step with a capacity shortfall or an undrained backlog violates.
    """
    if mode not in ("spot-greedy", "prepositioned"):
        raise ValueError(
            f"mode must be spot-greedy|prepositioned, got {mode!r}"
        )
    prepos = mode == "prepositioned"
    lam_max = scenario.lambda_max_rps
    dt = scenario.plant_dt_s
    end = scenario.rate.total_duration

    serving = scenario.initial_replicas  # spot replicas serving
    pending: list[list[float]] = []  # [ready_at, count] spot replacements
    # headroom replicas currently SERVING storm victims: [release_at
    # (replacement ready), count]; release returns them to idle slack
    active_headroom: list[list[float]] = []
    # storm victims waiting out the failover latency: [serve_at, count]
    failover: list[list[float]] = []
    storms = sorted(scenario.storms)
    storm_i = 0

    backlog = 0.0
    violation_s = 0.0
    spot_replica_seconds = 0.0
    headroom_replica_seconds = 0.0
    preemptions = 0
    t = 0.0
    next_control = scenario.control_interval_s
    interval_integral = interval_elapsed = 0.0

    while t < end - 1e-9:
        ready = [p for p in pending if p[0] <= t + 1e-9]
        if ready:
            n_ready = int(sum(c for _, c in ready))
            serving += n_ready
            pending = [p for p in pending if p[0] > t + 1e-9]
            # replacements free the headroom that covered for them
            release = n_ready
            for h in active_headroom:
                take = min(release, int(h[1]))
                h[1] -= take
                release -= take
            active_headroom = [h for h in active_headroom if h[1] > 0]
        due = [f for f in failover if f[0] <= t + 1e-9]
        if due and prepos:
            for f in due:
                active_headroom.append([math.inf, f[1]])
            failover = [f for f in failover if f[0] > t + 1e-9]

        while storm_i < len(storms) and storms[storm_i][0] <= t + 1e-9:
            _, frac = storms[storm_i]
            storm_i += 1
            victims = min(serving, math.ceil(frac * serving))
            if victims <= 0:
                continue
            preemptions += victims
            serving -= victims
            pending.append([t + scenario.spinup_s, victims])
            if prepos:
                held = headroom_size(scenario, serving + victims)
                occupied = int(sum(h[1] for h in active_headroom))
                grant = min(victims, max(held - occupied, 0))
                if grant > 0:
                    failover.append([t + scenario.failover_s, grant])

        lam = scenario.rate.rate_at(t)
        serving_now = serving + int(sum(h[1] for h in active_headroom))
        capacity = serving_now * lam_max
        if lam > capacity:
            backlog += (lam - capacity) * dt
        else:
            backlog = max(0.0, backlog - (capacity - lam) * dt)
        if lam > capacity or backlog > 1e-9:
            violation_s += dt
        provisioned_spot = serving + int(sum(c for _, c in pending))
        spot_replica_seconds += provisioned_spot * dt
        if prepos:
            headroom_replica_seconds += headroom_size(
                scenario, provisioned_spot
            ) * dt
        interval_integral += lam * dt
        interval_elapsed += dt
        t += dt

        if t + 1e-9 >= next_control:
            lam_obs = interval_integral / max(interval_elapsed, 1e-9)
            interval_integral = interval_elapsed = 0.0
            desired = min(
                scenario.max_replicas, max(1, math.ceil(lam_obs / lam_max))
            )
            provisioned = serving + int(sum(c for _, c in pending))
            if desired > provisioned:
                pending.append([t + scenario.spinup_s, desired - provisioned])
            elif desired < provisioned:
                drop = provisioned - desired
                for p in sorted(pending, key=lambda p: -p[0]):
                    take = min(drop, int(p[1]))
                    p[1] -= take
                    drop -= take
                    if drop == 0:
                        break
                pending = [p for p in pending if p[1] > 0]
                serving -= drop
            next_control += scenario.control_interval_s

    duration_h = end / 3600.0
    price = scenario.cost_per_replica_hr
    cost = (
        (spot_replica_seconds / end) * price * (1.0 - scenario.discount)
        + (headroom_replica_seconds / end) * price
    ) * duration_h
    return {
        "mode": mode,
        "slo_violation_s": round(violation_s, 3),
        "violation_fraction": round(violation_s / end, 4),
        "preempted_replicas": preemptions,
        "spot_replica_seconds": round(spot_replica_seconds, 3),
        "headroom_replica_seconds": round(headroom_replica_seconds, 3),
        "cost": round(cost, 6),
        "final_backlog": round(backlog, 3),
    }


def headroom_size(scenario: SpotStormScenario, spot_replicas: int) -> int:
    """Reserved headroom replicas the pre-positioner holds for the
    current spot fleet — the replica-granular analogue of
    `market.headroom_chips`."""
    if spot_replicas <= 0:
        return 0
    return int(math.ceil(scenario.blast_radius * spot_replicas))


def run_spot_storm_comparison(
    scenario: SpotStormScenario | None = None,
) -> dict[str, Any]:
    """Risk-blind spot-greedy vs pre-positioned headroom on the same
    seeded storm schedule — the `make bench-spot` subject: the
    pre-positioner must cut violation-seconds strictly, at a bounded
    cost overhead."""
    scenario = scenario or storm_scenario()
    greedy = run_spot_storm_loop(scenario, "spot-greedy")
    prepos = run_spot_storm_loop(scenario, "prepositioned")
    return {
        "scenario": {
            "name": scenario.name,
            "duration_s": scenario.rate.total_duration,
            "storms": [list(s) for s in scenario.storms],
            "lambda_max_rps": round(scenario.lambda_max_rps, 4),
            "spinup_s": scenario.spinup_s,
            "discount": scenario.discount,
            "blast_radius": scenario.blast_radius,
        },
        "spot_greedy": greedy,
        "prepositioned": prepos,
        "violation_s_saved": round(
            greedy["slo_violation_s"] - prepos["slo_violation_s"], 3
        ),
        "cost_delta_pct": round(
            100.0 * (prepos["cost"] - greedy["cost"]) / greedy["cost"]
            if greedy["cost"] else 0.0,
            3,
        ),
    }
