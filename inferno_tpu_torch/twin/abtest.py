"""Closed-loop policy A/B at fleet scale, on the vectorized twin plant.

`run_twin_ab` drives two (or more) solver policies through the SAME
seeded trace against a `TwinPlant` fleet — real queueing, real KV
admission, real spot kills — and scores each on SLO-violation seconds
and provisioned cost. The policies are the closed-loop pair the fluid
plant (`emulator.experiment.run_autoscale_loop`) validates: "reactive"
sizes on the window's observed arrival rate, "predictive" feeds the same
observations through `forecast.ArrivalForecaster` and sizes on the upper
band at the spin-up horizon. Here the plant is a thousand discrete-event
engines instead of a fluid approximation, so violation seconds come from
MEASURED per-window TTFT tails, not a capacity inequality.

Observations flow through the `TwinPromFeed` seam (twin/promfeed.py):
the loop reads the arrival rate off the same FakeProm samples the real
collector would read, so the policy sees the fleet exactly as the
production reconciler does.

Port copy of `inferno_tpu/twin/abtest.py`, verbatim apart from its imports
and the `backend`/`device` arguments passed on to `TwinPlant`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from inferno_tpu_torch.emulator.engine import EngineProfile
from inferno_tpu_torch.emulator.experiment import sustainable_rate_rps
from inferno_tpu_torch.twin.plant import TwinPlant
from inferno_tpu_torch.twin.promfeed import TwinPromFeed
from inferno_tpu_torch.twin.traces import TwinTrace, build_trace

POLICIES = ("reactive", "predictive")


@dataclasses.dataclass(frozen=True)
class TwinABScenario:
    """One closed-loop fleet experiment: a trace, a pool of emulated
    engines, spin-up latency, and an SLO. `rate_rps` is the trace's base
    (1x) fleet rate; None sizes it so the canonical burst peak (9x)
    lands near the full pool's sustainable ceiling."""

    name: str = "twin-ab"
    engines: int = 64
    profile: EngineProfile = dataclasses.field(default_factory=EngineProfile)
    trace: str = "ramp_burst"
    rate_rps: float | None = None
    duration_s: float = 92.0
    seed: int = 0
    control_interval_s: float = 2.0
    spinup_s: float = 4.0
    initial_replicas: int | None = None  # None = 2x the trace's 1x rate
    max_replicas: int | None = None  # None = the whole pool
    slo_ttft_ms: float = 2000.0
    # spot-storm schedule, spot injector contract: at each (t_s, count)
    # the count lowest-index surviving engines die abruptly
    kills: tuple[tuple[float, int], ...] = ()
    reactive_stabilization_s: float = 120.0
    predictive_stabilization_s: float | None = None
    cost_per_replica_hr: float = 1.0

    def lambda_max_rps(self) -> float:
        """Per-replica sustainable ceiling AT THE TRACE'S token mix — a
        short probe of the same generator/seed estimates the mean
        request shape (the lognormal means sit well above the medians,
        and agentic traces grow context; sizing from nominal medians
        overestimates capacity ~40% and saturates the pool)."""
        probe = build_trace(self.trace, 20.0, 30.0, self.seed)
        return sustainable_rate_rps(
            self.profile,
            int(round(float(probe.in_tokens.mean()))) or 1,
            int(round(float(probe.out_tokens.mean()))) or 1,
        )

    def base_rate_rps(self) -> float:
        """Default 1x rate: the canonical 9x burst peaks at 75% of the
        full pool's sustainable ceiling — hot enough that a lagging
        policy builds real queues, cold enough that a good one can
        absorb it (at >90% of ceiling NO policy can, and the A/B stops
        discriminating)."""
        if self.rate_rps is not None:
            return self.rate_rps
        return self.lambda_max_rps() * self.engines / 12.0

    def build_trace(self) -> TwinTrace:
        return build_trace(
            self.trace, self.base_rate_rps(), self.duration_s, self.seed
        )


def run_twin_policy_loop(
    scenario: TwinABScenario,
    policy: str = "reactive",
    trace: TwinTrace | None = None,
    instruments=None,
    backend: str | None = None,
    device=None,
) -> dict[str, Any]:
    """One policy through the scenario, closed loop. Deterministic:
    same scenario + seed => bit-identical report. `instruments` (a
    `controller.metrics.TwinInstruments`) publishes per-window plant
    progress to the linted `inferno_twin_*` series when provided.
    `backend`/`device` choose where the plant's step cost runs
    (`TwinPlant`: None = TWIN_BACKEND, else torch on the CUDA card)."""
    from inferno_tpu_torch.forecast import (
        ArrivalForecaster,
        ForecastConfig,
        ScaleDownStabilizer,
    )

    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    predictive = policy == "predictive"
    trace = trace if trace is not None else scenario.build_trace()
    lam_max = scenario.lambda_max_rps()
    E = scenario.engines
    max_replicas = min(scenario.max_replicas or E, E)
    plant = TwinPlant(scenario.profile, E, backend=backend, device=device)
    feed = TwinPromFeed(model_id=scenario.name)

    forecaster = (
        ArrivalForecaster(
            ForecastConfig(reference_interval_s=scenario.control_interval_s)
        )
        if predictive else None
    )
    window = (
        scenario.predictive_stabilization_s
        if scenario.predictive_stabilization_s is not None
        else 2.0 * (scenario.spinup_s + scenario.control_interval_s)
    ) if predictive else scenario.reactive_stabilization_s
    stabilizer = ScaleDownStabilizer(window)
    horizon = scenario.spinup_s + scenario.control_interval_s

    serving = min(
        scenario.initial_replicas
        if scenario.initial_replicas is not None
        else max(math.ceil(2.0 * scenario.base_rate_rps() / lam_max), 1),
        max_replicas,
    )
    # per-window capacity yardstick at the OBSERVED token mix (what the
    # real sizing path derives from the collector's token-rate ratios),
    # cached on the rounded request shape
    _lam_cache: dict[tuple[int, int], float] = {}

    def _lam_max_at(avg_in: float, avg_out: float) -> float:
        key = (int(round(avg_in / 16.0)) * 16, int(round(avg_out / 16.0)) * 16)
        if key[0] <= 0 or key[1] <= 0:
            return lam_max
        if key not in _lam_cache:
            _lam_cache[key] = sustainable_rate_rps(
                scenario.profile, key[0], key[1]
            )
        return _lam_cache[key]
    pending: list[list[float]] = []  # [ready_at_s, count]
    alive = list(range(E))
    kills = sorted(scenario.kills)
    ki = 0
    rr = 0  # round-robin cursor
    cursor = 0  # next trace index to route
    dt = scenario.control_interval_s
    end = scenario.duration_s
    violation_s = 0.0
    replica_seconds = 0.0
    peak_provisioned = serving
    scale_ups = scale_downs = 0
    window_p95: list[float] = []
    avg_in_w = avg_out_w = 0.0  # last window's arrival token means

    t = 0.0
    while t < end - 1e-9:
        t1 = min(t + dt, end)
        ready = [p for p in pending if p[0] <= t + 1e-9]
        if ready:
            serving += int(sum(c for _, c in ready))
            pending = [p for p in pending if p[0] > t + 1e-9]
        serving = min(serving, len(alive))
        enabled = alive[: max(serving, 1)]

        # route this window's arrivals round-robin over enabled engines
        hi = int(np.searchsorted(trace.arr_ms, t1 * 1000.0, side="left"))
        n_arr = hi - cursor
        if n_arr > 0:
            sl = slice(cursor, hi)
            # token mix published for sizing comes from the ARRIVAL side
            # (what a gateway observes at admission). Completion-side
            # means are survivorship-biased in short windows: under
            # overload only small requests finish, inflating the
            # apparent per-engine capacity right when it matters most.
            avg_in_w = float(trace.in_tokens[sl].mean())
            avg_out_w = float(trace.out_tokens[sl].mean())
            eng = np.asarray(
                [enabled[(rr + i) % len(enabled)] for i in range(n_arr)],
                dtype=np.int64,
            )
            plant.inject_bulk(
                eng, trace.arr_ms[sl], trace.in_tokens[sl],
                trace.out_tokens[sl],
            )
            rr += n_arr
            cursor = hi

        # advance, splitting at kill instants inside the window
        seg = t
        while ki < len(kills) and kills[ki][0] <= t1 + 1e-9:
            kt, count = kills[ki]
            plant.advance_to(max(kt, seg) * 1000.0)
            victims = alive[:count]  # lowest surviving index first
            plant.preempt(np.asarray(victims, dtype=np.int64))
            killed_enabled = sum(1 for e in victims if e in enabled)
            alive = [e for e in alive if e not in victims]
            serving = max(serving - killed_enabled, 0)
            enabled = alive[: max(serving, 1)]
            seg = max(kt, seg)
            ki += 1
        plant.advance_to(t1 * 1000.0)
        if instruments is not None:
            instruments.observe_plant(plant, policy=policy)

        # observe the window
        rids = plant.drain_completions()
        res = plant.results(rids) if len(rids) else None
        lam_obs = n_arr / (t1 - t)
        if res is not None:
            ttft = res["ttft_emu_ms"]
            lat = res["latency_emu_ms"]
            out = res["out_tokens"]
            multi = out > 1
            itl = (
                float(
                    ((lat[multi] - ttft[multi]) / (out[multi] - 1)).mean()
                )
                if multi.any() else 0.0
            )
            p95 = float(np.percentile(ttft, 95))
            window_p95.append(p95)
            feed.publish(
                arrival_rps=lam_obs,
                avg_in_tokens=avg_in_w,
                avg_out_tokens=avg_out_w,
                ttft_ms=float(ttft.mean()),
                itl_ms=itl,
                running=float(plant.batch.sum()),
            )
            violating = p95 > scenario.slo_ttft_ms
        else:
            feed.publish(lam_obs, avg_in_w, avg_out_w, 0.0, 0.0,
                         float(plant.batch.sum()))
            # no completions: violating iff work is stuck behind the
            # breach (arrived requests waiting with nothing finishing)
            violating = plant.waiting_total() > 0
        if violating:
            violation_s += t1 - t

        provisioned = serving + int(sum(c for _, c in pending))
        peak_provisioned = max(peak_provisioned, provisioned)
        replica_seconds += provisioned * (t1 - t)

        # the policy decision — the arrival rate read back through the
        # FakeProm seam, exactly what the real collector derives
        lam_sizing = feed.arrival_rpm() / 60.0
        if forecaster is not None:
            forecaster.observe(scenario.name, t1, lam_sizing)
            fc = forecaster.forecast(scenario.name, horizon)
            if fc.valid:
                lam_sizing = max(lam_sizing, fc.upper)
        # backlog-drain term, BOTH policies: the twin's queues are real,
        # so sizing to the arrival rate alone leaves any standing queue
        # standing forever (the fluid plant never sees this — its
        # violation is a capacity inequality with no queue memory);
        # budget the backlog to drain over one actuation cycle
        lam_sizing += plant.waiting_total() / horizon
        lam_max_w = _lam_max_at(*feed.token_means())
        raw = min(max_replicas, max(1, math.ceil(lam_sizing / lam_max_w)))
        raw = min(raw, len(alive))
        desired, _held = stabilizer.recommend(scenario.name, raw, t1)
        desired = min(desired, len(alive))
        if desired > provisioned:
            pending.append([t1 + scenario.spinup_s, desired - provisioned])
            scale_ups += 1
        elif desired < provisioned:
            drop = provisioned - desired
            scale_downs += 1
            for p in sorted(pending, key=lambda p: -p[0]):
                take = min(drop, int(p[1]))
                p[1] -= take
                drop -= take
                if drop == 0:
                    break
            pending = [p for p in pending if p[1] > 0]
            serving -= drop  # scale-in is immediate (drain: no new load)
        t = t1

    rep = plant.report()
    avg_replicas = replica_seconds / end
    duration_h = end / 3600.0
    return {
        "provenance": policy,
        "stabilization_window_s": window,
        "slo_violation_s": round(violation_s, 3),
        "violation_fraction": round(violation_s / end, 4),
        "replica_seconds": round(replica_seconds, 3),
        "avg_replicas": round(avg_replicas, 3),
        "peak_replicas": peak_provisioned,
        "cost": round(avg_replicas * scenario.cost_per_replica_hr * duration_h, 6),
        "scale_ups": scale_ups,
        "scale_downs": scale_downs,
        "requests": rep["requests"],
        "completed": rep["completed"],
        "rejected": rep["rejected"],
        "preempted_requests": rep["preempted_requests"],
        "p95_ttft_emu_ms": round(
            float(np.percentile(window_p95, 95)) if window_p95 else 0.0, 3
        ),
        "events_total": rep["events_total"],
    }


def run_twin_ab(
    scenario: TwinABScenario | None = None,
    policies: tuple[str, ...] = POLICIES,
    instruments=None,
    backend: str | None = None,
    device=None,
) -> dict[str, Any]:
    """A/B (or A/B/C) the policies on one seeded trace; the comparison
    block scores the second policy against the first. `instruments`
    (controller.metrics.TwinInstruments) receives per-window plant
    progress, labelled by policy. `backend`/`device` go to every
    policy's `TwinPlant`."""
    scenario = scenario or TwinABScenario()
    trace = scenario.build_trace()
    out: dict[str, Any] = {
        "scenario": {
            "name": scenario.name,
            "engines": scenario.engines,
            "trace": scenario.trace,
            "base_rate_rps": round(scenario.base_rate_rps(), 4),
            "duration_s": scenario.duration_s,
            "seed": scenario.seed,
            "requests": trace.requests,
            "lambda_max_rps": round(scenario.lambda_max_rps(), 4),
            "spinup_s": scenario.spinup_s,
            "control_interval_s": scenario.control_interval_s,
            "slo_ttft_ms": scenario.slo_ttft_ms,
            "kills": [list(k) for k in scenario.kills],
        },
    }
    for p in policies:
        out[p] = run_twin_policy_loop(scenario, p, trace=trace,
                                      instruments=instruments,
                                      backend=backend, device=device)
    if len(policies) >= 2:
        a, b = out[policies[0]], out[policies[1]]
        out["comparison"] = {
            "baseline": policies[0],
            "candidate": policies[1],
            "slo_violation_s_saved": round(
                a["slo_violation_s"] - b["slo_violation_s"], 3
            ),
            "cost_delta": round(b["cost"] - a["cost"], 6),
        }
    return out
