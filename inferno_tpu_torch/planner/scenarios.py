"""Deterministic traffic-scenario generators for the offline planner.

Each generator turns a per-server base-rate vector (req/min, the
System's server order) into a `ScenarioTrace` — a [T, S] rate matrix the
batched time-axis solve (`parallel.fleet.calculate_fleet_batch`) replays
in one pass. Everything is seeded and reproducible: the same
(base, steps, step_seconds, seed) always produces bit-identical traces,
so planner reports are diffable across runs.

Shapes are built from the emulator's schedule language where one exists
(`RateSpec` / `RateSpec.ramp`, sampled per step by
`emulator.experiment.rate_trace`) so the planner's ramps and the
closed-loop autoscale experiments describe load the same way; the
stochastic structure (which variants burst, regional phase jitter) comes
from a `numpy` Generator seeded per scenario.

Port of `inferno_tpu/planner/scenarios.py`, verbatim apart from its
imports.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from inferno_tpu_torch.emulator.experiment import rate_trace
from inferno_tpu_torch.emulator.loadgen import RateSpec

DAY_S = 86400.0


@dataclasses.dataclass(frozen=True)
class ScenarioTrace:
    """One replayable traffic scenario: [T, S] arrival rates (req/min)."""

    name: str
    rates: np.ndarray
    step_seconds: float
    seed: int
    description: str = ""

    @property
    def steps(self) -> int:
        return len(self.rates)

    @property
    def duration_s(self) -> float:
        return self.steps * self.step_seconds


def base_rates_from_system(system) -> np.ndarray:
    """Per-server base arrival rates (req/min) in system server order;
    servers without load report 0 (they are skipped by the replay)."""
    return np.asarray(
        [
            s.load.arrival_rate if s.load is not None else 0.0
            for s in system.servers.values()
        ],
        np.float64,
    )


def _trace(name, rates, step_seconds, seed, description) -> ScenarioTrace:
    return ScenarioTrace(
        name=name,
        rates=np.maximum(np.asarray(rates, np.float64), 0.0),
        step_seconds=step_seconds,
        seed=seed,
        description=description,
    )


def diurnal(
    base: np.ndarray,
    steps: int,
    step_seconds: float,
    seed: int = 0,
    amplitude: float = 0.6,
    period_s: float = DAY_S,
    phase_jitter: float = 0.15,
) -> ScenarioTrace:
    """Daily sinusoid around the base rate with reproducible per-variant
    phase jitter (users of different variants wake at different hours)."""
    rng = np.random.default_rng(seed)
    t = (np.arange(steps, dtype=np.float64) + 0.5) * step_seconds
    phase = rng.uniform(-phase_jitter, phase_jitter, size=len(base)) * period_s
    mult = 1.0 + amplitude * np.sin(
        2.0 * math.pi * (t[:, None] + phase[None, :]) / period_s
    )
    return _trace(
        "diurnal", base[None, :] * mult, step_seconds, seed,
        f"daily sinusoid, amplitude {amplitude}, per-variant phase jitter",
    )


def ramp(
    base: np.ndarray,
    steps: int,
    step_seconds: float,
    seed: int = 0,
    start_scale: float = 0.5,
    end_scale: float = 2.0,
) -> ScenarioTrace:
    """Fleet-wide linear growth from `start_scale`x to `end_scale`x the
    base rate over the horizon — quarter-over-quarter traffic growth —
    expressed as a `RateSpec.ramp` sampled at step midpoints."""
    spec = RateSpec.ramp(
        start_scale, end_scale, duration=steps * step_seconds,
        steps=min(max(steps, 1), 256),
    )
    mult = rate_trace(spec, steps, step_seconds)
    return _trace(
        "ramp", base[None, :] * mult[:, None], step_seconds, seed,
        f"fleet-wide ramp {start_scale}x -> {end_scale}x",
    )


def flash_crowd(
    base: np.ndarray,
    steps: int,
    step_seconds: float,
    seed: int = 0,
    bursts: int = 3,
    magnitude: tuple[float, float] = (3.0, 8.0),
    width_steps: tuple[int, int] = (1, 3),
    fraction: float = 0.2,
) -> ScenarioTrace:
    """Baseline traffic with `bursts` correlated flash crowds: each burst
    hits a random `fraction` of the variants with a `magnitude`x spike
    lasting `width_steps` timesteps."""
    rng = np.random.default_rng(seed)
    mult = np.ones((steps, len(base)), np.float64)
    n_hit = max(1, int(round(fraction * len(base))))
    for _ in range(max(bursts, 0)):
        if steps == 0:
            break
        t0 = int(rng.integers(0, steps))
        width = int(rng.integers(width_steps[0], width_steps[1] + 1))
        mag = float(rng.uniform(*magnitude))
        hit = rng.choice(len(base), size=n_hit, replace=False)
        mult[t0 : t0 + width, hit] *= mag
    return _trace(
        "flash_crowd", base[None, :] * mult, step_seconds, seed,
        f"{bursts} bursts x {magnitude} on {fraction:.0%} of variants",
    )


def launch(
    base: np.ndarray,
    steps: int,
    step_seconds: float,
    seed: int = 0,
    fraction: float = 0.1,
    launch_scale: float = 1.5,
    ramp_steps: int = 12,
) -> ScenarioTrace:
    """New-model launches: a random `fraction` of variants start near
    zero traffic and, at a random launch time, ramp to `launch_scale`x
    their base rate over `ramp_steps` (a `RateSpec.ramp` per variant)."""
    rng = np.random.default_rng(seed)
    rates = np.repeat(base[None, :], steps, axis=0)
    n_new = max(1, int(round(fraction * len(base))))
    new_ids = rng.choice(len(base), size=n_new, replace=False)
    launched = 0  # drawn ids with zero base rate have nothing to ramp
    for s in new_ids:
        if steps == 0 or base[s] <= 0:
            continue
        launched += 1
        t0 = int(rng.integers(0, max(steps - 1, 1)))
        width = min(max(ramp_steps, 1), steps - t0)
        spec = RateSpec.ramp(
            0.0, launch_scale * base[s], duration=width * step_seconds,
            steps=width,
        )
        rates[:t0, s] = 0.0
        rates[t0 : t0 + width, s] = rate_trace(spec, width, step_seconds)
        rates[t0 + width :, s] = launch_scale * base[s]
    return _trace(
        "launch", rates, step_seconds, seed,
        f"{launched} variants launch mid-horizon to {launch_scale}x base",
    )


def regional_skew(
    base: np.ndarray,
    steps: int,
    step_seconds: float,
    seed: int = 0,
    swing: float = 0.5,
    period_s: float = DAY_S,
    jitter: float = 0.2,
) -> ScenarioTrace:
    """Follow-the-sun traffic: variants split into two regional cohorts
    (alternating, mirroring `fleet_system_spec(split_pools=True)`'s r0/r1
    placement) whose shares of the load swing in antiphase over the day,
    plus a reproducible per-variant jitter factor (the `perturb_loads`
    rng-skew, applied once per variant)."""
    rng = np.random.default_rng(seed)
    t = (np.arange(steps, dtype=np.float64) + 0.5) * step_seconds
    wave = swing * np.sin(2.0 * math.pi * t / period_s)
    cohort = np.arange(len(base)) % 2  # 0 = r0, 1 = r1
    sign = np.where(cohort == 0, 1.0, -1.0)
    skew = 1.0 + jitter * rng.uniform(-1.0, 1.0, size=len(base))
    mult = (1.0 + wave[:, None] * sign[None, :]) * skew[None, :]
    return _trace(
        "regional_skew", base[None, :] * mult, step_seconds, seed,
        f"antiphase regional swing {swing} with per-variant jitter {jitter}",
    )


GENERATORS = {
    "diurnal": diurnal,
    "ramp": ramp,
    "flash_crowd": flash_crowd,
    "launch": launch,
    "regional_skew": regional_skew,
}


def derive_ensemble_seeds(
    table: dict, name: str, base_seed: int, count: int,
    what: str = "scenario",
) -> list[int]:
    """THE fixed-generator-index seed derivation for a `count`-member
    ensemble over any generator table: member k draws
    ``base_seed + offset(name) + k * len(table)``. The offset is the
    generator's FIXED position in its table and the stride the FIXED
    table size, so (a) member 0 is exactly what the single-replay
    builders (`build_scenarios` / `spot.scenarios.build_storms`)
    produce for the same (name, base_seed) — a single replay is the
    S=1 ensemble — and (b) no two (generator, member) pairs of one
    table ever share a raw seed, regardless of which generators or how
    many members ride along. One implementation shared by the traffic
    and storm ensembles so the convention cannot drift between them."""
    if name not in table:
        raise ValueError(
            f"unknown {what} {name!r}; available: {sorted(table)}"
        )
    offset = list(table).index(name)
    stride = len(table)
    return [base_seed + offset + k * stride for k in range(max(count, 0))]


def ensemble_seeds(name: str, base_seed: int, count: int) -> list[int]:
    """Generator seeds of a `count`-member Monte Carlo ensemble of one
    traffic scenario (`derive_ensemble_seeds` over GENERATORS)."""
    return derive_ensemble_seeds(GENERATORS, name, base_seed, count)


def build_scenarios(
    names, base: np.ndarray, steps: int, step_seconds: float, seed: int = 0
) -> list[ScenarioTrace]:
    """Instantiate the named generators (all of GENERATORS when `names`
    is empty) with per-scenario derived seeds. The offset is each
    generator's FIXED position in GENERATORS — not the position in the
    caller's selection — so the same (scenario, seed) pair produces the
    same trace regardless of which other scenarios ride along, and
    reports stay diffable across differently-scoped runs."""
    picked = list(names) or list(GENERATORS)
    unknown = [n for n in picked if n not in GENERATORS]
    if unknown:
        raise ValueError(
            f"unknown scenario(s) {unknown}; available: {sorted(GENERATORS)}"
        )
    offset = {name: i for i, name in enumerate(GENERATORS)}
    return [
        GENERATORS[name](base, steps, step_seconds, seed=seed + offset[name])
        for name in picked
    ]
