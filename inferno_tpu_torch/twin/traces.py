"""Request-level trace generators for the fleet twin.

Fleet-scale arrival traces — each a sorted arrival-time column plus
in/out token columns — covering the scenario diversity the single
canonical plant could not: heavy-tailed token mixes, multi-turn/agentic
sessions that re-arrive with grown context, and correlated flash crowds.
Seeding follows the fixed-generator-index convention
(`planner.scenarios.derive_ensemble_seeds` over the `TRACES` table), so
member 0 of any ensemble is exactly the single-replay trace for the same
(name, seed) and no two (generator, member) pairs share a raw seed.

Port copy of `inferno_tpu/twin/traces.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from inferno_tpu_torch.emulator.loadgen import (
    SHAREGPT_INPUT,
    SHAREGPT_OUTPUT,
    RateSpec,
    TokenDistribution,
)
from inferno_tpu_torch.planner.scenarios import derive_ensemble_seeds


@dataclasses.dataclass(frozen=True)
class TwinTrace:
    """A fleet-level request trace: arrivals sorted nondecreasing."""

    name: str
    seed: int
    duration_s: float
    arr_ms: np.ndarray  # [N] float64, sorted
    in_tokens: np.ndarray  # [N] int64
    out_tokens: np.ndarray  # [N] int64

    @property
    def requests(self) -> int:
        return len(self.arr_ms)

    def offered_rps(self) -> float:
        return self.requests / self.duration_s if self.duration_s else 0.0


def _poisson_arrivals(
    rng: np.random.Generator, rate: RateSpec, duration_s: float
) -> np.ndarray:
    """Nonhomogeneous Poisson arrivals (msec) over a piecewise schedule:
    homogeneous exponential gaps within each phase, restarted at phase
    edges — the same process `LoadGenerator` realizes serially."""
    out: list[float] = []
    t_edge = 0.0
    for dur, rps in rate.phases:
        end = min(t_edge + dur, duration_s)
        t = t_edge
        if rps > 0:
            while True:
                t += float(rng.exponential(1.0 / rps))
                if t >= end:
                    break
                out.append(t * 1000.0)
        t_edge = end
        if t_edge >= duration_s:
            break
    return np.asarray(out, dtype=np.float64)


def _tokens(
    rng: np.random.Generator,
    n: int,
    in_dist: TokenDistribution,
    out_dist: TokenDistribution,
) -> tuple[np.ndarray, np.ndarray]:
    i = np.array([in_dist.sample(rng) for _ in range(n)], dtype=np.int64)
    o = np.array([out_dist.sample(rng) for _ in range(n)], dtype=np.int64)
    return i, o


def steady(rate_rps: float, duration_s: float, seed: int = 0) -> TwinTrace:
    """Stationary Poisson traffic at the ShareGPT-ish token mix — the
    parity workhorse (it exercises every admission path without shape
    changes)."""
    rng = np.random.default_rng(seed)
    arr = _poisson_arrivals(rng, RateSpec(((duration_s, rate_rps),)), duration_s)
    i, o = _tokens(rng, len(arr), SHAREGPT_INPUT, SHAREGPT_OUTPUT)
    return TwinTrace("steady", seed, duration_s, arr, i, o)


def ramp_burst(rate_rps: float, duration_s: float, seed: int = 0) -> TwinTrace:
    """The canonical closed-loop shape (`forecast_scenario`): ramp
    1.3x -> 5x, hold, a 9x burst, hold, ramp down, cheap tail — rates in
    multiples of `rate_rps` and phase widths in fractions of
    `duration_s`, so the same stress lands at any fleet scale."""
    rng = np.random.default_rng(seed)
    u = duration_s / 92.0  # the canonical schedule's 92 s, rescaled
    up = RateSpec.ramp(1.3 * rate_rps, 5.0 * rate_rps, 30.0 * u, steps=6)
    down = RateSpec.ramp(5.0 * rate_rps, 1.5 * rate_rps, 12.0 * u, steps=4)
    schedule = RateSpec(
        up.phases
        + ((12.0 * u, 5.0 * rate_rps), (6.0 * u, 9.0 * rate_rps),
           (12.0 * u, 5.0 * rate_rps))
        + down.phases
        + ((20.0 * u, 1.5 * rate_rps),)
    )
    arr = _poisson_arrivals(rng, schedule, duration_s)
    i, o = _tokens(rng, len(arr), SHAREGPT_INPUT, SHAREGPT_OUTPUT)
    return TwinTrace("ramp_burst", seed, duration_s, arr, i, o)


def flash_crowd(
    rate_rps: float, duration_s: float, seed: int = 0,
    spikes: int = 3, spike_scale: float = 6.0,
) -> TwinTrace:
    """Correlated flash crowds: baseline Poisson plus `spikes` short
    windows (5% of the horizon each) at `spike_scale`x the base rate,
    at seeded random instants — the correlated-across-variants surge
    `planner.scenarios.flash_crowd` models at trace granularity."""
    rng = np.random.default_rng(seed)
    width = 0.05 * duration_s
    starts = np.sort(rng.uniform(0.0, duration_s - width, size=spikes))
    phases: list[tuple[float, float]] = []
    t = 0.0
    for s in starts:
        if s > t:
            phases.append((s - t, rate_rps))
        phases.append((width, spike_scale * rate_rps))
        t = max(t, s) + width
    if t < duration_s:
        phases.append((duration_s - t, rate_rps))
    arr = _poisson_arrivals(rng, RateSpec(tuple(phases)), duration_s)
    i, o = _tokens(rng, len(arr), SHAREGPT_INPUT, SHAREGPT_OUTPUT)
    return TwinTrace("flash_crowd", seed, duration_s, arr, i, o)


def agentic(
    rate_rps: float, duration_s: float, seed: int = 0,
    mean_turns: float = 4.0, think_s: float = 2.0,
) -> TwinTrace:
    """Multi-turn/agentic sessions: session starts are Poisson at a rate
    chosen so the TOTAL request rate averages `rate_rps`; each session
    runs a geometric number of turns, every follow-up re-arriving after
    a lognormal think gap WITH GROWN CONTEXT (the next prompt carries
    the whole conversation: previous in + previous out + the new turn's
    text) — the KV-pressure shape single-turn traces never produce."""
    rng = np.random.default_rng(seed)
    session_rate = rate_rps / max(mean_turns, 1.0)
    starts = _poisson_arrivals(
        rng, RateSpec(((duration_s, session_rate),)), duration_s
    )
    arr: list[float] = []
    ins: list[int] = []
    outs: list[int] = []
    for s_ms in starts:
        turns = 1 + int(rng.geometric(1.0 / max(mean_turns, 1.0)))
        t = float(s_ms)
        context = 0
        for _ in range(turns):
            text = SHAREGPT_INPUT.sample(rng)
            out = SHAREGPT_OUTPUT.sample(rng)
            i_tok = min(context + text, SHAREGPT_INPUT.max_tokens * 8)
            if t >= duration_s * 1000.0:
                break
            arr.append(t)
            ins.append(i_tok)
            outs.append(out)
            context = i_tok + out  # the follow-up carries it all
            gap_s = float(rng.lognormal(np.log(think_s), 0.6))
            t += gap_s * 1000.0
    order = np.argsort(np.asarray(arr), kind="stable")
    return TwinTrace(
        "agentic", seed, duration_s,
        np.asarray(arr, dtype=np.float64)[order],
        np.asarray(ins, dtype=np.int64)[order],
        np.asarray(outs, dtype=np.int64)[order],
    )


def heavy_tail(rate_rps: float, duration_s: float, seed: int = 0) -> TwinTrace:
    """Poisson arrivals under a heavier-than-ShareGPT token mix (wider
    lognormal sigma, taller caps): the long-context stragglers that
    dominate KV occupancy and head-of-line block admission."""
    rng = np.random.default_rng(seed)
    arr = _poisson_arrivals(rng, RateSpec(((duration_s, rate_rps),)), duration_s)
    i, o = _tokens(
        rng, len(arr),
        TokenDistribution(median=200.0, sigma=1.6, max_tokens=8192),
        TokenDistribution(median=150.0, sigma=1.2, max_tokens=2048),
    )
    return TwinTrace("heavy_tail", seed, duration_s, arr, i, o)


@dataclasses.dataclass(frozen=True)
class FlashEnvelope:
    """The SHARED burst envelope of a correlated flash crowd: `windows`
    are `(start_s, width_s)` spike intervals, disjoint and sorted;
    inside a window every variant's rate is `spike_scale`x its base,
    outside it is 1x. One envelope drives a whole fleet, which is what
    makes the crowd *correlated*: a news event hits every variant's
    traffic in the same seconds, unlike independent `flash_crowd` traces
    whose spikes land at per-variant random instants.

    At million-variant scale the envelope is the usable artifact — the
    event-storm bench scales per-variant base rates by `multiplier_at`
    rather than materializing a million request traces."""

    seed: int
    duration_s: float
    spike_scale: float
    windows: tuple[tuple[float, float], ...]

    def multiplier_at(self, t_s: float) -> float:
        """The fleet-wide rate multiplier at horizon time `t_s`."""
        for start, width in self.windows:
            if start <= t_s < start + width:
                return self.spike_scale
        return 1.0

    def phases(self, rate_rps: float) -> RateSpec:
        """The envelope as a piecewise schedule at a given base rate —
        the same shape `flash_crowd` builds, with these exact windows."""
        out: list[tuple[float, float]] = []
        t = 0.0
        for start, width in self.windows:
            if start > t:
                out.append((start - t, rate_rps))
            out.append((width, self.spike_scale * rate_rps))
            t = start + width
        if t < self.duration_s:
            out.append((self.duration_s - t, rate_rps))
        return RateSpec(tuple(out))


def flash_envelope(
    duration_s: float, seed: int = 0,
    spikes: int = 3, spike_scale: float = 6.0,
) -> FlashEnvelope:
    """A seeded shared burst envelope: `spikes` disjoint windows, each
    5% of the horizon, at seeded random instants (the same window
    construction `flash_crowd` uses for a single trace)."""
    rng = np.random.default_rng(seed)
    width = 0.05 * duration_s
    starts = np.sort(rng.uniform(0.0, duration_s - width, size=spikes))
    windows: list[tuple[float, float]] = []
    t = 0.0
    for s in starts:
        start = max(t, float(s))
        if start + width > duration_s:
            break
        windows.append((start, width))
        t = start + width
    return FlashEnvelope(seed, duration_s, spike_scale, tuple(windows))


def correlated_flash_crowds(
    n_variants: int, rate_rps: float, duration_s: float, seed: int = 0,
    spikes: int = 3, spike_scale: float = 6.0,
) -> tuple[FlashEnvelope, list[TwinTrace]]:
    """Correlated flash crowds ACROSS variants: one shared envelope
    (seeded from `seed`) scales N otherwise-independent Poisson traces.
    Every variant spikes in the same windows; the request-level
    realizations stay independent (per-variant member seeds from the
    flash_crowd ensemble convention, so no two variants — and no
    (variant, single-trace) pair — share a raw seed)."""
    env = flash_envelope(duration_s, seed, spikes=spikes,
                         spike_scale=spike_scale)
    schedule_cache: RateSpec = env.phases(rate_rps)
    traces: list[TwinTrace] = []
    for member_seed in trace_ensemble_seeds("flash_crowd", seed, n_variants):
        rng = np.random.default_rng(member_seed)
        arr = _poisson_arrivals(rng, schedule_cache, duration_s)
        i, o = _tokens(rng, len(arr), SHAREGPT_INPUT, SHAREGPT_OUTPUT)
        traces.append(
            TwinTrace("correlated_flash", member_seed, duration_s, arr, i, o)
        )
    return env, traces


TRACES = {
    "steady": steady,
    "ramp_burst": ramp_burst,
    "flash_crowd": flash_crowd,
    "agentic": agentic,
    "heavy_tail": heavy_tail,
}


def trace_ensemble_seeds(name: str, base_seed: int, count: int) -> list[int]:
    """Seeds of a `count`-member ensemble of one twin trace generator —
    `derive_ensemble_seeds` over TRACES, the same convention the traffic
    and storm ensembles share."""
    return derive_ensemble_seeds(TRACES, name, base_seed, count, what="trace")


def build_trace(
    name: str, rate_rps: float, duration_s: float, seed: int = 0
) -> TwinTrace:
    if name not in TRACES:
        raise ValueError(f"unknown trace {name!r}; available: {sorted(TRACES)}")
    member_seed = trace_ensemble_seeds(name, seed, 1)[0]
    return TRACES[name](rate_rps, duration_s, seed=member_seed)


def route_round_robin(
    trace: TwinTrace, engines: int, start: int = 0
) -> np.ndarray:
    """Static round-robin request routing over `engines` — per-engine
    arrival order stays nondecreasing because the trace is sorted."""
    return (np.arange(trace.requests, dtype=np.int64) + start) % engines
