"""Per-variant arrival-rate forecasting: EWMA level + Holt-style trend
with a dispersion-derived confidence band and a burst detector.

Model choice. The controller needs a forecast that (a) is cheap enough
to run for every variant every cycle, (b) adapts within a handful of
observations (a reconcile interval is typically 30-60 s, so "history"
is minutes, not days), and (c) degrades to *exactly the observed rate*
on constant traffic — a steady workload must size identically with and
without prediction, or enabling the feature would perturb every stable
fleet. Holt's linear (double-exponential) smoothing over irregular
sample spacing satisfies all three: the level tracks the rate, the
trend extrapolates ramps over the spin-up horizon, and both collapse to
the observation itself when the series is flat.

Band. The half-width is `z x` an EWMA of the absolute one-step-ahead
forecast error. On constant traffic the one-step error is ~0, so the
band is tight and `upper ~= observed` (the no-perturbation property
above). On a ramp the trend lags each step by a bounded error, so the
band widens with exactly the miss the forecast has been making — a
self-calibrating margin, not a tuned constant.

Burst detection. A jump that exceeds `burst_z x` the rolling dispersion
AND a minimum fraction of the current level is a regime change, not
noise: the level snaps to the new observation (EWMA convergence over
several cycles would under-provision for its whole tail) and the trend
resets (a step has no slope). The error feeding the dispersion EWMA is
recorded BEFORE the snap, so the band stays inflated for the next few
forecasts — scale-up right after a burst carries extra headroom.

Hygiene (the unbounded-state and garbage-telemetry edges):

* NaN/Inf/negative λ observations are dropped — one poisoned scrape
  must not corrupt the level/trend state.
* Non-monotonic timestamps are rejected (`observe` returns False): a
  clock step backwards would produce a negative dt and flip the trend
  sign.
* Per-variant state lives in a bounded ring (`window`) and `prune()`
  drops variants no longer reconciled — a long-lived controller must
  not accumulate forecaster state for deleted VAs forever (same
  contract as `models/corrector.py::prune`).

Units: the forecaster is unit-agnostic — level/trend/band are in
whatever unit λ arrives in (the controller feeds requests/minute, the
emulator closed loop requests/second) per second of timestamp.

Port copy of `inferno_tpu/forecast/forecaster.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

# An already-active burst classification holds until the level has
# re-converged (see Forecast.burst); fresh activation is per-observation.
MIN_FORECAST_SAMPLES = 3  # below this, forecast() reports invalid


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    """Tuning knobs (docs/forecasting.md#tuning)."""

    level_alpha: float = 0.5  # EWMA gain on the level, per reference interval
    trend_beta: float = 0.3  # EWMA gain on the trend, per reference interval
    dispersion_gamma: float = 0.3  # EWMA gain on the |one-step error|
    # The observation spacing the gains above are calibrated for (the
    # reconcile interval). Gains are time-weighted per observation:
    # g_eff = 1-(1-g)^(dt/reference) — so an observation arriving
    # milliseconds after the previous one (a watch-poked double cycle)
    # moves the state proportionally to the time it actually spans,
    # instead of letting scrape noise over a tiny dt masquerade as a
    # huge dλ/dt trend. At dt == reference the gains are exactly the
    # configured values.
    reference_interval_s: float = 60.0
    band_z: float = 2.0  # band half-width, in dispersion units
    burst_z: float = 4.0  # jump threshold, in dispersion units
    # a jump must also clear this fraction of the current level: with a
    # near-zero dispersion (constant traffic) ANY wiggle would otherwise
    # read as a burst
    burst_min_frac: float = 0.5
    # safety clamp on trend extrapolation: the trend's contribution at
    # the horizon is bounded to ±max_growth x the level. Observations at
    # irregular, possibly tiny spacing (a watch-poked double cycle runs
    # two observations milliseconds apart) can produce a locally huge
    # dλ/dt; extrapolating that over a 90 s spin-up horizon would size
    # the fleet to absurdity. Genuine step changes are the burst
    # detector's job, not the trend's.
    max_growth: float = 2.0
    window: int = 64  # bounded per-variant observation ring

    def __post_init__(self) -> None:
        for name in ("level_alpha", "trend_beta", "dispersion_gamma"):
            v = getattr(self, name)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{name} must be in (0, 1], got {v}")
        if self.band_z < 0 or self.burst_z <= 0 or self.burst_min_frac < 0:
            raise ValueError(
                f"band_z >= 0, burst_z > 0, burst_min_frac >= 0 required "
                f"(got {self.band_z}, {self.burst_z}, {self.burst_min_frac})"
            )
        if self.max_growth <= 0:
            raise ValueError(f"max_growth must be > 0, got {self.max_growth}")
        if self.reference_interval_s <= 0:
            raise ValueError(
                f"reference_interval_s must be > 0, got {self.reference_interval_s}"
            )
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")


@dataclasses.dataclass(frozen=True)
class Forecast:
    """Answer to `forecast(horizon_s)`: point estimate + confidence band
    at the horizon, plus the burst classification of the current state."""

    rate: float  # point estimate at the horizon (level + trend*h, >= 0)
    upper: float  # rate + band (the scale-up sizing bound)
    lower: float  # max(0, rate - band)
    band: float  # half-width
    burst: bool  # the latest observation was classified a burst
    samples: int  # observations backing this forecast
    horizon_s: float

    @property
    def valid(self) -> bool:
        """Enough history to act on (MIN_FORECAST_SAMPLES). An invalid
        forecast must never override the observed rate."""
        return self.samples >= MIN_FORECAST_SAMPLES


@dataclasses.dataclass
class _VariantState:
    ring: deque  # (timestamp_s, lambda) observations, bounded
    level: float = 0.0
    trend: float = 0.0  # lambda-units per second
    dispersion: float = 0.0  # EWMA of |one-step-ahead error|
    last_t: float = 0.0
    last_abs_error: float = 0.0  # realized error of the last one-step forecast
    burst: bool = False
    samples: int = 0  # accepted observations ever (ring is bounded)


class ArrivalForecaster:
    """Per-variant arrival-rate forecaster. Single-threaded by design
    (called from the reconcile loop, like the corrector)."""

    def __init__(self, config: ForecastConfig | None = None):
        self.config = config or ForecastConfig()
        self._state: dict[str, _VariantState] = {}

    # -- bookkeeping ---------------------------------------------------------

    def prune(self, active: set[str]) -> None:
        """Drop state for variants no longer reconciled."""
        for key in [k for k in self._state if k not in active]:
            del self._state[key]

    def variants(self) -> set[str]:
        return set(self._state)

    def observations(self, key: str) -> int:
        st = self._state.get(key)
        return st.samples if st is not None else 0

    def realized_abs_error(self, key: str) -> float:
        """|observed - predicted| of the most recent one-step forecast:
        the realized forecast error the obs gauges report."""
        st = self._state.get(key)
        return st.last_abs_error if st is not None else 0.0

    # -- the filter ----------------------------------------------------------

    def observe(self, key: str, t: float, lam: float) -> bool:
        """Record one (timestamp, λ) observation. Returns False when the
        observation is rejected: NaN/Inf/negative λ (poisoned scrape) or
        a timestamp not strictly after the previous one (clock step —
        a negative dt would flip the trend sign)."""
        if not math.isfinite(lam) or lam < 0 or not math.isfinite(t):
            return False
        st = self._state.get(key)
        if st is None:
            st = _VariantState(ring=deque(maxlen=self.config.window))
            st.level = lam
            st.last_t = t
            st.ring.append((t, lam))
            st.samples = 1
            self._state[key] = st
            return True
        if t <= st.last_t:
            return False

        cfg = self.config
        dt = t - st.last_t
        predicted = st.level + st.trend * dt
        error = lam - predicted
        st.last_abs_error = abs(error)

        # Time-weighted gains: an observation spanning a fraction of the
        # reference interval moves the state by that fraction's worth —
        # g_eff = 1-(1-g)^(dt/ref) equals g at dt == ref, ~g·dt/ref for
        # tiny dt, and approaches 1 after long gaps. Without this, a
        # cycle run milliseconds after the previous one (watch poke)
        # would divide scrape noise by a tiny dt and read it as a
        # violent trend.
        frac = dt / cfg.reference_interval_s
        a_eff = 1.0 - (1.0 - cfg.level_alpha) ** frac
        b_eff = 1.0 - (1.0 - cfg.trend_beta) ** frac
        g_eff = 1.0 - (1.0 - cfg.dispersion_gamma) ** frac

        # Burst: a jump the rolling dispersion cannot explain AND large
        # relative to the level. Dispersion updates with the PRE-snap
        # error so the band stays wide through the burst's tail.
        burst = (
            st.samples >= MIN_FORECAST_SAMPLES
            and abs(error) > cfg.burst_z * st.dispersion
            and abs(error) > cfg.burst_min_frac * max(st.level, 1e-9)
        )
        st.dispersion = g_eff * abs(error) + (1.0 - g_eff) * st.dispersion
        if burst:
            st.level = lam  # regime change: EWMA convergence is too slow
            st.trend = 0.0  # a step has no slope
            st.burst = True
        else:
            prev_level = st.level
            st.level = a_eff * lam + (1.0 - a_eff) * predicted
            st.trend = (
                b_eff * ((st.level - prev_level) / dt)
                + (1.0 - b_eff) * st.trend
            )
            # an active burst classification releases once the level has
            # re-converged (the observation is explainable again)
            if st.burst and abs(error) <= cfg.band_z * max(st.dispersion, 1e-9):
                st.burst = False
        st.last_t = t
        st.ring.append((t, lam))
        st.samples += 1
        return True

    def forecast(self, key: str, horizon_s: float) -> Forecast:
        """Point estimate + band at `horizon_s` from now. With no (or
        one) observation the forecast reports itself invalid and echoes
        whatever level exists — callers must check `.valid` before
        letting it override the observed rate."""
        if horizon_s < 0 or not math.isfinite(horizon_s):
            raise ValueError(f"horizon_s must be finite and >= 0, got {horizon_s}")
        st = self._state.get(key)
        if st is None:
            return Forecast(
                rate=0.0, upper=0.0, lower=0.0, band=0.0,
                burst=False, samples=0, horizon_s=horizon_s,
            )
        # trend contribution clamped to ±max_growth x level: extreme
        # local slopes (tiny observation spacing) must not extrapolate
        # to absurd sizes over a long spin-up horizon
        growth_cap = self.config.max_growth * max(st.level, 1e-9)
        growth = min(max(st.trend * horizon_s, -growth_cap), growth_cap)
        rate = max(0.0, st.level + growth)
        band = self.config.band_z * st.dispersion
        return Forecast(
            rate=rate,
            upper=rate + band,
            lower=max(0.0, rate - band),
            band=band,
            burst=st.burst,
            samples=st.samples,
            horizon_s=horizon_s,
        )
