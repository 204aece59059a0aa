"""Predictive scaling: per-variant arrival-rate forecasting, burst
detection, and scale-down stabilization.

The reactive controller sizes every variant against the *currently
observed* arrival rate, so a traffic ramp always breaches the SLO for
one replica-spin-up interval before the controller catches up, and a
noisy rate flaps the replica count on the way down. This package closes
that gap (PAPERS: inference-fleet-sim plans capacity against *forecast*
demand over the same queueing model; the WVA control-plane framing puts
that anticipation in the controller):

* `ArrivalForecaster` — bounded ring of (timestamp, λ) observations per
  variant; EWMA level + Holt-style trend; a burst detector (sudden jump
  against the rolling one-step-error dispersion); `forecast(horizon_s)`
  answers a point estimate with a confidence band. The horizon is the
  accelerator-shape-dependent replica spin-up latency
  (`config.tpu_catalog.spinup_seconds`).
* `ScaleDownStabilizer` — the peak-over-window scale-down gate,
  mirroring HPA's `behavior.scaleDown.stabilizationWindowSeconds`
  semantics already modeled in `inferno_tpu/testing/hpa.py`: upscales
  pass through immediately, downscales act on the MAX recommendation
  seen within the window.

Dependency-free by design (stdlib only) so the reconciler, the emulator
experiment driver, and bench.py can all share it without import cycles
— same rule as `inferno_tpu/obs/`.

Port copy of `inferno_tpu/forecast/__init__.py`, verbatim apart from its imports.
"""

from inferno_tpu_torch.forecast.forecaster import (
    ArrivalForecaster,
    Forecast,
    ForecastConfig,
)
from inferno_tpu_torch.forecast.stabilizer import ScaleDownStabilizer

__all__ = [
    "ArrivalForecaster",
    "Forecast",
    "ForecastConfig",
    "ScaleDownStabilizer",
]
