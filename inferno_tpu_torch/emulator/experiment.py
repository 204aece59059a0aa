"""Experiment helpers for the emulated engine.

Port of `inferno_tpu/emulator/experiment.py`, partial: `rate_trace`
only, verbatim apart from its imports. It samples a `RateSpec` into the
per-timestep rate vectors of the planner (`planner/scenarios.py`). The
batch experiment driver and the closed-loop autoscaling comparison come
with the emulator slice of the port.
"""

from __future__ import annotations

from inferno_tpu_torch.emulator.loadgen import RateSpec


def rate_trace(
    spec: RateSpec, steps: int, step_seconds: float, repeat: bool = False
):
    """Sample a piecewise `RateSpec` at step midpoints into a [steps]
    rate vector — the bridge from the emulator's schedule language
    (`RateSpec`, `RateSpec.ramp`) to the planner's per-timestep rate
    arrays (inferno_tpu_torch.planner.scenarios). Midpoint sampling keeps a
    ramp's time-averaged rate exact regardless of the step count, the
    same convention as `RateSpec.ramp` itself. `repeat=True` tiles the
    schedule periodically (a diurnal day replayed over a week); past the
    schedule's end `rate_at` returns 0 otherwise."""
    import numpy as np

    if steps < 0 or step_seconds <= 0:
        raise ValueError(
            f"need steps >= 0 and step_seconds > 0, got {steps}, {step_seconds}"
        )
    ts = (np.arange(steps, dtype=np.float64) + 0.5) * step_seconds
    if repeat and spec.total_duration > 0:
        ts = ts % spec.total_duration
    return np.asarray([spec.rate_at(float(t)) for t in ts], np.float64)
