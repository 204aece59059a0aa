"""Load schedules for emulated (or real) engines.

Port of `inferno_tpu/emulator/loadgen.py`, partial: `RateSpec` only,
verbatim apart from its imports. It is the schedule language the
planner's scenario generators (`planner/scenarios.py`) build on. The
token distributions and the load generators that drive an engine come
with the emulator slice of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RateSpec:
    """Piecewise schedule: list of (duration_seconds, req_per_sec)."""

    phases: tuple[tuple[float, float], ...] = ((10.0, 5.0),)

    def rate_at(self, t: float) -> float:
        acc = 0.0
        for duration, rate in self.phases:
            acc += duration
            if t < acc:
                return rate
        return 0.0

    @property
    def total_duration(self) -> float:
        return sum(d for d, _ in self.phases)

    @classmethod
    def ramp(
        cls,
        start_rps: float,
        end_rps: float,
        duration: float,
        steps: int = 8,
    ) -> "RateSpec":
        """A linear ramp from `start_rps` to `end_rps` over `duration`
        seconds as `steps` equal piecewise-constant phases, so ramp
        schedules aren't hand-rolled phase tables in every experiment.
        Each step carries the ramp's MIDPOINT rate, which keeps the
        schedule's time-averaged rate exactly (start+end)/2 regardless
        of the step count. Compose with other phases via
        `RateSpec(ramp(...).phases + ((hold_s, rate),))`."""
        if duration <= 0:
            raise ValueError(f"duration must be > 0, got {duration}")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if start_rps < 0 or end_rps < 0:
            raise ValueError(
                f"rates must be >= 0, got {start_rps} -> {end_rps}"
            )
        step_s = duration / steps
        slope = (end_rps - start_rps) / steps
        return cls(
            phases=tuple(
                (step_s, start_rps + slope * (i + 0.5)) for i in range(steps)
            )
        )


