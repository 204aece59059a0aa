"""Emulated inference engines and their load schedules.

Port of `inferno_tpu/emulator/__init__.py`, partial: only the rate
schedule the planner's scenario generators build on (`RateSpec` from
`loadgen`, `rate_trace` from `experiment`). The engine, the load
generators, MiniProm and the emulator server come with the emulator
slice of the port.
"""

from inferno_tpu_torch.emulator.experiment import rate_trace
from inferno_tpu_torch.emulator.loadgen import RateSpec

__all__ = ["RateSpec", "rate_trace"]
