"""Emulated inference engines, their load generators, MiniProm and the
emulator server.

Port copy of `inferno_tpu/emulator/__init__.py`, verbatim apart from its
imports and one more export, `experiment.rate_trace` (the schedule
sampler the planner's scenarios build on).
"""

from inferno_tpu_torch.emulator.disagg import DisaggEngine, DisaggProfile
from inferno_tpu_torch.emulator.engine import EmulatedEngine, EngineProfile, RequestResult
from inferno_tpu_torch.emulator.experiment import rate_trace
from inferno_tpu_torch.emulator.loadgen import (
    SHAREGPT_INPUT,
    SHAREGPT_OUTPUT,
    LoadGenerator,
    RateSpec,
    TokenDistribution,
)
from inferno_tpu_torch.emulator.miniprom import MiniProm, MiniPromClient
from inferno_tpu_torch.emulator.server import EmulatorServer, render_engine_metrics

__all__ = [
    "DisaggEngine",
    "DisaggProfile",
    "EmulatedEngine",
    "EngineProfile",
    "RequestResult",
    "LoadGenerator",
    "RateSpec",
    "TokenDistribution",
    "SHAREGPT_INPUT",
    "SHAREGPT_OUTPUT",
    "MiniProm",
    "MiniPromClient",
    "EmulatorServer",
    "render_engine_metrics",
    "rate_trace",
]
