"""Decision-trace observability: span tracing, per-variant decision
records, and the metric-catalog lint.

Dependency-free by design (stdlib only, no controller imports) so the
reconciler, the emulator experiment driver, and bench.py can all thread
the same tracer without import cycles. The flight recorder
(`obs/recorder.py`, numpy-backed) is deliberately NOT re-exported here —
import it directly so this package root stays stdlib-only.

Port copy of `inferno_tpu/obs/__init__.py`, verbatim apart from its imports.
"""

from inferno_tpu_torch.obs.attainment import (
    AttainmentConfig,
    AttainmentScore,
    AttainmentTracker,
    relative_error,
)
from inferno_tpu_torch.obs.decision import (
    PROVENANCE_CORRECTED,
    PROVENANCE_CR,
    RATE_PROVENANCE_FORECAST,
    RATE_PROVENANCE_OBSERVED,
    REASON_ASLEEP,
    REASON_CAPACITY_LIMITED,
    REASON_CODES,
    REASON_COST_BOUND,
    REASON_ERROR,
    REASON_FORECAST_BOUND,
    REASON_SLO_BOUND,
    REASON_SPOT_RISK_BOUND,
    REASON_STABILIZATION_HOLD,
    SIZING_PROVENANCE_CACHED,
    SIZING_PROVENANCE_SOLVED,
    DecisionRecord,
)
from inferno_tpu_torch.obs.profiler import (
    PROFILE_SCHEMA,
    CycleProfiler,
    build_profile_doc,
)
from inferno_tpu_torch.obs.trace import Span, TraceBuffer, Tracer

__all__ = [
    "PROFILE_SCHEMA",
    "CycleProfiler",
    "build_profile_doc",
    "AttainmentConfig",
    "AttainmentScore",
    "AttainmentTracker",
    "relative_error",
    "DecisionRecord",
    "PROVENANCE_CORRECTED",
    "PROVENANCE_CR",
    "RATE_PROVENANCE_FORECAST",
    "RATE_PROVENANCE_OBSERVED",
    "SIZING_PROVENANCE_CACHED",
    "SIZING_PROVENANCE_SOLVED",
    "REASON_ASLEEP",
    "REASON_CAPACITY_LIMITED",
    "REASON_CODES",
    "REASON_COST_BOUND",
    "REASON_ERROR",
    "REASON_FORECAST_BOUND",
    "REASON_SLO_BOUND",
    "REASON_SPOT_RISK_BOUND",
    "REASON_STABILIZATION_HOLD",
    "Span",
    "TraceBuffer",
    "Tracer",
]
