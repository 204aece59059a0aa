"""Port copy of `inferno_tpu/analyzer/__init__.py`, verbatim apart from its imports."""

from inferno_tpu_torch.analyzer.queue import (
    AnalysisMetrics,
    AnalyzerError,
    QueueAnalyzer,
    QueueStats,
    RequestSize,
    TargetPerf,
    TargetRate,
    build_analyzer,
    effective_concurrency,
    service_rates,
    solve_birth_death,
)
from inferno_tpu_torch.analyzer.disagg import (
    DisaggAnalyzer,
    DisaggSpec,
    build_disagg_analyzer,
)
from inferno_tpu_torch.analyzer.sizing import BisectionResult, bisect_monotone

__all__ = [
    "DisaggAnalyzer",
    "DisaggSpec",
    "build_disagg_analyzer",
    "AnalysisMetrics",
    "AnalyzerError",
    "QueueAnalyzer",
    "QueueStats",
    "RequestSize",
    "TargetPerf",
    "TargetRate",
    "build_analyzer",
    "effective_concurrency",
    "service_rates",
    "solve_birth_death",
    "BisectionResult",
    "bisect_monotone",
]
