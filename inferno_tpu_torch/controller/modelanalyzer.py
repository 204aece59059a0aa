"""Per-variant model analysis facade.

Capability parity with the reference's ModelAnalyzer adapter
(the upstream project's internal/modelanalyzer/analyzer.go:25-34 and its
ModelAnalyzeResponse at internal/interfaces/interfaces.go:20-28): given
a prepared System and one server, size every candidate slice shape and
report the per-shape allocations plus the binding per-replica QPS the
queueing analysis found. The reconciler itself uses the batched fleet
path for the whole system; this facade is the single-variant query
surface (useful for tooling, dry-run APIs, and tests).

Port copy of `inferno_tpu/controller/modelanalyzer.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

from inferno_tpu_torch.core.allocation import Allocation
from inferno_tpu_torch.core.system import System

REASON_MARKOVIAN = "markovian analysis"  # reference: modelanalyzer/utils.go


@dataclasses.dataclass
class ModelAnalyzeResponse:
    """(reference ModelAnalyzeResponse: internal/interfaces/interfaces.go)"""

    allocations: list[Allocation]
    # binding sustainable rate of the best (min-value) candidate, req/sec
    required_prefill_qps: float
    required_decode_qps: float
    reason: str = REASON_MARKOVIAN


def analyze_model(system: System, server_name: str) -> ModelAnalyzeResponse:
    """Size all candidate slice shapes for one server
    (reference AnalyzeModel: internal/modelanalyzer/analyzer.go:25-34).

    Raises KeyError for an unknown server; a server with no feasible
    candidates returns an empty allocation list."""
    server = system.servers[server_name]
    server.calculate(system)
    allocations = sorted(server.all_allocations.values(), key=lambda a: a.value)
    qps = 0.0
    if allocations:
        # reference scales maxArrvRatePerReplica (req/msec) x1000 -> req/sec
        qps = allocations[0].max_arrv_rate_per_replica * 1000.0
    return ModelAnalyzeResponse(
        allocations=allocations,
        required_prefill_qps=qps,
        required_decode_qps=qps,
    )
