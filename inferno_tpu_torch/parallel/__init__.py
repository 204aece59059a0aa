from inferno_tpu_torch.parallel.fleet import (
    FleetCandidates,
    FleetPlan,
    LaneAllocations,
    TandemPlan,
    build_fleet,
    build_tandem_fleet,
    calculate_fleet,
    reset_fleet_state,
)
from inferno_tpu_torch.parallel.mesh import fleet_device

__all__ = [
    "FleetCandidates",
    "FleetPlan",
    "LaneAllocations",
    "TandemPlan",
    "build_fleet",
    "build_tandem_fleet",
    "calculate_fleet",
    "reset_fleet_state",
    "fleet_device",
]
