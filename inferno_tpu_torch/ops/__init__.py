from inferno_tpu_torch.ops.queueing import (
    FleetParams,
    FleetResult,
    TandemParams,
    fleet_analyze,
    fleet_params_from_numpy,
    fleet_size,
    tandem_fleet_size,
    tandem_params_from_numpy,
)

__all__ = [
    "FleetParams",
    "FleetResult",
    "TandemParams",
    "fleet_analyze",
    "fleet_params_from_numpy",
    "fleet_size",
    "tandem_fleet_size",
    "tandem_params_from_numpy",
]
