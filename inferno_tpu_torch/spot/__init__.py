"""Spot-market fleet economics.

Port copy of `inferno_tpu/spot/__init__.py`, `market` only: the risk
model, `TPU_SPOT_POOLS` parsing with actionable validation, the
spot-replica split every sizing path applies (scalar `create_allocation`
and the vectorized fleet writeback), and the reserved-headroom
arithmetic the limited-mode solvers pre-position. The reference's
`scenarios` (storm replays over `calculate_fleet_batch`) and `injection`
(emulator preemption) belong to the planner and emulator slices.
"""

from inferno_tpu_torch.spot.market import (
    SpotConfigError,
    parse_pool_quotas,
    parse_spot_pools,
    spot_enabled,
)

__all__ = [
    "SpotConfigError",
    "parse_pool_quotas",
    "parse_spot_pools",
    "spot_enabled",
]
