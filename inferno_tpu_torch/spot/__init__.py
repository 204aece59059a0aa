"""Spot-market fleet economics and eviction-storm replays.

Port copy of `inferno_tpu/spot/__init__.py`, without `injection`:

* `market` — the risk model: `TPU_SPOT_POOLS` parsing with actionable
  validation, the spot-replica split every sizing path applies (scalar
  `create_allocation`, the vectorized fleet writeback, the batched
  time-axis replay), and the reserved-headroom arithmetic the
  limited-mode solvers pre-position.
* `scenarios` — seeded correlated-storm generators (spot reclaims, zone
  outages) and the offline evaluation that replays them against
  `calculate_fleet_batch` output, reporting violation-seconds, recovery
  time, and cost with and without pre-positioned headroom.

The reference's `injection` (preempting emulated engines mid-run)
drives the emulator's engine and comes with the emulator slice.
"""

from inferno_tpu_torch.spot.market import (
    SpotConfigError,
    parse_pool_quotas,
    parse_spot_pools,
    spot_enabled,
)
from inferno_tpu_torch.spot.scenarios import (
    STORM_GENERATORS,
    StormEvent,
    StormSchedule,
    build_storms,
    evaluate_storms,
    replay_spot_storm,
    replay_spot_storm_ensemble,
    spot_reclaim,
    storm_ensemble_seeds,
    zone_outage,
)

__all__ = [
    "STORM_GENERATORS",
    "SpotConfigError",
    "StormEvent",
    "StormSchedule",
    "build_storms",
    "evaluate_storms",
    "parse_pool_quotas",
    "parse_spot_pools",
    "replay_spot_storm",
    "replay_spot_storm_ensemble",
    "spot_enabled",
    "spot_reclaim",
    "storm_ensemble_seeds",
    "zone_outage",
]
