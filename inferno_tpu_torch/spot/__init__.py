"""Spot-market fleet economics, eviction-storm replays and injection:

* `market` — the risk model: `TPU_SPOT_POOLS` parsing with actionable
  validation, the spot-replica split every sizing path applies (scalar
  `create_allocation`, the vectorized fleet writeback, the batched
  time-axis replay), and the reserved-headroom arithmetic the
  limited-mode solvers pre-position.
* `scenarios` — seeded correlated-storm generators (spot reclaims, zone
  outages) and the offline evaluation that replays them against
  `calculate_fleet_batch` output, reporting violation-seconds, recovery
  time, and cost with and without pre-positioned headroom.
* `injection` — the emulator-side fault injector: `EmulatedEngine`
  preemption mid-run, and the deterministic closed-loop storm
  comparison (`run_spot_storm_comparison`).

Port of `inferno_tpu/spot/__init__.py`; it also exports the names of
`scenarios` and `injection`.
"""

from inferno_tpu_torch.spot.injection import (
    PreemptionInjector,
    run_spot_storm_comparison,
    run_spot_storm_loop,
    storm_scenario,
)
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
    "PreemptionInjector",
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
    "run_spot_storm_comparison",
    "run_spot_storm_loop",
    "spot_enabled",
    "spot_reclaim",
    "storm_ensemble_seeds",
    "storm_scenario",
    "zone_outage",
]
