"""Offline fleet capacity planner.

Replays millions-of-users traffic scenarios — diurnal cycles, regional
skews, flash crowds, new-model launches, fleet-wide growth ramps —
through the batched time-axis sizing solve
(`parallel.fleet.calculate_fleet_batch`: one pass for a whole quarter of
timesteps, bit-identical to the per-cycle solve; its grid solve runs
on the card's kernels) and answers "how many
chips of which generation, and when does each pool first bind" with
per-pool peak/p95 chip demand, violation-seconds, first-bind timestamps
under the capacity quota buckets, and $-cost bands per scenario.

CLI: ``python -m inferno_tpu_torch.planner --help`` (see docs/performance.md
"Batched time-axis replay"). Library entry points:

* `scenarios.build_scenarios` / the individual generators — seeded,
  deterministic [T, S] rate traces;
* `replay.replay_scenario` — one scenario through the batched solve,
  aggregated; `forecast=True` adds the forecast-bound sizing pass;
* `replay.aggregate_replay` — the aggregation alone, for callers that
  already hold a `FleetBatchResult`;
* `montecarlo.replay_montecarlo` — a seeded S-member ensemble of one
  scenario streamed through ONE prepared solve context, summarized into
  p50/p95/p99/max envelopes for chip demand, cost, and
  violation-seconds plus tail-risk outputs (first-bind probability, p99
  peak demand); `montecarlo.survival_failures` is the reserved-quota
  gate the CLI exits non-zero on.

Port of `inferno_tpu/planner/__init__.py`, verbatim apart from its
imports. The replays take `backend` ("cuda", the default, or "torch")
and `device` (None = the CUDA card; "cpu" with backend "torch").
"""

from inferno_tpu_torch.planner.montecarlo import (
    percentile_envelope,
    replay_montecarlo,
    survival_failures,
)
from inferno_tpu_torch.planner.replay import (
    aggregate_replay,
    forecast_bound_rates,
    replay_scenario,
)
from inferno_tpu_torch.planner.scenarios import (
    GENERATORS,
    ScenarioTrace,
    base_rates_from_system,
    build_scenarios,
    ensemble_seeds,
)

__all__ = [
    "GENERATORS",
    "ScenarioTrace",
    "aggregate_replay",
    "base_rates_from_system",
    "build_scenarios",
    "ensemble_seeds",
    "forecast_bound_rates",
    "percentile_envelope",
    "replay_montecarlo",
    "replay_scenario",
    "survival_failures",
]
