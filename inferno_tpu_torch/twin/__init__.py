"""Vectorized fleet-scale digital twin.

Thousands of emulated engines advanced by ONE event loop on a shared
virtual clock: per-engine queues, in-flight batches, step clocks, and KV
occupancy live as struct-of-arrays columns (`plant.TwinPlant`, the same
columnarization move `parallel/snapshot.py` made for fleet state), so a
1000-engine closed loop costs one numpy pass per decode round instead of
1000 threads of wall-paced sleeps.

The scalar `emulator.engine.EmulatedEngine` stays the semantic oracle:
`oracle.run_serial_oracle` drives real engines in their synchronous
stepping mode over the same trace, and tests pin BIT-equality of
TTFT/latency between the two. Everything above the plant couples through
real seams — `promfeed.TwinPromFeed` serves collector-shaped FakeProm
queries, `abtest.run_twin_ab` closes the loop with the production
forecaster/stabilizer policy machinery, `replay.replay_artifact` re-runs
flight-recorder captures, `tandem.run_tandem` gives the disagg path a
deterministic fast-tier sim.

CLI: ``python -m inferno_tpu_torch.twin --policies reactive,predictive
--engines 1000``.

Port copy of `inferno_tpu/twin/__init__.py`, verbatim apart from its imports.
"""

from inferno_tpu_torch.twin.abtest import (
    POLICIES,
    TwinABScenario,
    run_twin_ab,
    run_twin_policy_loop,
)
from inferno_tpu_torch.twin.oracle import parity_diff, run_serial_oracle
from inferno_tpu_torch.twin.plant import TwinPlant
from inferno_tpu_torch.twin.promfeed import TwinPromFeed
from inferno_tpu_torch.twin.replay import replay_artifact, trace_from_artifact
from inferno_tpu_torch.twin.tandem import run_tandem, run_tandem_poisson
from inferno_tpu_torch.twin.traces import (
    TRACES,
    TwinTrace,
    build_trace,
    route_round_robin,
    trace_ensemble_seeds,
)

__all__ = [
    "POLICIES",
    "TRACES",
    "TwinABScenario",
    "TwinPlant",
    "TwinPromFeed",
    "TwinTrace",
    "build_trace",
    "parity_diff",
    "replay_artifact",
    "route_round_robin",
    "run_serial_oracle",
    "run_tandem",
    "run_tandem_poisson",
    "run_twin_ab",
    "run_twin_policy_loop",
    "trace_ensemble_seeds",
    "trace_from_artifact",
]
