"""inferno_tpu_torch — the autoscaler's sizing path on PyTorch and CUDA.

A port of `inferno_tpu` (the JAX reference, which stays beside it) to
torch tensors on an NVIDIA GPU. Module paths mirror the reference one to
one (`inferno_tpu_torch/ops/queueing.py` <-> `inferno_tpu/ops/queueing.py`);
the package imports torch and numpy, never jax or `inferno_tpu`, and keeps
its own copy of every reference module it needs.

Ported so far: the batched fleet sizing pass

    System(spec) -> parallel.calculate_fleet(system) -> solver.solve_unlimited(system)

with every stationary solve of the birth-death chain on the hand-written
CUDA kernel `ops/csrc/stats_kernel.cu` and every sizing bisection on
`ops/csrc/bisect_kernel.cu` (backend "cuda", the default) or their plain
torch versions (backend "torch", any device); the incremental and
event-driven cycle, the limited-mode solve and spot tiers; the reconcile
loop (`python -m inferno_tpu_torch.controller.main`) with its flight
recorder; and the offline planner (`python -m inferno_tpu_torch.planner`:
the batched time-axis solve `parallel.calculate_fleet_batch`, scenario,
Monte Carlo and spot-storm replays, and `--trace` replays of recorded
cycles); and the sharded programs: the fleet solve split over a device
mesh (`parallel.fleet_mesh`, `SIZING_SHARDS`), the surrogate's (dp, tp)
training on `torch.distributed` ranks, and the graft entry
(`graft_entry.entry`, `graft_entry.dryrun_multichip`).
"""

from inferno_tpu_torch.version import __version__

__all__ = ["__version__"]
