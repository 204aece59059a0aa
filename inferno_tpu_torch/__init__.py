"""inferno_tpu_torch — the autoscaler's sizing path on PyTorch and CUDA.

A port of `inferno_tpu` (the JAX reference, which stays beside it) to
torch tensors on an NVIDIA GPU. Module paths mirror the reference one to
one (`inferno_tpu_torch/ops/queueing.py` <-> `inferno_tpu/ops/queueing.py`);
the package imports torch and numpy, never jax or `inferno_tpu`, and keeps
its own copy of every reference module it needs.

Ported so far: the batched fleet sizing pass

    System(spec) -> parallel.calculate_fleet(system) -> solver.solve_unlimited(system)

with every stationary solve of the birth-death chain on the hand-written
CUDA kernel `ops/csrc/stats_kernel.cu` (backend "cuda", the default) or
its plain torch version (backend "torch", any device).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
