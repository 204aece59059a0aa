"""Device selection for the fleet solve.

Port of `inferno_tpu/parallel/mesh.py`, device selection only. The
reference shards the lane axis over a `jax.sharding.Mesh`; splitting
lanes over several GPUs comes in a later slice of the port, and until
then the whole fleet is solved on one device.
"""

from __future__ import annotations

import torch


def fleet_device(device: str | torch.device | None = None) -> torch.device:
    """The device the fleet is sized on. `None` means the CUDA card, and
    raises when there is none: the port runs on the GPU unless the caller
    asks for the CPU explicitly (`device="cpu"`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' (with backend='torch') to "
                "size the fleet on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
