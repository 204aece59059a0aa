"""Device selection and the lane mesh of the fleet solve.

Port of `inferno_tpu/parallel/mesh.py`. The fleet solve is embarrassingly
parallel over lanes, so its sharding is 1-D over a list of devices, a
`FleetMesh` (the reference's `jax.sharding.Mesh` with axis "fleet").
`shard_fleet_params` splits a params tuple's lane axis into one
contiguous numpy slice per device; `parallel.fleet.solve_slots` launches
each slice on its own device, under that device's current stream, and
gathers the packed results back in lane order.

A mesh may name a device more than once: `fleet_mesh(devices=["cpu"] * 8)`
(the tests) or `["cuda:0"] * 4` on a one-card machine are the port's
counterpart of the reference's virtual CPU devices. The lanes are really
split, and the shards run one after another on that device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FLEET_AXIS = "fleet"


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


@dataclasses.dataclass(frozen=True, eq=False)
class FleetMesh:
    """A 1-D mesh of devices over the lane axis. Compared by identity, as
    the reference's solve memo and incremental state compare meshes;
    `fleet_mesh` hands out one object per device list."""

    devices: tuple[torch.device, ...]  # axis FLEET_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


_meshes: dict[tuple[torch.device, ...], FleetMesh] = {}


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {device} requested but CUDA is not available")
        index = torch.cuda.current_device() if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"mesh device cuda:{index} requested, {torch.cuda.device_count()} visible"
            )
        return torch.device("cuda", index)
    return device


def fleet_mesh(n_devices: int | None = None, devices=None) -> FleetMesh:
    """1-D mesh, axis "fleet": over the first `n_devices` (default: all)
    visible CUDA devices, or over `devices` (which may repeat one). With
    no CUDA device, or fewer than `n_devices`, it raises: the CPU is used
    only when named in `devices`."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for a fleet mesh: pass devices=['cpu'] * n to "
                "split the lanes on the CPU"
            )
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise RuntimeError(f"a fleet mesh of {n} CUDA devices requested, {count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [_resolve(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"a fleet mesh of {n_devices} devices requested, {len(devices)} given"
                )
            devices = devices[:n_devices]
    if not devices:
        raise ValueError("a fleet mesh needs at least one device")
    key = tuple(devices)
    if key not in _meshes:
        _meshes[key] = FleetMesh(key)
    return _meshes[key]


def shard_fleet_params(params, mesh: FleetMesh) -> list:
    """Split a params tuple (FleetParams, TandemParams, or a plain tuple of
    lane columns) into `mesh.size` contiguous numpy slices of the lane
    axis, one per device, in device order. The lane count must be a
    multiple of the mesh size (the fleet pads buckets with dummy lanes to
    one: `parallel.fleet._pad_lanes`)."""
    arrays = [np.asarray(a) for a in params]
    n = len(arrays[0]) if arrays else 0
    if n % mesh.size:
        raise ValueError(
            f"{n} lanes do not split evenly over a mesh of {mesh.size}: pad the "
            "lane axis to a multiple of the mesh size"
        )
    width = n // mesh.size
    make = getattr(type(params), "_make", type(params))
    return [
        make(a[j * width : (j + 1) * width] for a in arrays) for j in range(mesh.size)
    ]
