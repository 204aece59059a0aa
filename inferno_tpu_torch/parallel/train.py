"""Training of the performance surrogate, on one device or a (dp, tp) mesh.

Port of `inferno_tpu/parallel/train.py`: the same loss (mean squared
error over all outputs), the same optimizer (AdamW with optax's defaults:
betas 0.9/0.999, eps 1e-8, weight decay 1e-4, which is not torch's
default of 1e-2) and the same batch draw (`np.random.default_rng(seed)
.choice`), so that both packages see the same batches. Initialization
comes from `Surrogate(cfg, seed)`: for the default config and seed 0, the
reference's own seed-0 weights.

On a mesh (`train_mesh`: a `torch.distributed` `DeviceMesh` of shape
(dp, tp) over the initialized process group, one rank a device) each rank
holds its tp slice of the full initial weights (`surrogate_param_specs`:
heads and the MLP hidden dimension split, Megatron style) and its dp
slice of every batch (`shard_batch`). The forward runs Megatron's
conjugate pair around each parallel block (`models.surrogate.tp_copy` /
`tp_reduce`, over the tp group); after the backward the gradients are
averaged over the dp group, and AdamW runs on each rank's own shards (it
is elementwise, so the sharded update is the one-device update). The
reference's XLA inserts the same collectives. Every rank draws the same
batch indices; the batch is rounded down to a multiple of dp, as the
reference's. A (1, 1) mesh is the one-device step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from inferno_tpu_torch.models.surrogate import (
    Surrogate,
    SurrogateConfig,
    surrogate_param_specs,
)
from inferno_tpu_torch.parallel.mesh import fleet_device

# optax.adamw's defaults (torch's AdamW defaults to weight_decay=1e-2)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4

DP_AXIS = "dp"
TP_AXIS = "tp"


def train_mesh(n_devices: int | None = None, tp: int = 2):
    """(dp, tp) `DeviceMesh` over the initialized process group (one rank
    a device; NCCL ranks on CUDA, gloo ranks on the CPU): tp shrinks to
    the largest width that divides the device count, as the reference's.
    `n_devices` must be the world size (default)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "train_mesh needs an initialized process group "
            "(torch.distributed.init_process_group)"
        )
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a process group of {world} ranks")
    tp = min(tp, n)
    while n % tp:
        tp -= 1
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // tp, tp), mesh_dim_names=(DP_AXIS, TP_AXIS))


def _axis(mesh, name: str) -> tuple[int, int]:
    """(size, this rank's coordinate) of a mesh axis; (1, 0) without a mesh."""
    if mesh is None:
        return 1, 0
    return mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name)


@dataclasses.dataclass
class TrainState:
    model: Surrogate
    optimizer: torch.optim.Optimizer
    device: torch.device
    cfg: SurrogateConfig
    mesh: object = None  # the (dp, tp) DeviceMesh, or None on one device


def _shard_model(model: Surrogate, cfg: SurrogateConfig, mesh) -> None:
    """Keep this rank's tp slice of every split parameter of the full
    initial weights, and hand the forward the tp group."""
    tp, rank = _axis(mesh, TP_AXIS)
    if tp == 1:
        return
    specs = surrogate_param_specs(cfg)
    with torch.no_grad():
        for name, param in model.named_parameters():
            dim = specs[name]
            if dim is not None:
                param.data = param.data.chunk(tp, dim=dim)[rank].contiguous()
    model.tp_group = mesh.get_group(TP_AXIS)


def init_train_state(
    device,
    cfg: SurrogateConfig = SurrogateConfig(),
    learning_rate: float = 3e-4,
    seed: int = 0,
    mesh=None,
) -> TrainState:
    """The model (from `Surrogate(cfg, seed)`'s full weights, so that a
    sharded run and a one-device run start equal; on a mesh this rank's
    tp slices) and its AdamW state on `device`."""
    model = Surrogate(cfg, seed)
    _shard_model(model, cfg, mesh)
    model = model.to(device)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
        eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY,
    )
    return TrainState(model=model, optimizer=optimizer, device=device, cfg=cfg, mesh=mesh)


def shard_batch(state: TrainState, x, y) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's dp slice of a global batch, as f32 tensors on the
    state's device (the whole batch without a mesh). The batch must split
    evenly over dp."""
    dp, rank = _axis(state.mesh, DP_AXIS)
    x = torch.as_tensor(np.asarray(x, np.float32), device=state.device)
    y = torch.as_tensor(np.asarray(y, np.float32), device=state.device)
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} does not split over dp={dp}")
    per = x.shape[0] // dp
    return x[rank * per : (rank + 1) * per], y[rank * per : (rank + 1) * per]


def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor) -> float:
    """One full (forward+backward+update) step on this rank's slice of the
    batch; returns the loss before the update over the whole global batch,
    as the reference's jitted step does. On a mesh the gradients (and the
    loss) are averaged over dp in one all-reduce."""
    pred = state.model(x)
    loss = torch.mean((pred - y) ** 2)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    dp, _ = _axis(state.mesh, DP_AXIS)
    if dp > 1:
        import torch.distributed as dist

        params = list(state.model.parameters())
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=state.mesh.get_group(DP_AXIS))
        flat /= dp
        offset = 0
        for p in params:
            p.grad.copy_(flat[offset : offset + p.numel()].view_as(p.grad))
            offset += p.numel()
        loss = flat[-1]
    state.optimizer.step()
    return float(loss.detach())


def dp_batch_size(batch_size: int, n: int, dp: int) -> int:
    """The batch a dp-way data-parallel step draws from `n` rows: rounded
    down to a multiple of dp (at least dp), as the reference's. One device
    stepping on this batch computes the dp-way step: the dp slices are
    equal, so the mean of their means is the batch mean."""
    return max(dp, (min(batch_size, n) // dp) * dp)


def fit_surrogate(
    x: np.ndarray,
    y: np.ndarray,
    device=None,
    cfg: SurrogateConfig = SurrogateConfig(),
    epochs: int = 100,
    batch_size: int = 256,
    learning_rate: float = 1e-3,
    seed: int = 0,
    mesh=None,
) -> tuple[TrainState, list[float]]:
    """Fit the surrogate to telemetry (features x [N,F], targets y [N,3]).

    `device=None` is the CUDA card and raises when there is none; the CPU
    is used only when asked for (`device="cpu"`). With a `mesh`
    (`train_mesh`) every rank calls this with the same data; the batch is
    rounded down to a multiple of dp, as the reference's."""
    device = fleet_device(device)
    state = init_train_state(device, cfg, learning_rate, seed, mesh)
    n = x.shape[0]
    batch_size = dp_batch_size(batch_size, n, _axis(mesh, DP_AXIS)[0])
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(epochs):
        idx = rng.choice(n, size=batch_size, replace=n < batch_size)
        bx, by = shard_batch(state, np.asarray(x)[idx], np.asarray(y)[idx])
        losses.append(train_step(state, bx, by))
    return state, losses
