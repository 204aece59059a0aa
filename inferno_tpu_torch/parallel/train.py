"""Training of the performance surrogate, on one device.

Port of `inferno_tpu/parallel/train.py` for one device: the same loss
(mean squared error over all outputs), the same optimizer (AdamW with
optax's defaults: betas 0.9/0.999, eps 1e-8, weight decay 1e-4, which is
not torch's default of 1e-2) and the same batch draw
(`np.random.default_rng(seed).choice`), so that both packages see the
same batches. Initialization comes from `Surrogate(cfg, seed)`: for the
default config and seed 0, the reference's own seed-0 weights.

The reference's (dp, tp) mesh and the multi-GPU training stay for a
later slice. On one device the batch is `min(batch_size, n)`, as the
reference's on a one-device mesh; on a wider mesh the reference rounds it
down to a multiple of the data-parallel width.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from inferno_tpu_torch.models.surrogate import Surrogate, SurrogateConfig
from inferno_tpu_torch.parallel.mesh import fleet_device

# optax.adamw's defaults (torch's AdamW defaults to weight_decay=1e-2)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class TrainState:
    model: Surrogate
    optimizer: torch.optim.Optimizer
    device: torch.device
    cfg: SurrogateConfig


def init_train_state(
    device,
    cfg: SurrogateConfig = SurrogateConfig(),
    learning_rate: float = 3e-4,
    seed: int = 0,
) -> TrainState:
    model = Surrogate(cfg, seed).to(device)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
        eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY,
    )
    return TrainState(model=model, optimizer=optimizer, device=device, cfg=cfg)


def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor) -> float:
    """One full (forward+backward+update) step; returns the loss before
    the update, as the reference's jitted step does."""
    pred = state.model(x)
    loss = torch.mean((pred - y) ** 2)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    return float(loss.detach())


def fit_surrogate(
    x: np.ndarray,
    y: np.ndarray,
    device=None,
    cfg: SurrogateConfig = SurrogateConfig(),
    epochs: int = 100,
    batch_size: int = 256,
    learning_rate: float = 1e-3,
    seed: int = 0,
) -> tuple[TrainState, list[float]]:
    """Fit the surrogate to telemetry (features x [N,F], targets y [N,3]).

    `device=None` is the CUDA card and raises when there is none; the CPU
    is used only when asked for (`device="cpu"`)."""
    device = fleet_device(device)
    state = init_train_state(device, cfg, learning_rate, seed)
    xs = torch.as_tensor(np.asarray(x, np.float32), device=device)
    ys = torch.as_tensor(np.asarray(y, np.float32), device=device)
    n = x.shape[0]
    batch_size = max(1, min(batch_size, n))
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(epochs):
        idx = rng.choice(n, size=batch_size, replace=n < batch_size)
        idx_t = torch.as_tensor(idx, device=device)
        losses.append(train_step(state, xs[idx_t], ys[idx_t]))
    return state, losses
