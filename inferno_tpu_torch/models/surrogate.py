"""Learned performance surrogate, in torch.

The linear alpha/beta/gamma/delta profile is a two-parameter-per-stage
approximation; real serving latency bends with batch, context length and
slice shape. The surrogate is a small transformer regressor that predicts
(ITL, TTFT, throughput) for a (slice shape, model, load) feature vector,
trained on telemetry; the profile corrector (`models/corrector.py`)
consults it where the linear profile's residuals are large.

Port of `inferno_tpu/models/surrogate.py`. The parameters keep the
reference's names and layouts (`embed [T, d]`, `pos [T, d]`,
`head_w [d, 3]`, `head_b [3]`, and per layer `qkv_w [d, 3, h, d/h]`,
`attn_out_w [h, d/h, d]`, `mlp_in_w [d, f]`, `mlp_out_w [f, d]`, the
biases and the two layer norms), so `surrogate_params_from_jax` carries a
reference parameter pytree across as a `state_dict`. The forward pass is
the reference's expression for expression: `jax.nn.gelu` is the tanh
approximation, the layer norm takes the population variance with eps 1e-6
inside the rsqrt. `featurize` stays numpy.

Tensor parallelism: `surrogate_param_specs` names, for each parameter,
the dimension it splits over the "tp" axis (the reference's Megatron-style
column/row split), and a model whose `tp_group` is set holds its rank's
slices (`parallel.train.init_train_state`) and runs Megatron's conjugate
pair around each parallel block: `tp_copy` (identity forward, all-reduce
backward) at the input of the column-parallel `qkv` and `mlp_in`
products, `tp_reduce` (all-reduce forward, identity backward) after the
row-parallel `attn_out` and `mlp_out` products, before the replicated
`mlp_out_b` is added. With no group the forward is the one-device one.

`Surrogate()` (the default config, seed 0) starts from the reference's
`init_surrogate(jax.random.key(0))` weights, stored in `surrogate_init.npz`
beside this module (written through `surrogate_params_from_jax`), so that
the corrector's refit starts from the same weights in both packages and
takes the same decision on the same telemetry.
`tests/test_torch_surrogate.py` holds the file equal to the reference's
init. Any other (config, seed) draws from `torch.Generator(seed)`.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib

import numpy as np
import torch
from torch import nn

# feature vector layout (see featurize()):
N_FEATURES = 10
N_OUTPUTS = 3  # itl_ms, ttft_ms, throughput_rps (log-space)

# the reference's init_surrogate(jax.random.key(0)) for SurrogateConfig()
REFERENCE_INIT = pathlib.Path(__file__).with_name("surrogate_init.npz")

_LAYER_KEYS = (
    "qkv_w", "attn_out_w", "ln1_scale", "ln1_bias", "mlp_in_w", "mlp_in_b",
    "mlp_out_w", "mlp_out_b", "ln2_scale", "ln2_bias",
)


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    n_tokens: int = N_FEATURES  # one token per feature


def featurize(
    chips: np.ndarray,
    cost_per_chip: np.ndarray,
    alpha: np.ndarray,
    beta: np.ndarray,
    gamma: np.ndarray,
    delta: np.ndarray,
    batch: np.ndarray,
    in_tokens: np.ndarray,
    out_tokens: np.ndarray,
    rate: np.ndarray,
) -> np.ndarray:
    """Stack raw quantities into the [B, N_FEATURES] input (log1p scaled)."""
    cols = [chips, cost_per_chip, alpha, beta, gamma, delta, batch, in_tokens, out_tokens, rate]
    x = np.stack([np.asarray(c, dtype=np.float32) for c in cols], axis=-1)
    return np.log1p(np.abs(x)) * np.sign(x)


def surrogate_param_specs(cfg: SurrogateConfig = SurrogateConfig()) -> dict[str, int | None]:
    """The tensor-parallel split of each parameter (`state_dict` names):
    the dimension it splits over "tp", or None where it is replicated.
    Attention heads and the MLP hidden dimension are split: `qkv_w` by
    heads (column-parallel), `attn_out_w` by its head rows (row-parallel),
    `mlp_in_w` and `mlp_in_b` by columns, `mlp_out_w` by rows; everything
    else is replicated (reference: `surrogate_param_specs`)."""
    specs: dict[str, int | None] = {
        "embed": None, "pos": None, "head_w": None, "head_b": None,
    }
    split = {"qkv_w": 2, "attn_out_w": 0, "mlp_in_w": 1, "mlp_in_b": 0, "mlp_out_w": 0}
    for i in range(cfg.n_layers):
        for name in _LAYER_KEYS:
            specs[f"layers.{i}.{name}"] = split.get(name)
    return specs


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient over the
    tp group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: all-reduce over the tp group forward, identity
    backward (`torch.distributed.nn.functional.all_reduce` would reduce the
    gradient again, scaling it by tp)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


class _Layer(nn.Module):
    def __init__(self, cfg: SurrogateConfig, gen: torch.Generator):
        super().__init__()
        d, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff

        def normal(shape, fan_in):
            return nn.Parameter(torch.randn(shape, generator=gen) / math.sqrt(fan_in))

        self.qkv_w = normal((d, 3, h, d // h), d)
        self.attn_out_w = normal((h, d // h, d), d)
        self.ln1_scale = nn.Parameter(torch.ones(d))
        self.ln1_bias = nn.Parameter(torch.zeros(d))
        self.mlp_in_w = normal((d, f), d)
        self.mlp_in_b = nn.Parameter(torch.zeros(f))
        self.mlp_out_w = normal((f, d), f)
        self.mlp_out_b = nn.Parameter(torch.zeros(d))
        self.ln2_scale = nn.Parameter(torch.ones(d))
        self.ln2_bias = nn.Parameter(torch.zeros(d))


class Surrogate(nn.Module):
    """x: [B, N_FEATURES] -> [B, N_OUTPUTS].

    Each feature scalar scales its learned token embedding; pre-LN
    transformer blocks; mean-pool; linear head. The default config with
    seed 0 loads the reference's seed-0 weights (`REFERENCE_INIT`); any
    other is initialized from `seed` through an explicit `torch.Generator`
    (values that differ from the reference's `jax.random` init; carry
    those with `load_state_dict`)."""

    def __init__(self, cfg: SurrogateConfig = SurrogateConfig(), seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d, t = cfg.d_model, cfg.n_tokens
        self.embed = nn.Parameter(torch.randn((t, d), generator=gen) * 0.02)
        self.pos = nn.Parameter(torch.randn((t, d), generator=gen) * 0.02)
        self.head_w = nn.Parameter(
            torch.randn((d, N_OUTPUTS), generator=gen) / math.sqrt(d)
        )
        self.head_b = nn.Parameter(torch.zeros(N_OUTPUTS))
        self.layers = nn.ModuleList(_Layer(cfg, gen) for _ in range(cfg.n_layers))
        self.tp_group = None  # set with this rank's slices (parallel.train)
        if cfg == SurrogateConfig() and seed == 0:
            with np.load(REFERENCE_INIT) as f:
                self.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp_group
        h = self.embed[None, :, :] * x[:, :, None] + self.pos[None, :, :]  # [B, T, D]
        for layer in self.layers:
            y = tp_copy(_layer_norm(h, layer.ln1_scale, layer.ln1_bias), tp)
            qkv = torch.einsum("btd,dchk->cbthk", y, layer.qkv_w)  # [3,B,T,H,K]
            q, k_, v = qkv[0], qkv[1], qkv[2]
            logits = torch.einsum("bthk,bshk->bhts", q, k_) / math.sqrt(q.shape[-1])
            attn = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("bhts,bshk->bthk", attn, v)
            h = h + tp_reduce(torch.einsum("bthk,hkd->btd", ctx, layer.attn_out_w), tp)
            y = tp_copy(_layer_norm(h, layer.ln2_scale, layer.ln2_bias), tp)
            ff = nn.functional.gelu(y @ layer.mlp_in_w + layer.mlp_in_b, approximate="tanh")
            h = h + tp_reduce(ff @ layer.mlp_out_w, tp) + layer.mlp_out_b
        pooled = h.mean(dim=1)  # [B, D]
        return pooled @ self.head_w + self.head_b


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)  # population, as jnp.var
    return (x - mean) * torch.rsqrt(var + 1e-6) * scale + bias


def surrogate_forward(model: Surrogate, x) -> torch.Tensor:
    """Predict for a [B, N_FEATURES] array on the model's device, without
    tracking gradients."""
    p = next(model.parameters())
    with torch.no_grad():
        return model(torch.as_tensor(np.asarray(x, np.float32), device=p.device))


def surrogate_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A reference parameter pytree (`inferno_tpu.models.surrogate.
    init_surrogate`, or a trained state's `params`) as a `state_dict` for
    `Surrogate.load_state_dict`. Leaves are read through numpy, so this
    needs no jax import."""
    out = {
        name: torch.from_numpy(np.array(params[name], dtype=np.float32))
        for name in ("embed", "pos", "head_w", "head_b")
    }
    for i, layer in enumerate(params["layers"]):
        for name in _LAYER_KEYS:
            out[f"layers.{i}.{name}"] = torch.from_numpy(
                np.array(layer[name], dtype=np.float32)
            )
    return out
