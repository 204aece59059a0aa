"""Real transformer compute for on-device profiling: Gemma-2 architecture.

The Llama block (`models/llama_block.py`) deliberately refuses to stand
in for architectures with a different layer body (its MODEL_PRESETS
note), because a profile measured on the wrong block is a wrong profile.
Gemma-2 differs in every way that moves the roofline:

* **sandwich norms** — RMSNorm BEFORE and AFTER each of attention and
  MLP (4 norms/layer vs Llama's 2), with Gemma's (1 + w) weight
  convention;
* **GeGLU** — tanh-approximate GELU gating instead of SiLU;
* **logit softcapping** — attention logits squashed to ±50 via
  tanh (final LM logits to ±30);
* **alternating sliding-window attention** — even layers attend only to
  the last `window` positions, odd layers globally (Gemma-2 technical
  report);
* **query scaling** by `query_pre_attn_scalar**-0.5` (hidden/n_heads for
  the 27B — NOT head_dim).

Same structure and profiling API as the Llama block — stacked params,
decode steps as in-place `.step`s on device state, head-major KV cache
written in place, everything bfloat16 with float32 softmax/norm
accumulation — so `inferno_tpu_torch.tools.profile_gpu` drives either
family through one code path.

Port of `inferno_tpu/models/gemma_block.py` in torch, with the Llama
port's departures (in-place clamped cache writes, Python loops, `.step`
for CUDA graphs, logits as the product in the cache's dtype cast to
float32, int8 cast before the product; see `llama_block`'s docstring).
The prefill picks each layer's mask by its parity in a Python loop where
the reference selects it inside a `lax.scan`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from inferno_tpu_torch.models.llama_block import (
    _attend,
    _cache_write,
    _mm,
    _random_weight,
    _rope,
    _sample_next,
    causal_mask,
    decode_mask,
    init_projections,
    layer_params,
    params_from_jax,
    repeat_fn,
    resolve_device,
    steps_fn,
    write_index,
)

__all__ = [
    "GEMMA_PRESETS",
    "GemmaDims",
    "init_stack",
    "make_decode_fn",
    "make_mixed_fn",
    "make_prefill_repeat_fn",
    "params_from_jax",
]


@dataclasses.dataclass(frozen=True)
class GemmaDims:
    """Gemma-2 model dimensions. Defaults are Gemma-2-9B."""

    hidden: int = 3584
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 256
    ffn: int = 14336
    vocab: int = 256128
    n_layers: int = 42
    rope_theta: float = 10000.0
    sliding_window: int = 4096
    attn_softcap: float = 50.0
    final_softcap: float = 30.0
    # Gemma-2 scales queries by query_pre_attn_scalar**-0.5; the 27B sets
    # it to hidden/n_heads, the 9B to head_dim
    query_pre_attn_scalar: float = 256.0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_params_bytes(self, dtype_bytes: int = 2) -> int:
        attn = self.hidden * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.hidden
        mlp = 3 * self.hidden * self.ffn
        norms = 4 * self.hidden  # sandwich: pre+post for attn and mlp
        return (attn + mlp + norms) * dtype_bytes

    def kv_bytes_per_token(self, n_layers: int | None = None, dtype_bytes: int = 2) -> int:
        layers = self.n_layers if n_layers is None else n_layers
        return layers * 2 * self.kv_dim * dtype_bytes


GEMMA_PRESETS: dict[str, GemmaDims] = {
    "gemma-2-9b": GemmaDims(),
    "gemma-2-27b": GemmaDims(hidden=4608, n_heads=32, n_kv_heads=16,
                             head_dim=128, ffn=36864, vocab=256128,
                             n_layers=46,
                             query_pre_attn_scalar=4608 / 32),
}


def init_stack(
    generator: torch.Generator, dims: GemmaDims, n_layers: int,
    weight_dtype: str = "bfloat16", device: str | torch.device | None = None,
) -> dict:
    """Stacked parameters for `n_layers` Gemma-2 layers + final norm and
    the (tied, read once per step) LM head. Same int8/float32 modes,
    generator and device rules as the Llama stack."""
    device = resolve_device(device)
    h = dims.hidden
    layers = init_projections(generator, dims, n_layers, weight_dtype, device)
    # Gemma norm weights are stored as w with the (1 + w) convention;
    # zeros reproduce identity-strength norms
    bf = torch.bfloat16
    for name in ("norm_attn_pre", "norm_attn_post", "norm_mlp_pre", "norm_mlp_post"):
        layers[name] = torch.zeros((n_layers, h), dtype=bf, device=device)
    return {
        "layers": layers,
        "norm_out": torch.zeros((h,), dtype=bf, device=device),
        "lm_head": _random_weight(generator, (h, dims.vocab), weight_dtype, device),
    }


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma convention: scale by (1 + w), norm in float32."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * (1.0 + w.float())).to(x.dtype)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


def _gqa_attend(q, k, v, mask, dims: GemmaDims):
    """Grouped-query attention with Gemma's query scaling and attention
    logit softcap. Shapes as in the Llama block (head-major cache)."""
    return _attend(q, k, v, mask, dims.n_kv_heads, dims.head_dim,
                   dims.query_pre_attn_scalar ** -0.5, softcap=dims.attn_softcap)


def _sliding_mask(base_mask: torch.Tensor, q_positions: torch.Tensor,
                  k_positions: torch.Tensor, window: int) -> torch.Tensor:
    """Restrict an additive causal mask to the last `window` positions:
    key j visible to query i iff i - window < j <= i."""
    delta = q_positions[..., :, None] - k_positions[..., None, :]
    inside = delta < window
    return torch.where(inside, base_mask, -torch.inf)


def _layer(x, layer_p, kv_cache, positions, mask, dims: GemmaDims,
           sliding: bool, k_positions, write_idx=None):
    """One Gemma-2 layer: sandwich-normed attention (sliding on even
    layers) + sandwich-normed GeGLU MLP, KV cache write at `positions`
    (the slots `write_idx`)."""
    h = _rmsnorm(x, layer_p["norm_attn_pre"])
    b, t = x.shape[0], x.shape[1]
    q = _mm(h, layer_p["wq"]).reshape(b, t, dims.n_heads, dims.head_dim)
    k = _mm(h, layer_p["wk"]).reshape(b, t, dims.n_kv_heads, dims.head_dim)
    v = _mm(h, layer_p["wv"]).reshape(b, t, dims.n_kv_heads, dims.head_dim)
    q = _rope(q, positions, dims.rope_theta)
    k = _rope(k, positions, dims.rope_theta)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if kv_cache is not None:
        _cache_write(kv_cache[0], k, write_idx)
        _cache_write(kv_cache[1], v, write_idx)
        k_all, v_all = kv_cache
    else:
        k_all, v_all = k, v

    attn_mask = (
        _sliding_mask(mask, positions, k_positions, dims.sliding_window)
        if sliding else mask
    )
    attn = _gqa_attend(q, k_all, v_all, attn_mask, dims)
    x = x + _rmsnorm(_mm(attn, layer_p["wo"]), layer_p["norm_attn_post"])

    h = _rmsnorm(x, layer_p["norm_mlp_pre"])
    gated = F.gelu(_mm(h, layer_p["w_gate"]).float(), approximate="tanh").to(h.dtype)
    mlp = _mm(gated * _mm(h, layer_p["w_up"]), layer_p["w_down"])
    x = x + _rmsnorm(mlp, layer_p["norm_mlp_post"])
    return x, kv_cache


def _final_logits(x: torch.Tensor, params: dict, dims: GemmaDims) -> torch.Tensor:
    x = _rmsnorm(x, params["norm_out"])
    return _softcap(_mm(x, params["lm_head"]).float(), dims.final_softcap)


def make_decode_fn(dims: GemmaDims, n_layers: int, n_steps: int):
    """Multi-step decode, API-identical to llama_block.make_decode_fn:
    (params, x0 (B,1,H), caches flat tuple, start_pos) -> (scalar, x,
    caches), plus `.step(params, x, caches, pos, acc)` in place. Even
    layer indices use the sliding window (Gemma-2's alternating
    pattern)."""

    def step(params, x, caches, pos, acc):
        b = x.shape[0]
        s_max = caches[0].shape[2]
        positions = pos.expand(b, 1)
        k_positions = torch.arange(s_max, device=x.device).expand(b, s_max)
        mask = decode_mask(pos, b, s_max)
        write_idx = write_index(pos, s_max, 1)
        h = x
        for li in range(n_layers):
            h, _ = _layer(
                h, layer_params(params, li), (caches[2 * li], caches[2 * li + 1]),
                positions, mask, dims, sliding=(li % 2 == 0),
                k_positions=k_positions, write_idx=write_idx,
            )
        logits = _final_logits(h[:, -1, :], params, dims)
        x.copy_(_sample_next(logits, dims.hidden, x.dtype))
        acc.add_(torch.sum(logits))
        pos.add_(1)

    return steps_fn(step, n_steps)


def _mixed_layer(x_all, split_b, layer_p, kv_cache, positions_dec, pos_chunk,
                 mask_dec, mask_chunk, dims: GemmaDims, sliding: bool,
                 k_positions, write_idx):
    """One Gemma-2 layer over a continuous-batching iteration (`split_b`
    decode rows + one prefill chunk, sharing every weight matmul) —
    the Gemma analogue of llama_block._mixed_layer, with sandwich norms,
    GeGLU, softcaps, and the layer's sliding/global attention applied to
    BOTH groups. x_all: (B + T, H)."""
    b = split_b
    h = _rmsnorm(x_all, layer_p["norm_attn_pre"])
    q = _mm(h, layer_p["wq"])
    k = _mm(h, layer_p["wk"])
    v = _mm(h, layer_p["wv"])

    # decode group: (B, 1, heads, hd) against the cache
    qd = q[:b].reshape(b, 1, dims.n_heads, dims.head_dim)
    kd = k[:b].reshape(b, 1, dims.n_kv_heads, dims.head_dim)
    vd = v[:b].reshape(b, 1, dims.n_kv_heads, dims.head_dim)
    qd = _rope(qd, positions_dec, dims.rope_theta)
    kd = _rope(kd, positions_dec, dims.rope_theta).transpose(1, 2)
    vd = vd.transpose(1, 2)
    _cache_write(kv_cache[0], kd, write_idx)
    _cache_write(kv_cache[1], vd, write_idx)
    mask_d = (
        _sliding_mask(mask_dec, positions_dec, k_positions, dims.sliding_window)
        if sliding else mask_dec
    )
    attn_d = _gqa_attend(qd, kv_cache[0], kv_cache[1], mask_d, dims).reshape(b, dims.q_dim)

    # chunk group: (1, T, heads, hd), causal (+ sliding) within the chunk
    t = x_all.shape[0] - b
    qc = q[b:].reshape(1, t, dims.n_heads, dims.head_dim)
    kc = k[b:].reshape(1, t, dims.n_kv_heads, dims.head_dim)
    vc = v[b:].reshape(1, t, dims.n_kv_heads, dims.head_dim)
    qc = _rope(qc, pos_chunk, dims.rope_theta)
    kc = _rope(kc, pos_chunk, dims.rope_theta).transpose(1, 2)
    vc = vc.transpose(1, 2)
    mask_c = (
        _sliding_mask(mask_chunk, pos_chunk, pos_chunk, dims.sliding_window)
        if sliding else mask_chunk
    )
    attn_c = _gqa_attend(qc, kc, vc, mask_c, dims).reshape(t, dims.q_dim)

    attn = torch.cat([attn_d, attn_c], dim=0)
    x_all = x_all + _rmsnorm(_mm(attn, layer_p["wo"]), layer_p["norm_attn_post"])
    h = _rmsnorm(x_all, layer_p["norm_mlp_pre"])
    gated = F.gelu(_mm(h, layer_p["w_gate"]).float(), approximate="tanh").to(h.dtype)
    mlp = _mm(gated * _mm(h, layer_p["w_up"]), layer_p["w_down"])
    x_all = x_all + _rmsnorm(mlp, layer_p["norm_mlp_post"])
    return x_all, kv_cache


def make_mixed_fn(dims: GemmaDims, n_layers: int, n_steps: int):
    """Continuous-batching iteration (B decode rows + one T-token prefill
    chunk per step, projections shared), API-identical to
    llama_block.make_mixed_fn — so Gemma TTFT calibration measures the
    real shared-iteration quantity instead of the pessimistic
    decode+prefill upper bound."""

    def step(params, x_dec, caches, chunk, pos, acc):
        b = x_dec.shape[0]
        t = chunk.shape[0]
        s_max = caches[0].shape[2]
        chunk = chunk * (1.0 + acc * 1e-30).to(chunk.dtype)
        positions_dec = pos.expand(b, 1)
        k_positions = torch.arange(s_max, device=chunk.device).expand(b, s_max)
        mask_dec = decode_mask(pos, b, s_max)
        pos_chunk = torch.arange(t, device=chunk.device)[None, :]
        mask_chunk = causal_mask(t, chunk.device)[None]
        write_idx = write_index(pos, s_max, 1)

        x_all = torch.cat([x_dec[:, 0, :], chunk], dim=0)
        for li in range(n_layers):
            x_all, _ = _mixed_layer(
                x_all, b, layer_params(params, li), (caches[2 * li], caches[2 * li + 1]),
                positions_dec, pos_chunk, mask_dec, mask_chunk, dims,
                sliding=(li % 2 == 0), k_positions=k_positions, write_idx=write_idx,
            )
        logits = _final_logits(x_all, params, dims)
        x_dec.copy_(_sample_next(logits[:b], dims.hidden, x_dec.dtype))
        acc.add_(torch.sum(logits) * 1e-30)
        pos.add_(1)

    return steps_fn(step, n_steps)


def make_prefill_repeat_fn(dims: GemmaDims, reps: int):
    """Repeated causal prefill, API-identical to the Llama version (a loop
    over the stacked layers, each layer's mask picked by its parity,
    data-dependence across reps)."""

    def prefill_body(params, x):
        b, t = x.shape[0], x.shape[1]
        positions = torch.arange(t, device=x.device).expand(b, t)
        mask = causal_mask(t, x.device).expand(b, t, t)
        sliding = _sliding_mask(mask, positions, positions, dims.sliding_window)
        y = x
        for li in range(params["layers"]["wq"].shape[0]):
            m = sliding if li % 2 == 0 else mask
            y, _ = _layer(y, layer_params(params, li), None, positions, m, dims,
                          sliding=False, k_positions=positions)
        logits = _final_logits(y[:, -1, :], params, dims)
        return torch.sum(logits)

    def step(params, x, acc):
        s = prefill_body(params, x * (1.0 + acc * 1e-30).to(x.dtype))
        acc.add_(s * 1e-30)

    return repeat_fn(step, reps)
