"""Real transformer compute for on-device profiling: Llama-3.1-8B dimensions.

The reference fits its linear performance profiles (alpha/beta/gamma/delta)
from guidellm measurements against a live vLLM GPU server
(upstream docs/tutorials/parameter-estimation.md:127-266). This
module measures the same quantities from first principles: a Llama-style
decoder stack (GQA attention + SwiGLU MLP + RMSNorm + RoPE) at
Llama-3.1-8B dimensions, timed by `inferno_tpu_torch.tools.profile_gpu`
over swept batch sizes / input lengths.

Port of `inferno_tpu/models/llama_block.py` in torch. The parameters keep
the reference's stacked `[L, in, out]` layout (`params_from_jax` is a
copy), the functions compute what the reference's do, and the factories
keep their names and call signatures. What differs:

* The KV cache is written in place (`index_copy_` along the sequence
  axis at a device index), not returned as a new buffer; the start is
  placed as `lax.dynamic_update_slice` places it (`write_index`: a
  negative start wraps, then the start is clamped to `[0, S_max - T]`),
  once a step for all its layers, where the reference takes it per layer
  from the same position. The caches a factory's function returns are
  the caches it was given, updated.
* The reference's `lax.fori_loop` over steps and `lax.scan` over layers
  are Python loops. Each factory's function also carries `.step`, one
  step that updates its state tensors in place (the position and the
  accumulator are device scalars), so that the profiler can capture one
  step in a CUDA graph and replay it: dispatch never enters the timing,
  as it does not in the reference's single compiled loop.
* Attention logits are the product in the cache's dtype (fp32
  accumulation inside the matmul) cast to float32, where the reference
  asks XLA for float32 outputs: in bf16 the logits are rounded to bf16
  once before the f32 softmax. Upcasting the bf16 cache instead would
  triple the bytes a decode step reads.
* int8 weights are cast to the activations' dtype before the product;
  XLA fuses that cast into the matmul's read, torch materializes it.
* The docstrings describe the design without the reference's TPU figures;
  apart from these points the code is a line-by-line translation.

Everything runs on the device of the tensors it is given; `init_stack`
places them on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LlamaDims:
    """Model dimensions. Defaults are Llama-3.1-8B."""

    hidden: int = 4096
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    ffn: int = 14336
    vocab: int = 128256
    n_layers: int = 32  # full model; profiling may run a sub-stack
    rope_theta: float = 500000.0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_params_bytes(self, dtype_bytes: int = 2) -> int:
        attn = self.hidden * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.hidden
        mlp = 3 * self.hidden * self.ffn
        return (attn + mlp + 2 * self.hidden) * dtype_bytes

    def kv_bytes_per_token(self, n_layers: int | None = None, dtype_bytes: int = 2) -> int:
        layers = self.n_layers if n_layers is None else n_layers
        return layers * 2 * self.kv_dim * dtype_bytes


# Profiling presets for the dense-decoder families the profiler supports
# out of the box; any other architecture is a LlamaDims(...) away.
MODEL_PRESETS: dict[str, LlamaDims] = {
    "llama-3.1-8b": LlamaDims(),
    # BASELINE config #5's multi-host model (80 layers, 8192 hidden,
    # GQA-8): its bf16 weights exceed one device's memory, so profiling
    # runs reduced depths (--layer-depths) and the layer regression
    # extrapolates
    "llama-3.1-70b": LlamaDims(hidden=8192, n_heads=64, n_kv_heads=8,
                               head_dim=128, ffn=28672, vocab=128256,
                               n_layers=80),
    "llama-3.2-3b": LlamaDims(hidden=3072, n_heads=24, n_kv_heads=8,
                              head_dim=128, ffn=8192, vocab=128256,
                              n_layers=28),
    "llama-3.2-1b": LlamaDims(hidden=2048, n_heads=32, n_kv_heads=8,
                              head_dim=64, ffn=8192, vocab=128256,
                              n_layers=16),
}
# NOTE: presets are Llama-family only on purpose — architectures with a
# different layer body (Gemma-2's post-norms/softcaps/sliding-window,
# MoE models) need their own block to be measured honestly.

WEIGHT_DTYPES = ("bfloat16", "int8", "float32")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device the blocks run on. `None` means the CUDA card and raises
    when there is none: the CPU is used only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the profiling "
                "blocks on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _random_weight(generator, shape, weight_dtype, device):
    """N(0, 0.02²) weights, one layer at a time (a full-depth float32
    temporary of the largest projection would double the peak memory).
    int8 stores round(w / 0.02 * 63) clipped to ±127, as the reference."""
    scale = 0.02
    dtype = {"bfloat16": torch.bfloat16, "int8": torch.int8,
             "float32": torch.float32}[weight_dtype]
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out if len(shape) == 3 else out[None]
    for layer in rows:
        full = torch.randn(layer.shape, generator=generator, dtype=torch.float32,
                           device=device) * scale
        if weight_dtype == "int8":
            full = torch.clamp(torch.round(full / scale * 63.0), -127, 127)
        layer.copy_(full)
    return out


def init_projections(generator, dims, n_layers: int, weight_dtype: str, device) -> dict:
    """The seven stacked projection weights of `n_layers` layers, the
    layout both families share, drawn in this order."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype {weight_dtype!r} not in {WEIGHT_DTYPES}")
    h, q, kv, f = dims.hidden, dims.q_dim, dims.kv_dim, dims.ffn
    shapes = {
        "wq": (n_layers, h, q), "wk": (n_layers, h, kv), "wv": (n_layers, h, kv),
        "wo": (n_layers, q, h), "w_gate": (n_layers, h, f), "w_up": (n_layers, h, f),
        "w_down": (n_layers, f, h),
    }
    return {k: _random_weight(generator, shape, weight_dtype, device)
            for k, shape in shapes.items()}


def init_stack(
    generator: torch.Generator, dims: LlamaDims, n_layers: int,
    weight_dtype: str = "bfloat16", device: str | torch.device | None = None,
) -> dict:
    """Stacked parameters for `n_layers` identical decoder layers plus the
    final norm and LM head. Leading axis of each layer tensor is the layer
    index.

    weight_dtype "int8" stores projection weights quantized (w8a16):
    decode is weight-read-bound, so halving weight bytes roughly halves
    the step time where the dequant fuses into the matmul; norms stay
    bfloat16. "float32" is the CPU-testable mode.

    `generator` draws the weights and must live on `device` (None = the
    card). Its numbers are not jax.random's: to compare with the
    reference, carry its weights across with `params_from_jax`.
    """
    device = resolve_device(device)
    h = dims.hidden
    layers = init_projections(generator, dims, n_layers, weight_dtype, device)
    bf = torch.bfloat16
    layers["norm_attn"] = torch.ones((n_layers, h), dtype=bf, device=device)
    layers["norm_mlp"] = torch.ones((n_layers, h), dtype=bf, device=device)
    return {
        "layers": layers,
        "norm_out": torch.ones((h,), dtype=bf, device=device),
        "lm_head": _random_weight(generator, (h, dims.vocab), weight_dtype, device),
    }


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, which torch cannot read
    directly) -> torch on `device`."""
    a = np.array(a)  # a writable copy: jax hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params_np: dict, device: str | torch.device | None = None) -> dict:
    """The reference's `init_stack` output (a nested dict of numpy arrays,
    e.g. `jax.tree.map(np.asarray, params)`) as the port's parameters: the
    layout is the same, so this is a copy."""
    device = resolve_device(device)
    return {k: (params_from_jax(v, device) if isinstance(v, dict)
                else _tensor_from_numpy(v, device))
            for k, v in params_np.items()}


def layer_params(params: dict, li: int) -> dict:
    """Layer `li`'s slice of the stacked layer tensors (views)."""
    return {k: w[li] for k, w in params["layers"].items()}


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul with dequant for int8-stored weights (w8a16)."""
    if w.dtype == torch.int8:
        w = w.to(x.dtype)
    return x @ w


def _rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * g


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). The
    "rotate half" layout: the first half of each head pairs with the
    second, with float32 angles."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [(xf1 * cos - xf2 * sin).to(x.dtype), (xf2 * cos + xf1 * sin).to(x.dtype)],
        dim=-1,
    )


def _attend(q, k, v, mask, n_kv_heads, head_dim, scale, softcap=None):
    """Grouped-query attention, the reference's composition: two batched
    products, float32 logits, an additive mask, a float32 softmax whose
    probabilities take v's dtype. q: (B, Tq, n_heads, hd); k, v: (B,
    n_kv_heads, Tk, hd), head-major; mask: (B, Tq, Tk) additive. Returns
    (B, Tq, n_heads*hd). `softcap` squashes the scaled logits (Gemma)."""
    b, tq, n_heads, hd = q.shape
    groups = n_heads // n_kv_heads
    # (B, Tq, kvh, g, hd) -> (B, kvh, g*Tq, hd): one product per kv head
    qg = q.reshape(b, tq, n_kv_heads, groups, hd).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, n_kv_heads, groups * tq, hd)
    logits = torch.matmul(qg, k.transpose(-1, -2)).float()
    logits = logits.view(b, n_kv_heads, groups, tq, -1) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + mask[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.view(b, n_kv_heads, groups * tq, -1), v)
    out = out.view(b, n_kv_heads, groups, tq, hd).permute(0, 3, 1, 2, 4)
    return out.to(q.dtype).reshape(b, tq, n_heads * hd)


def _gqa_attend(q, k, v, mask, dims: LlamaDims):
    """q: (B, Tq, n_heads, hd); k,v: (B, n_kv_heads, Tk, hd) — head-major so
    the per-step cache reads are contiguous; mask: (B, Tq, Tk) additive.
    Returns (B, Tq, n_heads*hd)."""
    return _attend(q, k, v, mask, dims.n_kv_heads, dims.head_dim, dims.head_dim ** -0.5)


def write_index(start: torch.Tensor, s_max: int, t: int) -> torch.Tensor:
    """The cache slots a T-token write at device position `start` lands
    on, placed as `lax.dynamic_update_slice` places it: a negative start
    counts from the end (jax adds S_max), then XLA clamps the start to
    [0, S_max - T]. Every layer of a step writes at the same start, so the
    steps compute this once and hand it to each layer's write."""
    s = torch.where(start < 0, start + s_max, start)
    s = torch.clamp(s, 0, s_max - t)
    return s + torch.arange(t, device=start.device, dtype=s.dtype)


def _cache_write(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """cache[:, :, idx] = new, in place (idx from `write_index`)."""
    cache.index_copy_(2, idx, new.contiguous())


def _layer(x, layer_p, kv_cache, positions, mask, dims: LlamaDims, write_idx=None):
    """One decoder layer over (B, T, H) with KV cache write at `positions`.

    kv_cache: (k, v) pair of (B, n_kv_heads, S_max, hd) buffers for this
    layer, written in place at the slots `write_idx` (`write_index` of
    positions[0, 0]), or None (prefill without cache retention).
    Returns (out, cache)."""
    h = _rmsnorm(x, layer_p["norm_attn"])
    b, t = x.shape[0], x.shape[1]
    q = _mm(h, layer_p["wq"]).reshape(b, t, dims.n_heads, dims.head_dim)
    k = _mm(h, layer_p["wk"]).reshape(b, t, dims.n_kv_heads, dims.head_dim)
    v = _mm(h, layer_p["wv"]).reshape(b, t, dims.n_kv_heads, dims.head_dim)
    q = _rope(q, positions, dims.rope_theta)
    k = _rope(k, positions, dims.rope_theta)
    k = k.transpose(1, 2)  # (B, kvh, T, hd)
    v = v.transpose(1, 2)

    if kv_cache is not None:
        _cache_write(kv_cache[0], k, write_idx)
        _cache_write(kv_cache[1], v, write_idx)
        k_all, v_all = kv_cache
    else:
        k_all, v_all = k, v

    attn = _gqa_attend(q, k_all, v_all, mask, dims)
    x = x + _mm(attn, layer_p["wo"])
    h = _rmsnorm(x, layer_p["norm_mlp"])
    gated = F.silu(_mm(h, layer_p["w_gate"]).float()).to(h.dtype)
    x = x + _mm(gated * _mm(h, layer_p["w_up"]), layer_p["w_down"])
    return x, kv_cache


def _mixed_layer(x_all, split_b, layer_p, kv_cache, positions_dec, pos_chunk, mask_dec,
                 mask_chunk, dims, write_idx):
    """One decoder layer over a continuous-batching iteration: `split_b`
    decode rows + one prefill chunk, SHARING every weight matmul (the rows
    are concatenated for all projections, so the weight read amortizes the
    way a real chunked-prefill engine's step does), with attention split
    per group. x_all: (B + T, H); the decode rows write the cache at
    `write_idx`. Returns (x_all, cache)."""
    b = split_b
    h = _rmsnorm(x_all, layer_p["norm_attn"])
    q = _mm(h, layer_p["wq"])
    k = _mm(h, layer_p["wk"])
    v = _mm(h, layer_p["wv"])

    # decode group: (B, 1, heads, hd)
    qd = q[:b].reshape(b, 1, dims.n_heads, dims.head_dim)
    kd = k[:b].reshape(b, 1, dims.n_kv_heads, dims.head_dim)
    vd = v[:b].reshape(b, 1, dims.n_kv_heads, dims.head_dim)
    qd = _rope(qd, positions_dec, dims.rope_theta)
    kd = _rope(kd, positions_dec, dims.rope_theta).transpose(1, 2)
    vd = vd.transpose(1, 2)
    _cache_write(kv_cache[0], kd, write_idx)
    _cache_write(kv_cache[1], vd, write_idx)
    attn_d = _gqa_attend(qd, kv_cache[0], kv_cache[1], mask_dec, dims).reshape(b, dims.q_dim)

    # chunk group: (1, T, heads, hd), causal within the chunk
    t = x_all.shape[0] - b
    qc = q[b:].reshape(1, t, dims.n_heads, dims.head_dim)
    kc = k[b:].reshape(1, t, dims.n_kv_heads, dims.head_dim)
    vc = v[b:].reshape(1, t, dims.n_kv_heads, dims.head_dim)
    qc = _rope(qc, pos_chunk, dims.rope_theta)
    kc = _rope(kc, pos_chunk, dims.rope_theta).transpose(1, 2)
    vc = vc.transpose(1, 2)
    attn_c = _gqa_attend(qc, kc, vc, mask_chunk, dims).reshape(t, dims.q_dim)

    attn = torch.cat([attn_d, attn_c], dim=0)
    x_all = x_all + _mm(attn, layer_p["wo"])
    h = _rmsnorm(x_all, layer_p["norm_mlp"])
    gated = F.silu(_mm(h, layer_p["w_gate"]).float()).to(h.dtype)
    x_all = x_all + _mm(gated * _mm(h, layer_p["w_up"]), layer_p["w_down"])
    return x_all, kv_cache


# -- masks and positions, built on the device from a device position ------


def decode_mask(pos: torch.Tensor, b: int, s_max: int) -> torch.Tensor:
    """(B, 1, S_max) additive mask: cache slots [0, pos] visible."""
    valid = torch.arange(s_max, device=pos.device)[None, None, :] <= pos
    mask = torch.where(valid, 0.0, -torch.inf).to(torch.float32)
    return mask.expand(b, 1, s_max)


def causal_mask(t: int, device) -> torch.Tensor:
    """(T, T) additive causal mask."""
    ar = torch.arange(t, device=device)
    return torch.where(ar[:, None] >= ar[None, :], 0.0, -torch.inf).to(torch.float32)


def as_position(start_pos, device) -> torch.Tensor:
    """A 0-d int64 device tensor holding `start_pos` (a new tensor: the
    step functions advance it in place)."""
    return torch.as_tensor(start_pos, dtype=torch.int64, device=device).reshape(()).clone()


def steps_fn(step, n_steps: int):
    """A factory's function over its in-place `step(params, x, caches,
    *extra, pos, acc)`: (params, x, caches, *extra, start_pos) -> (acc +
    sum(x), x, caches), `n_steps` steps from a copy of x, a fresh position
    and a zero accumulator; the caches are updated in place. The step is
    kept as `.step`."""

    def run(params, x, caches, *args):
        *extra, start_pos = args
        x = x.clone()
        pos = as_position(start_pos, x.device)
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(n_steps):
            step(params, x, caches, *extra, pos, acc)
        # a scalar that depends on every step's full logits
        return acc + torch.sum(x.float()), x, tuple(caches)

    run.step = step
    return run


def repeat_fn(step, reps: int):
    """A repeated prefill over its in-place `step(params, x, acc)`:
    (params, x) -> acc after `reps` steps from zero; the step is kept as
    `.step`."""

    def run(params, x):
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(reps):
            step(params, x, acc)
        return acc

    run.step = step
    return run


def _sample_next(logits: torch.Tensor, hidden: int, dtype) -> torch.Tensor:
    """A deterministic next embedding from the logits: the caller also
    consumes a reduction of ALL logits, so the LM head is computed in
    full, as a real engine's sampling over the whole vocab needs."""
    return torch.tanh(logits[:, :hidden]).to(dtype)[:, None, :]


def make_mixed_fn(dims: LlamaDims, n_layers: int, n_steps: int):
    """Continuous-batching iteration: a batch of B decoding sequences plus
    ONE T-token prefill chunk per step, projections shared.

    Timing this per step measures the quantity the reference's TTFT
    calibration actually observes (guidellm TTFT at concurrency B under
    vLLM continuous batching = the arriving request's chunk riding a
    shared iteration, upstream docs/tutorials/
    parameter-estimation.md:241-266) — NOT B serialized full prefills.

    (params, x_dec (B,1,H), caches flat tuple, chunk (T,H), start_pos)
    -> (scalar, x_dec, caches); the caches are updated in place. `.step(
    params, x_dec, caches, chunk, pos, acc)` runs one iteration on state
    tensors in place (x_dec, the caches, the 0-d int64 `pos` and the 0-d
    float32 `acc`).
    """

    def step(params, x_dec, caches, chunk, pos, acc):
        b = x_dec.shape[0]
        t = chunk.shape[0]
        s_max = caches[0].shape[2]
        # perturb the chunk through the accumulated scalar so no
        # iteration's chunk work can be hoisted
        chunk = chunk * (1.0 + acc * 1e-30).to(chunk.dtype)
        positions_dec = pos.expand(b, 1)
        mask_dec = decode_mask(pos, b, s_max)
        pos_chunk = torch.arange(t, device=chunk.device)[None, :]
        mask_chunk = causal_mask(t, chunk.device)[None]
        write_idx = write_index(pos, s_max, 1)

        x_all = torch.cat([x_dec[:, 0, :], chunk], dim=0)
        for li in range(n_layers):
            x_all, _ = _mixed_layer(
                x_all, b, layer_params(params, li), (caches[2 * li], caches[2 * li + 1]),
                positions_dec, pos_chunk, mask_dec, mask_chunk, dims, write_idx,
            )
        x_all = _rmsnorm(x_all, params["norm_out"])
        logits = _mm(x_all, params["lm_head"])  # decode rows + chunk tail all sampled
        x_dec.copy_(_sample_next(logits[:b], dims.hidden, x_dec.dtype))
        acc.add_(torch.sum(logits.float()) * 1e-30)
        pos.add_(1)

    return steps_fn(step, n_steps)


def make_prefill_repeat_fn(dims: LlamaDims, reps: int):
    """Repeated prefill: runs the causal forward `reps` times, each
    iteration's input perturbed by the previous iteration's output so no
    iteration can be hoisted. Returns a scalar. Time/call divided by
    `reps` = one prefill's time. `.step(params, x, acc)` runs one
    iteration, accumulating into the 0-d float32 `acc` in place."""

    def prefill_body(params, x):
        b, t = x.shape[0], x.shape[1]
        positions = torch.arange(t, device=x.device).expand(b, t)
        mask = causal_mask(t, x.device).expand(b, t, t)
        y = x
        for li in range(params["layers"]["wq"].shape[0]):
            y, _ = _layer(y, layer_params(params, li), None, positions, mask, dims)
        y = _rmsnorm(y, params["norm_out"])
        logits = _mm(y[:, -1, :], params["lm_head"])
        return torch.sum(logits.float())

    def step(params, x, acc):
        # data dependence across iterations defeats loop-invariant hoisting
        s = prefill_body(params, x * (1.0 + acc * 1e-30).to(x.dtype))
        acc.add_(s * 1e-30)

    return repeat_fn(step, reps)


def make_decode_fn(dims: LlamaDims, n_layers: int, n_steps: int):
    """Multi-step greedy-shape decode: `n_steps` single-token steps over the
    layer stack.

    (params, x0 (B,1,H), caches = flat tuple (k_0, v_0, ..., k_{L-1},
    v_{L-1}) each (B,kvh,S_max,hd), start_pos) -> (scalar, x_final,
    caches); the caches are updated in place. Timing `.step(params, x,
    caches, pos, acc)` (one step on state tensors, in place) replayed from
    a CUDA graph gives the inter-token latency without per-step dispatch.
    """

    def step(params, x, caches, pos, acc):
        b = x.shape[0]
        s_max = caches[0].shape[2]
        positions = pos.expand(b, 1)
        # attend to cache slots [0, pos]; future slots masked
        mask = decode_mask(pos, b, s_max)
        write_idx = write_index(pos, s_max, 1)
        h = x
        for li in range(n_layers):
            h, _ = _layer(
                h, layer_params(params, li), (caches[2 * li], caches[2 * li + 1]),
                positions, mask, dims, write_idx,
            )
        h = _rmsnorm(h, params["norm_out"])
        logits = _mm(h[:, -1, :], params["lm_head"])
        x.copy_(_sample_next(logits, dims.hidden, x.dtype))
        acc.add_(torch.sum(logits.float()))
        pos.add_(1)

    return steps_fn(step, n_steps)
