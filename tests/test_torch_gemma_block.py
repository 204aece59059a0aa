"""The port's Gemma-2 profiling block (inferno_tpu_torch.models.gemma_block)
against the reference's, on the CPU, and the cases of
tests/test_gemma_block.py on the port: sandwich norms, softcaps and the
ALTERNATING sliding-window attention, family dispatch and the dims
round-trip through the profiler's recorded meta.

Weights are carried across with `params_from_jax`; the same numpy inputs
go to both; the scalar, x and every cache are compared under the
tolerances of tests/test_torch_llama_block.py (float32: 1e-5 relative,
absolute floor 1e-5; int8: 1e-4 of each array's largest value, for the
integer-valued weights' large activations; scalars relatively only).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferno_tpu.models import gemma_block as ref
from inferno_tpu_torch.models import gemma_block as port
from inferno_tpu_torch.models.profiles import build_profile_json, dims_from_meta
from tests.test_torch_llama_block import assert_close, assert_scalar_close

TINY = port.GemmaDims(hidden=32, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64,
                      vocab=96, n_layers=2, sliding_window=8,
                      query_pre_attn_scalar=8.0)
RTINY = ref.GemmaDims(**dataclasses.asdict(TINY))


def make_params(weight_dtype, n_layers=2, seed=0):
    pj = ref.init_stack(jax.random.PRNGKey(seed), RTINY, n_layers, weight_dtype)
    return pj, port.params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


def np_caches(n_layers, batch, s_max, rng=None):
    shape = (batch, TINY.n_kv_heads, s_max, TINY.head_dim)
    if rng is None:
        return [np.zeros(shape, np.float32) for _ in range(2 * n_layers)]
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2 * n_layers)]


def to_port(caches):
    return [torch.from_numpy(c.copy()) for c in caches]


def to_jax(caches):
    return tuple(jnp.asarray(c) for c in caches)


# -- parity with the reference ----------------------------------------------


@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
@pytest.mark.parametrize("pos", [16, 30, 40])
def test_decode_matches_reference(weight_dtype, pos):
    """pos 16 with window 8 puts early keys outside the sliding window;
    pos 40 > S_max - 1 exercises the clamp of the cache write."""
    pj, pt = make_params(weight_dtype)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 1, TINY.hidden)) * 0.1).astype(np.float32)
    caches = np_caches(2, 3, 32, rng)
    s_r, x_r, c_r = ref.make_decode_fn(RTINY, 2, 3)(pj, jnp.asarray(x), to_jax(caches), pos)
    s_p, x_p, c_p = port.make_decode_fn(TINY, 2, 3)(pt, torch.from_numpy(x), to_port(caches),
                                                     pos)
    assert_scalar_close(s_p, s_r, weight_dtype)
    assert_close(x_p, x_r, weight_dtype)
    for cp, cr in zip(c_p, c_r):
        assert_close(cp, cr, weight_dtype)


@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
@pytest.mark.parametrize("t", [6, 12])
def test_mixed_matches_reference(weight_dtype, t):
    """t = 12 > window 8: the chunk's sliding mask bites on even layers."""
    pj, pt = make_params(weight_dtype)
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 1, TINY.hidden)) * 0.1).astype(np.float32)
    chunk = (rng.normal(size=(t, TINY.hidden)) * 0.1).astype(np.float32)
    caches = np_caches(2, 3, 24, rng)
    s_r, x_r, c_r = ref.make_mixed_fn(RTINY, 2, 2)(pj, jnp.asarray(x), to_jax(caches),
                                                    jnp.asarray(chunk), 16)
    s_p, x_p, c_p = port.make_mixed_fn(TINY, 2, 2)(pt, torch.from_numpy(x), to_port(caches),
                                                    torch.from_numpy(chunk), 16)
    assert_scalar_close(s_p, s_r, weight_dtype)
    assert_close(x_p, x_r, weight_dtype)
    for cp, cr in zip(c_p, c_r):
        assert_close(cp, cr, weight_dtype)


@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_layers", [2, 3])
def test_prefill_matches_reference(weight_dtype, n_layers):
    """T = 12 > window 8, so the parity-selected masks differ."""
    pj, pt = make_params(weight_dtype, n_layers=n_layers, seed=2)
    x = (np.random.default_rng(3).normal(size=(2, 12, TINY.hidden)) * 0.05).astype(np.float32)
    s_r = ref.make_prefill_repeat_fn(RTINY, 2)(pj, jnp.asarray(x))
    s_p = port.make_prefill_repeat_fn(TINY, 2)(pt, torch.from_numpy(x))
    assert_scalar_close(s_p, s_r, weight_dtype)


def test_norm_softcap_and_sliding_mask_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, TINY.hidden)).astype(np.float32) * 3
    w = rng.normal(size=(TINY.hidden,)).astype(np.float32)
    np.testing.assert_allclose(port._rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(ref._rmsnorm(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)
    y = rng.normal(size=(50,)).astype(np.float32) * 100
    np.testing.assert_allclose(port._softcap(torch.from_numpy(y), 50.0).numpy(),
                               np.asarray(ref._softcap(jnp.asarray(y), 50.0)),
                               rtol=1e-6, atol=1e-5)
    base = np.where(np.arange(20)[:, None] >= np.arange(20)[None, :], 0.0,
                    -np.inf).astype(np.float32)[None]
    pos = np.arange(20)[None]
    np.testing.assert_array_equal(
        port._sliding_mask(torch.from_numpy(base), torch.from_numpy(pos),
                           torch.from_numpy(pos), 8).numpy(),
        np.asarray(ref._sliding_mask(jnp.asarray(base), jnp.asarray(pos),
                                     jnp.asarray(pos), 8)))


# -- the reference's own cases, on the port --------------------------------


def test_decode_runs_and_is_finite():
    n_layers, batch, s_max = 2, 3, 24
    params = port.init_stack(torch.Generator().manual_seed(0), TINY, n_layers, "float32",
                             device="cpu")
    decode = port.make_decode_fn(TINY, n_layers, n_steps=4)
    x0 = torch.ones((batch, 1, TINY.hidden)) * 0.1
    acc, x, caches = decode(params, x0, to_port(np_caches(n_layers, batch, s_max)), 16)
    assert np.isfinite(float(acc))
    assert x.shape == (batch, 1, TINY.hidden)
    assert len(caches) == 2 * n_layers


def test_sliding_window_alternates_by_layer_parity():
    """Even layers use the sliding window, odd layers attend globally:
    perturbing cached keys OUTSIDE the window must not change the output
    through an even layer, and must change it through an odd one."""
    n_layers, batch, s_max, pos = 2, 1, 32, 16
    _, params = make_params("float32", seed=1)
    decode = port.make_decode_fn(TINY, n_layers, n_steps=1)
    x0 = torch.ones((batch, 1, TINY.hidden)) * 0.1
    base = np_caches(n_layers, batch, s_max, np.random.default_rng(3))
    _, x_base, _ = decode(params, x0, to_port(base), pos)

    far, near = 2, 12  # pos - far = 14 >= window 8; delta 4 < 8

    def poke(layer, position):
        out = [c.copy() for c in base]
        out[2 * layer][:, :, position, :] += 7.0
        return to_port(out)

    _, x_far0, _ = decode(params, x0, poke(0, far), pos)
    np.testing.assert_allclose(x_base.numpy(), x_far0.numpy(), rtol=1e-6, atol=1e-7)
    _, x_near0, _ = decode(params, x0, poke(0, near), pos)
    assert not np.allclose(x_base.numpy(), x_near0.numpy())
    _, x_far1, _ = decode(params, x0, poke(1, far), pos)
    assert not np.allclose(x_base.numpy(), x_far1.numpy())


def test_softcap_bounds_and_preserves_small_values():
    y = port._softcap(torch.tensor([-1000.0, -1.0, 0.0, 1.0, 1000.0]), 50.0).numpy()
    assert np.all(np.abs(y) <= 50.0)
    assert y[2] == 0.0
    assert y[3] == pytest.approx(1.0, rel=1e-3)


def test_prefill_repeat_runs_with_alternating_masks():
    _, params = make_params("float32", n_layers=3, seed=2)
    prefill = port.make_prefill_repeat_fn(TINY, reps=2)
    x = torch.ones((2, 12, TINY.hidden)) * 0.05
    assert np.isfinite(float(prefill(params, x)))


def test_mixed_decode_rows_match_pure_decode():
    n_layers, batch, s_max, pos = 2, 3, 24, 16
    _, params = make_params("float32", seed=4)
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.normal(size=(batch, 1, TINY.hidden)) * 0.1).astype(np.float32))
    chunk = torch.from_numpy((rng.normal(size=(6, TINY.hidden)) * 0.1).astype(np.float32))
    _, x_dec, caches_dec = port.make_decode_fn(TINY, n_layers, 2)(
        params, x, to_port(np_caches(n_layers, batch, s_max, np.random.default_rng(5))), pos)
    _, x_mix, caches_mix = port.make_mixed_fn(TINY, n_layers, 2)(
        params, x, to_port(np_caches(n_layers, batch, s_max, np.random.default_rng(5))),
        chunk, pos)
    np.testing.assert_allclose(x_mix.numpy(), x_dec.numpy(), rtol=1e-5, atol=1e-5)
    for cd, cm in zip(caches_dec, caches_mix):
        np.testing.assert_allclose(cm.numpy(), cd.numpy(), rtol=1e-5, atol=1e-5)
    # ...and the chunk work actually happens (zero decode input: the scalar
    # is then purely the 1e-30-scaled chunk-logit term)
    mixed1 = port.make_mixed_fn(TINY, n_layers, 1)
    x0 = torch.zeros((batch, 1, TINY.hidden))
    s1 = float(mixed1(params, x0, to_port(np_caches(n_layers, batch, s_max)), chunk, pos)[0])
    s2 = float(mixed1(params, x0, to_port(np_caches(n_layers, batch, s_max)), chunk * 2.0,
                      pos)[0])
    assert s1 != s2


def test_presets_match_published_dimensions():
    d27 = port.GEMMA_PRESETS["gemma-2-27b"]
    assert (d27.hidden, d27.n_layers, d27.n_heads, d27.n_kv_heads) == (4608, 46, 32, 16)
    assert d27.query_pre_attn_scalar == pytest.approx(4608 / 32)
    d9 = port.GEMMA_PRESETS["gemma-2-9b"]
    assert (d9.hidden, d9.n_layers, d9.head_dim) == (3584, 42, 256)
    assert {k: dataclasses.asdict(v) for k, v in port.GEMMA_PRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.GEMMA_PRESETS.items()}


def test_dims_from_meta_round_trip_both_families():
    meta = dataclasses.asdict(TINY)
    meta["n_layers_full"] = meta.pop("n_layers")
    back = dims_from_meta(meta)
    assert isinstance(back, port.GemmaDims) and back == TINY

    legacy = {"hidden": 4096, "n_heads": 32, "n_kv_heads": 8,
              "head_dim": 128, "ffn": 14336, "vocab": 128256,
              "n_layers_full": 32}
    from inferno_tpu_torch.models.llama_block import LlamaDims
    ll = dims_from_meta(legacy)
    assert isinstance(ll, LlamaDims) and ll.n_layers == 32


def test_profile_pipeline_accepts_gemma_raw():
    dims_meta = dataclasses.asdict(port.GEMMA_PRESETS["gemma-2-9b"])
    dims_meta["n_layers_full"] = dims_meta.pop("n_layers")
    decode, prefill = [], []
    for L in (2, 4, 8):
        for b in (1, 8, 32):
            decode.append({"n_layers": L, "batch": b, "context": 1024,
                           "step_ms": 1.2 + L * (0.5 + 0.004 * b)})
        for t in (128, 512, 2048):
            prefill.append({"n_layers": L, "batch": 1, "in_tokens": t,
                            "prefill_ms": 1.2 + L * 0.002 * t})
    raw = {"meta": {"model": "gemma-2-9b", "dims": dims_meta,
                    "dtype": "bfloat16", "weight_dtype": "int8"},
           "decode": decode, "prefill": prefill}
    doc = build_profile_json(raw, "v5e-4-int8", n_chips=4, weight_bytes_per_param=1.0)
    assert doc["name"] == "gemma-2-9b" and doc["derived"] is True
    assert doc["maxBatchSize"] > 0
    assert doc["decodeParms"]["alpha"] > 0 and doc["prefillParms"]["delta"] > 0


def test_profiler_family_dispatch():
    from inferno_tpu_torch.models import llama_block
    from inferno_tpu_torch.tools import profile_gpu

    assert profile_gpu.family_for("gemma-2-27b") is port
    assert profile_gpu.family_for("llama-3.1-70b") is llama_block
    assert "gemma-2-9b" in profile_gpu.ALL_PRESETS
    for fn in ("init_stack", "make_decode_fn", "make_prefill_repeat_fn", "make_mixed_fn"):
        assert callable(getattr(port, fn))
        assert callable(getattr(llama_block, fn))


@pytest.mark.parametrize("weight_dtype", ["bfloat16", "int8", "float32"])
def test_init_stack_zero_norms_and_dtypes(weight_dtype):
    p = port.init_stack(torch.Generator().manual_seed(0), TINY, 2, weight_dtype, device="cpu")
    for name in ("norm_attn_pre", "norm_attn_post", "norm_mlp_pre", "norm_mlp_post"):
        assert p["layers"][name].shape == (2, TINY.hidden)
        assert not p["layers"][name].any()
    assert not p["norm_out"].any()
    assert p["lm_head"].shape == (TINY.hidden, TINY.vocab)
    assert str(p["layers"]["wq"].dtype) == f"torch.{weight_dtype}"
