"""The port's Llama profiling block (inferno_tpu_torch.models.llama_block)
against the reference's, on the CPU.

The reference's weights are carried across with `params_from_jax` (the
stacked layout is the same), the same numpy inputs go to both, and the
scalar, x and every cache are compared. Tolerances: float32, 1e-5
relative with an absolute floor of 1e-5 (as tests/test_llama_block.py:76-80;
products summed in another order); int8 weights, 1e-4 relative to the
largest value of each array: the reference stores int8 weights as
round(w / 0.02 * 63), integers up to ±127, so activations and attention
logits reach the thousands, where the f32 summation order moves the
result by up to 3e-5 of its largest value (measured). The scalars are
compared relatively only (the prefill's is of order 1e-30).

The cases of tests/test_llama_block.py run on the port as well, and the
in-place cache write is held to XLA's clamped `lax.dynamic_update_slice`.
A graph replay on the card is `cuda`-marked and skips here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferno_tpu.models import llama_block as ref
from inferno_tpu_torch.models import llama_block as port

DIMS = port.LlamaDims(hidden=64, n_heads=4, n_kv_heads=2, head_dim=16, ffn=128,
                      vocab=256, n_layers=8)
RDIMS = ref.LlamaDims(hidden=64, n_heads=4, n_kv_heads=2, head_dim=16, ffn=128,
                      vocab=256, n_layers=8)
L = 2
B = 3
S_MAX = 24
CTX = 16
RTOL = {"float32": 1e-5, "int8": 1e-4}


def assert_close(got, want, weight_dtype):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    if weight_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = RTOL[weight_dtype]
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def assert_scalar_close(got, want, weight_dtype):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL[weight_dtype], atol=0.0)


def make_params(weight_dtype, n_layers=L, seed=0):
    """(reference params, the port's copy of them)."""
    pj = ref.init_stack(jax.random.PRNGKey(seed), RDIMS, n_layers, weight_dtype=weight_dtype)
    return pj, port.params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


def np_caches(seed, n_layers=L, s_max=S_MAX, zero=False):
    rng = np.random.default_rng(seed)
    shape = (B, DIMS.n_kv_heads, s_max, DIMS.head_dim)
    return [np.zeros(shape, np.float32) if zero
            else (rng.normal(size=shape) * 0.1).astype(np.float32)
            for _ in range(2 * n_layers)]


def to_jax(caches):
    return tuple(jnp.asarray(c) for c in caches)


def to_port(caches):
    return [torch.from_numpy(c.copy()) for c in caches]


def np_normal(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def f32_params():
    return make_params("float32")


# -- parity with the reference ----------------------------------------------


@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
@pytest.mark.parametrize("start", [CTX, S_MAX - 1, S_MAX + 3])
def test_decode_matches_reference(weight_dtype, start):
    """start > S_max - 1 exercises XLA's clamp of the cache write."""
    pj, pt = make_params(weight_dtype)
    x = np_normal(1, (B, 1, DIMS.hidden))
    caches = np_caches(2)
    s_r, x_r, c_r = ref.make_decode_fn(RDIMS, L, 4)(pj, jnp.asarray(x), to_jax(caches),
                                                     jnp.int32(start))
    s_p, x_p, c_p = port.make_decode_fn(DIMS, L, 4)(pt, torch.from_numpy(x), to_port(caches),
                                                      start)
    assert_scalar_close(s_p, s_r, weight_dtype)
    assert_close(x_p, x_r, weight_dtype)
    assert len(c_p) == len(c_r) == 2 * L
    for cp, cr in zip(c_p, c_r):
        assert_close(cp, cr, weight_dtype)


@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
@pytest.mark.parametrize("start", [CTX, S_MAX + 3])
def test_mixed_matches_reference(weight_dtype, start):
    pj, pt = make_params(weight_dtype)
    x = np_normal(3, (B, 1, DIMS.hidden))
    chunk = np_normal(4, (8, DIMS.hidden))
    caches = np_caches(5)
    s_r, x_r, c_r = ref.make_mixed_fn(RDIMS, L, 2)(
        pj, jnp.asarray(x), to_jax(caches), jnp.asarray(chunk), jnp.int32(start))
    s_p, x_p, c_p = port.make_mixed_fn(DIMS, L, 2)(
        pt, torch.from_numpy(x), to_port(caches), torch.from_numpy(chunk), start)
    assert_scalar_close(s_p, s_r, weight_dtype)
    assert_close(x_p, x_r, weight_dtype)
    for cp, cr in zip(c_p, c_r):
        assert_close(cp, cr, weight_dtype)


@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
@pytest.mark.parametrize("reps", [1, 3])
def test_prefill_matches_reference(weight_dtype, reps):
    pj, pt = make_params(weight_dtype, n_layers=3)
    x = np_normal(7, (2, 12, DIMS.hidden))
    s_r = ref.make_prefill_repeat_fn(RDIMS, reps)(pj, jnp.asarray(x))
    s_p = port.make_prefill_repeat_fn(DIMS, reps)(pt, torch.from_numpy(x))
    assert_scalar_close(s_p, s_r, weight_dtype)


@pytest.mark.parametrize("start", [-3, 0, 5, S_MAX - 6, S_MAX - 4, S_MAX + 10])
def test_cache_write_clamps_like_dynamic_update_slice(start):
    cache = np_caches(8, n_layers=1)[0]
    new = np_normal(9, (B, DIMS.n_kv_heads, 6, DIMS.head_dim), scale=1.0)
    want = jax.lax.dynamic_update_slice(jnp.asarray(cache), jnp.asarray(new),
                                        (0, 0, jnp.int32(start), 0))
    got = torch.from_numpy(cache.copy())
    # as the layers pass it: a (B, T, kvh, hd) tensor transposed, not contiguous
    new_t = torch.from_numpy(np.ascontiguousarray(new.transpose(0, 2, 1, 3))).transpose(1, 2)
    port._cache_write(got, new_t, port.write_index(torch.tensor(start), S_MAX, 6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rope_and_rmsnorm_match_reference():
    x = np_normal(10, (2, 5, DIMS.n_heads, DIMS.head_dim), scale=1.0)
    pos = np.array([[0, 3, 17, 100, 4095]] * 2)
    np.testing.assert_allclose(
        port._rope(torch.from_numpy(x), torch.from_numpy(pos), DIMS.rope_theta).numpy(),
        np.asarray(ref._rope(jnp.asarray(x), jnp.asarray(pos), RDIMS.rope_theta)),
        rtol=1e-5, atol=1e-5)
    h = np_normal(11, (3, 2, DIMS.hidden), scale=3.0)
    g = np_normal(12, (DIMS.hidden,), scale=1.0)
    np.testing.assert_allclose(
        port._rmsnorm(torch.from_numpy(h), torch.from_numpy(g)).numpy(),
        np.asarray(ref._rmsnorm(jnp.asarray(h), jnp.asarray(g))), rtol=1e-6, atol=1e-6)


def test_params_from_jax_is_a_copy(f32_params):
    pj, pt = f32_params
    flat_r = jax.tree_util.tree_leaves_with_path(pj)
    assert len(flat_r) == len(pt["layers"]) + 2
    for path, leaf in flat_r:
        keys = [p.key for p in path]
        got = pt
        for k in keys:
            got = got[k]
        want = np.asarray(leaf)
        assert tuple(got.shape) == want.shape
        # the norms are bf16 in the reference even in float32 mode
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
        assert str(got.dtype).endswith(str(want.dtype))


def test_step_is_the_factory_in_place(f32_params):
    """`.step` on state tensors (what the profiler captures in a CUDA
    graph) computes exactly what the factory's function returns."""
    _, pt = f32_params
    decode = port.make_decode_fn(DIMS, L, 3)
    x0 = torch.from_numpy(np_normal(13, (B, 1, DIMS.hidden)))
    s_f, x_f, c_f = decode(pt, x0, to_port(np_caches(14)), CTX)
    x, caches = x0.clone(), to_port(np_caches(14))
    pos = torch.tensor(CTX)
    acc = torch.zeros(())
    for _ in range(3):
        decode.step(pt, x, caches, pos, acc)
    assert int(pos) == CTX + 3
    assert torch.equal(acc + torch.sum(x.float()), s_f) and torch.equal(x, x_f)
    assert all(torch.equal(a, b) for a, b in zip(caches, c_f))


# -- the reference's own cases, on the port --------------------------------


def test_decode_steps_advance_cache_and_stay_finite(f32_params):
    _, pt = f32_params
    decode = port.make_decode_fn(DIMS, L, 4)
    x = torch.from_numpy(np_normal(1, (B, 1, DIMS.hidden)))
    before = to_port(np_caches(2))
    s, x2, caches2 = decode(pt, x, to_port(np_caches(2)), CTX)
    assert np.isfinite(float(s))
    assert torch.isfinite(x2).all()
    # the 4 steps wrote cache slots CTX..CTX+3; untouched slots identical
    assert not torch.allclose(caches2[0][:, :, CTX:CTX + 4], before[0][:, :, CTX:CTX + 4])
    assert torch.equal(caches2[0][:, :, :CTX], before[0][:, :, :CTX])


def test_mixed_decode_rows_match_pure_decode(f32_params):
    """The chunk must ride along without changing the decode computation."""
    _, pt = f32_params
    x = torch.from_numpy(np_normal(3, (B, 1, DIMS.hidden)))
    chunk = torch.from_numpy(np_normal(4, (8, DIMS.hidden)))
    _, x_dec, caches_dec = port.make_decode_fn(DIMS, L, 2)(pt, x, to_port(np_caches(5)), CTX)
    _, x_mix, caches_mix = port.make_mixed_fn(DIMS, L, 2)(pt, x, to_port(np_caches(5)),
                                                         chunk, CTX)
    np.testing.assert_allclose(x_mix.numpy(), x_dec.numpy(), rtol=1e-5, atol=1e-5)
    for cd, cm in zip(caches_dec, caches_mix):
        np.testing.assert_allclose(cm.numpy(), cd.numpy(), rtol=1e-5, atol=1e-5)


def test_mixed_output_depends_on_chunk(f32_params):
    """...but the chunk work must actually happen (its logits feed the
    returned scalar)."""
    _, pt = f32_params
    x = torch.zeros((B, 1, DIMS.hidden))
    mixed = port.make_mixed_fn(DIMS, L, 1)
    c1 = torch.from_numpy(np_normal(6, (8, DIMS.hidden)))
    s1 = float(mixed(pt, x, to_port(np_caches(0, zero=True)), c1, CTX)[0])
    s2 = float(mixed(pt, x, to_port(np_caches(0, zero=True)), c1 * 2.0, CTX)[0])
    assert s1 != s2


def test_prefill_repeat_scalar_finite(f32_params):
    _, pt = f32_params
    fn = port.make_prefill_repeat_fn(DIMS, reps=2)
    x = torch.from_numpy(np_normal(7, (2, 12, DIMS.hidden)))
    assert np.isfinite(float(fn(pt, x)))


# -- the port's own surface ---------------------------------------------------


@pytest.mark.parametrize("weight_dtype", ["bfloat16", "int8", "float32"])
def test_init_stack_shapes_dtypes_and_seed(weight_dtype):
    def make(seed):
        return port.init_stack(torch.Generator().manual_seed(seed), DIMS, L, weight_dtype,
                               device="cpu")

    p = make(0)
    want = {"bfloat16": torch.bfloat16, "int8": torch.int8, "float32": torch.float32}
    assert p["layers"]["wq"].shape == (L, DIMS.hidden, DIMS.q_dim)
    assert p["layers"]["w_down"].shape == (L, DIMS.ffn, DIMS.hidden)
    assert p["lm_head"].shape == (DIMS.hidden, DIMS.vocab)
    assert p["layers"]["wk"].dtype == p["lm_head"].dtype == want[weight_dtype]
    assert p["layers"]["norm_attn"].dtype == p["norm_out"].dtype == torch.bfloat16
    assert torch.equal(make(0)["layers"]["wv"], p["layers"]["wv"])
    assert not torch.equal(make(1)["layers"]["wv"], p["layers"]["wv"])
    if weight_dtype == "int8":
        assert int(p["layers"]["w_up"].abs().max()) <= 127
    else:
        assert abs(float(p["layers"]["w_up"].float().std()) - 0.02) < 2e-3


def test_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.init_stack(torch.Generator(), DIMS, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.params_from_jax({"lm_head": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="weight_dtype"):
        port.init_stack(torch.Generator(), DIMS, 1, "fp8", device="cpu")


@pytest.fixture
def cuda_device():
    """The card, for `cuda`-marked tests; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replay_is_bit_identical_on_card(cuda_device):
    from inferno_tpu_torch.tools.profile_gpu import replayable

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pt = port.init_stack(gen, DIMS, L, "bfloat16", device=cuda_device)
    x0 = torch.randn((B, 1, DIMS.hidden), generator=gen, device=cuda_device).bfloat16()
    decode = port.make_decode_fn(DIMS, L, 3)
    caches0 = [torch.zeros((B, DIMS.n_kv_heads, S_MAX, DIMS.head_dim), dtype=torch.bfloat16,
                           device=cuda_device) for _ in range(2 * L)]
    s_e, x_e, c_e = decode(pt, x0, [c.clone() for c in caches0], CTX)
    x, caches = x0.clone(), [c.clone() for c in caches0]
    pos = torch.zeros((), dtype=torch.int64, device=cuda_device)
    acc = torch.zeros((), device=cuda_device)
    run = replayable(lambda: decode.step(pt, x, caches, pos, acc), cuda_device)
    x.copy_(x0)
    for c, c0 in zip(caches, caches0):
        c.copy_(c0)
    pos.fill_(CTX)
    acc.zero_()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    assert torch.equal(x, x_e) and torch.equal(acc + torch.sum(x.float()), s_e)
    assert all(torch.equal(a, b) for a, b in zip(caches, c_e))
