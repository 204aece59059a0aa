"""The surrogate's (dp, tp) training and the tensor-parallel Llama decode
on gloo ranks on the CPU (`parallel.ranks.run_ranks`, one process a rank).

Tolerances: the mesh's step losses against the port's one-device steps
within 1e-5 relative (the same arithmetic, sums split over ranks); against
the reference's (2, 2) mesh of virtual devices within 1e-4 relative, the
tolerance of tests/test_torch_surrogate.py; each rank's gradient shards
after one step against the matching slices of the one-device gradients
within 1e-5 relative, plus 1e-7 of the array's largest entry for entries
that cancel to near zero (the sums run in another order); the
tp decode against the unsharded decode and the reference's at rtol 2e-4,
atol 1e-5, the reference dry run's tolerance.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from inferno_tpu_torch import graft_entry
from inferno_tpu_torch.models.surrogate import featurize, surrogate_param_specs
from inferno_tpu_torch.parallel.ranks import run_ranks

TESTS = str(pathlib.Path(__file__).resolve().parent)
STEP_RTOL = 1e-5
REF_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-7
RANK_TIMEOUT = 120.0


def _features(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return featurize(*[rng.uniform(0.5, 60.0, n) for _ in range(10)])


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    return _features(32, 5), rng.normal(size=(32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh_run(batch):
    """8 steps on 4 gloo ranks, a (2, 2) mesh, default config (the
    reference's seed-0 weights), each rank beside the one-device steps."""
    x, y = batch
    return run_ranks(
        "inferno_tpu_torch.graft_entry:_train_rank", 4, "cpu",
        dict(x=x, y=y, steps=8, learning_rate=3e-3, tp=2), timeout=RANK_TIMEOUT,
    )


def test_mesh_layout(mesh_run):
    assert sorted((r["dp_rank"], r["tp_rank"]) for r in mesh_run) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert {(r["dp"], r["tp"]) for r in mesh_run} == {(2, 2)}


def test_mesh_losses_equal_one_device_steps(mesh_run):
    """Every rank reports the global mean loss, equal to the one-device
    step on the whole batch."""
    losses = mesh_run[0]["losses"]
    for r in mesh_run:
        assert r["losses"] == losses
        np.testing.assert_allclose(r["losses"], r["single"], rtol=STEP_RTOL, atol=0)
    assert losses[-1] < losses[0]


def test_mesh_losses_match_reference_mesh(mesh_run, batch):
    """The reference's `init_train_state` on a (2, 2) mesh of its virtual
    CPU devices, the same batch, the same eight steps."""
    import jax

    from inferno_tpu.parallel import train as r_train

    x, y = batch
    mesh = r_train.train_mesh(n_devices=4, tp=2)
    assert dict(mesh.shape) == {"dp": 2, "tp": 2}
    state = r_train.init_train_state(jax.random.key(0), mesh, learning_rate=3e-3)
    bx, by = r_train.shard_batch(state, x, y)
    ref = [r_train.train_step(state, bx, by) for _ in range(8)]
    np.testing.assert_allclose(mesh_run[0]["losses"], ref, rtol=REF_RTOL, atol=0)


def test_gradient_shards_match_one_device_slices(mesh_run):
    """After one step each rank's gradient of a tp-split parameter is the
    matching slice of the one-device gradient, and its replicated
    gradients are the whole one-device ones: Megatron's f/g pair and the
    dp average are right (a g whose backward reduced again would scale
    the split gradients by tp)."""
    specs = surrogate_param_specs()
    for r in mesh_run:
        for name, dim in specs.items():
            want = r["single_grads"][name]
            if dim is not None:
                want = np.split(want, r["tp"], axis=dim)[r["tp_rank"]]
            atol = GRAD_ATOL_OF_MAX * float(np.abs(want).max())
            np.testing.assert_allclose(r["grads"][name], want, rtol=GRAD_RTOL,
                                       atol=atol, err_msg=name)


def test_param_specs_match_reference():
    """The port's split dimension of each parameter is where the
    reference's PartitionSpec names "tp"."""
    from inferno_tpu.models.surrogate import SurrogateConfig as RCfg
    from inferno_tpu.models.surrogate import surrogate_param_specs as ref_specs

    ref = ref_specs(RCfg())
    specs = surrogate_param_specs()

    def split_dim(spec):
        return next((i for i, axis in enumerate(spec) if axis == "tp"), None)

    want = {k: split_dim(ref[k]) for k in ("embed", "pos", "head_w", "head_b")}
    for i, layer in enumerate(ref["layers"]):
        want.update({f"layers.{i}.{k}": split_dim(s) for k, s in layer.items()})
    assert specs == want


def test_train_mesh_needs_a_process_group():
    from inferno_tpu_torch.parallel.train import train_mesh

    with pytest.raises(RuntimeError, match="initialized process group"):
        train_mesh()


def _fit_rank(x, y) -> dict:
    """Inside a rank: the reference's learning case on a (2, 2) mesh, then
    two short fits whose batches round down to a multiple of dp; records
    the local batch of every step."""
    from inferno_tpu_torch.parallel import train

    seen = []
    real = train.shard_batch

    def spy(state, bx, by):
        out = real(state, bx, by)
        seen.append((len(bx), len(out[0])))
        return out

    train.shard_batch = spy
    mesh = train.train_mesh(tp=2)
    _, losses = train.fit_surrogate(x, y, device="cpu", mesh=mesh, epochs=200,
                                    learning_rate=3e-3)
    learn = list(seen)
    seen.clear()
    train.fit_surrogate(x[:7], y[:7], device="cpu", mesh=mesh, epochs=1)
    train.fit_surrogate(x[:7], y[:7], device="cpu", mesh=mesh, epochs=1, batch_size=1)
    return {"losses": losses, "learn_batches": learn, "short_batches": list(seen)}


def test_surrogate_learns_queueing_surface_on_mesh():
    """tests/test_models.py's learning case (the surrogate fits its
    teacher, the scalar queueing analyzer), on the port's (2, 2) mesh;
    and the dp batch rounding of the reference: max(dp, (min(batch, n) //
    dp) * dp) — 256 of 256, 6 of 7, and 2 for a batch of 1."""
    from inferno_tpu.analyzer import RequestSize, build_analyzer
    from inferno_tpu.config.types import DecodeParms, PrefillParms

    rng = np.random.default_rng(1)
    rows, targets = [], []
    for _ in range(256):
        alpha = rng.uniform(5, 20)
        beta = rng.uniform(0.05, 0.4)
        in_tok, out_tok = int(rng.integers(64, 512)), int(rng.integers(16, 128))
        qa = build_analyzer(16, 160, DecodeParms(alpha, beta),
                            PrefillParms(3.0, 0.02), RequestSize(in_tok, out_tok))
        rate = rng.uniform(0.1, 0.9) * qa.max_rate
        m = qa.analyze(rate)
        rows.append([4, 1.2, alpha, beta, 3.0, 0.02, 16, in_tok, out_tok, rate])
        targets.append([m.avg_token_time, m.ttft, m.throughput])
    x = featurize(*np.array(rows, np.float32).T)
    y = np.log1p(np.array(targets, np.float32))
    runs = run_ranks("test_torch_train_mesh:_fit_rank", 4, "cpu", dict(x=x, y=y),
                     timeout=RANK_TIMEOUT, path=(TESTS,))
    losses = runs[0]["losses"]
    assert all(r["losses"] == losses for r in runs)
    assert losses[-1] < losses[0] * 0.2  # clear learning signal
    assert np.isfinite(losses[-1])
    for r in runs:
        assert set(r["learn_batches"]) == {(256, 128)}
        assert r["short_batches"] == [(6, 3), (2, 1)]


def test_tp_decode_matches_unsharded_and_reference():
    """The Llama decode at the reference dry run's toy dims, tp = 2 over two
    gloo ranks on the reference's own weights (`params_from_jax`): each
    rank holds it against the unsharded port decode, and here both are
    held against the reference's `make_decode_fn`."""
    import jax
    import jax.numpy as jnp

    from inferno_tpu.models.llama_block import LlamaDims, init_stack, make_decode_fn

    dims = LlamaDims(**graft_entry.TP_DECODE)
    run = graft_entry.TP_DECODE_RUN
    params = init_stack(jax.random.PRNGKey(7), dims, run["n_layers"], "float32")
    x0 = jax.random.normal(jax.random.PRNGKey(8), (run["batch"], 1, dims.hidden),
                           dtype=jnp.float32)
    caches = tuple(jnp.zeros((run["batch"], dims.n_kv_heads, run["s_max"], dims.head_dim),
                             jnp.float32) for _ in range(2 * run["n_layers"]))
    acc_ref, x_ref, _ = make_decode_fn(dims, run["n_layers"], run["steps"])(
        params, x0, caches, run["start"])
    out = run_ranks(
        "inferno_tpu_torch.graft_entry:_tp_decode_rank", 2, "cpu",
        dict(params_np=jax.tree.map(np.asarray, params), x0=np.asarray(x0)),
        timeout=RANK_TIMEOUT,
    )
    tol = dict(rtol=graft_entry.DECODE_RTOL, atol=graft_entry.DECODE_ATOL)
    for r in out:
        np.testing.assert_allclose(r["x"], np.asarray(x_ref), **tol)
        np.testing.assert_allclose(r["x_single"], np.asarray(x_ref), **tol)
        np.testing.assert_allclose(r["acc"], float(acc_ref), rtol=graft_entry.DECODE_RTOL)
    np.testing.assert_array_equal(out[0]["x"], out[1]["x"])
