"""The corrector's surrogate refit at the reference's data-parallel width,
against the reference's refit on its mesh, on the CPU.

Under tests/conftest.py the reference sees 8 virtual CPU devices, and its
`ProfileCorrector` refits on `train_mesh(tp=1)` over all of them: dp 8,
the batch rounded down to a multiple of 8. The port draws the same
rounded batch (`parallel.train.dp_batch_size`) at `ProfileCorrector(dp=)`
and steps on it on one device, which computes the dp-way step. The
windows are tests/test_torch_surrogate.py's (`_window`: ITL = (5 + 0.1 b
+ 0.15 b^2) U(0.97, 1.03), out of band for the CR line alpha 5, beta 0.1).

Tolerances:
- REFIT_RTOL = 1e-2: the corrector's linearized alpha and beta against
  the reference's (80 f32 AdamW steps, then a least-squares line through
  16 predictions), as in tests/test_torch_surrogate.py;
- LOSS_RTOL = 1e-4: the first 20 step losses against the reference's
  `fit_surrogate` on `train_mesh(n_devices=dp, tp=1)` (XLA sums across its
  devices in another order), as in test_torch_surrogate.py;
- STEP_RTOL = 1e-5: one step's gradients and loss on the whole rounded
  batch against the mean of the dp slices' (the arithmetic of a dp-way
  all-reduce), relative to the largest gradient, as in
  tests/test_torch_train_mesh.py;
- the rounded batch sizes, the dp and the one-device path exactly.
"""

from __future__ import annotations

import multiprocessing
import os
import subprocess
import types

import jax
import numpy as np
import pytest
import torch

from inferno_tpu.config.types import DecodeParms as RDecode
from inferno_tpu.config.types import PrefillParms as RPrefill
from inferno_tpu.models import corrector as r_corr
from inferno_tpu.parallel import train as r_train
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller import reconciler as p_rec
from inferno_tpu_torch.models import corrector as p_corr
from inferno_tpu_torch.models.surrogate import featurize
from inferno_tpu_torch.parallel import train as p_train
from test_torch_held_cycle import reference_dp
from test_torch_surrogate import _feed, _window

REFIT_RTOL = 1e-2
LOSS_RTOL = 1e-4
STEP_RTOL = 1e-5
DECODE = dict(alpha=5.0, beta=0.1)
PREFILL = dict(gamma=2.0, delta=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The fits here are small, and the tests run beside other test
    workers: torch's intra-op threads would only contend with them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_refit(points, **kw):
    port = p_corr.ProfileCorrector(**kw)
    _feed(port, p_corr.Observation, points)
    dec, _, state = port.corrected_parms("v", DecodeParms(**DECODE), PrefillParms(**PREFILL))
    return port, dec, state


def _spy_fits(monkeypatch) -> list[dict]:
    """Record every `fit_surrogate` call the corrector makes: its rows,
    batch size and step losses."""
    seen = []
    real = p_train.fit_surrogate

    def spy(x, y, **kwargs):
        state, losses = real(x, y, **kwargs)
        seen.append({"n": x.shape[0], "batch_size": kwargs.get("batch_size"), "losses": losses,
                     "x": x, "y": y})
        return state, losses

    monkeypatch.setattr(p_train, "fit_surrogate", spy)
    return seen


def _batch(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    x = featurize(*[rng.uniform(0.5, 60.0, n) for _ in range(10)])
    return x, rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [12, 30, 37, 64])
def test_corrector_refit_matches_reference_at_its_dp(n):
    """Windows that are not multiples of the reference's 8 devices (12,
    30, 37) and one that is (64): the port's refit at the reference's dp
    gives the reference's corrected DecodeParms."""
    points = _window(np.random.default_rng(0), n)
    ref = r_corr.ProfileCorrector()
    _feed(ref, r_corr.Observation, points)
    r_dec, _, r_state = ref.corrected_parms("v", RDecode(**DECODE), RPrefill(**PREFILL))
    port, p_dec, p_state = _port_refit(points, device="cpu", dp=reference_dp())
    assert reference_dp() == len(jax.devices()) == 8
    assert r_state.surrogate_used and p_state.surrogate_used
    assert port.refit_errors == 0
    assert p_state.decode_ratio == pytest.approx(r_state.decode_ratio, rel=1e-12)
    assert p_dec.alpha == pytest.approx(r_dec.alpha, rel=REFIT_RTOL)
    assert p_dec.beta == pytest.approx(r_dec.beta, rel=REFIT_RTOL)


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_step_losses_match_reference_mesh(dp):
    """30 rows (a multiple of none of 4 and 8): the reference's dp-way
    steps on its mesh and the port's one-device steps on the same rounded
    batch, drawn alike, agree."""
    x, y = _batch(30)
    mesh = r_train.train_mesh(n_devices=dp, tp=1)
    assert dict(mesh.shape) == {"dp": dp, "tp": 1}
    _, ref = r_train.fit_surrogate(x, y, mesh=mesh, epochs=20, learning_rate=3e-3)
    _, got = p_train.fit_surrogate(x, y, device="cpu", batch_size=p_train.dp_batch_size(256, 30, dp),
                                   epochs=20, learning_rate=3e-3)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("dp", [2, 3, 4, 8])
def test_rounded_batch_step_is_the_dp_step(dp):
    """One step on the whole rounded batch (37 rows: 36 at dp 2, 3, 4; 32
    at 8) against dp equal slices, their gradients and losses summed in
    rank order and divided by dp, as a dp-way all-reduce averages them."""
    x, y = _batch(37)
    n = p_train.dp_batch_size(256, 37, dp)
    assert n == (37 // dp) * dp
    model = p_train.init_train_state("cpu", learning_rate=3e-3).model
    bx, by = torch.as_tensor(x[:n]), torch.as_tensor(y[:n])

    def step(sx, sy):
        model.zero_grad(set_to_none=True)
        loss = torch.mean((model(sx) - sy) ** 2)
        loss.backward()
        return torch.cat([p.grad.reshape(-1) for p in model.parameters()]
                         + [loss.detach().reshape(1)])

    whole = step(bx, by)
    per = n // dp
    total = step(bx[:per], by[:per])
    for r in range(1, dp):
        total += step(bx[r * per : (r + 1) * per], by[r * per : (r + 1) * per])
    total /= dp
    scale = float(whole.abs().max())
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=0, atol=STEP_RTOL * scale)
    assert float(total[-1]) == pytest.approx(float(whole[-1]), rel=STEP_RTOL)


def test_dp_one_is_the_one_device_path(monkeypatch):
    """An explicit device refits at dp 1: the whole window, the batch and
    losses of `fit_surrogate`'s default call, and `dp=1` changes nothing."""
    seen = _spy_fits(monkeypatch)
    points = _window(np.random.default_rng(0), 37)
    _, dec, state = _port_refit(points, device="cpu")
    _, dec1, _ = _port_refit(points, device="cpu", dp=1)
    assert state.surrogate_used and (dec.alpha, dec.beta) == (dec1.alpha, dec1.beta)
    assert [s["batch_size"] for s in seen] == [37, 37]
    _, default = p_train.fit_surrogate(seen[0]["x"], seen[0]["y"], device="cpu", epochs=80,
                                       learning_rate=3e-3)
    assert seen[0]["losses"] == seen[1]["losses"] == default


@pytest.mark.parametrize(
    "dp, n, want",
    [(3, 37, 36), (8, 12, 8), (8, 30, 24), (8, 37, 32), (8, 64, 64), (1, 37, 37), (16, 12, 16)],
)
def test_refit_batch_rounds_to_dp(monkeypatch, dp, n, want):
    """The refit's batch is the reference's: min(256, n) rounded down to a
    multiple of dp, at least dp (a 12-window on 16 devices draws 16 with
    replacement, as the reference's `rng.choice` does)."""
    seen = _spy_fits(monkeypatch)
    port, _, _ = _port_refit(_window(np.random.default_rng(0), n), device="cpu", dp=dp)
    assert port.refit_errors == 0 and port.refit_dp() == dp
    assert [(s["n"], s["batch_size"]) for s in seen] == [(n, want)]
    assert want == max(dp, (min(256, n) // dp) * dp)  # inferno_tpu/parallel/train.py:118


def test_default_dp_is_every_visible_card(monkeypatch):
    """`device=None`: the CUDA card at dp = the visible cards, as
    `train_mesh(tp=1)` spans every local device; an explicit device is dp
    1; `dp=` is used as given. The reconciler's COMPUTE_DEVICE likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert p_corr.ProfileCorrector().refit_dp() == 3
    assert p_corr.ProfileCorrector(device="cpu").refit_dp() == 1
    assert p_corr.ProfileCorrector(device="cpu", dp=8).refit_dp() == 8
    for compute_device, want in ((None, (torch.device("cuda"), 3)),
                                 ("cpu", (torch.device("cpu"), 1))):
        rec = types.SimpleNamespace(
            config=p_rec.ReconcilerConfig(compute_device=compute_device))
        device, dp = p_rec.Reconciler._corrector_placement(rec)
        assert (device, dp) == want
        assert p_corr.ProfileCorrector(device=device, dp=dp).refit_dp() == want[1]


def test_no_card_raises(monkeypatch):
    """Without a card the default corrector's dp and refit raise (the
    refit's fallback then counts it, tests/test_torch_surrogate.py), and
    so does the reconciler's placement without COMPUTE_DEVICE."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_corr.ProfileCorrector().refit_dp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_corr.ProfileCorrector()._fit_and_linearize(
            [p_corr.Observation(concurrency=c, in_tokens=16, out_tokens=64, itl_ms=i,
                                ttft_ms=3.0) for c, i in _window(np.random.default_rng(0), 12)],
            DecodeParms(**DECODE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_corr.ProfileCorrector(device="cuda:0", dp=4)._fit_and_linearize(
            [p_corr.Observation(concurrency=c, in_tokens=16, out_tokens=64, itl_ms=i,
                                ttft_ms=3.0) for c, i in _window(np.random.default_rng(0), 12)],
            DecodeParms(**DECODE))
    rec = types.SimpleNamespace(config=p_rec.ReconcilerConfig(compute_device=None))
    with pytest.raises(RuntimeError, match="the profile corrector has no device"):
        p_rec.Reconciler._corrector_placement(rec)


def test_refit_runs_in_the_callers_process(monkeypatch):
    """The dp-4 refit starts no process and uses no process group: every
    way to start one, and every collective, raises if called."""
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("the refit left its process")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(multiprocessing.Process, "start", refuse)
    monkeypatch.setattr(os, "fork", refuse)
    for name in ("init_process_group", "new_group", "all_reduce", "broadcast"):
        monkeypatch.setattr(dist, name, refuse)
    port, dec, state = _port_refit(_window(np.random.default_rng(0), 37), device="cpu", dp=4)
    assert state.surrogate_used and port.refit_errors == 0 and dec.alpha > 0
    assert not dist.is_initialized()
