"""The port's surrogate, its training and the corrector's refit against
the reference's, on the CPU. The port's default initial weights are the
reference's seed-0 weights (`models/surrogate_init.npz`); other weights
are carried across with `surrogate_params_from_jax`.

Tolerances: the forward pass within 1e-5 (absolute, on outputs of order
1: f32 einsums summed in another order); the first 20 training-step
losses within 1e-4 relative (same batches, AdamW with optax's defaults;
the f32 drift grows with the steps); the corrector's refitted DecodeParms
within 1e-2 relative (80 steps, then a least-squares line through 16
predictions).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferno_tpu.config.types import DecodeParms as RDecode
from inferno_tpu.config.types import PrefillParms as RPrefill
from inferno_tpu.models import corrector as r_corr
from inferno_tpu.models import surrogate as r_sur
from inferno_tpu.parallel import train as r_train
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.models import corrector as p_corr
from inferno_tpu_torch.models.surrogate import (
    Surrogate,
    featurize,
    surrogate_forward,
    surrogate_params_from_jax,
)
from inferno_tpu_torch.parallel.train import (
    ADAMW_WEIGHT_DECAY,
    fit_surrogate,
)

FWD_ATOL = 1e-5
LOSS_RTOL = 1e-4
REFIT_RTOL = 1e-2


def _features(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return featurize(*[rng.uniform(0.5, 60.0, n) for _ in range(10)])


def _carried(seed: int = 0):
    params = r_sur.init_surrogate(jax.random.key(seed))
    return params, surrogate_params_from_jax(params)


def test_state_dict_keeps_reference_names_and_layouts():
    params, sd = _carried()
    model = Surrogate()
    own = model.state_dict()
    assert set(own) == set(sd)
    for name, t in own.items():
        assert tuple(t.shape) == tuple(sd[name].shape), name
    assert tuple(own["layers.0.qkv_w"].shape) == (64, 3, 4, 16)
    assert tuple(own["layers.1.attn_out_w"].shape) == (4, 16, 64)
    model.load_state_dict(sd)
    np.testing.assert_array_equal(
        model.layers[1].mlp_out_w.detach().numpy(),
        np.asarray(params["layers"][1]["mlp_out_w"]),
    )


def test_default_init_is_reference_init():
    """`Surrogate()` starts from the reference's `init_surrogate(key(0))`
    bit for bit, so both packages' refits start alike."""
    _, sd = _carried(0)
    own = Surrogate().state_dict()
    assert set(own) == set(sd)
    for name, t in own.items():
        np.testing.assert_array_equal(t.numpy(), sd[name].numpy(), err_msg=name)
    # another seed is the port's own draw
    other = Surrogate(seed=1).state_dict()
    assert not torch.equal(other["embed"], own["embed"])


@pytest.mark.parametrize("seed", [0, 3])
def test_forward_matches_reference(seed):
    params, sd = _carried(seed)
    model = Surrogate()
    model.load_state_dict(sd)
    x = _features(24, seed)
    ref = np.asarray(r_sur.surrogate_forward(params, jnp.asarray(x)))
    got = surrogate_forward(model, x).numpy()
    assert got.shape == ref.shape == (24, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_ATOL)


def test_first_training_losses_match_reference():
    """Both fits from their default initial weights (the same values)."""
    rng = np.random.default_rng(5)
    x = _features(32, 5)
    y = rng.normal(size=(32, 3)).astype(np.float32)
    _, ref = r_train.fit_surrogate(
        x, y, mesh=r_train.train_mesh(tp=1), epochs=20, learning_rate=3e-3
    )
    _, got = fit_surrogate(x, y, device="cpu", epochs=20, learning_rate=3e-3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=LOSS_RTOL, atol=0)
    assert ADAMW_WEIGHT_DECAY == 1e-4  # optax.adamw's default, not torch's


def _window(rng) -> list[tuple[float, float]]:
    beta2 = 0.15
    concs = rng.uniform(2.0, 16.0, size=32)
    return [
        (float(b), (5.0 + 0.1 * b + beta2 * b * b) * float(rng.uniform(0.97, 1.03)))
        for b in concs
    ]


def _feed(corrector, obs_cls, points) -> None:
    for conc, itl in points:
        corrector.observe("v", obs_cls(
            concurrency=conc, in_tokens=16, out_tokens=64, itl_ms=itl, ttft_ms=3.0,
        ))


def test_corrector_refit_matches_reference():
    """A 32-observation window whose residual is out of band: both
    correctors, each with its default initial weights, take the surrogate
    path and their linearized DecodeParms agree."""
    points = _window(np.random.default_rng(0))
    ref = r_corr.ProfileCorrector()
    _feed(ref, r_corr.Observation, points)
    r_dec, _, r_state = ref.corrected_parms(
        "v", RDecode(alpha=5.0, beta=0.1), RPrefill(gamma=2.0, delta=0.01)
    )
    port = p_corr.ProfileCorrector(device="cpu")
    _feed(port, p_corr.Observation, points)
    p_dec, _, p_state = port.corrected_parms(
        "v", DecodeParms(alpha=5.0, beta=0.1), PrefillParms(gamma=2.0, delta=0.01)
    )
    assert r_state.surrogate_used and p_state.surrogate_used
    assert p_state.active == r_state.active
    assert p_state.decode_ratio == pytest.approx(r_state.decode_ratio, rel=1e-12)
    assert p_dec.alpha == pytest.approx(r_dec.alpha, rel=REFIT_RTOL)
    assert p_dec.beta == pytest.approx(r_dec.beta, rel=REFIT_RTOL)


def test_refit_without_spread_falls_back_to_ratio():
    port = p_corr.ProfileCorrector(device="cpu")
    _feed(port, p_corr.Observation, [(8.0, 12.0)] * 16)
    dec, _, state = port.corrected_parms(
        "v", DecodeParms(alpha=5.0, beta=0.1), PrefillParms(gamma=2.0, delta=0.01)
    )
    assert state.active and not state.surrogate_used
    assert dec.alpha == pytest.approx(5.0 * state.decode_ratio)


def test_refit_device_error_propagates(monkeypatch, caplog):
    """A device error inside the refit propagates to the refit's fallback,
    as in the reference: it is logged and counted, and this variant is
    ratio-scaled (a Reconciler resolves the corrector's device when it is
    built, so a missing card stops the controller there instead)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the reference's get_logger() ("inferno", reached by any earlier
    # backend-auto Reconciler in this process) stops propagation below it,
    # so the corrector's warning would never reach caplog's root handler
    monkeypatch.setattr(logging.getLogger("inferno"), "propagate", True)
    port = p_corr.ProfileCorrector(device=None)
    _feed(port, p_corr.Observation, _window(np.random.default_rng(1)))
    dec, _, state = port.corrected_parms(
        "v", DecodeParms(alpha=5.0, beta=0.1), PrefillParms(gamma=2.0, delta=0.01)
    )
    assert state.active and not state.surrogate_used
    assert dec.alpha == 5.0 * state.decode_ratio
    assert port.refit_errors == 1
    assert "CUDA" in caplog.text
