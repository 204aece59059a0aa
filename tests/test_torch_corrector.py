"""The port's profile corrector when a surrogate refit cannot run: as in
the reference (`inferno_tpu/models/corrector.py`), the refit's failure
falls back to ratio scaling for that variant only, is logged and counted
(`refit_errors`), and a reconcile cycle completes with the corrected
parameters the reference's corrector gives on the same observations. A
controller whose corrector has no device (no COMPUTE_DEVICE, no card)
fails when it is built, not at its first refit. All on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from inferno_tpu.config.types import DecodeParms as RDecode
from inferno_tpu.config.types import PrefillParms as RPrefill
from inferno_tpu.models import corrector as r_corr
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.models import corrector as p_corr
from inferno_tpu_torch.testing.fleet import (
    CONFIG_NS,
    FLEET_NS,
    fleet_cluster,
    fleet_fake_prom,
    fleet_model,
    fleet_variant,
)

DECODE = dict(alpha=5.0, beta=0.1)
PREFILL = dict(gamma=2.0, delta=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The surrogate refits here are small, and the tests run beside other
    test workers: torch's intra-op threads would only contend with them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _observations(n: int, seed: int, alpha: float = 5.0, beta: float = 0.1) -> list[dict]:
    """`n` observations whose ITL bends quadratically away from the linear
    profile alpha + beta * b (out of band, with spread): the refit's
    trigger."""
    rng = np.random.default_rng(seed)
    out = []
    for b in rng.uniform(2.0, 16.0, size=n):
        itl = (alpha + beta * b + 0.15 * b * b) * float(rng.uniform(0.97, 1.03))
        out.append(dict(concurrency=float(b), in_tokens=16.0, out_tokens=64.0,
                        itl_ms=itl, ttft_ms=3.0))
    return out


def _raise(*args, **kwargs):
    raise RuntimeError("refit cannot run")


@pytest.fixture
def refits_raise(monkeypatch):
    """Both packages' surrogate training raises."""
    from inferno_tpu.parallel import train as r_train
    from inferno_tpu_torch.parallel import train as p_train

    monkeypatch.setattr(r_train, "fit_surrogate", _raise)
    monkeypatch.setattr(p_train, "fit_surrogate", _raise)


def _reference(obs: list[dict], decode: dict, prefill: dict):
    ref = r_corr.ProfileCorrector()
    for o in obs:
        ref.observe("v", r_corr.Observation(**o))
    return ref.corrected_parms("v", RDecode(**decode), RPrefill(**prefill))


def _fields(decode, prefill, state):
    return (decode.alpha, decode.beta, prefill.gamma, prefill.delta,
            state.active, state.decode_active, state.prefill_active,
            state.decode_ratio, state.prefill_ratio, state.surrogate_used,
            state.observations)


def test_failed_refit_falls_back_like_reference(refits_raise):
    """40 observations, both refits raising: both correctors scale by the
    median ratio, to the same parameters bit for bit."""
    obs = _observations(40, 0)
    port = p_corr.ProfileCorrector(device="cpu")
    for o in obs:
        port.observe("v", p_corr.Observation(**o))
    got = port.corrected_parms("v", DecodeParms(**DECODE), PrefillParms(**PREFILL))
    want = _reference(obs, DECODE, PREFILL)
    assert _fields(*got) == _fields(*want)
    assert got[2].active and not got[2].surrogate_used
    assert got[0].alpha == DECODE["alpha"] * got[2].decode_ratio
    assert port.refit_errors == 1


def test_refit_error_is_per_variant(monkeypatch):
    """A refit that raises for one variant leaves another variant's refit
    alone: only the failing one falls back."""
    from inferno_tpu_torch.parallel import train as p_train

    fit = p_train.fit_surrogate
    calls = []

    def fail_first(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("refit cannot run")
        return fit(*args, **kwargs)

    monkeypatch.setattr(p_train, "fit_surrogate", fail_first)
    port = p_corr.ProfileCorrector(device="cpu")
    for key in ("a", "b"):
        for o in _observations(32, 0):
            port.observe(key, p_corr.Observation(**o))
    _, _, a = port.corrected_parms("a", DecodeParms(**DECODE), PrefillParms(**PREFILL))
    _, _, b = port.corrected_parms("b", DecodeParms(**DECODE), PrefillParms(**PREFILL))
    assert not a.surrogate_used and b.surrogate_used
    assert port.refit_errors == 1


def _rows(itl_s: float) -> dict:
    return {(fleet_model(0), FLEET_NS): {
        "running": 6.0, "arrival_rps": 4.0, "in_tokens": 16.0,
        "out_tokens": 64.0, "ttft_s": 0.003, "itl_s": itl_s, "max_batch": 64.0,
    }}


def test_cycle_completes_when_refit_raises(refits_raise, monkeypatch):
    """A reconcile cycle whose corrector refit raises: the cycle completes
    with ratio scaling, and the sizing runs on the corrected parameters
    the reference's corrector gives on the same 40 observations."""
    rec = Reconciler(fleet_cluster(1), fleet_fake_prom(_rows(0.04)), ReconcilerConfig(
        config_namespace=CONFIG_NS, compute_backend="torch", compute_device="cpu"))
    key = f"{fleet_variant(0)}:{FLEET_NS}@v5e-4"
    # the fleet's profile is alpha 18, beta 0.3; the cycle's telemetry
    # adds the 40th observation
    for o in _observations(39, 1, alpha=18.0, beta=0.3):
        rec.corrector.observe(key, p_corr.Observation(**o))
    seen = []
    corrected = rec.corrector.corrected_parms

    def spy(k, decode, prefill):
        seen.append((k, decode, prefill))
        return corrected(k, decode, prefill)

    monkeypatch.setattr(rec.corrector, "corrected_parms", spy)
    report = rec.run_cycle()
    assert report.errors == [] and report.optimization_ok
    assert report.corrections_active == 1 and rec.corrector.refit_errors == 1
    (k, decode, prefill), = seen
    assert k == key
    obs = [dict(concurrency=o.concurrency, in_tokens=o.in_tokens,
                out_tokens=o.out_tokens, itl_ms=o.itl_ms, ttft_ms=o.ttft_ms)
           for o in rec.corrector._obs[key]]
    assert len(obs) == 40
    want_decode, want_prefill, want_state = _reference(
        obs, dict(alpha=decode.alpha, beta=decode.beta),
        dict(gamma=prefill.gamma, delta=prefill.delta))
    assert want_state.active and not want_state.surrogate_used
    record, = report.decisions
    assert (record.decode_alpha, record.decode_beta) == (
        want_decode.alpha, want_decode.beta)
    assert (record.prefill_gamma, record.prefill_delta) == (
        want_prefill.gamma, want_prefill.delta)


def test_scalar_backend_without_a_device_fails_at_init(monkeypatch):
    """COMPUTE_BACKEND=scalar with no COMPUTE_DEVICE and no card: the
    corrector's device is resolved when the Reconciler is built, so the
    controller fails at startup, naming the ways out."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="COMPUTE_DEVICE=cpu"):
        Reconciler(fleet_cluster(1), fleet_fake_prom({}),
                   ReconcilerConfig(compute_backend="scalar"))
    # a device, or no corrector, builds
    rec = Reconciler(fleet_cluster(1), fleet_fake_prom({}),
                     ReconcilerConfig(compute_backend="scalar", compute_device="cpu"))
    assert rec.corrector.device == torch.device("cpu")
    rec = Reconciler(fleet_cluster(1), fleet_fake_prom({}),
                     ReconcilerConfig(compute_backend="scalar",
                                      profile_correction=False))
    assert rec.corrector is None
