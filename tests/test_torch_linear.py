"""The port's linear profile fit (inferno_tpu_torch.models.linear, numpy)
against the reference's: the cases of tests/test_models.py that cover it,
and equal results on the same samples (the same numpy calls, so exactly
equal)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from inferno_tpu.models import linear as ref
from inferno_tpu_torch.config.types import ModelPerfSpec
from inferno_tpu_torch.models import FittedProfile, fit_profile
from inferno_tpu_torch.models import linear as port


def test_fit_profile_recovers_exact_line():
    batch = np.array([1, 8, 16, 32, 64], dtype=np.float64)
    itl = 7.0 + 0.027 * batch  # the reference tutorial's fitted Llama-8B curve
    in_tok = np.array([128, 256, 512, 1024, 2048], dtype=np.float64)
    pb = np.array([1, 2, 4, 8, 16], dtype=np.float64)
    prefill = 5.2 + 0.1 * in_tok * pb
    fp = fit_profile(batch, itl, pb, in_tok, prefill)
    assert fp.decode.alpha == pytest.approx(7.0, rel=1e-9)
    assert fp.decode.beta == pytest.approx(0.027, rel=1e-9)
    assert fp.prefill.gamma == pytest.approx(5.2, rel=1e-6)
    assert fp.prefill.delta == pytest.approx(0.1, rel=1e-9)
    assert fp.decode_rmse < 1e-9


def test_fit_profile_noisy_and_clamped():
    rng = np.random.default_rng(0)
    batch = np.linspace(1, 64, 50)
    itl = 7.0 + 0.03 * batch + rng.normal(0, 0.05, 50)
    fp = fit_profile(batch, itl, batch, np.full(50, 128.0), 5.0 + 0.01 * 128 * batch)
    assert fp.decode.alpha == pytest.approx(7.0, abs=0.15)
    assert fp.decode.beta >= 0.0
    with pytest.raises(ValueError):
        fit_profile([1.0], [7.0], batch, batch, batch)
    with pytest.raises(ValueError):
        fit_profile(batch, itl, [1.0], [128.0], [5.0])


def test_fit_profile_to_perf_spec():
    fp = fit_profile([1, 64], [7.0, 8.7], [1, 8], [512, 512], [10.0, 50.0])
    spec = fp.to_perf_spec("llama", "v5e-8", max_batch_size=64, at_tokens=128)
    assert isinstance(spec, ModelPerfSpec) and isinstance(fp, FittedProfile)
    assert spec.acc == "v5e-8"
    assert spec.decode_parms.alpha == pytest.approx(fp.decode.alpha)


@pytest.mark.parametrize("seed", range(4))
def test_fit_profile_equals_reference(seed):
    """Random samples, including ones whose least-squares line has a
    negative base or slope (clamped to 0 on both sides)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    args = [rng.uniform(1, 64, n), rng.normal(5, 3, n), rng.integers(1, 8, n),
            rng.uniform(16, 2048, n), rng.normal(20, 10, n)]
    got, want = fit_profile(*args), ref.fit_profile(*args)
    assert dataclasses.asdict(got.decode) == dataclasses.asdict(want.decode)
    assert dataclasses.asdict(got.prefill) == dataclasses.asdict(want.prefill)
    assert (got.decode_rmse, got.prefill_rmse) == (want.decode_rmse, want.prefill_rmse)
    assert got.to_perf_spec("m", "a", 8, 128, slices_per_replica=2).to_dict() == \
        want.to_perf_spec("m", "a", 8, 128, slices_per_replica=2).to_dict()
    x, y = args[0], args[1]
    assert port._fit_line(x, y) == ref._fit_line(x, y)
