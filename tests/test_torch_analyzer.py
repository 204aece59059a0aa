"""Port of tests/test_analyzer.py, on the port's imports.

Unit tests for the queueing analyzer.

Mirrors the reference's table-driven analyzer tests
(the upstream Go project's pkg/analyzer/queueanalyzer_test.go) in strategy: exact
closed-form checks where they exist (constant-rate birth-death chain ==
M/M/1/K), monotonicity and feasibility properties elsewhere.
"""

import collections
import dataclasses
import functools
import importlib
import math

import numpy as np
import pytest

from inferno_tpu_torch.analyzer import (
    AnalyzerError,
    TargetPerf,
    bisect_monotone,
    build_analyzer,
    effective_concurrency,
    service_rates,
    solve_birth_death,
)
from inferno_tpu_torch.analyzer.queue import RequestSize
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms

# -- the reference beside the port ---------------------------------------------
# Every analyzer call of these tests goes through `hold`: the port's function
# runs, then the reference's on the same inputs (carried into its types), and
# both must agree exactly — the analyzer is the same f64 numpy code in both
# packages. The port's tests of the analyzer import these helpers from here.


def to_reference(obj):
    """`obj` with every port dataclass or named tuple in it rebuilt as the
    reference's class of the same module path and name."""
    mod = type(obj).__module__
    if mod.startswith("inferno_tpu_torch."):
        cls = getattr(importlib.import_module("inferno_tpu" + mod[len("inferno_tpu_torch"):]),
                      type(obj).__name__)
        if dataclasses.is_dataclass(obj):
            return cls(**{f.name: to_reference(getattr(obj, f.name))
                          for f in dataclasses.fields(obj) if f.init})
        if hasattr(obj, "_asdict"):
            return cls(**{k: to_reference(v) for k, v in obj._asdict().items()})
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_asdict"):
        return type(obj)(to_reference(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_reference(v) for k, v in obj.items()}
    return obj


def assert_same(got, want, path="result"):
    """Exact agreement of a port value and a reference value: arrays
    element for element (NaN where NaN), floats bit for bit, containers,
    dataclasses and named tuples field by field."""
    if isinstance(got, np.ndarray) or isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)
    elif dataclasses.is_dataclass(got) and not isinstance(got, type):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(got):
            assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(got, (list, tuple, collections.deque)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(got, dict):
        assert list(got) == list(want), path
        for k in got:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(got, float) and math.isnan(got):
        assert math.isnan(want), path
    else:
        assert got == want, (path, got, want)


def _both(port_fn, ref_fn, args, kwargs, held=False):
    try:
        got = port_fn(*args, **kwargs)
    except Exception as e:
        with pytest.raises(Exception) as ref_err:
            ref_fn(*to_reference(args), **to_reference(kwargs))
        assert type(ref_err.value).__name__ == type(e).__name__
        raise
    want = ref_fn(*to_reference(args), **to_reference(kwargs))
    if held:
        return Held(got, want)
    assert_same(got, want)
    return got


class Held:
    """A port object (an analyzer, a forecaster) beside the reference's
    built from the same inputs: attributes are checked equal, method calls
    run on both."""

    def __init__(self, port, ref):
        self._port, self._ref = port, ref

    def __getattr__(self, name):
        value, ref = getattr(self._port, name), getattr(self._ref, name)
        if callable(value):
            return lambda *a, **k: _both(value, ref, a, k)
        assert_same(value, ref, name)
        return value


def hold(port_fn, ref_fn, held=False):
    """`port_fn`, checked against `ref_fn` on every call; with `held`, the
    object it returns (an analyzer, a forecaster) is held beside the
    reference's (`Held`)."""
    return functools.wraps(port_fn)(lambda *a, **k: _both(port_fn, ref_fn, a, k, held))


import inferno_tpu.analyzer as ref_analyzer  # noqa: E402

bisect_monotone = hold(bisect_monotone, ref_analyzer.bisect_monotone)
build_analyzer = hold(build_analyzer, ref_analyzer.build_analyzer, held=True)
effective_concurrency = hold(effective_concurrency, ref_analyzer.effective_concurrency)
service_rates = hold(service_rates, ref_analyzer.service_rates)
solve_birth_death = hold(solve_birth_death, ref_analyzer.solve_birth_death)

# Example emulated-A100 profile from the reference examples
# (deploy/examples/vllm-emulator/vllme-setup/vllme-variantautoscaling.yaml:31-37)
DECODE = DecodeParms(alpha=20.58, beta=0.41)
PREFILL = PrefillParms(gamma=5.2, delta=0.1)
REQ = RequestSize(avg_in_tokens=128, avg_out_tokens=64)


def test_service_rates_formula():
    rates = service_rates(DECODE, PREFILL, REQ, max_batch=4)
    assert rates.shape == (4,)
    for i, n in enumerate(range(1, 5)):
        pf = PREFILL.gamma + PREFILL.delta * REQ.avg_in_tokens * n
        dc = (REQ.avg_out_tokens - 1) * (DECODE.alpha + DECODE.beta * n)
        assert rates[i] == pytest.approx(n / (pf + dc), rel=1e-12)


def test_service_rates_decode_only_single_token():
    # in_tokens=0, out_tokens=1 still pays one decode step
    req = RequestSize(avg_in_tokens=0, avg_out_tokens=1)
    rates = service_rates(DECODE, PREFILL, req, max_batch=2)
    assert rates[0] == pytest.approx(1.0 / (DECODE.alpha + DECODE.beta), rel=1e-12)


def test_birth_death_matches_mm1k_closed_form():
    # With a constant service rate the chain is exactly M/M/1/K.
    mu, lam, big_k = 0.5, 0.3, 12
    stats = solve_birth_death(lam, np.array([mu]), big_k)
    rho = lam / mu
    p0 = (1 - rho) / (1 - rho ** (big_k + 1))
    p = p0 * rho ** np.arange(big_k + 1)
    expected_l = float(np.sum(np.arange(big_k + 1) * p))
    expected_x = lam * (1 - p[big_k])
    assert stats.avg_num_in_system == pytest.approx(expected_l, rel=1e-9)
    assert stats.throughput == pytest.approx(expected_x, rel=1e-9)
    assert stats.utilization == pytest.approx(1 - p0, rel=1e-9)
    assert stats.avg_resp_time == pytest.approx(expected_l / expected_x, rel=1e-9)


def test_birth_death_heavy_load_no_overflow():
    # Large K and lambda >> mu: log-space must stay finite where the naive
    # product recursion overflows.
    stats = solve_birth_death(50.0, np.array([0.001, 0.002]), 3000)
    assert math.isfinite(stats.avg_num_in_system)
    assert stats.blocking_probability > 0.9
    assert stats.avg_num_in_system == pytest.approx(3000, rel=1e-3)


def test_effective_concurrency_inverts_service_time():
    mb = 8
    for n in [1.0, 3.5, 8.0]:
        serv = (PREFILL.gamma + PREFILL.delta * REQ.avg_in_tokens * n) + (
            REQ.avg_out_tokens - 1
        ) * (DECODE.alpha + DECODE.beta * n)
        got = effective_concurrency(serv, DECODE, PREFILL, REQ, mb)
        assert got == pytest.approx(n, rel=1e-9)


def test_effective_concurrency_clamped():
    assert effective_concurrency(0.0, DECODE, PREFILL, REQ, 8) == 0.0
    assert effective_concurrency(1e9, DECODE, PREFILL, REQ, 8) == 8.0


def test_analyzer_low_rate_near_zero_wait():
    qa = build_analyzer(8, 80, DECODE, PREFILL, REQ)
    m = qa.analyze(qa.lambda_min * 1000.0 * 2)
    assert m.avg_wait_time == pytest.approx(0.0, abs=1e-3)
    assert m.avg_token_time >= DECODE.alpha
    assert 0.0 <= m.rho <= 1.0


def test_analyzer_ttft_monotone_in_rate():
    qa = build_analyzer(8, 80, DECODE, PREFILL, REQ)
    rates = np.linspace(qa.lambda_min * 1000 * 2, qa.max_rate * 0.98, 12)
    ttfts = [qa.analyze(float(r)).ttft for r in rates]
    assert all(b >= a - 1e-9 for a, b in zip(ttfts, ttfts[1:]))


def test_analyzer_rejects_unstable_rate():
    qa = build_analyzer(8, 80, DECODE, PREFILL, REQ)
    with pytest.raises(AnalyzerError):
        qa.analyze(qa.max_rate * 1.5)
    with pytest.raises(AnalyzerError):
        qa.analyze(0.0)


def test_size_meets_targets():
    qa = build_analyzer(8, 80, DECODE, PREFILL, REQ)
    targets = TargetPerf(target_ttft=500.0, target_itl=24.0)
    rates, metrics, achieved = qa.size(targets)
    assert 0 < rates.rate_target_ttft <= qa.max_rate
    assert 0 < rates.rate_target_itl <= qa.max_rate
    # achieved values at the binding rate satisfy both targets (within the
    # bisection tolerance)
    assert achieved.target_ttft <= targets.target_ttft * 1.01
    assert achieved.target_itl <= targets.target_itl * 1.01


def test_size_tighter_target_lower_rate():
    qa = build_analyzer(8, 80, DECODE, PREFILL, REQ)
    loose, _, _ = qa.size(TargetPerf(target_itl=24.0))
    tight, _, _ = qa.size(TargetPerf(target_itl=21.5))
    assert tight.rate_target_itl < loose.rate_target_itl


def test_size_infeasible_itl_raises():
    qa = build_analyzer(8, 80, DECODE, PREFILL, REQ)
    # ITL can never go below alpha
    with pytest.raises(AnalyzerError):
        qa.size(TargetPerf(target_itl=DECODE.alpha * 0.5))


def test_size_loose_target_hits_lambda_max():
    qa = build_analyzer(8, 80, DECODE, PREFILL, REQ)
    # absurdly loose targets: the ceiling is the stability limit
    rates, _, _ = qa.size(TargetPerf(target_ttft=1e9, target_itl=1e9))
    assert rates.rate_target_ttft == pytest.approx(qa.max_rate, rel=1e-6)
    assert rates.rate_target_itl == pytest.approx(qa.max_rate, rel=1e-6)


def test_size_tps_safety_fraction():
    qa = build_analyzer(8, 80, DECODE, PREFILL, REQ)
    rates, _, _ = qa.size(TargetPerf(target_tps=100.0))
    assert rates.rate_target_tps == pytest.approx(qa.max_rate * 0.9, rel=1e-6)


def test_bisect_monotone_increasing_and_decreasing():
    res = bisect_monotone(0.0, 10.0, 25.0, lambda x: x * x)
    assert res.indicator == 0
    assert res.x == pytest.approx(5.0, rel=1e-5)
    res = bisect_monotone(0.1, 10.0, 2.0, lambda x: 10.0 / x)
    assert res.indicator == 0
    assert res.x == pytest.approx(5.0, rel=1e-5)


def test_bisect_out_of_range_indicators():
    assert bisect_monotone(0.0, 1.0, -5.0, lambda x: x).indicator == -1
    assert bisect_monotone(0.0, 1.0, 5.0, lambda x: x).indicator == +1
