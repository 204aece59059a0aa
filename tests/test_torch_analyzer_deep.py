"""Port of tests/test_analyzer_deep.py, on the port's imports.

Deep invariant tests for the queueing analyzer.

Complements test_analyzer.py's closed-form checks with the properties the
reference's analyzer suite leans on
(the upstream Go project's pkg/analyzer/{queueanalyzer,mm1modelstatedependent}_test.go):
a brute-force stationary-distribution cross-check of the log-space solve,
conservation laws, monotonicity in the arrival rate, occupancy-cap
effects, the percentile-TTFT semantics, and the sizing driver's
rate-selection contract.
"""

import math

import numpy as np
import pytest

from inferno_tpu_torch.analyzer.queue import (
    QueueAnalyzer,
    RequestSize,
    TargetPerf,
    build_analyzer,
    decode_time,
    effective_concurrency,
    prefill_time,
    service_rates,
    solve_birth_death,
)
from inferno_tpu_torch.analyzer import AnalyzerError
from inferno_tpu_torch.config.defaults import (
    SLO_MARGIN,
    SLO_PERCENTILE,
    STABILITY_SAFETY_FRACTION,
    slo_margin_for,
)
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms

import inferno_tpu.analyzer.queue as ref_queue  # noqa: E402
from test_torch_analyzer import hold  # noqa: E402

# every analyzer call below runs on the reference too and must agree exactly
build_analyzer = hold(build_analyzer, ref_queue.build_analyzer, held=True)
decode_time = hold(decode_time, ref_queue.decode_time)
effective_concurrency = hold(effective_concurrency, ref_queue.effective_concurrency)
prefill_time = hold(prefill_time, ref_queue.prefill_time)
service_rates = hold(service_rates, ref_queue.service_rates)
solve_birth_death = hold(solve_birth_death, ref_queue.solve_birth_death)

DEC = DecodeParms(alpha=20.0, beta=0.5)
PRE = PrefillParms(gamma=5.0, delta=0.02)
REQ = RequestSize(avg_in_tokens=128, avg_out_tokens=64)


def make(max_batch=8, max_queue=80) -> QueueAnalyzer:
    return build_analyzer(max_batch=max_batch, max_queue=max_queue,
                          decode=DEC, prefill=PRE, request=REQ)


def brute_force_stationary(lam: float, mu: np.ndarray, cap: int) -> np.ndarray:
    """Direct textbook recursion p[n+1] = p[n]*lam/mu(n+1), normalized —
    the reference's algorithm (mm1modelstatedependent.go:70-116), safe
    here because the chains in this test are short."""
    full = np.concatenate([mu, np.full(cap - len(mu), mu[-1])])
    p = [1.0]
    for n in range(cap):
        p.append(p[-1] * lam / full[n])
    p = np.array(p)
    return p / p.sum()


# -- service-rate curve ------------------------------------------------------


def test_service_rates_exact_small_case():
    mu = service_rates(DEC, PRE, REQ, max_batch=3)
    for i, n in enumerate((1, 2, 3)):
        pf = 5.0 + 0.02 * 128 * n
        dc = (64 - 1) * (20.0 + 0.5 * n)
        assert mu[i] == pytest.approx(n / (pf + dc))


def test_service_rates_decode_only_no_prefill_term():
    mu = service_rates(DEC, PRE, RequestSize(avg_in_tokens=0, avg_out_tokens=64),
                       max_batch=2)
    assert mu[0] == pytest.approx(1.0 / (63 * 20.5))


def test_service_rates_rejects_nonpositive_time():
    with pytest.raises(AnalyzerError):
        service_rates(DecodeParms(alpha=-100.0, beta=0.0), PRE, REQ, max_batch=2)


def test_prefill_and_decode_time_helpers():
    assert prefill_time(PRE, 128, 4.0) == pytest.approx(5.0 + 0.02 * 128 * 4)
    assert prefill_time(PRE, 0, 4.0) == 0.0
    assert decode_time(DEC, 4.0) == pytest.approx(20.0 + 0.5 * 4)


# -- birth-death solve vs brute force ----------------------------------------


@pytest.mark.parametrize("lam_frac", [0.2, 0.7, 0.95, 1.3])
def test_log_space_solve_matches_direct_recursion(lam_frac):
    """The vectorized log-space solve must agree with the reference's
    sequential recursion across light, moderate, and overloaded rates."""
    mu = service_rates(DEC, PRE, REQ, max_batch=4)
    cap = 12
    lam = lam_frac * float(mu[-1])
    p = brute_force_stationary(lam, mu, cap)

    stats = solve_birth_death(lam, mu, cap)
    k = np.arange(cap + 1)
    assert stats.blocking_probability == pytest.approx(p[-1], rel=1e-9)
    assert stats.throughput == pytest.approx(lam * (1 - p[-1]), rel=1e-9)
    assert stats.avg_num_in_system == pytest.approx(float((k * p).sum()), rel=1e-9)
    assert stats.utilization == pytest.approx(1 - p[0], rel=1e-9)
    # Little's law ties the averages together
    assert stats.avg_resp_time == pytest.approx(
        stats.avg_num_in_system / stats.throughput, rel=1e-12
    )


def test_solve_validates_inputs():
    mu = service_rates(DEC, PRE, REQ, max_batch=4)
    with pytest.raises(AnalyzerError):
        solve_birth_death(0.0, mu, 12)
    with pytest.raises(AnalyzerError):
        solve_birth_death(1e-3, mu, 3)  # cap below max batch


def test_extreme_overload_does_not_overflow():
    """1000x the max service rate: the geometric weights explode in linear
    space; the log-space form must stay finite (the reference rescales
    mid-recursion instead, mm1modelstatedependent.go:96-108)."""
    mu = service_rates(DEC, PRE, REQ, max_batch=8)
    stats = solve_birth_death(1000.0 * float(mu[-1]), mu, 88)
    assert math.isfinite(stats.avg_resp_time)
    assert stats.blocking_probability > 0.99
    assert stats.throughput <= float(mu[-1]) * 1.001


def test_conservation_bounds():
    an = make()
    mu_max = float(an.serv_rates[-1])
    for lam in (0.1 * mu_max, 0.5 * mu_max, 0.99 * mu_max):
        s = solve_birth_death(lam, an.serv_rates, an.occupancy_cap)
        assert 0.0 <= s.blocking_probability <= 1.0
        assert 0.0 <= s.utilization <= 1.0
        assert s.throughput <= lam + 1e-12
        assert s.avg_num_in_servers <= an.max_batch + 1e-9
        assert s.avg_num_in_system <= an.occupancy_cap + 1e-9
        assert s.avg_wait_time >= 0.0


def test_monotone_in_arrival_rate():
    an = make()
    mu_max = float(an.serv_rates[-1])
    lams = np.linspace(0.1, 1.5, 8) * mu_max
    waits, blocks, tputs = [], [], []
    for lam in lams:
        s = solve_birth_death(float(lam), an.serv_rates, an.occupancy_cap)
        waits.append(s.avg_wait_time)
        blocks.append(s.blocking_probability)
        tputs.append(s.throughput)
    assert all(b2 >= b1 - 1e-12 for b1, b2 in zip(blocks, blocks[1:]))
    assert all(w2 >= w1 - 1e-9 for w1, w2 in zip(waits, waits[1:]))
    assert all(t2 >= t1 - 1e-12 for t1, t2 in zip(tputs, tputs[1:]))


def test_longer_queue_trades_blocking_for_wait():
    short = make(max_queue=8)
    long = make(max_queue=160)
    lam = 0.95 * float(short.serv_rates[-1])
    s_short = solve_birth_death(lam, short.serv_rates, short.occupancy_cap)
    s_long = solve_birth_death(lam, long.serv_rates, long.occupancy_cap)
    assert s_long.blocking_probability < s_short.blocking_probability
    assert s_long.avg_wait_time > s_short.avg_wait_time


# -- effective concurrency ---------------------------------------------------


def test_effective_concurrency_round_trip():
    for n in (1.0, 3.5, 7.0):
        serv = prefill_time(PRE, REQ.avg_in_tokens, n) + (
            REQ.avg_out_tokens - 1
        ) * decode_time(DEC, n)
        rec = effective_concurrency(serv, DEC, PRE, REQ, max_batch=8)
        assert rec == pytest.approx(n, rel=1e-9)


def test_effective_concurrency_clamps_to_batch():
    huge = 1e9
    assert effective_concurrency(huge, DEC, PRE, REQ, max_batch=8) == 8.0
    assert effective_concurrency(0.0, DEC, PRE, REQ, max_batch=8) == 0.0


# -- percentile-TTFT semantics ----------------------------------------------


def test_slo_margin_constants():
    assert SLO_MARGIN == pytest.approx(-math.log(1.0 - SLO_PERCENTILE))
    assert slo_margin_for(0.99) > slo_margin_for(0.95) > slo_margin_for(0.5)
    with pytest.raises(ValueError):
        slo_margin_for(1.0)


def test_tail_ttft_scales_only_the_wait_component():
    an = make()
    lam = 0.8 * an.lambda_max
    mean = an._tail_ttft_at(lam, 1.0)
    tail = an._tail_ttft_at(lam, SLO_MARGIN)
    stats = an._solve(lam)
    assert tail - mean == pytest.approx((SLO_MARGIN - 1.0) * stats.avg_wait_time,
                                        rel=1e-9)
    assert tail > mean  # margin > 1


def test_percentile_sizing_is_stricter_than_mean():
    an = make()
    t = TargetPerf(target_ttft=300.0, target_itl=60.0)
    r_pct, m_pct, _ = an.size(t)  # default SLO_MARGIN
    r_mean, _, _ = an.size(t, ttft_tail_margin=1.0)
    assert r_pct.rate_target_ttft <= r_mean.rate_target_ttft
    # at the percentile-sized rate, the mean TTFT sits safely under target
    assert m_pct.ttft < 300.0


def test_p99_sizing_stricter_than_p95():
    an = make()
    t = TargetPerf(target_ttft=300.0)
    r95, _, _ = an.size(t, ttft_tail_margin=slo_margin_for(0.95))
    r99, _, _ = an.size(t, ttft_tail_margin=slo_margin_for(0.99))
    assert r99.rate_target_ttft < r95.rate_target_ttft


# -- sizing driver contract --------------------------------------------------


def test_sizing_binds_on_minimum_rate():
    an = make()
    rates, metrics, achieved = an.size(TargetPerf(target_ttft=300.0, target_itl=60.0))
    lam_star = min(rates.rate_target_ttft, rates.rate_target_itl,
                   rates.rate_target_tps)
    assert metrics.throughput <= lam_star / 1000.0 * 1000.0 + 1e-9
    # achieved values at the binding rate respect both targets
    assert achieved.target_itl <= 60.0 + 1e-6
    assert metrics.ttft <= 300.0  # mean under a percentile-bound target


def test_tps_target_applies_stability_headroom():
    an = make()
    rates, _, _ = an.size(TargetPerf(target_tps=1e9))
    assert rates.rate_target_tps == pytest.approx(
        an.lambda_max * (1.0 - STABILITY_SAFETY_FRACTION) * 1000.0
    )


def test_inactive_targets_default_to_lambda_max():
    an = make()
    rates, _, _ = an.size(TargetPerf(target_itl=60.0))
    assert rates.rate_target_ttft == pytest.approx(an.lambda_max * 1000.0)


def test_unachievable_ttft_raises():
    an = make()
    # gamma alone is 5ms; a 1ms TTFT target is below the value at lam_min
    with pytest.raises(AnalyzerError):
        an.size(TargetPerf(target_ttft=1.0))


def test_bisect_flat_curve_sides():
    """A flat evaluator must not read as 'decreasing': a target above the
    constant is satisfied everywhere (+1 at x_max); below it, nowhere (-1).
    The reference misclassifies this (pkg/analyzer/utils.go:40-44)."""
    from inferno_tpu_torch.analyzer.sizing import bisect_monotone

    res = bisect_monotone(0.0, 10.0, 5.0, lambda x: 2.0)
    assert (res.x, res.indicator) == (10.0, +1)
    res = bisect_monotone(0.0, 10.0, 1.0, lambda x: 2.0)
    assert (res.x, res.indicator) == (0.0, -1)
    # flat AT the target: exact hit at the lower probe
    res = bisect_monotone(0.0, 10.0, 2.0, lambda x: 2.0)
    assert res.indicator == 0


def test_single_token_requests_are_sizable():
    an = build_analyzer(max_batch=8, max_queue=80, decode=DEC, prefill=PRE,
                        request=RequestSize(avg_in_tokens=0, avg_out_tokens=1))
    rates, metrics, _ = an.size(TargetPerf(target_itl=60.0))
    assert rates.rate_target_itl > 0
    assert metrics.throughput > 0


def test_low_load_service_time_exact_on_large_grids():
    """Regression (found on real v5e): in_servers must sum the queue mass
    directly, never as nmax*(1 - mass_in_service) — at low load the
    complement is floating-point residue that nmax amplifies; in the f32
    kernels it inflated service time ~35% and flipped SLO feasibility.
    All four backends share the formulation now; this pins the scalar
    semantics at a tolerance the subtractive form cannot meet in f32."""
    dec = DecodeParms(alpha=18.0, beta=0.3)
    pre = PrefillParms(gamma=5.0, delta=0.02)
    req = RequestSize(avg_in_tokens=64, avg_out_tokens=32)
    mu = service_rates(dec, pre, req, max_batch=256)
    lam = float(mu[0]) * 1e-3  # the lam_min probe
    s = solve_birth_death(lam, mu, 2816)
    t1 = prefill_time(pre, 64, 1.0) + 31 * decode_time(dec, 1.0)
    # tiny genuine mass sits at n=2 (rel ~2e-5); the subtractive-form bug
    # was a 35% error, so 1e-4 discriminates with orders to spare
    assert s.avg_serv_time == pytest.approx(t1, rel=1e-4)


@pytest.mark.parametrize("seed", range(6))
def test_sizing_inverts_to_target_random_profiles(seed):
    """Bisection accuracy sweep: at the TTFT-binding rate the tail-TTFT
    evaluator returns (approximately) the target, and at the ITL-binding
    rate the ITL evaluator does — for random profiles whose targets fall
    strictly inside the achievable range."""
    rng = np.random.default_rng(seed)
    dec = DecodeParms(alpha=float(rng.uniform(5, 25)), beta=float(rng.uniform(0.1, 0.6)))
    pre = PrefillParms(gamma=float(rng.uniform(1, 8)), delta=float(rng.uniform(0.005, 0.05)))
    req = RequestSize(avg_in_tokens=int(rng.integers(32, 512)),
                      avg_out_tokens=int(rng.integers(16, 128)))
    an = build_analyzer(max_batch=int(rng.integers(4, 32)), max_queue=160,
                        decode=dec, prefill=pre, request=req)
    # targets strictly inside the curve's range at both bounds
    ttft_lo = an._tail_ttft_at(an.lambda_min)
    ttft_hi = an._tail_ttft_at(an.lambda_max)
    itl_lo = an._itl_at(an.lambda_min)
    itl_hi = an._itl_at(an.lambda_max)
    t_ttft = ttft_lo + 0.4 * (ttft_hi - ttft_lo)
    t_itl = itl_lo + 0.4 * (itl_hi - itl_lo)

    rates, metrics, _ = an.size(TargetPerf(target_ttft=t_ttft, target_itl=t_itl))
    lam_ttft = rates.rate_target_ttft / 1000.0
    lam_itl = rates.rate_target_itl / 1000.0
    assert an._tail_ttft_at(lam_ttft) == pytest.approx(t_ttft, rel=1e-3)
    assert an._itl_at(lam_itl) == pytest.approx(t_itl, rel=1e-3)
    # the returned operating point IS the one at the binding minimum
    # (no TPS target here, so no stability-headroom clamp applies)
    binding = min(lam_ttft, lam_itl)
    expect = an.analyze(binding * 1000.0)
    assert metrics.throughput == pytest.approx(expect.throughput, rel=1e-9)
    assert metrics.ttft == pytest.approx(expect.ttft, rel=1e-9)
