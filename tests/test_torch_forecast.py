"""Port of tests/test_forecast.py, on the port's imports.

Predictive scaling (inferno_tpu_torch/forecast/): the
arrival-rate forecaster and its edge cases, the scale-down stabilizer,
the spin-up horizon model, RateSpec.ramp, the deterministic closed-loop
reactive-vs-predictive scenario (the acceptance assertion lives here),
and the reconciler integration end to end.

Everything in this file is fast and deterministic — no threads, no
sleeps, no RNG — so the closed-loop comparison can assert a STRICT
ordering and stay inside the tier-1 `-m 'not slow'` budget.
"""

import math

import pytest

from inferno_tpu_torch.config.tpu_catalog import (
    SPINUP_BASE_S,
    SPINUP_PER_EXTRA_HOST_S,
    slice_shape,
    spinup_seconds,
)
from inferno_tpu_torch.forecast import (
    ArrivalForecaster,
    ForecastConfig,
    ScaleDownStabilizer,
)
from inferno_tpu_torch.forecast.forecaster import MIN_FORECAST_SAMPLES

import inferno_tpu.config.tpu_catalog as ref_catalog  # noqa: E402
import inferno_tpu.forecast as ref_forecast  # noqa: E402
from test_torch_analyzer import hold  # noqa: E402

# the forecaster and the stabilizer run beside the reference's on the same
# observations: every call's result must agree exactly
ArrivalForecaster = hold(ArrivalForecaster, ref_forecast.ArrivalForecaster, held=True)
ScaleDownStabilizer = hold(ScaleDownStabilizer, ref_forecast.ScaleDownStabilizer, held=True)
spinup_seconds = hold(spinup_seconds, ref_catalog.spinup_seconds)


# -- forecaster: filter behavior ---------------------------------------------


def feed_constant(fc, key, rate, n, dt=60.0, t0=0.0):
    for i in range(n):
        assert fc.observe(key, t0 + i * dt, rate)


def test_empty_history_invalid_forecast():
    fc = ArrivalForecaster()
    f = fc.forecast("v", 90.0)
    assert f.samples == 0 and not f.valid
    assert f.rate == f.upper == f.lower == 0.0


def test_single_sample_echoes_rate_but_invalid():
    fc = ArrivalForecaster()
    assert fc.observe("v", 0.0, 12.0)
    f = fc.forecast("v", 90.0)
    assert f.samples == 1 and not f.valid
    assert f.rate == pytest.approx(12.0)
    assert f.band == 0.0


def test_constant_rate_zero_trend_tight_band():
    """The no-perturbation property: on constant traffic the forecast
    must collapse to the observed rate with a ~zero band, so enabling
    predictive scaling cannot change the sizing of a steady fleet."""
    fc = ArrivalForecaster()
    feed_constant(fc, "v", 30.0, 10)
    f = fc.forecast("v", 120.0)
    assert f.valid
    assert f.rate == pytest.approx(30.0, abs=1e-9)
    assert f.band == pytest.approx(0.0, abs=1e-9)
    assert f.upper == pytest.approx(30.0, abs=1e-9)
    assert not f.burst


def test_ramp_extrapolates_above_last_observation():
    """Holt trend: on a steady ramp the forecast at the spin-up horizon
    must exceed the latest observation — that gap is exactly the
    capacity a reactive controller is late by."""
    fc = ArrivalForecaster()
    for i in range(10):
        fc.observe("v", i * 60.0, 10.0 + 5.0 * i)  # +5 rpm per cycle
    last = 10.0 + 5.0 * 9
    f = fc.forecast("v", 120.0)  # two cycles ahead
    assert f.valid
    assert f.rate > last
    assert f.upper >= f.rate


def test_trend_extrapolation_clamped_by_max_growth():
    """Two observations milliseconds apart (watch-poked double cycle)
    produce a huge local slope; the horizon extrapolation must stay
    within max_growth x level, not size the fleet to absurdity."""
    fc = ArrivalForecaster()
    feed_constant(fc, "v", 10.0, 4)
    fc.observe("v", 180.001, 14.0)  # 1 ms after the 4th sample
    f = fc.forecast("v", 90.0)
    level_bound = (1.0 + fc.config.max_growth) * 15.0  # level <= ~12
    assert f.rate <= level_bound


def test_tiny_dt_noise_does_not_become_trend():
    """Review r8: gains are time-weighted by dt/reference_interval, so a
    watch-poked cycle 0.1 s after the last one carrying 1% scrape noise
    barely moves the state — the forecast at the horizon stays ~level,
    and the next regular observation is NOT misread as a burst."""
    fc = ArrivalForecaster()  # reference_interval_s = 60
    feed_constant(fc, "v", 45.0, 6)
    fc.observe("v", 5 * 60.0 + 0.1, 45.5)  # poked cycle, jittered scrape
    f = fc.forecast("v", 120.0)
    assert f.rate == pytest.approx(45.0, rel=0.01)
    assert f.upper < 46.0  # no phantom doubling
    # the following regular cadence observation is mundane, not a burst
    fc.observe("v", 6 * 60.0 + 0.1, 45.0)
    assert not fc.forecast("v", 120.0).burst


def test_gains_exact_at_reference_interval():
    """At dt == reference_interval_s the time-weighted gains equal the
    configured ones: existing calibration is unchanged at the cadence it
    was tuned for."""
    fc = ArrivalForecaster(ForecastConfig(level_alpha=0.5))
    fc.observe("v", 0.0, 10.0)
    fc.observe("v", 60.0, 20.0)  # predicted 10, err 10, a_eff == 0.5
    assert fc._state["v"].level == pytest.approx(15.0)


def test_burst_detected_and_level_snaps():
    fc = ArrivalForecaster()
    feed_constant(fc, "v", 10.0, 6)
    assert not fc.forecast("v", 60.0).burst
    fc.observe("v", 6 * 60.0, 40.0)  # 4x jump against ~zero dispersion
    f = fc.forecast("v", 60.0)
    assert f.burst
    # regime change: the level snaps to the jump instead of EWMA-crawling
    assert f.rate >= 40.0 - 1e-9
    # dispersion absorbed the pre-snap error: the band carries headroom
    assert f.band > 0.0


def test_burst_flag_releases_after_reconvergence():
    fc = ArrivalForecaster()
    feed_constant(fc, "v", 10.0, 6)
    fc.observe("v", 360.0, 40.0)
    assert fc.forecast("v", 60.0).burst
    # traffic stays at the new plateau: once the level explains it, the
    # burst classification releases
    for i in range(1, 8):
        fc.observe("v", 360.0 + i * 60.0, 40.0)
    assert not fc.forecast("v", 60.0).burst


def test_small_wiggle_is_not_a_burst():
    """burst_min_frac: with near-zero dispersion, a small absolute
    wiggle must not classify as a burst."""
    fc = ArrivalForecaster()
    feed_constant(fc, "v", 100.0, 6)
    fc.observe("v", 360.0, 110.0)  # +10% — real, but not a regime change
    assert not fc.forecast("v", 60.0).burst


def test_nan_inf_negative_observations_dropped():
    fc = ArrivalForecaster()
    feed_constant(fc, "v", 20.0, 5)
    before = fc.forecast("v", 60.0)
    assert not fc.observe("v", 1000.0, float("nan"))
    assert not fc.observe("v", 1001.0, float("inf"))
    assert not fc.observe("v", 1002.0, -3.0)
    after = fc.forecast("v", 60.0)
    assert after == before  # state untouched by poisoned scrapes
    assert fc.observations("v") == 5


def test_non_monotonic_timestamps_rejected():
    fc = ArrivalForecaster()
    assert fc.observe("v", 100.0, 10.0)
    assert fc.observe("v", 160.0, 12.0)
    assert not fc.observe("v", 160.0, 50.0)  # same instant
    assert not fc.observe("v", 30.0, 50.0)  # clock step backwards
    assert fc.observations("v") == 2
    # the rejected 50s never entered the level
    assert fc.forecast("v", 0.0).rate < 20.0


def test_variant_eviction_on_prune():
    """No unbounded per-variant state: a variant that disappears from
    the reconciled set is evicted."""
    fc = ArrivalForecaster()
    feed_constant(fc, "a", 10.0, 4)
    feed_constant(fc, "b", 20.0, 4)
    fc.prune({"a"})
    assert fc.variants() == {"a"}
    assert fc.forecast("b", 60.0).samples == 0


def test_bounded_ring():
    cfg = ForecastConfig(window=8)
    fc = ArrivalForecaster(cfg)
    feed_constant(fc, "v", 10.0, 100)
    assert len(fc._state["v"].ring) == 8
    assert fc.observations("v") == 100  # the counter keeps the total


def test_config_validation():
    with pytest.raises(ValueError):
        ForecastConfig(level_alpha=0.0)
    with pytest.raises(ValueError):
        ForecastConfig(trend_beta=1.5)
    with pytest.raises(ValueError):
        ForecastConfig(burst_z=0.0)
    with pytest.raises(ValueError):
        ForecastConfig(window=1)
    with pytest.raises(ValueError):
        ForecastConfig(max_growth=0.0)
    with pytest.raises(ValueError):
        ArrivalForecaster().forecast("v", -1.0)


def test_realized_forecast_error_tracks_miss():
    fc = ArrivalForecaster()
    feed_constant(fc, "v", 10.0, 5)
    assert fc.realized_abs_error("v") == pytest.approx(0.0, abs=1e-9)
    fc.observe("v", 300.0, 25.0)
    assert fc.realized_abs_error("v") == pytest.approx(15.0, abs=1e-6)


# -- scale-down stabilizer ----------------------------------------------------


def test_stabilizer_upscale_passes_through():
    st = ScaleDownStabilizer(120.0)
    assert st.recommend("v", 3, 0.0) == (3, False)
    assert st.recommend("v", 7, 10.0) == (7, False)


def test_stabilizer_holds_peak_within_window():
    st = ScaleDownStabilizer(120.0)
    st.recommend("v", 8, 0.0)
    enacted, held = st.recommend("v", 2, 60.0)  # dip inside the window
    assert (enacted, held) == (8, True)
    # after the peak ages out, the down-recommendation wins
    enacted, held = st.recommend("v", 2, 130.0)
    assert (enacted, held) == (2, False)


def test_stabilizer_zero_window_is_passthrough():
    st = ScaleDownStabilizer(0.0)
    st.recommend("v", 8, 0.0)
    assert st.recommend("v", 2, 0.5) == (2, False)


def test_stabilizer_rejects_negative_window_and_prunes():
    with pytest.raises(ValueError):
        ScaleDownStabilizer(-1.0)
    st = ScaleDownStabilizer(60.0)
    st.recommend("a", 4, 0.0)
    st.recommend("b", 4, 0.0)
    st.prune({"b"})
    assert st.variants() == {"b"}


def test_stabilizer_shape_qualified_keys_are_independent_and_pruned():
    """Review r8: the reconciler keys windows by "<variant>@<shape>" so
    a shape migration starts a fresh window — the old shape's replica
    peak must not gate the new shape's count — and prune matches on the
    variant prefix, dropping every shape's window with the variant."""
    st = ScaleDownStabilizer(300.0)
    st.recommend("va@v5e-8", 8, 0.0)  # 8 small-slice replicas
    # migration to double-size slices: 3 replicas is NOT a scale-down
    enacted, held = st.recommend("va@v5e-16", 3, 10.0)
    assert (enacted, held) == (3, False)
    st.prune({"other"})  # the variant disappeared: both shape keys go
    assert st.variants() == set()


# -- spin-up horizon (catalog) ------------------------------------------------


def test_spinup_seconds_scales_with_hosts():
    single = spinup_seconds("v5e-4")  # 1 host
    multi = spinup_seconds("v5e-16")  # 4 hosts
    assert single == pytest.approx(SPINUP_BASE_S)
    assert multi == pytest.approx(SPINUP_BASE_S + 3 * SPINUP_PER_EXTRA_HOST_S)
    assert spinup_seconds(slice_shape("v5e-16")) == multi  # object or name


# -- RateSpec.ramp ------------------------------------------------------------


def test_ratespec_ramp_shape_and_average():
    from inferno_tpu_torch.emulator.loadgen import RateSpec

    r = RateSpec.ramp(2.0, 10.0, 30.0, steps=6)
    assert len(r.phases) == 6
    assert r.total_duration == pytest.approx(30.0)
    # midpoint sampling preserves the ramp's time-averaged rate exactly
    avg = sum(d * rate for d, rate in r.phases) / r.total_duration
    assert avg == pytest.approx((2.0 + 10.0) / 2.0)
    # monotone increasing steps, strictly inside the endpoints
    rates = [rate for _, rate in r.phases]
    assert rates == sorted(rates)
    assert 2.0 < rates[0] < rates[-1] < 10.0
    # a downward ramp mirrors
    down = RateSpec.ramp(10.0, 2.0, 30.0, steps=6)
    assert [rate for _, rate in down.phases] == sorted(
        (rate for _, rate in down.phases), reverse=True
    )


def test_ratespec_ramp_validation():
    from inferno_tpu_torch.emulator.loadgen import RateSpec

    with pytest.raises(ValueError):
        RateSpec.ramp(1.0, 2.0, 0.0)
    with pytest.raises(ValueError):
        RateSpec.ramp(1.0, 2.0, 10.0, steps=0)
    with pytest.raises(ValueError):
        RateSpec.ramp(-1.0, 2.0, 10.0)


# -- the closed loop: predictive vs reactive ---------------------------------


def _comparison():
    from inferno_tpu_torch.emulator.experiment import run_autoscale_comparison

    return run_autoscale_comparison()


def test_predictive_beats_reactive_on_ramp_burst():
    """THE acceptance assertion of predictive scaling: on the closed-loop ramp+burst
    scenario the predictive controller incurs STRICTLY fewer
    SLO-violation seconds than the reactive baseline, at equal-or-lower
    average cost, with provenance marking both flavors."""
    res = _comparison()
    reactive, predictive = res["reactive"], res["predictive"]
    assert reactive["provenance"] == "reactive"
    assert predictive["provenance"] == "predictive"
    assert predictive["slo_violation_s"] < reactive["slo_violation_s"]
    assert predictive["cost"] <= reactive["cost"]
    # and the margin is structural, not a rounding artifact
    assert res["predictive_vs_reactive"]["slo_violation_s_saved"] > 5.0


def test_autoscale_loop_deterministic():
    """Deterministic-seed guarantee: the loop has no threads, sleeps, or
    RNG, so two runs must produce bit-identical results — which is what
    entitles the strict assertion above to live in the non-slow tier."""
    assert _comparison() == _comparison()


def test_autoscale_loop_physics():
    """Sanity on the plant: capacity shortfall accumulates backlog and
    violation time; abundant fixed capacity yields zero violations."""
    from inferno_tpu_torch.emulator.experiment import (
        AutoscaleScenario,
        run_autoscale_loop,
    )
    from inferno_tpu_torch.emulator.loadgen import RateSpec

    # plenty of initial capacity, flat load: nothing to violate
    easy = AutoscaleScenario(
        name="easy", rate=RateSpec(((20.0, 4.0),)), lambda_max_rps=2.0,
        spinup_s=4.0, initial_replicas=8,
    )
    res = run_autoscale_loop(easy, "reactive")
    assert res["slo_violation_s"] == 0.0
    assert res["final_backlog"] == 0.0

    # capacity pinned below offered load: violated end to end
    hard = AutoscaleScenario(
        name="hard", rate=RateSpec(((10.0, 10.0),)), lambda_max_rps=2.0,
        spinup_s=4.0, initial_replicas=1, max_replicas=1,
    )
    res = run_autoscale_loop(hard, "predictive")
    assert res["slo_violation_s"] == pytest.approx(10.0)
    assert res["final_backlog"] > 0.0


def test_autoscale_loop_rejects_unknown_controller():
    from inferno_tpu_torch.emulator.experiment import (
        forecast_scenario,
        run_autoscale_loop,
    )

    with pytest.raises(ValueError):
        run_autoscale_loop(forecast_scenario(), "clairvoyant")


def test_forecast_suites_stay_in_fast_tier():
    """Budget guard: the predictive-scaling suites
    are deterministic and thread-free by construction, so none of their
    tests may carry the `slow` marker — `-m 'not slow'` must keep
    covering the acceptance assertion above, inside the tier-1 budget."""
    import pathlib

    here = pathlib.Path(__file__).parent
    marker = "mark." + "slow"  # split so this line doesn't self-match
    for name in ("test_forecast.py", "test_predictive_reconciler.py"):
        assert marker not in (here / name).read_text(), (
            f"{name} must stay in the fast tier"
        )


def test_sustainable_rate_matches_analyzer_ceiling():
    from inferno_tpu_torch.emulator.engine import EngineProfile
    from inferno_tpu_torch.emulator.experiment import sustainable_rate_rps

    lam = sustainable_rate_rps(EngineProfile())
    assert lam > 0
    # a strictly slower profile sustains strictly less
    slower = EngineProfile(alpha=40.0, beta=0.8)
    assert sustainable_rate_rps(slower) < lam
