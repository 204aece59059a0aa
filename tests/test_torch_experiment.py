"""tests/test_experiment.py's cases on the port's experiment runner
(batch scenario runs with aggregate stats, cross-checked against the
analytic queueing model), tests/test_spot.py's three injection cases on
the port's `spot/injection.py`, and both packages on the same inputs:
`sustainable_rate_rps` bit for bit, and the deterministic closed loops
(`run_autoscale_comparison`, `run_spot_storm_comparison`) equal.

Two wall-paced cases of tests/test_experiment.py sit in the slow tier
there and are not repeated; the twin's deterministic counterpart of
`test_model_error_small_in_steady_state` is in tests/test_torch_twin.py.
"""

import dataclasses
import json
import subprocess
import sys

import pytest

from inferno_tpu_torch.emulator.engine import EmulatedEngine, EngineProfile
from inferno_tpu_torch.emulator.experiment import (
    Scenario,
    RateSpec,
    run_scenario,
)


def _quick_scenario(**kw) -> Scenario:
    base = dict(
        name="test",
        profile=EngineProfile(alpha=10.0, beta=0.2, gamma=2.0, delta=0.005, max_batch=16),
        rate=RateSpec(((1.0, 20.0),)),
        time_scale=0.002,
        out_tokens=16,
        runs=1,
    )
    base.update(kw)
    return Scenario(**base)


def test_run_scenario_reports_stats_and_model():
    res = run_scenario(_quick_scenario())
    assert res["requests"] > 0
    assert res["itl_ms"]["mean"] > 0
    assert res["ttft_ms"]["p95"] >= res["ttft_ms"]["p50"]
    assert "itl_ms" in res["model"]


def test_virtual_clock_matches_profile():
    # observed emulated ITL must track alpha + beta*batch regardless of
    # time_scale (the virtual clock is immune to host scheduling jitter)
    res = run_scenario(_quick_scenario())
    observed = res["itl_ms"]["mean"]
    batch = max(res["batch_depth"]["mean"], 1.0)
    predicted = 10.0 + 0.2 * batch
    assert abs(observed - predicted) / predicted < 0.25


def test_emu_paced_rejects_multi_replica():
    # the schedule clock is engines[0]: N replicas would silently read
    # the realized per-replica rate N x high (review r6)
    with pytest.raises(ValueError, match="single aggregated replica"):
        run_scenario(_quick_scenario(emu_paced=True, replicas=2))


def test_emu_paced_schedule_realizes_target_rate():
    """Emu-paced arrivals (the bench's benched-point mode) are scheduled
    on the engine's virtual clock: the realized emulated rate tracks the
    RateSpec up to Poisson count noise, independent of host overhead —
    wall-paced schedules drifted 10-30% (VERDICT r5 §5)."""
    res = run_scenario(_quick_scenario(
        emu_paced=True,
        # emu units now: 8 emulated seconds at 50 req/emulated-second
        rate=RateSpec(((8.0, 50.0),)),
        time_scale=0.01,
    ))
    realized = res["measured_emu_rps_per_replica"]
    assert 0.85 <= realized / 50.0 <= 1.15  # Poisson noise band, N=400
    assert res["offered_rps"] == pytest.approx(50.0)


def test_engine_emu_clock_monotonic_across_idle():
    import time

    eng = EmulatedEngine(EngineProfile(alpha=5.0, beta=0.1), time_scale=0.002)
    eng.start()
    try:
        res = eng.generate(32, 4, timeout=10)
        assert res is not None and res.latency_emu_ms > 0
        t1 = eng.emu_ms
        # idle: the virtual clock keeps advancing. Poll with a generous
        # deadline instead of one fixed sleep — under full-machine load
        # (e.g. the bench running alongside the suite) the engine thread
        # can starve for tens of ms, which is scheduler noise, not a bug.
        deadline = time.time() + 5.0
        while eng.emu_ms <= t1 and time.time() < deadline:
            time.sleep(0.01)
        assert eng.emu_ms > t1
        res2 = eng.generate(32, 4, timeout=10)
        assert res2 is not None
        # per-token virtual cost equals the profile's decode step at batch 1
        itl = (res2.latency_emu_ms - res2.ttft_emu_ms) / (res2.out_tokens - 1)
        assert abs(itl - (5.0 + 0.1)) < 0.5
    finally:
        eng.stop()


def test_cli_json_output(tmp_path):
    out = tmp_path / "results.json"
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "inferno_tpu_torch.emulator.experiment",
            "--scenario",
            "steady-light",
            "--json",
            str(out),
        ],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    results = json.loads(out.read_text())
    assert len(results) == 1 and results[0]["scenario"] == "steady-light"


def test_light_load_ttft_close_to_service_time():
    # the review case: at light load an idle engine must report TTFT near
    # the pure prefill+decode service time, not phantom idle-spin wait
    res = run_scenario(
        _quick_scenario(rate=RateSpec(((1.5, 5.0),)), time_scale=0.002)
    )
    # service time ~ gamma + delta*in*1 + alpha + beta*1 = 2+0.64+10.2 ≈ 13ms
    assert res["ttft_ms"]["p50"] < 40.0, res["ttft_ms"]



# -- tests/test_spot.py's injection cases ------------------------------------


def test_closed_loop_storm_comparison_strict_ordering():
    from inferno_tpu_torch.spot.injection import run_spot_storm_comparison

    r = run_spot_storm_comparison()
    assert r["spot_greedy"]["slo_violation_s"] > 0
    assert (
        r["prepositioned"]["slo_violation_s"]
        < r["spot_greedy"]["slo_violation_s"]
    )
    assert 0 < r["cost_delta_pct"] <= 10.0
    # deterministic: bit-identical reruns
    assert run_spot_storm_comparison() == r


def test_closed_loop_rejects_unknown_mode():
    from inferno_tpu_torch.spot.injection import run_spot_storm_loop, storm_scenario

    with pytest.raises(ValueError, match="spot-greedy|prepositioned"):
        run_spot_storm_loop(storm_scenario(), "yolo")


def test_engine_preempt_fails_inflight_and_refuses_new():
    """preempt() is abrupt by design: in-flight requests fail with the
    permanent-rejection contract and later submissions are refused."""
    from inferno_tpu_torch.emulator.engine import wait_for_result

    eng = EmulatedEngine(
        EngineProfile(alpha=50.0, beta=0.5, max_batch=4), time_scale=1.0
    )
    eng.start()
    try:
        # out_tokens large enough that the request cannot complete before
        # the preemption lands
        req = eng.submit(in_tokens=16, out_tokens=100_000)
        killed = eng.preempt()
        assert killed == 1
        result, rejected = wait_for_result(req, timeout=2.0)
        assert result is None and rejected is True
        late = eng.submit(in_tokens=16, out_tokens=8)
        result, rejected = wait_for_result(late, timeout=0.1)
        assert result is None and rejected is True
        assert eng.preempted and eng.preempted_requests == 1
        assert eng.num_running == 0 and eng.num_waiting == 0
    finally:
        eng.stop()


def test_run_scenario_preemption_storm_kills_replicas():
    """Closed-loop emulator run with mid-run evictions: a correlated storm
    takes half the fleet while every engine is busy with long decodes."""
    result = run_scenario(Scenario(
        name="preempt-storm",
        replicas=4,
        rate=RateSpec(((3.0, 30.0),)),
        in_tokens=64,
        out_tokens=1500,
        time_scale=0.01,
        preempt_at=((100.0, 2),),  # emulated seconds: ~1 s into the drive
    ))
    assert result["preempted_requests"] > 0
    # surviving replicas still completed work
    assert result["requests"] > 0


# -- both packages on the same inputs ----------------------------------------


@pytest.mark.parametrize("shape", [(128, 128), (16, 64), (160, 120), (1, 1), (2048, 7)])
@pytest.mark.parametrize("profile", [
    dict(),
    dict(alpha=5.0, beta=0.1, gamma=2.0, delta=0.01, max_batch=8),
    dict(alpha=18.0, beta=0.3, gamma=5.0, delta=0.02, max_batch=48, beta2=0.01),
])
def test_sustainable_rate_equals_reference(profile, shape):
    """The analyzer's stable-rate ceiling through both packages: the same
    float, bit for bit (the twin's A/B reports quote it)."""
    from inferno_tpu.emulator.engine import EngineProfile as RefProfile
    from inferno_tpu.emulator.experiment import sustainable_rate_rps as ref_rate
    from inferno_tpu_torch.emulator.experiment import sustainable_rate_rps

    got = sustainable_rate_rps(EngineProfile(**profile), *shape)
    assert got.hex() == ref_rate(RefProfile(**profile), *shape).hex()


def test_forecast_scenario_equals_reference():
    from inferno_tpu.emulator.experiment import forecast_scenario as ref_fs
    from inferno_tpu_torch.emulator.experiment import forecast_scenario

    assert dataclasses.asdict(forecast_scenario(time_scale=3.0)) == \
        dataclasses.asdict(ref_fs(time_scale=3.0))


def test_autoscale_comparison_equals_reference():
    """The deterministic fluid closed loop (forecaster, stabilizer,
    spin-up pipeline) gives the same report in both packages."""
    from inferno_tpu.emulator.experiment import run_autoscale_comparison as ref_cmp
    from inferno_tpu_torch.emulator.experiment import run_autoscale_comparison

    got = run_autoscale_comparison()
    assert json.dumps(got, sort_keys=True) == json.dumps(ref_cmp(), sort_keys=True)


def test_spot_storm_comparison_equals_reference():
    from inferno_tpu.spot.injection import run_spot_storm_comparison as ref_cmp
    from inferno_tpu_torch.spot import run_spot_storm_comparison

    assert run_spot_storm_comparison() == ref_cmp()
