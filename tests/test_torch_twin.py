"""tests/test_twin.py's cases on the port's fleet twin, with the plant's
step cost on its default backend, torch, on the CPU: the vectorized
TwinPlant against the scalar-engine oracle (BIT-equality, not tolerance
bands), chunk/backend invariance, seeded determinism of the closed-loop
A/B, the promfeed->real-collector seam, and the deterministic virtual-clock
versions of three wall-paced slow cases:

- test_emulator.py::test_e2e_p95_ttft_meets_raw_slo_under_poisson_load
- test_experiment.py::test_model_error_small_in_steady_state
- test_emulator_disagg.py::test_closed_loop_matches_tandem_analyzer

Then both packages on the same seeded inputs: the reference's numpy
plant against the port's on numpy and on torch (CPU), at 1, 2 and 64
engines and through spot storms; the serial oracles; the A/B reports and
the twin CLI's JSON; `replay_artifact` on artifacts recorded by either
package. Every comparison is exact (`parity_diff == []`, equal JSON).
"""

import dataclasses
import json

import numpy as np
import pytest

from inferno_tpu_torch.emulator.engine import EngineProfile
from inferno_tpu_torch.twin import (
    TwinABScenario,
    TwinPlant,
    TwinPromFeed,
    build_trace,
    parity_diff,
    route_round_robin,
    run_serial_oracle,
    run_tandem_poisson,
    run_twin_ab,
    run_twin_policy_loop,
)

BARRIER_MS = 2000.0
# the plant's default backend, on the CPU
CPU = dict(backend="torch", device="cpu")

# small-queue profile: forces admission waves, KV reservation pressure,
# and queue-full rejections — the branches where vectorized and scalar
# event loops could plausibly diverge
STRESS = EngineProfile(alpha=20.0, beta=0.5, beta2=0.001, gamma=8.0,
                       delta=0.02, max_batch=4, kv_tokens_capacity=4_000)


def _drive_twin(plant, trace, engines, end_ms, kills=()):
    """Mirror the oracle's barrier walk on the twin side: advance every
    edge (barrier multiples, kill instants, the end), applying each kill
    to the lowest-index surviving engines."""
    plant.inject_bulk(route_round_robin(trace, engines), trace.arr_ms,
                      trace.in_tokens, trace.out_tokens)
    edges = []
    t = BARRIER_MS
    while t < end_ms - 1e-9:
        edges.append(t)
        t += BARRIER_MS
    edges.append(end_ms)
    all_edges = sorted(set(edges) | {kt * 1000.0 for kt, _ in kills})
    alive = list(range(engines))
    ki = 0
    kills = sorted(kills)
    for t in all_edges:
        plant.advance_to(t)
        while ki < len(kills) and kills[ki][0] * 1000.0 <= t + 1e-9:
            count = kills[ki][1]
            plant.preempt(np.asarray(alive[:count], dtype=np.int64))
            alive = alive[count:]
            ki += 1
    plant.drain_completions()
    return plant


def _oracle(trace, engines, end_ms, profile, kills=()):
    return run_serial_oracle(
        profile, route_round_robin(trace, engines), trace.arr_ms,
        trace.in_tokens, trace.out_tokens, end_ms,
        barrier_ms=BARRIER_MS, kills=list(kills),
    )


# -- parity vs the scalar oracle ----------------------------------------------


def test_one_engine_parity_ramp_burst():
    """Seeded 1-engine twin == scalar EmulatedEngine, bit for bit, on
    the canonical ramp+burst schedule (the headline parity contract:
    the scalar emulator stays the oracle)."""
    trace = build_trace("ramp_burst", 4.0, 92.0, seed=0)
    end_ms = trace.duration_s * 1000.0
    plant = _drive_twin(TwinPlant(STRESS, 1, **CPU), trace, 1, end_ms)
    diffs = parity_diff(plant.results(), _oracle(trace, 1, end_ms, STRESS))
    assert diffs == []
    done = plant.results()["state"] == 2
    assert done.sum() > 50  # the scenario exercised real load


def test_one_engine_parity_spot_storm():
    """Preempting the only engine mid-burst: queued AND running work
    fails abruptly, later arrivals are refused — identically on both
    sides, stamps included."""
    trace = build_trace("ramp_burst", 4.0, 92.0, seed=3)
    end_ms = trace.duration_s * 1000.0
    kills = ((40.0, 1),)
    plant = _drive_twin(TwinPlant(STRESS, 1, **CPU), trace, 1, end_ms, kills)
    res = plant.results()
    diffs = parity_diff(res, _oracle(trace, 1, end_ms, STRESS, kills))
    assert diffs == []
    assert (res["state"] == 3).sum() > 0  # the storm actually rejected work
    assert (res["state"] == 2).sum() > 0  # ... after completing earlier work


def test_fleet_parity_spot_storm():
    """7 engines through ramp+burst with two staggered spot storms:
    overload rejections, mid-flight preemption, and idle-jump engines in
    one run — bit-identical to seven scalar engines stepped serially."""
    trace = build_trace("ramp_burst", 30.0, 92.0, seed=1)
    end_ms = trace.duration_s * 1000.0
    kills = ((40.0, 2), (61.5, 1))
    plant = _drive_twin(TwinPlant(STRESS, 7, **CPU), trace, 7, end_ms, kills)
    res = plant.results()
    diffs = parity_diff(res, _oracle(trace, 7, end_ms, STRESS, kills))
    assert diffs == []
    assert plant.preempted_requests > 0


def test_chunked_vs_unchunked_invariance():
    """chunk_events is a wall-time/cache knob, not a semantics knob:
    results are bit-identical across chunk sizes (non-runnable engines
    cannot become runnable mid-advance, so chunk boundaries are
    unobservable)."""
    trace = build_trace("heavy_tail", 12.0, 30.0, seed=5)
    end_ms = trace.duration_s * 1000.0

    def run(chunk):
        plant = _drive_twin(TwinPlant(STRESS, 3, chunk_events=chunk, **CPU),
                            trace, 3, end_ms)
        return plant.results()

    base = run(256)
    for chunk in (1, 7):
        assert parity_diff(run(chunk), base) == []


def test_torch_backend_matches_numpy():
    """The torch step cost (the default backend, here on the CPU)
    reproduces the numpy path bit for bit (float64, one op per term in
    the same left-to-right order)."""
    trace = build_trace("steady", 6.0, 20.0, seed=2)
    end_ms = trace.duration_s * 1000.0
    res_np = _drive_twin(TwinPlant(STRESS, 2, backend="numpy"),
                         trace, 2, end_ms).results()
    res_torch = _drive_twin(TwinPlant(STRESS, 2, **CPU),
                            trace, 2, end_ms).results()
    assert parity_diff(res_torch, res_np) == []


def test_step_cost_bit_equal_on_random_profiles():
    """`_step_cost_vec` on torch (CPU) against numpy over 64 engines whose
    profiles are seeded random floats, and random rounds: every step cost
    equal bit for bit. Awkward mantissas make any regrouping of the sum
    (a fused multiply-add, a reassociation) show in the last bit."""
    rng = np.random.default_rng(12)
    profiles = [
        EngineProfile(alpha=float(rng.uniform(5, 40)), beta=float(rng.uniform(0.05, 1.5)),
                      beta2=float(rng.uniform(0, 0.02)), gamma=float(rng.uniform(1, 30)),
                      delta=float(rng.uniform(0.001, 0.2)), max_batch=64)
        for _ in range(64)
    ]
    host = TwinPlant(profiles, 64, backend="numpy")
    card = TwinPlant(profiles, 64, **CPU)
    for _ in range(20):
        idx = np.sort(rng.choice(64, size=int(rng.integers(1, 65)), replace=False))
        batch = rng.integers(1, 65, size=len(idx))
        new_count = np.minimum(rng.integers(0, 4, size=len(idx)), batch)
        new_count[::5] = batch[::5]  # a whole batch new: the gamma term
        new_in_sum = (new_count * rng.integers(1, 900, size=len(idx))).astype(np.float64)
        args = (idx, batch.astype(np.float64), new_count, new_in_sum, batch)
        want, got = host._step_cost_vec(*args), card._step_cost_vec(*args)
        assert got.dtype == np.float64
        assert np.array_equal(got.view(np.int64), want.view(np.int64))


# -- closed-loop A/B ----------------------------------------------------------


def test_same_seed_bit_identical_report():
    """The full closed-loop report (forecaster, stabilizer, spin-up
    pipeline, round-robin routing) is a pure function of (scenario,
    seed): two runs serialize identically."""
    scenario = TwinABScenario(engines=16, duration_s=30.0, seed=11,
                              kills=((18.0, 2),))
    a = run_twin_policy_loop(scenario, "predictive", **CPU)
    b = run_twin_policy_loop(scenario, "predictive", **CPU)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["requests"] > 0 and a["completed"] > 0


def test_ab_report_shape_and_policies_differ():
    """A/B on one seeded trace: both policies produce the scored report
    (violation-seconds + provisioned cost), and the two closed loops
    actually take different scaling decisions on a bursty trace."""
    scenario = TwinABScenario(engines=24, duration_s=46.0, seed=4)
    rep = run_twin_ab(scenario, ("reactive", "predictive"), **CPU)
    for policy in ("reactive", "predictive"):
        block = rep[policy]
        assert block["slo_violation_s"] >= 0.0
        assert block["cost"] > 0.0
        assert block["requests"] == rep["scenario"]["requests"]
    comp = rep["comparison"]
    assert comp["baseline"] == "reactive"
    assert comp["candidate"] == "predictive"
    # different policy machinery => different provisioning trajectories
    assert (rep["reactive"]["replica_seconds"]
            != rep["predictive"]["replica_seconds"])


# -- promfeed -> real collector seam ------------------------------------------


def test_promfeed_serves_real_collector():
    """The twin's FakeProm feed answers the production collector's
    five-query observation path — units converted on the wire exactly as
    a live engine would expose them (seconds, req/s rates)."""
    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
    from inferno_tpu_torch.controller.collector import collect_current_alloc
    from inferno_tpu_torch.controller.crd import (
        ACCELERATOR_LABEL,
        AcceleratorProfile,
        ConfigMapKeyRef,
        VariantAutoscaling,
        VariantAutoscalingSpec,
    )
    from inferno_tpu_torch.controller.engines import VLLM_TPU
    from inferno_tpu_torch.controller.workload import from_deployment

    feed = TwinPromFeed(model_id="twin-model", namespace="twins")
    feed.publish(arrival_rps=5.0, avg_in_tokens=160.0, avg_out_tokens=120.0,
                 ttft_ms=85.0, itl_ms=21.0, running=12.0)
    va = VariantAutoscaling(
        name="twin-variant", namespace="twins",
        labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id="twin-model",
            slo_class_ref=ConfigMapKeyRef(name="classes", key="Premium"),
            accelerators=[AcceleratorProfile(
                acc="v5e-4", acc_count=1, max_batch_size=48, at_tokens=128,
                decode_parms=DecodeParms(alpha=18.0, beta=0.3),
                prefill_parms=PrefillParms(gamma=5.0, delta=0.02),
            )],
        ),
    )
    workload = from_deployment({
        "metadata": {"name": "twin-variant", "namespace": "twins",
                     "uid": "u1"},
        "spec": {"replicas": 3},
    })
    alloc = collect_current_alloc(feed.prom, VLLM_TPU, va, workload, 10.0)
    assert alloc.load.arrival_rate == pytest.approx(300.0)  # rps -> rpm
    assert alloc.load.avg_input_tokens == pytest.approx(160.0)
    assert alloc.load.avg_output_tokens == pytest.approx(120.0)
    assert alloc.ttft_average == pytest.approx(85.0)  # s -> ms round trip
    assert alloc.itl_average == pytest.approx(21.0)
    assert alloc.num_replicas == 3


# -- ports of the quarantined slow tests (deterministic, fast tier) -----------


def test_e2e_p95_ttft_meets_raw_slo_under_poisson_load_twin():
    """Fast-tier port of test_emulator.py::
    test_e2e_p95_ttft_meets_raw_slo_under_poisson_load (slow: wall-paced
    LoadGenerator + wall-compressed engine). Same claim — size the max
    rate for a TTFT target with the tail-aware analyzer (SLO_MARGIN
    applied), drive Poisson load at that rate, p95 of measured TTFT
    beats the raw SLO — on the twin's virtual clock: no sleeps, no host
    noise, bit-reproducible."""
    from inferno_tpu_torch.analyzer import RequestSize, TargetPerf, build_analyzer
    from inferno_tpu_torch.config import DecodeParms, PrefillParms
    from inferno_tpu_torch.config.defaults import SLO_PERCENTILE

    fast = EngineProfile(alpha=5.0, beta=0.1, gamma=2.0, delta=0.01,
                         max_batch=8)
    slo_ttft = 25.0  # msec; binds well below the engine's saturation
    analyzer = build_analyzer(
        max_batch=fast.max_batch,
        max_queue=10 * fast.max_batch,
        decode=DecodeParms(alpha=fast.alpha, beta=fast.beta),
        prefill=PrefillParms(gamma=fast.gamma, delta=fast.delta),
        request=RequestSize(avg_in_tokens=16, avg_out_tokens=64),
    )
    targets = TargetPerf(target_ttft=slo_ttft)
    rates_tail, _, _ = analyzer.size(targets)  # default: SLO_MARGIN applied
    rates_mean, _, _ = analyzer.size(targets, ttft_tail_margin=1.0)
    # the margin must actually bite: tail-aware sizing admits less load
    assert rates_tail.rate_target_ttft < 0.9 * rates_mean.rate_target_ttft

    rate = rates_tail.rate_target_ttft  # req/sec at the SLO
    rng = np.random.default_rng(7)
    duration_ms = 6000.0
    gaps = rng.exponential(1000.0 / rate, size=int(rate * 6 * 3) + 50)
    arr = np.cumsum(gaps)
    arr = arr[arr < duration_ms]
    n = len(arr)
    plant = TwinPlant(fast, 1, **CPU)
    plant.inject_bulk(np.zeros(n, dtype=np.int64), arr,
                      np.full(n, 16, dtype=np.int64),
                      np.full(n, 64, dtype=np.int64))
    plant.advance_to(duration_ms + 60_000.0)  # drain the tail
    plant.drain_completions()
    res = plant.results()
    ttfts = np.sort(res["ttft_emu_ms"][res["state"] == 2])
    assert len(ttfts) >= 30  # enough mass for a percentile
    p95 = ttfts[min(int(len(ttfts) * SLO_PERCENTILE), len(ttfts) - 1)]
    assert p95 <= slo_ttft * 1.05  # percentile meets the raw SLO


def test_model_error_small_in_steady_state_twin():
    """Fast-tier port of test_experiment.py::
    test_model_error_small_in_steady_state (slow: lazily-ticked virtual
    clock starves under host load and the operating point drifts). The
    twin holds the operating point exactly — Poisson arrivals on the
    virtual clock — so the analyzer's ITL prediction for that point must
    match the measured mean within the same 20% band."""
    from inferno_tpu_torch.analyzer import RequestSize, build_analyzer
    from inferno_tpu_torch.config import (
        MAX_QUEUE_TO_BATCH_RATIO,
        DecodeParms,
        PrefillParms,
    )
    from inferno_tpu_torch.obs import relative_error

    profile = EngineProfile(alpha=10.0, beta=0.2, gamma=2.0, delta=0.005,
                            max_batch=16)
    rate, duration_ms = 30.0, 6000.0
    rng = np.random.default_rng(9)
    gaps = rng.exponential(1000.0 / rate, size=int(rate * 6 * 2) + 50)
    arr = np.cumsum(gaps)
    arr = arr[arr < duration_ms]
    n = len(arr)
    plant = TwinPlant(profile, 1, **CPU)
    plant.inject_bulk(np.zeros(n, dtype=np.int64), arr,
                      np.full(n, 128, dtype=np.int64),
                      np.full(n, 16, dtype=np.int64))
    plant.advance_to(duration_ms + 60_000.0)
    plant.drain_completions()
    res = plant.results()
    done = res["state"] == 2
    out = res["out_tokens"][done]
    lat = res["latency_emu_ms"][done]
    ttft = res["ttft_emu_ms"][done]
    multi = out > 1
    measured_itl = float(((lat[multi] - ttft[multi]) / (out[multi] - 1)).mean())

    analyzer = build_analyzer(
        max_batch=profile.max_batch,
        max_queue=profile.max_batch * MAX_QUEUE_TO_BATCH_RATIO,
        decode=DecodeParms(alpha=profile.alpha, beta=profile.beta),
        prefill=PrefillParms(gamma=profile.gamma, delta=profile.delta),
        request=RequestSize(avg_in_tokens=128, avg_out_tokens=16),
    )
    realized_rps = n / (duration_ms / 1000.0)
    predicted = analyzer.analyze(realized_rps)
    rel = relative_error(predicted.avg_token_time, measured_itl)
    assert rel is not None and rel < 0.2


def test_closed_loop_matches_tandem_analyzer_twin():
    """Fast-tier port of test_emulator_disagg.py::
    test_closed_loop_matches_tandem_analyzer (slow: the DisaggEngine's
    emu clock is WALL-derived). run_tandem_poisson is the deterministic
    discrete-event counterpart of the same 1-prefill/2-decode unit;
    steady Poisson at ~60% of the unit's max rate must land on the
    tandem model's analyze() prediction — and determinism buys tighter
    bands than the wall-paced original's [0.6, 1.6]."""
    from inferno_tpu_torch.analyzer import RequestSize, build_disagg_analyzer
    from inferno_tpu_torch.config.types import DecodeParms, DisaggSpec, PrefillParms
    from inferno_tpu_torch.emulator.disagg import DisaggProfile

    decode = DecodeParms(alpha=40.0, beta=1.0)
    prefill = PrefillParms(gamma=30.0, delta=0.02)
    request = RequestSize(avg_in_tokens=128, avg_out_tokens=12)
    spec = DisaggSpec(prefill_slices=1, decode_slices=2, prefill_max_batch=8)
    qa = build_disagg_analyzer(
        max_batch=16, max_queue=160, decode=decode, prefill=prefill,
        request=request, spec=spec,
    )
    rate = 0.6 * qa.max_rate  # req/s of emulated time

    p = DisaggProfile(
        alpha=decode.alpha, beta=decode.beta,
        gamma=prefill.gamma, delta=prefill.delta,
        prefill_max_batch=8, decode_max_batch=16,
        prefill_engines=1, decode_engines=2, kv_transfer_ms=0.0,
    )
    res = run_tandem_poisson(p, rate, 600.0, request.avg_in_tokens,
                             request.avg_out_tokens, seed=0)
    done = res["state"] == 2
    assert done.sum() >= 100
    ttft = res["ttft_emu_ms"][done]
    lat = res["latency_emu_ms"][done]
    out = res["out_tokens"][done]
    k = len(ttft) // 3  # drop the warmup third
    mean_ttft = float(ttft[k:].mean())
    itl = (lat - ttft) / np.maximum(out - 1, 1)
    mean_itl = float(itl[k:].mean())
    pred = qa.analyze(rate)
    model_ttft = pred.avg_wait_time + pred.avg_prefill_time
    assert model_ttft * 0.8 <= mean_ttft <= model_ttft * 1.5, (
        mean_ttft, model_ttft)
    assert pred.avg_token_time * 0.85 <= mean_itl <= pred.avg_token_time * 1.2, (
        mean_itl, pred.avg_token_time)


# -- correlated flash crowds -----------------------------------------------


def test_correlated_flash_crowd_shares_one_envelope():
    """One burst envelope drives all N variants: every trace's arrival
    rate inside the shared spike windows is several times its
    outside-window rate — the spikes land in the SAME seconds, which is
    the correlation independent `flash_crowd` traces don't have."""
    from inferno_tpu_torch.twin.traces import correlated_flash_crowds

    env, traces = correlated_flash_crowds(
        6, rate_rps=8.0, duration_s=120.0, seed=3, spikes=2,
        spike_scale=6.0,
    )
    assert len(traces) == 6
    assert len(env.windows) == 2
    assert len({t.seed for t in traces}) == 6  # independent realizations
    spike_s = sum(w for _, w in env.windows)
    base_s = env.duration_s - spike_s
    for t in traces:
        arr_s = t.arr_ms / 1000.0
        in_spike = np.zeros(len(arr_s), dtype=bool)
        for start, width in env.windows:
            in_spike |= (arr_s >= start) & (arr_s < start + width)
        spike_rate = in_spike.sum() / spike_s
        base_rate = (~in_spike).sum() / base_s
        # 6x programmed ratio, generously banded for Poisson noise
        assert spike_rate > 3.0 * base_rate, t.seed
    # the envelope multiplier agrees with its own windows
    start0 = env.windows[0][0]
    assert env.multiplier_at(start0 + 0.01) == 6.0
    assert env.multiplier_at(env.duration_s - 1e-6) in (1.0, 6.0)


def test_correlated_flash_crowd_deterministic():
    """Pure function of (n, rate, duration, seed): same arguments, bit
    identical traces and envelope — the property every twin generator
    holds (and the storm bench's reproducibility depends on)."""
    from inferno_tpu_torch.twin.traces import correlated_flash_crowds

    a_env, a = correlated_flash_crowds(3, 5.0, 60.0, seed=9)
    b_env, b = correlated_flash_crowds(3, 5.0, 60.0, seed=9)
    assert a_env == b_env
    for x, y in zip(a, b):
        assert np.array_equal(x.arr_ms, y.arr_ms)
        assert np.array_equal(x.in_tokens, y.in_tokens)
        assert np.array_equal(x.out_tokens, y.out_tokens)
    c_env, _ = correlated_flash_crowds(3, 5.0, 60.0, seed=10)
    assert c_env.windows != a_env.windows


# -- meta ---------------------------------------------------------------------


def test_no_slow_marks_in_module():
    """The whole point of the twin suite is fast-tier determinism: no
    test here may carry the slow quarantine mark."""
    import tests.test_torch_twin as me

    for name in dir(me):
        fn = getattr(me, name)
        if name.startswith("test_") and callable(fn):
            marks = getattr(fn, "pytestmark", [])
            assert not any(m.name == "slow" for m in marks), name


# -- both packages on the same seeded inputs ----------------------------------


def _ref_profile(p):
    from inferno_tpu.emulator.engine import EngineProfile as RefProfile

    return RefProfile(**dataclasses.asdict(p))


def _ref_drive(trace, engines, kills=()):
    """The reference's numpy plant through `_drive_twin`'s barrier walk."""
    from inferno_tpu.twin import TwinPlant as RefPlant

    return _drive_twin(RefPlant(_ref_profile(STRESS), engines, backend="numpy"),
                       trace, engines, trace.duration_s * 1000.0, kills)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("engines", [1, 2, 64])
def test_plant_equals_reference(engines, backend):
    """The port's plant on numpy and on torch (CPU) against the
    reference's numpy plant: every request's outcome bit-identical, and
    the same report."""
    trace = build_trace("ramp_burst", 4.0 * engines, 92.0, seed=engines)
    ref = _ref_drive(trace, engines)
    port = _drive_twin(TwinPlant(STRESS, engines, backend=backend, device="cpu"),
                       trace, engines, trace.duration_s * 1000.0)
    assert parity_diff(port.results(), ref.results()) == []
    assert port.report() == ref.report()
    assert (port.results()["state"] == 2).sum() > 40 * engines


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_spot_storm_equals_reference(backend):
    """Staggered spot storms over 64 engines (overload rejections,
    mid-flight preemption, refused traffic to the dead): the same
    outcome in both packages."""
    trace = build_trace("ramp_burst", 200.0, 92.0, seed=8)
    kills = ((30.0, 10), (45.0, 6), (61.5, 3))
    ref = _ref_drive(trace, 64, kills)
    port = _drive_twin(TwinPlant(STRESS, 64, backend=backend, device="cpu"),
                       trace, 64, trace.duration_s * 1000.0, kills)
    assert parity_diff(port.results(), ref.results()) == []
    assert port.report() == ref.report()
    assert port.preempted_requests == ref.preempted_requests > 0


def test_serial_oracle_equals_reference():
    """`run_serial_oracle` (scalar engines, sync-stepped) of both packages
    on a seven-engine storm trace."""
    from inferno_tpu.twin import run_serial_oracle as ref_oracle

    trace = build_trace("ramp_burst", 30.0, 92.0, seed=1)
    kills = [(40.0, 2), (61.5, 1)]
    args = (route_round_robin(trace, 7), trace.arr_ms, trace.in_tokens,
            trace.out_tokens, trace.duration_s * 1000.0)
    port = run_serial_oracle(STRESS, *args, barrier_ms=BARRIER_MS, kills=kills)
    ref = ref_oracle(_ref_profile(STRESS), *args, barrier_ms=BARRIER_MS, kills=kills)
    assert parity_diff(port, ref) == []


@pytest.mark.parametrize("engines,kills", [(16, ((18.0, 2),)), (24, ())])
def test_twin_ab_equals_reference(engines, kills):
    """The closed-loop A/B report of both packages on one scenario:
    equal JSON documents (lambda_max_rps included)."""
    from inferno_tpu.twin import TwinABScenario as RefScenario
    from inferno_tpu.twin import run_twin_ab as ref_ab

    kw = dict(engines=engines, duration_s=40.0, seed=5, kills=kills)
    ref = ref_ab(RefScenario(**kw))
    port = run_twin_ab(TwinABScenario(**kw), **CPU)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_twin_cli_equals_reference(tmp_path):
    """`python -m inferno_tpu_torch.twin` (torch on the CPU) writes the
    reference CLI's JSON report, byte for byte."""
    from inferno_tpu.twin.__main__ import main as ref_main
    from inferno_tpu_torch.twin.__main__ import main

    argv = ["--engines", "20", "--duration", "36", "--kills", "12:2,20:1",
            "--seed", "3"]
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    assert ref_main(argv + ["--out", str(ref_out)]) == 0
    assert main(argv + ["--backend", "torch", "--device", "cpu",
                        "--out", str(port_out)]) == 0
    assert port_out.read_text() == ref_out.read_text()


def _record(tmp_path, package):
    """Three recorded cycles of a 4-variant fleet, by `package`'s
    reconciler (the reference on backend jax, the port on torch, CPU)."""
    import importlib

    ctl = importlib.import_module(f"{package}.controller.reconciler")
    fleet = importlib.import_module(f"{package}.testing.fleet")
    device = {} if package == "inferno_tpu" else {"compute_device": "cpu"}
    rows = {
        (fleet.fleet_model(i), fleet.FLEET_NS): {
            "running": 3.0, "arrival_rps": 5.0 + i, "in_tokens": 128.0 + 32 * i,
            "out_tokens": 96.0, "ttft_s": 0.05, "itl_s": 0.02, "max_batch": 64.0,
        }
        for i in range(4)
    }
    d = str(tmp_path / package)
    rec = ctl.Reconciler(
        kube=fleet.fleet_cluster(4), prom=fleet.fleet_fake_prom(rows),
        config=ctl.ReconcilerConfig(
            config_namespace=fleet.CONFIG_NS, flight_recorder_dir=d,
            compute_backend="jax" if package == "inferno_tpu" else "torch",
            **device,
        ),
    )
    for _ in range(3):
        assert rec.run_cycle().errors == []
    rec.close()
    return d


@pytest.mark.parametrize("recorded_by", ["inferno_tpu", "inferno_tpu_torch"])
def test_replay_artifact_equals_reference(tmp_path, recorded_by):
    """One artifact, recorded by either package, replayed through both
    packages' twins: the same report."""
    from inferno_tpu.twin import replay_artifact as ref_replay
    from inferno_tpu_torch.twin import replay_artifact

    d = _record(tmp_path, recorded_by)
    ref = ref_replay(d, engines=8, seed=2)
    port = replay_artifact(d, engines=8, seed=2, **CPU)
    assert port == ref
    assert port["completed"] > 100
