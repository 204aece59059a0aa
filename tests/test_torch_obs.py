"""Decision-trace observability: span tracer, per-cycle trace
threading through the reconciler, DecisionRecord reason codes, latency
histograms on /metrics, the /debug/decisions route, and stale-controller
readiness.

Port of tests/test_obs.py on the port's modules, the expectations unchanged.
Every reconciler sizes on backend "torch" on the CPU, asked for
explicitly (`PORT_CPU`), and every clean cycle over an in-memory
cluster is held to the reference's decisions on the same inputs
(`test_torch_held_cycle.held_reconciler`).
"""

import io
import json
import logging
import time
import urllib.error
import urllib.request

import pytest

from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
from inferno_tpu_torch.controller.metrics import (
    CycleInstruments,
    HealthServer,
    MetricsEmitter,
    MetricsServer,
    Registry,
)
from inferno_tpu_torch.obs import (
    REASON_ASLEEP,
    REASON_CAPACITY_LIMITED,
    REASON_COST_BOUND,
    REASON_ERROR,
    REASON_SLO_BOUND,
    DecisionRecord,
    TraceBuffer,
    Tracer,
)

from test_torch_apiserver import CFG_NS, NS, make_cluster, make_prom
from test_torch_held_cycle import PORT_CPU, held_reconciler
from inferno_tpu_torch.controller.promclient import FakeProm


def reconciler(cluster, prom, **kw):
    cfg = ReconcilerConfig(config_namespace=CFG_NS, **PORT_CPU, **kw)
    return held_reconciler(kube=cluster, prom=prom, config=cfg)


# -- tracer primitives -------------------------------------------------------


def test_tracer_nests_spans_and_measures_monotonic():
    tracer = Tracer("root")
    with tracer.span("outer", phase=1) as outer:
        with tracer.span("inner"):
            pass
        outer.set(done=True)
    with tracer.span("sibling"):
        pass
    root = tracer.finish()
    assert [c.name for c in root.children] == ["outer", "sibling"]
    assert [c.name for c in root.children[0].children] == ["inner"]
    assert root.children[0].attrs == {"phase": 1, "done": True}
    # durations are monotonic-clock deltas: non-negative, parent >= child,
    # root >= everything
    inner = root.find("inner")
    assert 0.0 <= inner.duration_ms <= root.children[0].duration_ms
    assert root.duration_ms >= root.children[0].duration_ms
    # children start within the parent
    assert root.children[0].start_ms <= inner.start_ms
    # finish() is idempotent
    assert tracer.finish().duration_ms == root.duration_ms


def test_span_to_dict_round_trips_through_json():
    tracer = Tracer("t")
    with tracer.span("a", k="v"):
        with tracer.span("b"):
            pass
    doc = json.loads(json.dumps(tracer.finish().to_dict()))
    assert doc["name"] == "t"
    assert doc["children"][0]["attrs"] == {"k": "v"}
    assert doc["children"][0]["children"][0]["name"] == "b"


def test_trace_buffer_bounded_with_monotonic_seq():
    buf = TraceBuffer(capacity=3)
    for i in range(5):
        buf.append({"i": i})
    snap = buf.snapshot()
    assert len(snap) == len(buf) == 3
    assert [d["i"] for d in snap] == [2, 3, 4]  # oldest evicted
    assert [d["seq"] for d in snap] == [3, 4, 5]  # seq keeps counting
    with pytest.raises(ValueError):
        TraceBuffer(capacity=0)


def test_trace_buffer_stamp_survives_embedded_seq():
    """A document already carrying a "seq" key (a recorded cycle
    replayed back through a buffer) must NOT override the monotonic
    stamp — readers detect missed cycles by seq gaps, and a stale
    embedded value fakes gaps or reversals."""
    buf = TraceBuffer(capacity=4)
    for i in range(3):
        buf.append({"i": i, "seq": 999})  # hostile embedded seq
    assert [d["seq"] for d in buf.snapshot()] == [1, 2, 3]


def test_trace_buffer_concurrent_append_read_stress():
    """The reconcile thread appends while the debug route iterates: every
    snapshot must show strictly-consecutive monotonic seqs (no gaps, no
    tears) and stay JSON-serializable mid-append."""
    import threading

    buf = TraceBuffer(capacity=8)
    stop = threading.Event()
    writer_errors: list[BaseException] = []

    def writer():
        i = 0
        try:
            while not stop.is_set():
                # embedded "seq" exercises the stamp-priority fix under
                # concurrency too
                buf.append({"i": i, "seq": 12345, "payload": {"n": i}})
                i += 1
        except BaseException as e:  # noqa: BLE001 — surfaced below
            writer_errors.append(e)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        snapshots = 0
        last_seen = 0
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            snap = buf.snapshot()
            if not snap:
                continue
            seqs = [d["seq"] for d in snap]
            # monotonic AND gapless within one snapshot: a torn view
            # (append racing the copy) would show a jump or repeat
            assert seqs == list(range(seqs[0], seqs[0] + len(seqs))), seqs
            # never goes backwards across snapshots
            assert seqs[-1] >= last_seen
            last_seen = seqs[-1]
            # each doc is internally consistent (i stamped before append)
            for d in snap:
                assert d["payload"]["n"] == d["i"]
            json.dumps(snap)  # serializable mid-append
            snapshots += 1
    finally:
        stop.set()
        t.join(timeout=3.0)
    assert not writer_errors
    assert snapshots > 100  # the loop genuinely raced the writer
    assert last_seen > 100


def test_decision_record_rejects_unknown_reason():
    with pytest.raises(ValueError):
        DecisionRecord(variant="v", reason="because")
    rec = DecisionRecord(variant="v")
    with pytest.raises(ValueError):
        rec.decide("vibes")


# -- the reconcile cycle carries trace + decisions ---------------------------


def test_cycle_trace_has_four_phases_and_decision_per_variant():
    """The acceptance shape: run_cycle() returns a CycleReport
    carrying a trace with the four phase spans and one DecisionRecord per
    prepared variant."""
    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    report = rec.run_cycle()
    assert report.errors == []

    assert report.trace is not None
    phases = [c.name for c in report.trace.children]
    assert phases == ["collect", "analyze", "solve", "actuate"]
    assert len(phases) >= 4
    # every span measured on the same clock, inside the root
    for sp in report.trace.walk():
        assert sp.duration_ms >= 0.0
        assert sp.start_ms + sp.duration_ms <= report.trace.duration_ms + 1e-6
    # per-variant child under analyze
    analyze = report.trace.find("analyze")
    variants = [s for s in analyze.children if s.name == "variant"]
    assert [s.attrs["variant"] for s in variants] == ["llama-premium:workloads"]

    assert report.variants_prepared == 1
    assert len(report.decisions) == 1
    d = report.decisions[0]
    assert d.reason == REASON_SLO_BOUND  # 50 rps drove replicas over the floor
    assert d.replicas > 1 and d.accelerator == "v5e-4"
    assert d.arrival_rpm == pytest.approx(3000.0)  # observed λ, req/min
    assert d.lambda_max_rpm > 0.0  # λ_max: per-replica sustainable ceiling
    # the fleet holds the SLO: N * λ_max covers λ, N-1 would not
    assert d.replicas * d.lambda_max_rpm >= d.arrival_rpm
    assert (d.replicas - 1) * d.lambda_max_rpm < d.arrival_rpm
    assert d.profile_provenance == "cr"
    assert d.slo_ttft_ms == 500.0 and d.slo_itl_ms == 24.0
    # headroom = SLO - prediction; a feasible sizing has margin
    assert d.ttft_headroom_ms > 0.0 and d.itl_headroom_ms > 0.0
    assert d.cost_delta == pytest.approx(d.cost - d.prev_cost)
    assert d.prev_replicas == 1

    # the cycle landed in the trace ring buffer, JSON-ready
    snap = rec.traces.snapshot()
    assert len(snap) == 1
    doc = json.loads(json.dumps(snap[0]))
    assert doc["optimization_ok"] is True
    assert doc["decisions"][0]["reason"] == REASON_SLO_BOUND
    assert [c["name"] for c in doc["spans"]["children"]] == [
        "collect", "analyze", "solve", "actuate",
    ]


def test_decision_reason_cost_bound_at_idle_floor():
    cluster = make_cluster(replicas=2)
    rec = reconciler(cluster, make_prom(arrival_rps=0.0, out_tok=0.0))
    report = rec.run_cycle()
    (d,) = report.decisions
    assert d.reason == REASON_COST_BOUND
    assert d.replicas == 1  # the floor without scale-to-zero


def test_decision_reason_asleep():
    """Scaled-to-zero variant with no engine series: sized from gateway
    demand and explained as `asleep`, not an error."""
    cluster = make_cluster(replicas=0)
    rec = reconciler(cluster, FakeProm(), scale_to_zero=True)
    report = rec.run_cycle()
    (d,) = report.decisions
    assert d.asleep is True
    assert d.reason == REASON_ASLEEP
    assert d.replicas == 0  # no demand at the gateway either


def test_decision_reason_capacity_limited():
    """Limited mode with a zero-chip pool squeezes the variant out: the
    decision is the floor, explained as capacity_limited."""
    cluster = make_cluster(replicas=1)
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "OPTIMIZER_MODE": "limited",
        "TPU_CAPACITY": json.dumps({"v5e": 0}),
    })
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    report = rec.run_cycle()
    (d,) = report.decisions
    assert d.reason == REASON_CAPACITY_LIMITED
    assert d.replicas == 1  # the floor
    # the degradation ladder enriches the detail with the chip shortfall
    # of the preferred candidate in the binding pool
    assert "zeroed by capacity" in d.detail
    assert d.degradation_step == "zeroed"
    assert d.chip_shortfall > 0
    assert "v5e" in d.detail


def test_decision_reason_error_on_optimize_failure(monkeypatch):
    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))

    class Boom:
        def __init__(self, spec):
            pass

        def optimize(self, system, calculate=False):
            raise RuntimeError("solver exploded")

    monkeypatch.setattr("inferno_tpu_torch.controller.reconciler.Optimizer", Boom)
    report = rec.run_cycle()
    (d,) = report.decisions
    assert d.reason == REASON_ERROR
    assert "solver exploded" in d.detail
    # the failed cycle is still traced and retained
    assert report.trace.find("solve") is not None
    assert rec.traces.snapshot()[0]["optimization_ok"] is False


def test_decision_reason_error_on_prepare_failure():
    cluster = make_cluster()
    cluster.set_configmap(CFG_NS, "service-classes-config", {})
    rec = reconciler(cluster, make_prom())
    report = rec.run_cycle()
    assert report.variants_prepared == 0
    (d,) = report.decisions
    assert d.reason == REASON_ERROR
    assert "no SLO entry" in d.detail


def test_configmap_read_error_survives_cycle():
    """A transient apiserver failure on the ConfigMap reads is recorded
    and retried next cycle — it must not escape run_cycle (which would
    kill run_forever and crash-loop the controller on an API blip)."""
    from inferno_tpu_torch.controller import InMemoryCluster
    from inferno_tpu_torch.controller.kube import KubeError

    class FlakyConfig(InMemoryCluster):
        def get_configmap(self, namespace, name):
            if getattr(self, "_arm", False):
                raise KubeError("apiserver 500")
            return super().get_configmap(namespace, name)

    cluster = FlakyConfig()
    cluster.__dict__.update(make_cluster().__dict__)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    cluster._arm = True
    report = rec.run_cycle()  # must not raise
    assert not report.optimization_ok
    assert any("config" in e for e in report.errors)
    assert report.trace is not None  # still traced and retained
    cluster._arm = False
    assert rec.run_cycle().optimization_ok  # next cycle recovers


def test_leadership_loss_explains_all_pending_decisions():
    """gate() turning false mid-apply stamps the handoff explanation on
    EVERY not-yet-applied variant's record, not just the one in flight."""
    import copy

    cluster = make_cluster(replicas=1)
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    va2 = copy.deepcopy(va)
    va2.name = "llama-second"
    cluster.add_variant_autoscaling(va2)
    cluster.add_deployment(NS, "llama-second", replicas=1)

    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    calls = {"n": 0}

    def gate():
        # True through prepare; False once _apply starts writing
        calls["n"] += 1
        return calls["n"] < 4

    rec.gate = gate
    report = rec.run_cycle()
    assert any("leadership lost" in e for e in report.errors)
    undetailed = [d for d in report.decisions if not d.detail]
    assert undetailed == []  # every record carries an explanation
    assert any("leadership lost" in d.detail for d in report.decisions)


def test_decision_emitted_as_structured_log_event():
    from inferno_tpu_torch.controller.logger import get_logger

    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    buf = io.StringIO()
    log = logging.getLogger("inferno.reconciler")
    log.handlers.clear()
    rec.log = get_logger("inferno.reconciler", stream=buf)
    rec.run_cycle()
    events = [json.loads(line) for line in buf.getvalue().strip().splitlines()]
    decisions = [e for e in events if e["msg"] == "decision"]
    assert len(decisions) == 1
    assert decisions[0]["reason"] == REASON_SLO_BOUND
    assert decisions[0]["lambda_max_rpm"] > 0
    log.handlers.clear()


def test_corrected_provenance_lands_in_decision():
    """When the corrector's calibration is active, the DecisionRecord's
    profile_provenance flips to `corrected` — the operator can tell which
    parameter set actually sized the fleet."""
    class FakeState:
        active = True
        decode_ratio = 1.3
        prefill_ratio = 1.0
        surrogate_used = False
        observations = 9

    class FakeCorrector:
        def observe(self, key, obs):
            pass

        def corrected_parms(self, key, decode, prefill):
            import dataclasses as dc

            return (
                dc.replace(decode, alpha=decode.alpha * 1.3, beta=decode.beta * 1.3),
                prefill,
                FakeState(),
            )

        def prune(self, active):
            pass

    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    rec.corrector = FakeCorrector()
    report = rec.run_cycle()
    (d,) = report.decisions
    assert d.profile_provenance == "corrected"
    assert report.corrections_active == 1


# -- histograms on /metrics --------------------------------------------------


def test_cycle_histograms_render_valid_prometheus_text():
    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    rec.run_cycle()
    rec.run_cycle()
    body = rec.emitter.registry.render()

    for name in ("inferno_cycle_duration_seconds", "inferno_solver_seconds",
                 "inferno_variant_analysis_seconds", "inferno_prom_scrape_seconds"):
        assert f"# TYPE {name} histogram" in body, name
        assert f'{name}_bucket' in body, name

    lines = body.splitlines()
    # cycle histogram: 2 observations, cumulative buckets, count == +Inf
    counts = [ln for ln in lines if ln.startswith("inferno_cycle_duration_seconds_count")]
    assert counts == ["inferno_cycle_duration_seconds_count 2"]
    buckets = [
        float(ln.rsplit(" ", 1)[1])
        for ln in lines
        if ln.startswith("inferno_cycle_duration_seconds_bucket")
    ]
    assert buckets == sorted(buckets), "bucket counts must be cumulative"
    assert buckets[-1] == 2.0  # +Inf bucket equals _count
    # per-variant analysis series carries the variant labels
    assert any(
        ln.startswith("inferno_variant_analysis_seconds_bucket")
        and 'variant_name="llama-premium"' in ln
        and f'namespace="{NS}"' in ln
        for ln in lines
    )
    # sum is a positive latency total
    sums = [ln for ln in lines if ln.startswith("inferno_cycle_duration_seconds_sum")]
    assert len(sums) == 1 and float(sums[0].rsplit(" ", 1)[1]) > 0.0


def test_histogram_registry_guards():
    reg = Registry()
    reg.histogram("inferno_x_seconds", "x")
    with pytest.raises(ValueError):
        reg.gauge("inferno_x_seconds")  # kind clash must not silently alias
    with pytest.raises(ValueError):
        reg.histogram("inferno_y", "y", buckets=())


def test_variant_histogram_pruned_with_variant():
    """A deleted variant's per-variant analysis series is dropped exactly
    like its gauges — frozen latency series must not haunt the fleet
    percentiles."""
    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    rec.run_cycle()
    body = rec.emitter.registry.render()
    assert any(
        ln.startswith("inferno_variant_analysis_seconds")
        and 'variant_name="llama-premium"' in ln
        for ln in body.splitlines()
    )
    cluster._vas.clear()
    rec.run_cycle()  # sees no variants; prunes
    body = rec.emitter.registry.render()
    lines = body.splitlines()
    # histogram + gauges dropped together...
    for prefix in ("inferno_variant_analysis_seconds", "inferno_desired_replicas",
                   "inferno_current_replicas", "inferno_desired_ratio"):
        assert not any(
            ln.startswith(prefix) and 'variant_name="llama-premium"' in ln
            for ln in lines
        ), prefix
    # ...while cumulative history survives: the scaling counter and the
    # unlabeled cycle histogram (2 cycles observed)
    assert any(
        ln.startswith("inferno_replica_scaling_total")
        and 'variant_name="llama-premium"' in ln
        for ln in lines
    )
    assert "inferno_cycle_duration_seconds_count 2" in body


# -- /debug/decisions --------------------------------------------------------


def test_debug_decisions_route_serves_last_k_cycles():
    cluster = make_cluster(replicas=1)
    cfg = ReconcilerConfig(config_namespace=CFG_NS, **PORT_CPU)
    traces = TraceBuffer(capacity=2)
    rec = held_reconciler(
        kube=cluster, prom=make_prom(arrival_rps=50.0), config=cfg,
        trace_buffer=traces,
    )
    server = MetricsServer(rec.emitter.registry, port=0, traces=traces)
    server.start()
    try:
        for _ in range(3):
            rec.run_cycle()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/debug/decisions", timeout=10
        ) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            doc = json.load(resp)
        assert doc["capacity"] == 2
        assert len(doc["cycles"]) == 2  # ring kept the last K
        assert [c["seq"] for c in doc["cycles"]] == [2, 3]
        latest = doc["cycles"][-1]
        assert latest["decisions"][0]["variant"] == "llama-premium:workloads"
        assert latest["decisions"][0]["reason"] == REASON_SLO_BOUND
        assert latest["spans"]["name"] == "reconcile-cycle"
        # without a buffer the route does not exist
        bare = MetricsServer(Registry(), port=0)
        bare.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{bare.port}/debug/decisions", timeout=10
                )
            assert exc.value.code == 404
        finally:
            bare.stop()
    finally:
        server.stop()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.load(resp)


def test_debug_decisions_query_filters():
    """?variant= and ?cycles= narrow the ring so a
    large-fleet trace is inspectable without downloading everything;
    invalid parameters are a 400, never a silent full dump."""
    import copy

    cluster = make_cluster(replicas=1)
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    va2 = copy.deepcopy(va)
    va2.name = "llama-second"
    cluster.add_variant_autoscaling(va2)
    cluster.add_deployment(NS, "llama-second", replicas=1)
    traces = TraceBuffer(capacity=8)
    rec = held_reconciler(
        kube=cluster, prom=make_prom(arrival_rps=50.0),
        config=ReconcilerConfig(config_namespace=CFG_NS, **PORT_CPU),
        trace_buffer=traces,
    )
    server = MetricsServer(rec.emitter.registry, port=0, traces=traces)
    server.start()
    try:
        for _ in range(3):
            rec.run_cycle()
        base = f"http://127.0.0.1:{server.port}/debug/decisions"

        doc = _get_json(base + "?cycles=1")
        assert len(doc["cycles"]) == 1
        assert doc["cycles"][0]["seq"] == 3
        assert len(doc["cycles"][0]["decisions"]) == 2  # both variants

        doc = _get_json(base + "?variant=llama-second:workloads&cycles=2")
        assert len(doc["cycles"]) == 2
        for cyc in doc["cycles"]:
            assert [d["variant"] for d in cyc["decisions"]] == [
                "llama-second:workloads"
            ]
            # the fleet-wide span tree is omitted from filtered views
            assert "spans" not in cyc
            assert "seq" in cyc and "optimization_ok" in cyc

        # a variant that never reported: cycles kept, decisions empty
        doc = _get_json(base + "?variant=nope:ns")
        assert all(cyc["decisions"] == [] for cyc in doc["cycles"])

        for bad in ("?cycles=abc", "?cycles=0", "?cycles=-2", "?foo=1",
                    "?variant="):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(base + bad, timeout=10)
            assert exc.value.code == 400, bad
            assert "error" in json.load(exc.value)
    finally:
        server.stop()


# -- attainment scoreboard ---------------------------------------------------


def test_attainment_tracker_scores_prediction_against_next_observation():
    from inferno_tpu_torch.obs import AttainmentConfig, AttainmentTracker

    tr = AttainmentTracker(AttainmentConfig(ewma_gain=0.5, slo_objective=0.9))
    # cycle 1: a prediction is stored; nothing to score yet
    s = tr.observe("v", predicted_ttft_ms=100.0, predicted_itl_ms=10.0,
                   observed_ttft_ms=120.0, observed_itl_ms=9.0,
                   slo_ttft_ms=150.0, slo_itl_ms=12.0)
    assert s.ttft_error_ms is None and s.itl_error_ms is None
    assert s.scored_cycles == 0
    assert s.ttft_attainment == 1.0  # 120 <= 150
    # cycle 2: cycle 1's prediction scored against cycle 2's observation
    s = tr.observe("v", predicted_ttft_ms=100.0, predicted_itl_ms=10.0,
                   observed_ttft_ms=130.0, observed_itl_ms=8.0,
                   slo_ttft_ms=150.0, slo_itl_ms=12.0)
    assert s.ttft_error_ms == pytest.approx(30.0)  # 130 observed - 100 predicted
    assert s.itl_error_ms == pytest.approx(-2.0)
    assert s.ttft_error_ewma_ms == pytest.approx(30.0)  # seeded
    assert s.scored_cycles == 1
    # cycle 3: EWMA folds at gain 0.5; a breach moves attainment down
    s = tr.observe("v", predicted_ttft_ms=100.0, predicted_itl_ms=10.0,
                   observed_ttft_ms=200.0, observed_itl_ms=8.0,
                   slo_ttft_ms=150.0, slo_itl_ms=12.0)
    assert s.ttft_error_ms == pytest.approx(100.0)
    assert s.ttft_error_ewma_ms == pytest.approx(0.5 * 100 + 0.5 * 30)
    assert s.ttft_attainment == pytest.approx(0.5 * 0.0 + 0.5 * 1.0)
    # burn = (1 - min attainment) / (1 - objective) = 0.5 / 0.1
    assert s.burn_rate == pytest.approx(5.0)

    # missing telemetry neither scores nor corrupts state
    s = tr.observe("v", predicted_ttft_ms=0.0, predicted_itl_ms=0.0,
                   observed_ttft_ms=0.0, observed_itl_ms=0.0,
                   slo_ttft_ms=150.0, slo_itl_ms=12.0)
    assert s.ttft_error_ms is None
    assert s.ttft_error_ewma_ms == pytest.approx(65.0)  # unchanged

    tr.prune(set())
    assert tr.score_of("v") is None


def test_attainment_unconstrained_dimension_stays_none():
    from inferno_tpu_torch.obs import AttainmentTracker

    tr = AttainmentTracker()
    s = tr.observe("v", predicted_ttft_ms=10.0, predicted_itl_ms=10.0,
                   observed_ttft_ms=10.0, observed_itl_ms=10.0,
                   slo_ttft_ms=0.0, slo_itl_ms=20.0)  # no TTFT SLO
    assert s.ttft_attainment is None
    assert s.itl_attainment == 1.0
    assert s.burn_rate == 0.0  # fully attained on the only bound dimension


def test_model_error_gauges_gated_per_dimension():
    """A variant whose engine reports only ITL telemetry must not
    publish a 0.0 "perfect model" TTFT error gauge — each dimension's
    gauge emits only once that dimension has scored."""
    from inferno_tpu_torch.controller.metrics import AttainmentInstruments
    from inferno_tpu_torch.obs import AttainmentTracker

    tr = AttainmentTracker()
    inst = AttainmentInstruments(Registry())
    for _ in range(2):  # second observe scores ITL only
        s = tr.observe("v", predicted_ttft_ms=10.0, predicted_itl_ms=10.0,
                       observed_ttft_ms=0.0, observed_itl_ms=12.0,
                       slo_ttft_ms=100.0, slo_itl_ms=20.0)
    assert s.itl_error_scored and not s.ttft_error_scored
    inst.set_score("ns", "v", s)
    body = inst.registry.render()
    assert 'inferno_model_error_itl_ms{namespace="ns"' in body
    assert 'inferno_model_error_ttft_ms{namespace="ns"' not in body


def test_reconciler_stamps_model_error_fields_and_gauges():
    """From the second cycle on, the DecisionRecord carries observed -
    predicted model error and its EWMA, and the scoreboard gauges render
    on /metrics."""
    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    r1 = rec.run_cycle()
    (d1,) = r1.decisions
    assert d1.ttft_model_error_ms == 0.0  # nothing to score yet
    r2 = rec.run_cycle()
    (d2,) = r2.decisions
    # FakeProm telemetry is static: error = observed - cycle-1 prediction
    assert d2.ttft_model_error_ms == pytest.approx(
        d2.ttft_observed_ms - d1.ttft_predicted_ms
    )
    assert d2.itl_model_error_ms == pytest.approx(
        d2.itl_observed_ms - d1.itl_predicted_ms
    )
    assert d2.ttft_model_error_ewma_ms == pytest.approx(
        abs(d2.ttft_model_error_ms)
    )
    body = rec.emitter.registry.render()
    for name in ("inferno_model_error_ttft_ms", "inferno_model_error_itl_ms",
                 "inferno_error_budget_burn_ratio"):
        assert f'{name}{{namespace="{NS}",variant_name="llama-premium"}}' in body
    assert 'inferno_slo_attainment_ratio{dimension="itl"' in body


def test_attainment_series_pruned_with_variant():
    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    rec.run_cycle()
    rec.run_cycle()
    assert "inferno_model_error_ttft_ms{" in rec.emitter.registry.render()
    cluster._vas.clear()
    rec.run_cycle()
    body = rec.emitter.registry.render()
    assert 'variant_name="llama-premium"' not in "".join(
        ln for ln in body.splitlines()
        if ln.startswith(("inferno_model_error", "inferno_slo_attainment",
                          "inferno_error_budget_burn"))
    )
    assert rec.attainment.score_of("llama-premium:workloads") is None


def test_debug_attainment_endpoint():
    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    server = MetricsServer(
        rec.emitter.registry, port=0, attainment=rec.attainment
    )
    server.start()
    try:
        rec.run_cycle()
        rec.run_cycle()
        doc = _get_json(f"http://127.0.0.1:{server.port}/debug/attainment")
        assert doc["ewma_gain"] == pytest.approx(0.2)
        row = doc["variants"]["llama-premium:workloads"]
        assert row["scored_cycles"] == 1
        assert row["itl_attainment"] is not None
        assert row["itl_error_ewma_ms"] >= 0.0
        # without a tracker the route does not exist
        bare = MetricsServer(Registry(), port=0)
        bare.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{bare.port}/debug/attainment", timeout=10
                )
            assert exc.value.code == 404
        finally:
            bare.stop()
    finally:
        server.stop()


def test_debug_attainment_variant_filter_and_400_contract():
    """/debug/attainment gains ?variant= with the
    same 400-on-malformed contract /debug/decisions got — the
    two routes share one query-param validation helper."""
    import copy

    cluster = make_cluster(replicas=1)
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    va2 = copy.deepcopy(va)
    va2.name = "llama-second"
    cluster.add_variant_autoscaling(va2)
    cluster.add_deployment(NS, "llama-second", replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    server = MetricsServer(
        rec.emitter.registry, port=0, attainment=rec.attainment
    )
    server.start()
    try:
        rec.run_cycle()
        rec.run_cycle()
        base = f"http://127.0.0.1:{server.port}/debug/attainment"

        doc = _get_json(base)
        assert set(doc["variants"]) == {
            "llama-premium:workloads", "llama-second:workloads"
        }

        doc = _get_json(base + "?variant=llama-second:workloads")
        assert set(doc["variants"]) == {"llama-second:workloads"}
        assert doc["ewma_gain"] == pytest.approx(0.2)  # envelope intact

        # an unknown variant: empty map, mirroring the decisions route's
        # never-reported-variant semantics (not a 404)
        doc = _get_json(base + "?variant=nope:ns")
        assert doc["variants"] == {}

        for bad in ("?variant=", "?foo=1", "?cycles=2"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(base + bad, timeout=10)
            assert exc.value.code == 400, bad
            assert "error" in json.load(exc.value)
    finally:
        server.stop()


def test_debug_query_helper_shared_by_routes():
    """The validation contract itself (metrics.parse_debug_query): one
    helper serves decisions, attainment, and profile."""
    from inferno_tpu_torch.controller.metrics import _QueryError, parse_debug_query

    assert parse_debug_query(
        {"variant": "v", "cycles": "3"},
        str_params={"variant"}, int_params={"cycles"},
    ) == {"variant": "v", "cycles": 3}
    assert parse_debug_query(None, str_params={"variant"}) == {}
    with pytest.raises(_QueryError, match="unknown parameter"):
        parse_debug_query({"nope": "1"}, str_params={"variant"})
    with pytest.raises(_QueryError, match="non-empty"):
        parse_debug_query({"variant": ""}, str_params={"variant"})
    with pytest.raises(_QueryError, match="integer"):
        parse_debug_query({"cycles": "abc"}, int_params={"cycles"})
    with pytest.raises(_QueryError, match=">= 1"):
        parse_debug_query({"cycles": "0"}, int_params={"cycles"})


# -- stale-controller readiness ----------------------------------------------


def test_readyz_fails_when_reconcile_heartbeat_stale():
    flag = {"ready": True}
    hs = HealthServer(flag, port=0)
    hs.start()
    try:
        base = f"http://127.0.0.1:{hs.port}"
        # no heartbeat yet: startup is governed by `ready` alone
        assert urllib.request.urlopen(base + "/readyz", timeout=10).status == 200
        # fresh heartbeat within budget
        flag["last_cycle_monotonic"] = time.monotonic()
        flag["max_cycle_age_s"] = 5.0
        assert urllib.request.urlopen(base + "/readyz", timeout=10).status == 200
        # stale: last cycle 10s ago with a 5s budget (3x interval in prod)
        flag["last_cycle_monotonic"] = time.monotonic() - 10.0
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/readyz", timeout=10)
        assert exc.value.code == 503
        assert b"stale" in exc.value.read()
        # /healthz (liveness) stays green: staleness is a readiness signal
        assert urllib.request.urlopen(base + "/healthz", timeout=10).status == 200
    finally:
        hs.stop()


def test_reconciler_heartbeats_ready_flag():
    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    flag = {"ready": True}
    rec.ready_flag = flag
    before = time.monotonic()
    rec.run_cycle()
    assert before <= flag["last_cycle_monotonic"] <= time.monotonic()
    # 3x the ConfigMap interval (30s in make_cluster)
    assert flag["max_cycle_age_s"] == pytest.approx(90.0)


def test_nonleader_standby_heartbeats_while_idle():
    """A deposed/standby replica idles by design (gate() false) and must
    NOT trip the staleness check — run_forever refreshes the heartbeat in
    its idle branch without running cycles."""
    import threading

    cluster = make_cluster(replicas=1)
    rec = reconciler(cluster, make_prom(arrival_rps=50.0))
    flag = {"ready": True,
            "last_cycle_monotonic": time.monotonic() - 1e6,  # ancient
            "max_cycle_age_s": 5.0}
    rec.ready_flag = flag
    stop = {"v": False}
    t = threading.Thread(
        target=rec.run_forever,
        kwargs={"stop_check": lambda: stop["v"], "gate": lambda: False},
        daemon=True,
    )
    t.start()
    try:
        deadline = time.time() + 5.0
        while time.time() < deadline:
            if time.monotonic() - flag["last_cycle_monotonic"] < 60.0:
                break
            time.sleep(0.05)
        # heartbeat refreshed without any cycle having run
        assert time.monotonic() - flag["last_cycle_monotonic"] < 60.0
        assert len(rec.traces) == 0
    finally:
        stop["v"] = True
        t.join(timeout=3.0)


# -- emulator experiment trace -----------------------------------------------


def test_experiment_result_carries_trace():
    from inferno_tpu_torch.emulator.experiment import Scenario, run_scenario
    from inferno_tpu_torch.emulator.loadgen import RateSpec

    res = run_scenario(Scenario(
        name="tiny", rate=RateSpec(((0.4, 5.0),)), time_scale=0.01, runs=2,
    ))
    trace = res["trace"]
    assert trace["name"] == "scenario:tiny"
    runs = [c for c in trace["children"] if c["name"] == "run"]
    assert len(runs) == 2
    assert [c["name"] for c in runs[0]["children"]] == ["drive", "drain", "collect"]
    assert all(c["duration_ms"] >= 0 for c in runs[0]["children"])
    assert runs[0]["attrs"]["requests"] == runs[0]["attrs"]["submitted"] > 0
