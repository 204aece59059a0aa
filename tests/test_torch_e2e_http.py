"""Sockets-level e2e on the port: emulated engine HTTP server -> MiniProm
scrape -> HttpPromClient -> full reconcile cycles -> direct-scale
actuation.

The hardware-free analogue of the reference's Kind e2e scenario
(upstream test/e2e/e2e_test.go:341-563): drive real HTTP load at an
emulated engine, let a real scrape+query pipeline observe it, and assert
the controller scales the variant out under load and back in at idle,
with CR status matching the emitted gauges.

Port of tests/test_e2e_http.py on the port's controller, emulator and
fixtures: the reference's backend "tpu" is "torch" on the CPU here, and
every Reconciler gets `compute_device="cpu"`. MiniProm is scraped by hand
(no scrape thread, no wall-clock waits for a scrape or a rate window): a
scrape after the load, and idle is MiniProm's clock stepped past its
window. Added: one `run_cycle` of the reference's and the port's
Reconciler over RestKubeClient, each against its own MiniApiServer with
the same fake Prometheus rows, lands the same VA status, /scale and
/metrics gauges. The two MiniProm-over-HTTP cases of
tests/test_fleet_cycle.py (the 50-variant query budget, the POST path)
live here too.
"""

import json
import math
import re
import threading
import urllib.request

import pytest

from inferno_tpu_torch.controller.engines import (
    LABEL_ACCELERATOR,
    LABEL_OUT_NAMESPACE,
    LABEL_VARIANT,
)
from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.emulator.engine import EngineProfile
from inferno_tpu_torch.emulator.miniprom import parse_exposition
from inferno_tpu_torch.emulator.server import EmulatorServer

from test_torch_apiserver import (  # noqa: F401 (e2e_stack, prom_clock: fixtures)
    CFG_NS,
    E2E_TIME_SCALE as TIME_SCALE,
    MODEL,
    NS,
    e2e_stack,
    go_idle,
    hand_prom,
    make_cluster,
    make_e2e_stack,
    post_load as _post_load,
    prom_clock,
)

FREE_MODEL = "other/model"


def test_scale_out_under_load_and_in_at_idle(e2e_stack, prom_clock):
    srv, prom, cluster, rec = e2e_stack

    # -- phase 1: sustained load -> scale out -------------------------------
    _post_load(srv.port, duration_s=2.0)
    prom.scrape_once()  # the scraper observes the final counters

    report = rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    cond = va.status.condition("MetricsAvailable")
    assert cond is not None and cond.status == "True", cond
    desired = va.status.desired_optimized_alloc.num_replicas
    assert desired > 1, (desired, report)
    assert va.status.current_alloc.load.arrival_rate > 0

    # direct-scale actuation applied to the Deployment
    deploy = cluster.get_deployment(NS, "llama-premium")
    assert deploy["spec"]["replicas"] == desired

    # CR status matches the emitted gauges (the reference e2e's key
    # assertion, test/e2e/e2e_test.go:341-437)
    labels = {
        LABEL_OUT_NAMESPACE: NS,
        LABEL_VARIANT: "llama-premium",
        LABEL_ACCELERATOR: "v5e-4",
    }
    assert rec.emitter.desired_replicas.get(labels) == float(desired)

    # -- phase 2: idle past the rate window -> scale back to min ------------
    go_idle(prom, prom_clock)
    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    assert va.status.desired_optimized_alloc.num_replicas == 1


def test_scale_out_through_torch_fleet_path(e2e_stack):
    """The same sockets e2e with compute_backend="torch": the batched
    fleet path (the plain versions of the kernels, on the CPU; not the
    scalar loop) sizes the candidates inside a full collector -> sizing ->
    solver -> actuation cycle. Catches integration-level drift the
    lane-by-lane unit parity tests cannot."""
    srv, prom, cluster, _ = e2e_stack
    rec = Reconciler(
        kube=cluster,
        prom=HttpPromClient(PromConfig(base_url=prom.url, allow_http=True)),
        config=ReconcilerConfig(
            config_namespace=CFG_NS, compute_backend="torch",
            compute_device="cpu", direct_scale=True,
        ),
    )
    _post_load(srv.port, duration_s=2.0)
    prom.scrape_once()
    report = rec.run_cycle()
    assert report.errors == []
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    desired = va.status.desired_optimized_alloc.num_replicas
    assert desired > 1, (desired, report)
    assert cluster.get_deployment(NS, "llama-premium")["spec"]["replicas"] == desired


def _add_freemium_variant(cluster):
    """Second variant: same engine profile, Freemium class (priority 10)."""
    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
    from inferno_tpu_torch.controller.crd import (
        ACCELERATOR_LABEL,
        AcceleratorProfile,
        ConfigMapKeyRef,
        VariantAutoscaling,
        VariantAutoscalingSpec,
    )

    cluster.set_configmap(CFG_NS, "service-classes-config", {
        "premium.yaml": (
            "name: Premium\npriority: 1\ndata:\n"
            f"  - model: {MODEL}\n    slo-ttft: 500\n    slo-tpot: 24\n"
        ),
        "freemium.yaml": (
            "name: Freemium\npriority: 10\ndata:\n"
            f"  - model: {FREE_MODEL}\n    slo-ttft: 500\n    slo-tpot: 24\n"
        ),
    })
    va = VariantAutoscaling(
        name="llama-freemium",
        namespace=NS,
        labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=FREE_MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Freemium"),
            accelerators=[
                AcceleratorProfile(
                    acc="v5e-4", acc_count=1, max_batch_size=64, at_tokens=128,
                    decode_parms=DecodeParms(alpha=18.0, beta=0.3),
                    prefill_parms=PrefillParms(gamma=5.0, delta=0.02),
                ),
            ],
        ),
    )
    cluster.add_variant_autoscaling(va)
    cluster.add_deployment(NS, "llama-freemium", replicas=1)


def test_multi_va_priority_contention_limited_capacity():
    """The reference's second e2e scenario
    (upstream test/e2e/e2e_test.go:698-1130): two variants with distinct
    service classes share capacity. Under unlimited capacity both scale
    out; when the chip pool is then capped to exactly the Premium
    variant's demand, the greedy solver gives priority-1 Premium its full
    allocation through the whole collector -> fleet sizing -> greedy ->
    actuation loop, and priority-10 Freemium is squeezed out."""
    premium_srv = EmulatorServer(
        model_id=MODEL,
        profile=EngineProfile(alpha=18.0, beta=0.3, gamma=5.0, delta=0.02, max_batch=64),
        time_scale=TIME_SCALE,
    )
    free_srv = EmulatorServer(
        model_id=FREE_MODEL,
        profile=EngineProfile(alpha=18.0, beta=0.3, gamma=5.0, delta=0.02, max_batch=64),
        time_scale=TIME_SCALE,
    )
    premium_srv.start()
    free_srv.start()
    prom = hand_prom([
        (f"http://127.0.0.1:{premium_srv.port}/metrics", {"namespace": NS}),
        (f"http://127.0.0.1:{free_srv.port}/metrics", {"namespace": NS}),
    ])
    cluster = make_cluster(replicas=1)
    _add_freemium_variant(cluster)
    rec = Reconciler(
        kube=cluster,
        prom=HttpPromClient(PromConfig(base_url=prom.url, allow_http=True)),
        config=ReconcilerConfig(
            config_namespace=CFG_NS, compute_backend="torch",
            compute_device="cpu", direct_scale=True,
        ),
    )
    try:
        # load both variants together, then scrape once: the hand-scraped
        # MiniProm holds the observed rates still across BOTH cycles
        t1 = threading.Thread(target=_post_load, args=(premium_srv.port, 2.0))
        t2 = threading.Thread(target=_post_load,
                              args=(free_srv.port, 2.0, 6, FREE_MODEL))
        t1.start(); t2.start()
        t1.join(); t2.join()
        prom.scrape_once()

        # cycle A: unlimited capacity — both scale out
        report = rec.run_cycle()
        assert report.errors == []
        premium = cluster.get_variant_autoscaling(NS, "llama-premium")
        freemium = cluster.get_variant_autoscaling(NS, "llama-freemium")
        p_want = premium.status.desired_optimized_alloc.num_replicas
        f_want = freemium.status.desired_optimized_alloc.num_replicas
        assert p_want > 1 and f_want > 1, (p_want, f_want)

        # cycle B (same load): capacity = exactly Premium's cycle-A demand
        # in chips (v5e-4 -> 4 chips per replica)
        cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
            "GLOBAL_OPT_INTERVAL": "30s",
            "OPTIMIZER_MODE": "limited",
            "TPU_CAPACITY": json.dumps({"v5e": 4 * p_want}),
        })
        report = rec.run_cycle()
        assert report.errors == []
        premium = cluster.get_variant_autoscaling(NS, "llama-premium")
        freemium = cluster.get_variant_autoscaling(NS, "llama-freemium")
        p_got = premium.status.desired_optimized_alloc.num_replicas
        f_got = freemium.status.desired_optimized_alloc.num_replicas
        # priority 1 wins the contention: Premium keeps scale-out, Freemium
        # is squeezed to the no-scale-to-zero floor of 1 (keeping its
        # metric series alive for recovery) or the leftover chips
        assert p_got > 1, (p_got, p_want)
        assert p_got > f_got, (p_got, f_got)
        assert f_got <= max(1, p_want - p_got), (p_got, f_got, p_want)
        assert f_got < f_want, (f_got, f_want)
    finally:
        prom.stop()
        premium_srv.stop()
        free_srv.stop()


def test_collector_fallback_without_namespace_label(e2e_stack):
    """A scrape without target relabeling exposes model_name but no
    namespace label: the collector's namespaced validation query returns
    empty and the namespace-less fallback must carry
    (reference collector.go:113-137)."""
    srv, _, cluster, rec = e2e_stack
    bare = hand_prom([f"http://127.0.0.1:{srv.port}/metrics"])
    try:
        rec.prom = HttpPromClient(PromConfig(base_url=bare.url, allow_http=True))
        _post_load(srv.port, duration_s=0.8, concurrency=2)
        bare.scrape_once()
        rec.run_cycle()
        va = cluster.get_variant_autoscaling(NS, "llama-premium")
        cond = va.status.condition("MetricsAvailable")
        assert cond is not None and cond.status == "True"
    finally:
        bare.stop()


def test_miniprom_wire_format(e2e_stack):
    """HttpPromClient parses MiniProm's JSON exactly as it would a real
    Prometheus response."""
    srv, prom, cluster, rec = e2e_stack
    _post_load(srv.port, duration_s=0.6, concurrency=2)
    prom.scrape_once()
    client = HttpPromClient(PromConfig(base_url=prom.url, allow_http=True))
    assert client.healthy()
    samples = client.query(f'vllm:num_requests_running{{model_name="{MODEL}"}}')
    assert samples and samples[0].labels.get("model_name") == MODEL
    rate = client.query(f'sum(rate(vllm:request_success_total{{model_name="{MODEL}"}}[1m]))')
    assert rate and rate[0].value > 0


def test_exposition_parser():
    text = (
        "# HELP x help\n# TYPE x counter\n"
        'x{a="1",b="two"} 3.5\n'
        "plain 7\n"
        "bad line\n"
        'inf_val{c="d"} +Inf\n'
    )
    series = parse_exposition(text)
    assert ("x", {"a": "1", "b": "two"}, 3.5) in series
    assert ("plain", {}, 7.0) in series


def test_shape_pinning_and_economic_migration():
    """Heterogeneous slice economics through the full loop. Default
    (KEEP_ACCELERATOR=true, reference-exact pin of utils.go:290): the
    variant scales out on its current shape even when another shape is
    far cheaper for the load. With the pin off, the optimizer MIGRATES
    the variant to v5e-16 — whose barely-SLO-feasible little sibling
    serves ~1/50th the rate at 1/4 the price — and returns to the cheap
    shape at idle (the transition penalty shapes the objective but never
    outweighs a 4x running-cost gap)."""
    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
    from inferno_tpu_torch.controller.crd import (
        ACCELERATOR_LABEL,
        AcceleratorProfile,
        ConfigMapKeyRef,
        VariantAutoscaling,
        VariantAutoscalingSpec,
    )
    from test_torch_apiserver import make_prom

    cluster = make_cluster(replicas=1)
    cluster.delete_variant_autoscaling(NS, "llama-premium")
    va = VariantAutoscaling(
        name="llama-premium",
        namespace=NS,
        labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=[
                AcceleratorProfile(
                    acc="v5e-4", acc_count=1, max_batch_size=64, at_tokens=128,
                    decode_parms=DecodeParms(alpha=23.5, beta=0.3),
                    prefill_parms=PrefillParms(gamma=5.0, delta=0.02),
                ),
                AcceleratorProfile(
                    acc="v5e-16", acc_count=1, max_batch_size=128, at_tokens=128,
                    decode_parms=DecodeParms(alpha=4.0, beta=0.05),
                    prefill_parms=PrefillParms(gamma=2.0, delta=0.005),
                ),
            ],
        ),
    )
    cluster.add_variant_autoscaling(va)

    # -- default: reference-exact pin ---------------------------------------
    rec = Reconciler(
        kube=cluster,
        prom=make_prom(arrival_rps=20.0, out_tok=128.0),
        config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS, compute_backend="scalar"),
    )
    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    pinned = va.status.desired_optimized_alloc
    assert pinned.accelerator == "v5e-4"  # pinned despite 50x cheaper rates
    assert pinned.num_replicas > 10  # ...paying for it in replicas

    # -- KEEP_ACCELERATOR=false: economic migration -------------------------
    rec = Reconciler(
        kube=cluster,
        prom=make_prom(arrival_rps=20.0, out_tok=128.0),
        config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS, compute_backend="scalar",
                                keep_accelerator=False),
    )
    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    moved = va.status.desired_optimized_alloc
    assert moved.accelerator == "v5e-16", moved
    assert moved.num_replicas < pinned.num_replicas

    # load gone: back to the cheap shape
    rec.prom = make_prom(arrival_rps=0.0)
    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    assert va.status.desired_optimized_alloc.accelerator == "v5e-4"


def test_jetstream_engine_full_cycle_over_sockets():
    """The JetStream metric vocabulary end to end: emulated engine
    exposing jetstream_* series -> MiniProm scrape -> collector queries in
    the jetstream vocabulary (SERVING_ENGINE=jetstream) -> scale-out.
    Pins that the engine-pluggable path works over real sockets, not just
    in exposition unit tests."""
    srv, prom, cluster, rec, teardown = make_e2e_stack(engine="jetstream")
    try:
        _post_load(srv.port, duration_s=2.0)
        prom.scrape_once()
        report = rec.run_cycle()
        assert report.errors == []
        va = cluster.get_variant_autoscaling(NS, "llama-premium")
        cond = va.status.condition("MetricsAvailable")
        assert cond is not None and cond.status == "True", cond
        desired = va.status.desired_optimized_alloc.num_replicas
        assert desired > 1, (desired, report)
        # max batch came from the engine-reported jetstream_total_slots
        assert va.status.current_alloc.max_batch == 64
    finally:
        teardown()


# -- the same decisions: the reference's and the port's Reconciler over
#    RestKubeClient, each against its own MiniApiServer -----------------------

PARITY_N = 6
PARITY_RPS = (0.5, 3.0, 8.0, 20.0, 45.0, 90.0)
ACTUATION_SERIES = (
    "inferno_desired_replicas", "inferno_current_replicas",
    "inferno_desired_ratio",
)


def _parity_rows(fix) -> dict:
    return {
        (fix.fleet_model(i), NS): {
            "running": 3.0, "arrival_rps": PARITY_RPS[i], "in_tokens": 256.0,
            "out_tokens": 96.0, "ttft_s": 0.05, "itl_s": 0.02, "max_batch": 64.0,
        }
        for i in range(PARITY_N)
    }


def _seed_parity(server, fix) -> None:
    from test_torch_apiserver import add_deployment, make_va_doc, post

    entries = "".join(
        f"  - model: {fix.fleet_model(i)}\n    slo-ttft: 500\n    slo-tpot: 24\n"
        for i in range(PARITY_N)
    )
    for name, data in (
        ("accelerator-unit-costs", {"v5e-4": json.dumps({"cost": 10.0})}),
        ("service-classes-config",
         {"premium.yaml": f"name: Premium\npriority: 1\ndata:\n{entries}"}),
        ("inferno-autoscaler-config", {"GLOBAL_OPT_INTERVAL": "30s"}),
    ):
        post(server, f"/api/v1/namespaces/{CFG_NS}/configmaps",
             {"metadata": {"name": name, "namespace": CFG_NS}, "data": data})
    for i in range(PARITY_N):
        post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
             make_va_doc(name=fix.fleet_variant(i), model=fix.fleet_model(i)))
        add_deployment(server, NS, fix.fleet_variant(i), replicas=1 + i % 3)


def _one_cycle_over_sockets(pkg: str, backend: str) -> dict:
    """One run_cycle of `pkg`'s Reconciler over its RestKubeClient against
    its own MiniApiServer, with its MetricsServer serving the gauges;
    returns what landed on the wire."""
    if pkg == "ref":
        from inferno_tpu.controller import kube, metrics, reconciler
        from inferno_tpu.testing import MiniApiServer, fleet as fix

        extra = {}
    else:
        from inferno_tpu_torch.controller import kube, metrics, reconciler
        from inferno_tpu_torch.testing import MiniApiServer, fleet as fix

        extra = {"compute_device": "cpu"}
    server = MiniApiServer().start()
    emitter = metrics.MetricsEmitter()
    metrics_srv = metrics.MetricsServer(emitter.registry, port=0, host="127.0.0.1")
    metrics_srv.start()
    try:
        _seed_parity(server, fix)
        client = kube.RestKubeClient(base_url=server.url, token="", namespace=CFG_NS)
        rec = reconciler.Reconciler(
            kube=client, prom=fix.fleet_fake_prom(_parity_rows(fix)),
            config=reconciler.ReconcilerConfig(
                config_namespace=CFG_NS, compute_backend=backend,
                direct_scale=True, **extra,
            ),
            emitter=emitter,
        )
        report = rec.run_cycle()
        assert report.errors == [], report.errors
        out = {"status": {}, "scale": {}, "gauges": {}}
        base = server.url + f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings"
        for i in range(PARITY_N):
            name = fix.fleet_variant(i)
            status = json.loads(urllib.request.urlopen(f"{base}/{name}").read())["status"]
            status["desiredOptimizedAlloc"].pop("lastRunTime", None)
            for cond in status.get("conditions", []):
                cond.pop("lastTransitionTime", None)
            out["status"][name] = status
            scale = json.loads(urllib.request.urlopen(
                f"{server.url}/apis/apps/v1/namespaces/{NS}/deployments/{name}/scale"
            ).read())
            out["scale"][name] = scale["spec"]["replicas"]
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{metrics_srv.port}/metrics").read().decode()
        for line in text.splitlines():
            if line.startswith(ACTUATION_SERIES):
                key, _, value = line.rpartition(" ")
                out["gauges"][key] = float(value)
        rec.close()
        return out
    finally:
        metrics_srv.stop()
        server.stop()


def _variant_of(gauge_key: str) -> str:
    return re.search(r'variant_name="([^"]+)"', gauge_key).group(1)


@pytest.mark.parametrize("ref_backend,port_backend",
                         [("scalar", "scalar"), ("jax", "torch")])
def test_reference_and_port_decide_alike_over_sockets(ref_backend, port_backend):
    """The same decisions on the wire: the VA status each controller wrote
    to its apiserver, each Deployment's /scale and the /metrics gauges
    agree under the round's rule — replicas exactly, or ±1 where the two
    batched solves sit on a ceil boundary (never for scalar vs scalar)."""
    from inferno_tpu.parallel import fleet as r_fleet
    from inferno_tpu_torch.parallel import fleet as p_fleet

    r_fleet.reset_fleet_state()
    p_fleet.reset_fleet_state()
    ref = _one_cycle_over_sockets("ref", ref_backend)
    port = _one_cycle_over_sockets("port", port_backend)
    slack = 0 if port_backend == "scalar" else 1
    boundary = set()
    assert set(ref["status"]) == set(port["status"])
    for name, a in ref["status"].items():
        b = port["status"][name]
        da, db = a["desiredOptimizedAlloc"], b["desiredOptimizedAlloc"]
        assert abs(da["numReplicas"] - db["numReplicas"]) <= slack, (name, da, db)
        if da["numReplicas"] != db["numReplicas"]:
            boundary.add(name)
            da, db = dict(da), dict(db)
            da.pop("numReplicas"), db.pop("numReplicas")
        assert da == db, name
        assert {k: v for k, v in a.items() if k != "desiredOptimizedAlloc"} == {
            k: v for k, v in b.items() if k != "desiredOptimizedAlloc"}, name
        assert ref["scale"][name] == a["desiredOptimizedAlloc"]["numReplicas"]
        assert port["scale"][name] == b["desiredOptimizedAlloc"]["numReplicas"]
    assert len(boundary) <= 1, boundary
    assert set(ref["gauges"]) == set(port["gauges"])
    for key, va in ref["gauges"].items():
        vb = port["gauges"][key]
        if _variant_of(key) in boundary:
            assert abs(va - vb) <= 1.0, (key, va, vb)
        else:
            assert math.isclose(va, vb, rel_tol=1e-12), (key, va, vb)
    scaled = [n for n, r in port["scale"].items() if r > 1]
    assert len(scaled) >= 3, port["scale"]  # the loads really moved replicas


# -- the fleet cycle over MiniProm HTTP (tests/test_fleet_cycle.py:411-475) ---


def test_query_budget_50_variant_miniprom_cycle():
    """The regression guard: a 50-variant MiniProm-backed cycle, over
    HTTP, must stay within a fixed query budget (~Q grouped queries, zero
    per-variant fallback), not drift back toward Q x V (300+)."""
    from inferno_tpu_torch.testing.fleet import FLEET_NS, fleet_cluster, fleet_targets

    n = 50
    cluster = fleet_cluster(n)
    # the targets' counters advance with wall time at the requested rate,
    # so two back-to-back scrapes already read it
    prom = hand_prom([(t, {"namespace": FLEET_NS}) for t in fleet_targets(n)])
    try:
        prom.scrape_once()
        rec = Reconciler(
            kube=cluster,
            prom=HttpPromClient(PromConfig(base_url=prom.url, allow_http=True)),
            config=ReconcilerConfig(config_namespace=CFG_NS, compute_backend="scalar",
                                    compute_device="cpu"),
        )
        report = rec.run_cycle()
        assert report.errors == []
        assert report.variants_applied == n
        QUERY_BUDGET = 10  # 7 grouped today; headroom for one new metric
        assert report.prom_queries <= QUERY_BUDGET, (
            f"cycle issued {report.prom_queries} queries for {n} variants "
            f"(budget {QUERY_BUDGET}); the coalesced path regressed"
        )
    finally:
        prom.stop()


def test_miniprom_http_answers_grouped_queries_via_post():
    """HttpPromClient sends oversized queries as form-encoded POST;
    MiniProm's HTTP endpoint answers both verbs from the same evaluator
    (the 200-variant selector of chip_smoke.py rides the POST path)."""
    from inferno_tpu_torch.controller.collector import grouped_queries
    from inferno_tpu_torch.controller.engines import engine_for
    from inferno_tpu_torch.testing.fleet import FLEET_NS, fleet_model, fleet_targets

    n = 4
    prom = hand_prom([(t, {"namespace": FLEET_NS}) for t in fleet_targets(n)])
    try:
        prom.scrape_once()
        client = HttpPromClient(PromConfig(base_url=prom.url, allow_http=True))
        q = grouped_queries(
            engine_for("vllm-tpu"),
            {(fleet_model(i), FLEET_NS) for i in range(n)},
        )["running"]
        via_get = client.query(q)
        assert len(via_get) == n
        client._POST_THRESHOLD = 0  # force every query onto the POST path
        via_post = client.query(q)
        assert sorted((s.labels["model_name"], s.value) for s in via_post) \
            == sorted((s.labels["model_name"], s.value) for s in via_get)
    finally:
        prom.stop()
