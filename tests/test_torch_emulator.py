"""tests/test_emulator.py's cases on the port: loadgen -> emulated
engine -> fake scrape -> the port's reconciler (backend torch on the CPU)
-> scaling decision. Its wall-paced p95 case sits in the slow tier there;
its deterministic counterpart is
tests/test_torch_twin.py::test_e2e_p95_ttft_meets_raw_slo_under_poisson_load_twin.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller import InMemoryCluster, Reconciler, ReconcilerConfig
from inferno_tpu_torch.controller.crd import (
    ACCELERATOR_LABEL,
    AcceleratorProfile,
    ConfigMapKeyRef,
    TYPE_OPTIMIZATION_READY,
    VariantAutoscaling,
    VariantAutoscalingSpec,
)
from inferno_tpu_torch.emulator import (
    EmulatedEngine,
    EmulatorServer,
    EngineProfile,
    LoadGenerator,
    MiniProm,
    RateSpec,
)

MODEL = "emulated/llama"
NS = "workloads"
CFG_NS = "inferno-system"

# fast profile so tests run in seconds: mu(8) ~ 8/(2+0.08*8 + 15*(5+0.1*8)) ...
FAST = EngineProfile(alpha=5.0, beta=0.1, gamma=2.0, delta=0.01, max_batch=8)


def test_engine_processes_requests():
    e = EmulatedEngine(FAST)
    e.start()
    try:
        res = e.generate(in_tokens=32, out_tokens=8, timeout=10)
        assert res is not None
        assert res.ttft_ms >= 2.0  # at least prefill time
        assert res.latency_ms >= res.ttft_ms
        assert len(e.completions) == 1
    finally:
        e.stop()


def test_engine_batches_under_concurrency():
    e = EmulatedEngine(FAST)
    e.start()
    try:
        reqs = [e.submit(16, 16) for _ in range(20)]
        deadline = time.time() + 20
        for r in reqs:
            assert r.done_event.wait(max(deadline - time.time(), 0.1))
        assert len(e.completions) == 20
    finally:
        e.stop()


def test_http_server_completion_and_metrics():
    server = EmulatorServer(model_id=MODEL, profile=FAST, port=0)
    server.start()
    try:
        body = json.dumps(
            {"messages": [{"role": "user", "content": "hello world test"}],
             "max_tokens": 4}
        ).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/chat/completions",
            data=body, headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            out = json.loads(resp.read())
        assert out["usage"]["completion_tokens"] == 4
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=5
        ) as resp:
            text = resp.read().decode()
        assert f'vllm:request_success_total{{model_name="{MODEL}"}} 1' in text
        assert "vllm:time_to_first_token_seconds_sum" in text
    finally:
        server.stop()


def test_http_server_jetstream_vocabulary():
    server = EmulatorServer(model_id=MODEL, profile=FAST, engine_name="jetstream", port=0)
    server.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=5
        ) as resp:
            text = resp.read().decode()
        assert f'jetstream_request_success_count{{id="{MODEL}"}}' in text
        assert "vllm:" not in text
    finally:
        server.stop()


def _cluster_for_emulator():
    cluster = InMemoryCluster()
    cluster.set_configmap(CFG_NS, "accelerator-unit-costs", {
        "v5e-4": json.dumps({"cost": 10.0}),
    })
    cluster.set_configmap(CFG_NS, "service-classes-config", {
        "premium.yaml": (
            "name: Premium\npriority: 1\ndata:\n"
            f"  - model: {MODEL}\n    slo-ttft: 200\n    slo-tpot: 8\n"
        ),
    })
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {})
    va = VariantAutoscaling(
        name="emulated-llama",
        namespace=NS,
        labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=[
                AcceleratorProfile(
                    acc="v5e-4", acc_count=1,
                    max_batch_size=FAST.max_batch, at_tokens=16,
                    decode_parms=DecodeParms(alpha=FAST.alpha, beta=FAST.beta),
                    prefill_parms=PrefillParms(gamma=FAST.gamma, delta=FAST.delta),
                ),
            ],
        ),
    )
    cluster.add_variant_autoscaling(va)
    cluster.add_deployment(NS, "emulated-llama", replicas=1)
    return cluster


def test_e2e_scale_out_then_in():
    """Drive Poisson load at an emulated replica, reconcile, and check the
    full decision loop."""
    engine = EmulatedEngine(FAST)
    engine.start()
    # in-process MiniProm: engines' exposition scraped on a thread, queried
    # through the same PromQL-shape evaluator the sockets e2e uses
    prom_srv = MiniProm.for_engines({MODEL: [engine]}, labels={"namespace": NS})
    prom_srv.start()
    prom = prom_srv.client()
    cluster = _cluster_for_emulator()
    rec = Reconciler(
        kube=cluster, prom=prom,
        config=ReconcilerConfig(config_namespace=CFG_NS, compute_backend="torch",
                                compute_device="cpu", direct_scale=True),
    )
    try:
        # ~40 req/s of 64-token requests for 3 seconds: far beyond one
        # replica's SLO capacity (~6 req/s at the length-scaled batch) ->
        # scale-out must be requested
        gen = LoadGenerator([engine], RateSpec(phases=((3.0, 40.0),)),
                            in_tokens=16, out_tokens=64)
        gen.start()
        gen.join(20)
        time.sleep(0.5)  # let in-flight requests finish
        report = rec.run_cycle()
        assert report.errors == []
        va = cluster.get_variant_autoscaling(NS, "emulated-llama")
        assert va.status.condition(TYPE_OPTIMIZATION_READY).status == "True"
        desired_loaded = va.status.desired_optimized_alloc.num_replicas
        assert desired_loaded > 1
        # observed load is in the right ballpark (rate in req/min)
        arrival = va.status.current_alloc.load.arrival_rate
        assert arrival > 600.0  # > 10 req/s observed
        # direct actuation scaled the deployment
        deploy = cluster.get_deployment(NS, "emulated-llama")
        assert deploy["spec"]["replicas"] == desired_loaded

        # idle: clear telemetry windows (engine counters AND the scrape
        # history holding the old counter increases) -> next cycle sees
        # zero load
        engine.completions.clear()
        engine.arrivals.clear()
        prom_srv.history.clear()
        prom_srv.scrape_once()
        prom_srv.scrape_once()
        report2 = rec.run_cycle()
        assert report2.errors == []
        va2 = cluster.get_variant_autoscaling(NS, "emulated-llama")
        assert va2.status.desired_optimized_alloc.num_replicas == 1
    finally:
        prom_srv.stop()
        engine.stop()


def test_e2e_multihost_lws_scales_whole_groups():
    """A v5e-16 variant (4-host slice) is backed by a LeaderWorkerSet, not
    a Deployment: the reconciler resolves the workload, reads current
    replicas in GROUP units, and direct actuation scales groups — at no
    point is a fractional-host state (pods not a multiple of the group
    size) observable. Replaces the reference's 1-replica=1-pod assumption
    (the upstream collector.go:243-244)."""
    engine = EmulatedEngine(FAST)
    engine.start()
    prom_srv = MiniProm.for_engines({MODEL: [engine]}, labels={"namespace": NS})
    prom_srv.start()

    cluster = InMemoryCluster()
    cluster.set_configmap(CFG_NS, "accelerator-unit-costs", {
        "v5e-16": json.dumps({"cost": 10.0}),
    })
    cluster.set_configmap(CFG_NS, "service-classes-config", {
        "premium.yaml": (
            "name: Premium\npriority: 1\ndata:\n"
            f"  - model: {MODEL}\n    slo-ttft: 200\n    slo-tpot: 8\n"
        ),
    })
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {})
    va = VariantAutoscaling(
        name="emulated-llama-16",
        namespace=NS,
        labels={ACCELERATOR_LABEL: "v5e-16"},
        spec=VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=[
                AcceleratorProfile(
                    acc="v5e-16", acc_count=1,
                    max_batch_size=FAST.max_batch, at_tokens=16,
                    decode_parms=DecodeParms(alpha=FAST.alpha, beta=FAST.beta),
                    prefill_parms=PrefillParms(gamma=FAST.gamma, delta=FAST.delta),
                ),
            ],
        ),
    )
    cluster.add_variant_autoscaling(va)
    # v5e-16 = 16 chips / 4 chips-per-host = 4 pods per group; 1 group now
    cluster.add_leader_worker_set(NS, "emulated-llama-16", replicas=1, size=4)

    rec = Reconciler(
        kube=cluster, prom=prom_srv.client(),
        config=ReconcilerConfig(config_namespace=CFG_NS, compute_backend="torch",
                                compute_device="cpu", direct_scale=True),
    )
    try:
        gen = LoadGenerator([engine], RateSpec(phases=((3.0, 40.0),)),
                            in_tokens=16, out_tokens=64)
        gen.start()
        gen.join(20)
        time.sleep(0.5)
        report = rec.run_cycle()
        assert report.errors == []
        va = cluster.get_variant_autoscaling(NS, "emulated-llama-16")
        # current replicas were read in GROUP units (1 group, not 4 pods)
        assert va.status.current_alloc.num_replicas == 1
        desired = va.status.desired_optimized_alloc.num_replicas
        assert desired > 1
        # direct actuation scaled the LWS in whole groups
        lws = cluster.get_leader_worker_set(NS, "emulated-llama-16")
        assert lws["spec"]["replicas"] == desired
        # no fractional-host state: observable pods are exactly groups x 4
        assert cluster.pod_count(NS, "emulated-llama-16") == desired * 4
        # owner-ref targets the LWS kind for GC
        kinds = {r.get("kind") for r in va.owner_references}
        assert kinds == {"LeaderWorkerSet"}
    finally:
        prom_srv.stop()
        engine.stop()


def test_loadgen_token_distributions_reach_engine():
    """LoadGenerator's in_dist/out_dist plumbing: heavy-tailed lognormal
    lengths must arrive at the engine as submitted — prompt lengths vary,
    spread far beyond the median, and respect the clamp."""
    from inferno_tpu_torch.emulator import SHAREGPT_INPUT, SHAREGPT_OUTPUT

    engine = EmulatedEngine(
        EngineProfile(alpha=0.5, beta=0.01, gamma=0.2, delta=0.0005, max_batch=64),
        time_scale=0.002,
    )
    engine.start()
    try:
        gen = LoadGenerator([engine], RateSpec(phases=((1.5, 80.0),)),
                            in_dist=SHAREGPT_INPUT, out_dist=SHAREGPT_OUTPUT,
                            seed=11)
        gen.start()
        gen.join(20)
        time.sleep(1.5)
        comps = [r for _, r in engine.completions]
        assert len(comps) >= 60
        ins = sorted(c.in_tokens for c in comps)
        outs = [c.out_tokens for c in comps]
        med = ins[len(ins) // 2]
        assert len(set(ins)) > 10  # actually sampled, not a constant
        assert ins[-1] > 3 * med  # lognormal right tail
        assert ins[-1] <= SHAREGPT_INPUT.max_tokens
        assert max(outs) <= SHAREGPT_OUTPUT.max_tokens
        assert min(ins) >= 1 and min(outs) >= 1
    finally:
        engine.stop()


def test_e2e_observed_itl_matches_profile():
    """Closed loop sanity: emulated ITL should track alpha + beta*batch."""
    engine = EmulatedEngine(FAST)
    engine.start()
    try:
        reqs = [engine.submit(16, 32) for _ in range(FAST.max_batch)]
        for r in reqs:
            assert r.done_event.wait(30)
        comps = [r for _, r in engine.completions]
        # VIRTUAL timings: wall-clock ones inflate arbitrarily when the
        # host is loaded (e.g. the full suite running alongside a bench),
        # which is scheduler noise, not emulator behavior
        itl = sum(
            (c.latency_emu_ms - c.ttft_emu_ms) / max(c.out_tokens - 1, 1)
            for c in comps
        ) / len(comps)
        # full batch of 8: expected decode step ~ alpha + beta*8 = 5.8 ms
        assert itl == pytest.approx(5.8, rel=0.5)
    finally:
        engine.stop()


def test_http_server_edge_cases():
    """HTTP surface robustness: malformed JSON -> 400, unknown paths ->
    404, health endpoints, usage accounting in the completion body."""
    srv = EmulatorServer(model_id=MODEL, profile=FAST, time_scale=0.002)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        # health endpoints
        for path in ("/health", "/healthz"):
            with urllib.request.urlopen(base + path, timeout=5) as r:
                assert r.read() == b"ok"
        # unknown GET and POST paths
        for method, path in (("GET", "/nope"), ("POST", "/v1/completions")):
            req = urllib.request.Request(base + path, method=method,
                                         data=b"{}" if method == "POST" else None)
            try:
                urllib.request.urlopen(req, timeout=5)
                raise AssertionError("expected 404")
            except urllib.error.HTTPError as e:
                assert e.code == 404
        # malformed body -> 400
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=b"{not json",
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=5)
            raise AssertionError("expected 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
        # empty body falls back to defaults and still completes
        req = urllib.request.Request(base + "/v1/chat/completions", data=b"")
        with urllib.request.urlopen(req, timeout=30) as r:
            doc = json.loads(r.read())
        assert doc["usage"]["prompt_tokens"] >= 1
        assert doc["usage"]["completion_tokens"] == 64  # default max_tokens
        assert doc["model"] == MODEL
        # explicit token counts are echoed in usage
        body = json.dumps({"messages": [{"role": "user", "content": "a b c d"}],
                           "max_tokens": 7}).encode()
        req = urllib.request.Request(base + "/v1/chat/completions", data=body)
        with urllib.request.urlopen(req, timeout=30) as r:
            doc = json.loads(r.read())
        assert doc["usage"] == {"prompt_tokens": 4, "completion_tokens": 7,
                                "total_tokens": 11}
    finally:
        srv.stop()
