"""The production actuation contract, closed: `direct_scale=false`, the
controller only EMITS gauges, and the workload is scaled by the external
chain — real /metrics exposition -> MiniProm scrape over sockets ->
prometheus-adapter external-metrics rule -> HPA v2 replica arithmetic ->
kube /scale subresource over real HTTP.

The reference's primary e2e asserts exactly this path on a Kind cluster
(upstream test/e2e/e2e_test.go:341-517 with
config/samples/prometheus-adapter-values.yaml); every earlier closed loop
here used direct_scale=true.

Port of tests/test_e2e_hpa.py on the port's controller and its
`testing.hpa` actuators; every Reconciler gets `compute_device="cpu"`.
MiniProm is scraped by hand after each controller cycle (the reference
polls a scrape thread) and the HPA's stabilization window runs on its
injected `now` clock. Added: one sequence of metric values and clock
times through both packages' HpaEmulator and KedaScaledObject gives the
same replicas step by step.
"""

import pytest

from inferno_tpu_torch.controller.kube import RestKubeClient
from inferno_tpu_torch.controller.metrics import MetricsEmitter, MetricsServer
from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.testing.apiserver import MiniApiServer
from inferno_tpu_torch.testing.hpa import ExternalMetricsAdapter, HpaEmulator

from test_torch_apiserver import (
    CFG_NS,
    NS,
    add_deployment,
    hand_prom,
    make_prom,
    make_va_doc,
    post,
    seed_config,
)

VARIANT = "llama-premium"


@pytest.fixture()
def stack():
    """MiniApiServer + controller metrics endpoint + MiniProm scraping it
    + the adapter/HPA pair pointed at the Deployment."""
    api = MiniApiServer().start()
    emitter = MetricsEmitter()
    metrics_srv = MetricsServer(emitter.registry, port=0, host="127.0.0.1")
    metrics_srv.start()
    prom = hand_prom([f"http://127.0.0.1:{metrics_srv.port}/metrics"])
    try:
        kube = RestKubeClient(base_url=api.url, token="", namespace=CFG_NS)
        adapter_client = HttpPromClient(
            PromConfig(base_url=prom.url, allow_http=True))
        adapter = ExternalMetricsAdapter(prom=adapter_client)
        hpa = HpaEmulator(kube=kube, adapter=adapter, namespace=NS,
                          name=VARIANT, min_replicas=1, max_replicas=32)
        yield api, kube, emitter, prom, hpa
    finally:
        prom.stop()
        metrics_srv.stop()
        api.stop()


def reconcile_once(kube, emitter, arrival_rps):
    rec = Reconciler(
        kube=kube, prom=make_prom(arrival_rps=arrival_rps),
        config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS,
                                compute_backend="scalar",
                                direct_scale=False),
        emitter=emitter,
    )
    report = rec.run_cycle()
    assert report.errors == [], report.errors
    return report


def scrape_and_check(prom, predicate):
    """Scrape the controller's fresh exposition by hand; the emitted
    gauges must then be visible to queries."""
    prom.scrape_once()
    assert predicate(), "the scrape did not surface the expected gauges"


def test_hpa_scales_workload_from_emitted_gauges(stack):
    api, kube, emitter, prom, hpa = stack
    seed_config(api)
    post(api, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
         make_va_doc())
    add_deployment(api, NS, VARIANT, replicas=1)

    # heavy load -> the controller computes desired > 1 but must NOT
    # touch the Deployment itself (direct_scale=false)
    reconcile_once(kube, emitter, arrival_rps=50.0)
    va = kube.get_variant_autoscaling(NS, VARIANT)
    desired = va.status.desired_optimized_alloc.num_replicas
    assert desired > 1
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == 1

    # the adapter reads the REAL exposition through a real scrape; the
    # HPA arithmetic (ceil(metric / averageValue=1)) enacts the gauge
    scrape_and_check(prom, lambda: hpa.adapter.get_metric(
        {"variant_name": VARIANT, "namespace": NS}) is not None)
    applied = hpa.step()
    assert applied == desired == hpa.last_metric
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == desired

    # next controller cycle observes the HPA-scaled replicas as current
    reconcile_once(kube, emitter, arrival_rps=50.0)
    va = kube.get_variant_autoscaling(NS, VARIANT)
    assert va.status.current_alloc.num_replicas == desired


def test_hpa_scale_down_respects_stabilization_window(stack):
    api, kube, emitter, prom, hpa = stack
    seed_config(api)
    post(api, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
         make_va_doc())
    add_deployment(api, NS, VARIANT, replicas=1)

    clock = {"t": 1000.0}
    hpa.now = lambda: clock["t"]
    hpa.scale_down_stabilization_s = 120.0  # the sample policy's value

    reconcile_once(kube, emitter, arrival_rps=50.0)
    va = kube.get_variant_autoscaling(NS, VARIANT)
    high = va.status.desired_optimized_alloc.num_replicas
    scrape_and_check(prom, lambda: hpa.adapter.get_metric(
        {"variant_name": VARIANT, "namespace": NS}) is not None)
    assert hpa.step() == high

    # load vanishes; the controller recommends the floor — but within
    # the stabilization window HPA must hold the high watermark
    reconcile_once(kube, emitter, arrival_rps=0.05)
    scrape_and_check(prom, lambda: hpa.adapter.get_metric(
        {"variant_name": VARIANT, "namespace": NS}) == 1.0)
    clock["t"] += 60.0
    assert hpa.step() == high
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == high

    # after the window elapses the down-recommendation wins
    clock["t"] += 121.0
    assert hpa.step() == 1
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == 1


def test_hpa_no_metric_means_no_action(stack):
    api, kube, emitter, prom, hpa = stack
    seed_config(api)
    add_deployment(api, NS, VARIANT, replicas=3)
    # no reconcile ran, so no gauge series exists: HPA must not move the
    # workload (FailedGetExternalMetric semantics, not scale-to-min)
    assert hpa.step() is None
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == 3


# -- the same actuator: both packages' HpaEmulator and KedaScaledObject -------


class _ScriptedProm:
    """A PromClient whose answer is set per step: a value, None (no
    series), or "fail" (the query raises)."""

    def __init__(self):
        self.value = None

    def query(self, promql: str):
        if self.value == "fail":
            raise OSError("prometheus unreachable")
        if self.value is None:
            return []
        return [type("S", (), {"value": float(self.value)})()]


def _script(seed: int, steps: int = 60) -> list:
    """(clock seconds, metric) per step, made from `seed` with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    values = [None, "fail", 0.0, 0.0, 0.4, 1.0, 2.5, 7.0, 12.0, 40.0]
    t = 1000.0
    out = []
    for _ in range(steps):
        t += float(rng.choice([5.0, 15.0, 35.0, 70.0, 130.0]))
        out.append((t, values[int(rng.integers(len(values)))]))
    return out


def _drive(pkg: str, script: list) -> list:
    if pkg == "ref":
        from inferno_tpu.controller.kube import InMemoryCluster
        from inferno_tpu.testing import hpa
    else:
        from inferno_tpu_torch.controller.kube import InMemoryCluster
        from inferno_tpu_torch.testing import hpa
    clock = {"t": 0.0}
    now = lambda: clock["t"]  # noqa: E731
    out = []
    for kind in ("hpa", "keda"):
        kube = InMemoryCluster()
        kube.add_deployment(NS, VARIANT, replicas=2)
        prom = _ScriptedProm()
        if kind == "hpa":
            actuator = hpa.HpaEmulator(
                kube=kube, adapter=hpa.ExternalMetricsAdapter(prom=prom),
                namespace=NS, name=VARIANT, min_replicas=1, max_replicas=32,
                scale_down_stabilization_s=120.0, now=now,
            )
        else:
            actuator = hpa.KedaScaledObject(
                kube=kube, prom=prom, namespace=NS, name=VARIANT,
                cooldown_period_s=30.0, now=now,
            )
        for t, value in script:
            clock["t"] = t
            # the adapter has no failure path of its own: a failing query
            # is an empty answer there
            prom.value = None if (kind == "hpa" and value == "fail") else value
            step = actuator.step()
            out.append((kind, t, step, kube.get_deployment(NS, VARIANT)["spec"]["replicas"]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_and_port_actuators_step_alike(seed):
    script = _script(seed)
    ref = _drive("ref", script)
    port = _drive("port", script)
    assert ref == port
    replicas = {r for *_, r in port}
    assert len(replicas) >= 3, replicas  # the script really moved the workload
