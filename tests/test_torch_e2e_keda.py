"""KEDA scale-to-zero, closed over real sockets: the full
0 → N → 0 → N lifecycle with `WVA_SCALE_TO_ZERO=true` and
`direct_scale=false` — the controller only emits gauges; a
ScaledObject-semantics actuator enacts them (reference
docs/integrations/keda-integration.md:30-49, scale-to-zero being KEDA's
distinctive value).

The hard part this proves is the metric-series STRANDING mitigation: at
0 replicas every engine series is gone with the pods (emulated by
removing the engine scrape target), which without mitigation parks the
variant at MetricsMissing with a frozen gauge forever. The controller
instead treats {scale_to_zero, MetricsMissing, 0 ready replicas} as
ASLEEP: it keeps optimizing from the gateway-side demand counter
(collector.collect_sleeping_alloc; series that exist independently of
engine pods), so the gauges stay fresh — 0 while idle (KEDA's empty/0
query keeps the workload asleep instead of tripping its fallback), N as
soon as demand returns (KEDA activation edge 0 → N).

Port of tests/test_e2e_keda.py on the port's controller, emulator and
`testing.hpa.KedaScaledObject`; every Reconciler gets
`compute_device="cpu"`. Nothing waits on the wall clock for a scrape, a
rate window or a cooldown: MiniProm is scraped by hand on a clock the
test steps (`prom_clock`), and the KEDA cooldown runs on its injected
`now`.
"""

import json
import threading
import time
import urllib.request

import pytest

from inferno_tpu_torch.controller.crd import TYPE_METRICS_AVAILABLE, TYPE_OPTIMIZATION_READY
from inferno_tpu_torch.controller.kube import RestKubeClient
from inferno_tpu_torch.controller.metrics import MetricsEmitter, MetricsServer
from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.emulator.engine import EngineProfile
from inferno_tpu_torch.emulator.server import EmulatorServer
from inferno_tpu_torch.testing.apiserver import MiniApiServer
from inferno_tpu_torch.testing.hpa import KedaScaledObject

from test_torch_apiserver import (  # noqa: F401 (prom_clock: a fixture)
    CFG_NS,
    E2E_SCRAPE,
    E2E_TIME_SCALE,
    MODEL,
    NS,
    add_deployment,
    go_idle,
    hand_prom,
    make_va_doc,
    post,
    prom_clock,
    seed_config,
)

VARIANT = "llama-premium"


class Gateway:
    """The inference-gateway stand-in: a request counter whose series
    exist regardless of engine pods (scraped as an in-process MiniProm
    target). Demand hitting a scaled-to-zero variant lands HERE."""

    def __init__(self, model: str):
        self.model = model
        self.total = 0
        self.lock = threading.Lock()

    def hit(self, n: int = 1) -> None:
        with self.lock:
            self.total += n

    def render(self) -> str:
        with self.lock:
            return (
                "# TYPE inference_model_request_total counter\n"
                f'inference_model_request_total{{model_name="{self.model}"}}'
                f" {self.total}\n"
            )


@pytest.fixture()
def stack():
    api = MiniApiServer().start()
    engine = EmulatorServer(
        model_id=MODEL,
        profile=EngineProfile(alpha=18.0, beta=0.3, gamma=5.0, delta=0.02,
                              max_batch=64),
        time_scale=E2E_TIME_SCALE,
    )
    engine.start()
    gateway = Gateway(MODEL)
    emitter = MetricsEmitter()
    metrics_srv = MetricsServer(emitter.registry, port=0, host="127.0.0.1")
    metrics_srv.start()
    engine_target = f"http://127.0.0.1:{engine.port}/metrics"
    prom = hand_prom([
        (engine_target, {"namespace": NS}),
        (gateway.render, {"namespace": NS}),
        f"http://127.0.0.1:{metrics_srv.port}/metrics",
    ])
    try:
        kube = RestKubeClient(base_url=api.url, token="", namespace=CFG_NS)
        prom_client = HttpPromClient(PromConfig(base_url=prom.url, allow_http=True))
        rec = Reconciler(
            kube=kube, prom=prom_client,
            config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS,
                                    compute_backend="scalar",
                                    direct_scale=False,
                                    scale_to_zero=True),
            emitter=emitter,
        )
        keda = KedaScaledObject(kube=kube, prom=prom_client, namespace=NS,
                                name=VARIANT, cooldown_period_s=30.0)
        yield api, kube, engine, engine_target, gateway, prom, rec, keda
    finally:
        prom.stop()
        metrics_srv.stop()
        engine.stop()
        api.stop()


def drive_load(port: int, seconds: float, concurrency: int = 6):
    stop_at = time.time() + seconds
    url = f"http://127.0.0.1:{port}/v1/chat/completions"
    body = json.dumps({"model": MODEL,
                       "messages": [{"role": "user", "content": "x " * 64}],
                       "max_tokens": 32}).encode()

    def worker():
        while time.time() < stop_at:
            try:
                urllib.request.urlopen(
                    urllib.request.Request(
                        url, data=body,
                        headers={"Content-Type": "application/json"}),
                    timeout=30,
                ).read()
            except OSError:
                return

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def cycle(rec, kube):
    report = rec.run_cycle()
    assert report.errors == [], report.errors
    va = kube.get_variant_autoscaling(NS, VARIANT)
    return va, va.status.desired_optimized_alloc.num_replicas


def demand(gateway, prom, clock, hits: int = 8) -> None:
    """~30 req/s at the gateway over a few scrapes, on MiniProm's clock."""
    for _ in range(hits):
        gateway.hit(3)
        clock.advance(E2E_SCRAPE / 2)
        prom.scrape_once()


def test_scale_to_zero_full_lifecycle(stack, prom_clock):
    api, kube, engine, engine_target, gateway, prom, rec, keda = stack
    seed_config(api, model=MODEL)
    post(api, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
         make_va_doc(model=MODEL))
    add_deployment(api, NS, VARIANT, replicas=1)
    clock = {"t": 1000.0}
    keda.now = lambda: clock["t"]

    # ---- phase 1: load -> desired N >= 1, KEDA enacts it ----------------
    drive_load(engine.port, 1.5)
    prom.scrape_once()
    va, desired_busy = cycle(rec, kube)
    assert desired_busy >= 1
    prom.scrape_once()  # controller gauges reach the scrape store
    assert keda.step() == desired_busy
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == desired_busy

    # ---- phase 2: idle -> desired 0, cooldown, KEDA deactivates to 0 ----
    go_idle(prom, prom_clock)  # rates decay out of the window
    va, desired_idle = cycle(rec, kube)
    assert desired_idle == 0  # scale_to_zero lets the floor reach 0
    # the ratio gauge encodes the ABSOLUTE target when scaling to zero is
    # in play (reference metrics.go:118-124): desired 0 / current N -> 0.0
    prom.scrape_once()
    ratio = prom.evaluate(
        f'inferno_desired_ratio{{variant_name="{VARIANT}",namespace="{NS}"}}')
    assert float(ratio["data"]["result"][0]["value"][1]) == 0.0
    assert keda.step() == desired_busy  # within cooldown: still up
    clock["t"] += 31.0
    assert keda.step() == 0  # cooldown elapsed -> minReplicaCount 0
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == 0
    # the fake apiserver converges readyReplicas like a pod controller
    assert kube.get_deployment(NS, VARIANT)["status"]["readyReplicas"] == 0

    # ---- phase 3: pods gone -> engine series vanish; variant is ASLEEP,
    # not broken: gauges stay fresh at 0 and KEDA keeps polling happily --
    prom.remove_target(engine_target)
    va, desired_asleep = cycle(rec, kube)
    assert desired_asleep == 0
    cond = va.status.condition(TYPE_METRICS_AVAILABLE)
    assert cond.status == "False" and "scaled to zero" in cond.message
    assert va.status.condition(TYPE_OPTIMIZATION_READY).status == "True"
    prom.scrape_once()
    assert keda.step() == 0  # fresh 0 gauge: no fallback, no action

    # ---- phase 4: demand returns at the gateway -> wake 0 -> N ----------
    demand(gateway, prom, prom_clock)  # ~30 req/s ramp over a few scrapes
    va, desired_wake = cycle(rec, kube)
    assert desired_wake >= 1, "gateway demand must wake the variant"
    # ratio encodes the absolute target on the 0 -> N edge
    assert va.status.current_alloc.num_replicas == 0
    prom.scrape_once()
    ratio = prom.evaluate(
        f'inferno_desired_ratio{{variant_name="{VARIANT}",namespace="{NS}"}}')
    assert float(ratio["data"]["result"][0]["value"][1]) == float(desired_wake)
    clock["t"] += 1.0
    assert keda.step() == desired_wake  # activation edge: 0 -> N
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == desired_wake


def test_crashlooping_workload_is_not_asleep(stack):
    """spec.replicas=1 with zero READY pods and no metrics is breakage
    (ImagePullBackOff, crash loop), not sleep: the variant must be
    skipped as MetricsMissing, never optimized down to zero (
    intent — spec replicas — distinguishes asleep from broken)."""
    api, kube, engine, engine_target, gateway, prom, rec, keda = stack
    seed_config(api, model=MODEL)
    post(api, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
         make_va_doc(model=MODEL))
    post(api, f"/apis/apps/v1/namespaces/{NS}/deployments", {
        "metadata": {"name": VARIANT, "namespace": NS},
        "spec": {"replicas": 1},
        "status": {"replicas": 1, "readyReplicas": 0},  # crash-looping
    })
    prom.remove_target(engine_target)  # pods expose nothing
    gateway.hit(5)  # live demand changes nothing for a broken variant

    report = rec.run_cycle()
    assert report.errors == []
    va = kube.get_variant_autoscaling(NS, VARIANT)
    cond = va.status.condition(TYPE_METRICS_AVAILABLE)
    assert cond.status == "False" and "scaled to zero" not in cond.message
    assert va.status.condition(TYPE_OPTIMIZATION_READY).status == "False"
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == 1


def test_jetstream_variant_wakes_via_gateway_label(stack, prom_clock):
    """The gateway counter carries the GATEWAY's model label
    (model_name), not the engine's: a JetStream variant (model_label
    'id') asleep at zero must still see gateway demand."""
    api, kube, engine, engine_target, gateway, prom, rec, keda = stack
    from inferno_tpu_torch.controller.collector import collect_sleeping_alloc
    from inferno_tpu_torch.controller.engines import engine_for
    from inferno_tpu_torch.controller.crd import VariantAutoscaling
    from inferno_tpu_torch.controller.workload import from_deployment
    from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig

    demand(gateway, prom, prom_clock)
    prom_client = HttpPromClient(PromConfig(base_url=prom.url, allow_http=True))
    va = VariantAutoscaling.from_dict(make_va_doc(model=MODEL))
    wl = from_deployment({"metadata": {"name": VARIANT, "namespace": NS},
                          "spec": {"replicas": 0},
                          "status": {"replicas": 0, "readyReplicas": 0}})
    alloc = collect_sleeping_alloc(prom_client, engine_for("jetstream"), va, wl)
    assert alloc.load.arrival_rate > 0, (
        "jetstream wake query must not filter the gateway series on `id`")


def test_never_reported_variant_stays_untouched(stack):
    """A variant that NEVER produced engine metrics at >0 replicas is
    MetricsMissing and skipped — the asleep path must not hijack genuine
    breakage (docs/integrations/keda.md wake-up caveat)."""
    api, kube, engine, engine_target, gateway, prom, rec, keda = stack
    seed_config(api, model=MODEL)
    post(api, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
         make_va_doc(model=MODEL))
    add_deployment(api, NS, VARIANT, replicas=1)  # pods exist...
    prom.remove_target(engine_target)  # ...but expose nothing

    report = rec.run_cycle()
    assert report.errors == []
    va = kube.get_variant_autoscaling(NS, VARIANT)
    assert va.status.condition(TYPE_METRICS_AVAILABLE).status == "False"
    assert va.status.condition(TYPE_OPTIMIZATION_READY).status == "False"
    # desired untouched (stays at its zero-value default, never enacted)
    assert kube.get_deployment(NS, VARIANT)["spec"]["replicas"] == 1
