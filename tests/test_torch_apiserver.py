"""The port's controller transports against a real (socket-level) API
server: RestKubeClient CRUD/status/patch/scale, CRD schema rejection,
watch streams with a forced 410 resync, two-candidate leader failover,
and a full reconcile cycle scaling an HTTP-served Deployment, all on the
port's `MiniApiServer` (inferno_tpu_torch.testing).

Port of tests/test_apiserver.py: every case carried over to the port's
controller, with `compute_device="cpu"` wherever a Reconciler is built
(the port's profile corrector needs a device). Lease expiry runs on an
injected monotonic clock instead of wall-clock waits. Added: the two
servers (the reference's and the port's) answer one scripted request
sequence with the same status codes and bodies.

This file also holds the helpers the port's socket tests share (the
reference keeps them in tests/conftest.py, tests/test_controller.py and
tests/test_apiserver.py): the controller fixtures, the MiniApiServer
seeding helpers, a hand-scraped MiniProm on a shiftable clock, and the
emulated-engine stack.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller import leader as p_leader
from inferno_tpu_torch.controller.crd import (
    ACCELERATOR_LABEL,
    AcceleratorProfile,
    ConfigMapKeyRef,
    VariantAutoscaling,
    VariantAutoscalingSpec,
)
from inferno_tpu_torch.controller.kube import (
    Conflict,
    InMemoryCluster,
    NotFound,
    RestKubeClient,
)
from inferno_tpu_torch.controller.leader import LeaderElector
from inferno_tpu_torch.controller.promclient import FakeProm, Sample
from inferno_tpu_torch.controller.watch import Watcher
from inferno_tpu_torch.controller.workload import get_workload
from inferno_tpu_torch.emulator import miniprom as p_miniprom
from inferno_tpu_torch.emulator.miniprom import MiniProm
from inferno_tpu_torch.testing import MiniApiServer

NS = "workloads"
CFG_NS = "inferno-system"
MODEL = "meta-llama/Llama-3.1-8B"

# the sockets-e2e timing of tests/conftest.py: emulated time compressed so
# a "minute" of traffic fits a test run
E2E_TIME_SCALE = 0.02
E2E_SCRAPE = 0.2
# a hand-scraped MiniProm's rate window: wider than any test's run, so the
# rates only move when the test scrapes (or steps the clock past it)
HAND_WINDOW = 60.0


# -- controller fixtures (tests/test_controller.py) ---------------------------


def make_prom(arrival_rps=5.0, in_tok=128.0, out_tok=128.0, ttft_s=0.05,
              itl_s=0.02, running=3.0, age=0.0):
    """Fake Prometheus answering the collector's five query shapes."""
    prom = FakeProm()

    def handler(q):
        def s(v):
            return [Sample(labels={}, value=v, timestamp=time.time() - age)]

        if "num_requests_running" in q or "slots_used" in q:
            return s(running)
        if "success" in q:
            return s(arrival_rps)
        if "prompt_tokens" in q or "input_length" in q:
            return s(in_tok)
        if "generation_tokens" in q or "output_length" in q:
            return s(out_tok)
        if "first_token" in q:
            return s(ttft_s)
        if "per_output_token" in q:
            return s(itl_s)
        return []

    prom.add_handler(lambda q: True, handler)
    return prom


def make_cluster(replicas=1):
    """One Premium variant on v5e-4 (v5e-16 as a second candidate) with
    its Deployment and the three controller ConfigMaps."""
    cluster = InMemoryCluster()
    cluster.set_configmap(CFG_NS, "accelerator-unit-costs", {
        "v5e-4": json.dumps({"cost": 10.0}),
        "v5e-16": json.dumps({"cost": 10.0}),
    })
    cluster.set_configmap(CFG_NS, "service-classes-config", {
        "premium.yaml": (
            "name: Premium\npriority: 1\ndata:\n"
            f"  - model: {MODEL}\n    slo-ttft: 500\n    slo-tpot: 24\n"
        ),
        "freemium.yaml": (
            "name: Freemium\npriority: 10\ndata:\n"
            "  - model: other/model\n    slo-ttft: 2000\n    slo-tpot: 200\n"
        ),
    })
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "GLOBAL_OPT_INTERVAL": "30s",
    })
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
                    decode_parms=DecodeParms(alpha=18.0, beta=0.3),
                    prefill_parms=PrefillParms(gamma=5.0, delta=0.02),
                ),
                AcceleratorProfile(
                    acc="v5e-16", acc_count=1, max_batch_size=128, at_tokens=128,
                    decode_parms=DecodeParms(alpha=12.0, beta=0.25),
                    prefill_parms=PrefillParms(gamma=4.0, delta=0.012),
                ),
            ],
        ),
    )
    cluster.add_variant_autoscaling(va)
    cluster.add_deployment(NS, "llama-premium", replicas=replicas)
    return cluster


def wait_for(pred, timeout=10.0, step=0.02):
    """Poll `pred` until it holds or the deadline passes (a thread must
    act: the wait ends as soon as it has)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return bool(pred())


class ManualClock:
    """A monotonic clock that moves only when the test says so."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


@pytest.fixture()
def lease_clock(monkeypatch):
    """Lease expiry (leader.py judges it on time.monotonic) on a manual
    clock: a test steps past the lease duration instead of sleeping."""
    clock = ManualClock()
    monkeypatch.setattr(p_leader, "time", clock)
    return clock


# -- MiniProm scraped by hand, on a shiftable clock ---------------------------


class PromClock:
    """MiniProm's clock (its module's `time.time`) shifted forward on
    demand: `advance(s)` makes every later scrape and rate window see `s`
    more seconds, so a test ages counters out of the rate window without
    waiting for it."""

    def __init__(self):
        self.offset = 0.0

    def time(self) -> float:
        return time.time() + self.offset

    def advance(self, seconds: float) -> None:
        self.offset += seconds


@pytest.fixture()
def prom_clock(monkeypatch):
    clock = PromClock()
    monkeypatch.setattr(p_miniprom, "time", clock)
    return clock


def hand_prom(targets, window_seconds=HAND_WINDOW) -> MiniProm:
    """A MiniProm scraped by hand: its HTTP endpoint serves, no scraper
    thread runs, and one scrape is taken here; the test takes the others
    (`scrape_once`). `stop()` shuts the endpoint down."""
    prom = MiniProm(targets, window_seconds=window_seconds)
    threading.Thread(target=prom._httpd.serve_forever, daemon=True).start()
    prom.scrape_once()
    return prom


def go_idle(prom: MiniProm, clock: PromClock) -> None:
    """Idle past the rate window: step MiniProm's clock beyond it and
    scrape twice, a scrape interval apart, so every rate reads the flat
    counters of the idle period."""
    clock.advance(prom.window_seconds + E2E_SCRAPE)
    prom.scrape_once()
    clock.advance(E2E_SCRAPE)
    prom.scrape_once()


def make_e2e_stack(engine: str = "vllm-tpu", backend: str = "scalar"):
    """Emulated engine HTTP server -> hand-scraped MiniProm ->
    HttpPromClient -> the port's reconciler with direct-scale actuation.
    Returns (srv, prom, cluster, rec, teardown); `engine` selects the
    metric vocabulary end to end (exposition AND collector queries)."""
    from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
    from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
    from inferno_tpu_torch.emulator.engine import EngineProfile
    from inferno_tpu_torch.emulator.server import EmulatorServer

    srv = EmulatorServer(
        model_id=MODEL,
        profile=EngineProfile(alpha=18.0, beta=0.3, gamma=5.0, delta=0.02, max_batch=64),
        engine_name=engine,
        time_scale=E2E_TIME_SCALE,
    )
    srv.start()
    # the namespace label arrives via target relabeling, as a
    # ServiceMonitor would attach it on a real cluster
    prom = hand_prom([(f"http://127.0.0.1:{srv.port}/metrics", {"namespace": NS})])
    cluster = make_cluster(replicas=1)
    rec = Reconciler(
        kube=cluster,
        prom=HttpPromClient(PromConfig(base_url=prom.url, allow_http=True)),
        config=ReconcilerConfig(
            config_namespace=CFG_NS,
            compute_backend=backend,
            compute_device="cpu",
            direct_scale=True,
            engine=engine,
        ),
    )

    def teardown():
        prom.stop()
        srv.stop()

    return srv, prom, cluster, rec, teardown


@pytest.fixture()
def e2e_stack():
    """Shared sockets-e2e stack (vLLM-TPU vocabulary); see make_e2e_stack."""
    srv, prom, cluster, rec, teardown = make_e2e_stack()
    yield srv, prom, cluster, rec
    teardown()


def post_load(port: int, duration_s: float, concurrency: int = 6, model: str = MODEL):
    """Drive OpenAI-style completions from `concurrency` closed-loop
    threads for `duration_s` seconds."""
    stop_at = time.time() + duration_s
    url = f"http://127.0.0.1:{port}/v1/chat/completions"
    body = json.dumps(
        {
            "model": model,
            "messages": [{"role": "user", "content": "x " * 64}],
            "max_tokens": 32,
        }
    ).encode()

    def worker():
        while time.time() < stop_at:
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"}
            )
            try:
                urllib.request.urlopen(req, timeout=30).read()
            except OSError:
                return

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


# -- MiniApiServer fixtures and seeding (tests/test_apiserver.py) -------------


@pytest.fixture()
def server():
    srv = MiniApiServer().start()
    yield srv
    srv.stop()


@pytest.fixture()
def client(server):
    return RestKubeClient(base_url=server.url, token="", namespace=CFG_NS)


def post(server, path, body):
    req = urllib.request.Request(
        server.url + path, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    return json.loads(urllib.request.urlopen(req).read())


def make_va_doc(name="llama-premium", model="meta/llama-3.1-8b"):
    return {
        "apiVersion": "llmd.ai/v1alpha1",
        "kind": "VariantAutoscaling",
        "metadata": {
            "name": name, "namespace": NS,
            "labels": {"inference.optimization/acceleratorName": "v5e-4"},
        },
        "spec": {
            "modelID": model,
            "sloClassRef": {"name": "service-classes-config", "key": "Premium"},
            "modelProfile": {
                "accelerators": [
                    {
                        "acc": "v5e-4", "accCount": 1, "maxBatchSize": 64,
                        "atTokens": 128,
                        "perfParms": {
                            "decodeParms": {"alpha": "18.0", "beta": "0.3"},
                            "prefillParms": {"gamma": "5.0", "delta": "0.02"},
                        },
                    }
                ]
            },
        },
    }


def seed_config(server, interval="30s", accelerator="v5e-4",
                model="meta/llama-3.1-8b"):
    """Seed the three controller ConfigMaps (shared by every cycle test)."""
    for path, body in [
        (f"/api/v1/namespaces/{CFG_NS}/configmaps",
         {"metadata": {"name": "accelerator-unit-costs", "namespace": CFG_NS},
          "data": {accelerator: json.dumps({"cost": 10.0})}}),
        (f"/api/v1/namespaces/{CFG_NS}/configmaps",
         {"metadata": {"name": "service-classes-config", "namespace": CFG_NS},
          "data": {"premium.yaml": (
              "name: Premium\npriority: 1\ndata:\n"
              f"  - model: {model}\n    slo-ttft: 500\n    slo-tpot: 24\n"
          )}}),
        (f"/api/v1/namespaces/{CFG_NS}/configmaps",
         {"metadata": {"name": "inferno-autoscaler-config", "namespace": CFG_NS},
          "data": {"GLOBAL_OPT_INTERVAL": interval}}),
    ]:
        post(server, path, body)


def seed_cluster(server, interval="30s"):
    """The minimal reconcilable cluster: ConfigMaps, one VA, its
    Deployment — shared by the cycle/process tests."""
    seed_config(server, interval=interval)
    post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
         make_va_doc())
    add_deployment(server, NS, "llama-premium", replicas=1)


def add_deployment(server, ns, name, replicas=1):
    post(server, f"/apis/apps/v1/namespaces/{ns}/deployments", {
        "metadata": {"name": name, "namespace": ns},
        "spec": {"replicas": replicas},
        "status": {"replicas": replicas, "readyReplicas": replicas},
    })


# -- CRUD / subresources ------------------------------------------------------


def test_va_crud_status_and_meta_patch(server, client):
    post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
         make_va_doc())
    vas = client.list_variant_autoscalings()
    assert [va.name for va in vas] == ["llama-premium"]

    va = client.get_variant_autoscaling(NS, "llama-premium")
    assert va.spec.model_id == "meta/llama-3.1-8b"

    # status subresource: merge-patched, resourceVersion bumped
    va.status.desired_optimized_alloc.accelerator = "v5e-4"
    va.status.desired_optimized_alloc.num_replicas = 3
    client.update_variant_autoscaling_status(va)
    again = client.get_variant_autoscaling(NS, "llama-premium")
    assert again.status.desired_optimized_alloc.num_replicas == 3

    # meta patch: owner references land, spec untouched
    va.owner_references.append({
        "apiVersion": "apps/v1", "kind": "Deployment",
        "name": "llama-premium", "uid": "u1", "controller": True,
        "blockOwnerDeletion": False,
    })
    client.patch_variant_autoscaling_meta(va)
    again = client.get_variant_autoscaling(NS, "llama-premium")
    assert again.owner_references[0]["kind"] == "Deployment"
    assert again.spec.model_id == "meta/llama-3.1-8b"

    with pytest.raises(NotFound):
        client.get_variant_autoscaling(NS, "missing")


def test_crd_schema_rejects_invalid_va(server):
    bad = make_va_doc(name="bad")
    bad["spec"]["modelID"] = 42  # schema: string
    with pytest.raises(urllib.error.HTTPError) as err:
        post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings", bad)
    assert err.value.code == 422
    body = json.loads(err.value.read())
    assert "modelID" in body["message"]


def test_scale_subresources_and_workload_resolution(server, client):
    add_deployment(server, NS, "web", replicas=1)
    client.scale_deployment(NS, "web", 5)
    assert client.get_deployment(NS, "web")["spec"]["replicas"] == 5

    post(server, f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{NS}/leaderworkersets", {
        "metadata": {"name": "big", "namespace": NS},
        "spec": {"replicas": 1, "leaderWorkerTemplate": {"size": 4}},
        "status": {"replicas": 1, "readyReplicas": 1},
    })
    wl = get_workload(client, NS, "big")
    assert (wl.kind, wl.group_size) == ("LeaderWorkerSet", 4)
    client.scale_leader_worker_set(NS, "big", 2)
    assert client.get_leader_worker_set(NS, "big")["spec"]["replicas"] == 2


def test_configmaps_and_nodes(server, client):
    post(server, f"/api/v1/namespaces/{CFG_NS}/configmaps", {
        "metadata": {"name": "inferno-autoscaler-config", "namespace": CFG_NS},
        "data": {"GLOBAL_OPT_INTERVAL": "30s"},
    })
    assert client.get_configmap(CFG_NS, "inferno-autoscaler-config") == {
        "GLOBAL_OPT_INTERVAL": "30s"
    }
    post(server, "/api/v1/nodes", {
        "metadata": {"name": "tpu-node-1",
                     "labels": {"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}},
        "status": {"allocatable": {"google.com/tpu": "4"}},
    })
    nodes = client.list_nodes()
    assert nodes and nodes[0]["metadata"]["name"] == "tpu-node-1"


def test_http_error_mapping(server, client):
    """RestKubeClient maps the API server's failure statuses to the typed
    errors the reconciler's skip/backoff logic branches on: 404 ->
    NotFound, 409 -> Conflict, anything else -> KubeError with the
    status body in the message."""
    from inferno_tpu_torch.controller.kube import KubeError

    with pytest.raises(NotFound):
        client.get_deployment(NS, "missing")

    # 422 (schema rejection) surfaces as a KubeError carrying the reason;
    # a status write violating the committed CRD must not be silent
    post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
         make_va_doc(name="emap"))
    va = client.get_variant_autoscaling(NS, "emap")
    bad = {
        "apiVersion": "llmd.ai/v1alpha1", "kind": "VariantAutoscaling",
        "metadata": {"name": "emap", "namespace": NS},
        "status": {"desiredOptimizedAlloc": {"numReplicas": "three"}},
    }
    req = urllib.request.Request(
        server.url + f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings/emap/status",
        method="PATCH", data=json.dumps(bad).encode(),
        headers={"Content-Type": "application/merge-patch+json"},
    )
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req)
    assert err.value.code == 422

    # the same write through the client maps to KubeError (not swallowed)
    va.status.desired_optimized_alloc.num_replicas = "three"  # type: ignore
    with pytest.raises(KubeError):
        client.update_variant_autoscaling_status(va)


def test_list_resource_version_stable_without_writes(server, client):
    post(server, f"/api/v1/namespaces/{CFG_NS}/configmaps", {
        "metadata": {"name": "rv-probe", "namespace": CFG_NS}, "data": {"a": "1"},
    })
    req = urllib.request.Request(server.url + f"/api/v1/namespaces/{CFG_NS}/configmaps")
    rv1 = json.loads(urllib.request.urlopen(req).read())["metadata"]["resourceVersion"]
    rv2 = json.loads(urllib.request.urlopen(req).read())["metadata"]["resourceVersion"]
    assert rv1 == rv2  # a LIST must not consume resourceVersions


# -- leases / leader election -------------------------------------------------


def test_lease_optimistic_concurrency(server, client):
    lease = client.create_lease(CFG_NS, "test-lease", {"spec": {"holderIdentity": "a"}})
    with pytest.raises(Conflict):
        client.create_lease(CFG_NS, "test-lease", {"spec": {"holderIdentity": "b"}})
    # stale resourceVersion loses the update race
    stale = json.loads(json.dumps(lease))
    client.update_lease(CFG_NS, "test-lease", lease)  # rv consumed
    with pytest.raises(Conflict):
        client.update_lease(CFG_NS, "test-lease", stale)


def test_two_candidate_leader_failover(server, lease_clock):
    kube_a = RestKubeClient(base_url=server.url, token="", namespace=CFG_NS)
    kube_b = RestKubeClient(base_url=server.url, token="", namespace=CFG_NS)
    a = LeaderElector(kube=kube_a, identity="candidate-a", namespace=CFG_NS,
                      lease_duration=1.0, renew_deadline=0.8, retry_period=0.1)
    b = LeaderElector(kube=kube_b, identity="candidate-b", namespace=CFG_NS,
                      lease_duration=1.0, renew_deadline=0.8, retry_period=0.1)
    assert a.try_acquire_or_renew() is True
    assert b.try_acquire_or_renew() is False

    # holder stops renewing; after the lease duration the second candidate
    # must take over through the real HTTP lease API
    lease_clock.advance(0.5)
    assert b.try_acquire_or_renew() is False  # within the duration
    lease_clock.advance(0.6)
    assert b.try_acquire_or_renew() is True
    lease = kube_b.get_lease(CFG_NS, LeaderElector.lease_name)
    assert lease["spec"]["holderIdentity"] == "candidate-b"
    assert lease["spec"]["leaseTransitions"] >= 1


# -- watch streams ------------------------------------------------------------


def test_watch_stream_wakes_and_survives_410(server, client):
    wakes = []
    wake_evt = threading.Event()

    def wake():
        wakes.append(time.time())
        wake_evt.set()

    va_path = "/apis/llmd.ai/v1alpha1/variantautoscalings"  # cluster-wide
    watches = []
    real_watch_request = client.watch_request

    def watch_request(path):
        if path.startswith(va_path + "?watch=true") and "resourceVersion=" in path:
            watches.append(path)  # built after the list: the rv is known
        return real_watch_request(path)

    client.watch_request = watch_request
    watcher = Watcher(client, wake, config_namespace=CFG_NS)
    watcher.start()
    try:
        assert wait_for(lambda: watches), "the VA stream never listed"
        post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
             make_va_doc(name="va-1"))
        assert wake_evt.wait(5.0), "VA ADDED did not wake the reconciler"
        wake_evt.clear()

        # force a compaction: the stream's resume resourceVersion is now
        # stale, the server answers 410 (in-stream ERROR or at reconnect),
        # and the watcher must relist and keep delivering events
        server.compact()
        post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
             make_va_doc(name="va-2"))
        assert wake_evt.wait(10.0), "watch did not recover after 410"
    finally:
        watcher.stop()


def test_two_instance_process_shape_with_failover(server):
    """The full process shape of main(): two controller instances, each
    with its own RestKubeClient, lease elector, watcher, and run_forever
    loop against the HTTP API server. Exactly one reconciles at a time;
    when the leader releases, the follower takes over and keeps writing
    fresh decisions. (The reference delegates this to controller-runtime's
    manager; here it is this repo's own leader.py/watch.py/run_forever.)"""
    from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig

    seed_cluster(server, interval="1s")

    instances = []
    stops = []
    try:
        for ident in ("inst-a", "inst-b"):
            kube = RestKubeClient(base_url=server.url, token="", namespace=CFG_NS)
            rec = Reconciler(
                kube=kube, prom=make_prom(arrival_rps=40.0),
                config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS,
                                        compute_backend="scalar"),
            )
            elector = LeaderElector(kube=kube, identity=ident, namespace=CFG_NS,
                                    lease_duration=1.0, renew_deadline=0.8,
                                    retry_period=0.1)
            elector.start()
            watcher = Watcher(kube, rec.poke, config_namespace=CFG_NS)
            watcher.start()
            stop = {"stop": False}
            t = threading.Thread(
                target=rec.run_forever,
                kwargs={"stop_check": lambda s=stop: s["stop"],
                        "gate": elector.is_leader},
                daemon=True,
            )
            t.start()
            instances.append((rec, elector, watcher, t))
            stops.append(stop)

        def wait_for(pred, timeout=15.0):
            deadline = time.time() + timeout
            while time.time() < deadline:
                if pred():
                    return True
                time.sleep(0.1)
            return False

        client = RestKubeClient(base_url=server.url, token="", namespace=CFG_NS)

        def decided():
            va = client.get_variant_autoscaling(NS, "llama-premium")
            return va.status.desired_optimized_alloc.num_replicas > 1

        assert wait_for(decided), "no instance ever produced a decision"
        leaders = [e.is_leader() for _, e, _, _ in instances]
        assert sum(leaders) == 1, f"leadership not exclusive: {leaders}"
        first_leader = leaders.index(True)

        # leader steps down (releases the lease); the follower must take
        # over and keep producing fresh decisions
        instances[first_leader][1].stop(release=True)
        other = 1 - first_leader

        assert wait_for(lambda: instances[other][1].is_leader()), "no takeover"
        # capture the baseline only AFTER takeover: the outgoing leader's
        # loop may still finish one last cycle around its stop(), which
        # would otherwise satisfy the freshness check for it
        stamp = client.get_variant_autoscaling(
            NS, "llama-premium"
        ).status.desired_optimized_alloc.last_run_time

        def fresh_decision():
            va = client.get_variant_autoscaling(NS, "llama-premium")
            return (va.status.desired_optimized_alloc.last_run_time or "") > (stamp or "")

        assert wait_for(fresh_decision), "follower never wrote a fresh decision"
        lease = client.get_lease(CFG_NS, LeaderElector.lease_name)
        assert lease["spec"]["holderIdentity"] == instances[other][1].identity
    finally:
        for stop in stops:
            stop["stop"] = True
        for rec, elector, watcher, t in instances:
            rec.poke()
            watcher.stop()
            elector.stop()
        for _, _, _, t in instances:
            t.join(timeout=5)


def test_inmemory_cluster_and_apiserver_agree(server, client):
    """Differential guard: the same reconcile cycle against the in-memory
    fake (used by most controller tests) and against the wire-level API
    server must land the same status + scale. Keeps the fake honest —
    drift between the two would silently undermine every test built on
    InMemoryCluster."""
    from inferno_tpu_torch.controller.kube import InMemoryCluster
    from inferno_tpu_torch.controller.crd import VariantAutoscaling
    from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig

    seed_cluster(server)

    mem = InMemoryCluster()
    mem.set_configmap(CFG_NS, "accelerator-unit-costs",
                      {"v5e-4": json.dumps({"cost": 10.0})})
    mem.set_configmap(CFG_NS, "service-classes-config", {
        "premium.yaml": (
            "name: Premium\npriority: 1\ndata:\n"
            "  - model: meta/llama-3.1-8b\n    slo-ttft: 500\n    slo-tpot: 24\n"
        ),
    })
    mem.set_configmap(CFG_NS, "inferno-autoscaler-config",
                      {"GLOBAL_OPT_INTERVAL": "30s"})
    mem.add_variant_autoscaling(VariantAutoscaling.from_dict(make_va_doc()))
    mem.add_deployment(NS, "llama-premium", replicas=1)

    outcomes = {}
    for name, kube in (("rest", client), ("memory", mem)):
        rec = Reconciler(
            kube=kube, prom=make_prom(arrival_rps=40.0),
            config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS,
                                    compute_backend="scalar", direct_scale=True),
        )
        report = rec.run_cycle()
        assert report.errors == [], (name, report.errors)
        va = kube.get_variant_autoscaling(NS, "llama-premium")
        outcomes[name] = (
            va.status.desired_optimized_alloc.num_replicas,
            va.status.desired_optimized_alloc.accelerator,
            va.status.condition("OptimizationReady").status,
            kube.get_deployment(NS, "llama-premium")["spec"]["replicas"],
        )
    assert outcomes["rest"] == outcomes["memory"], outcomes


# -- full cycle over HTTP -----------------------------------------------------


def test_run_cycle_scales_real_deployment_over_http(server, client):
    from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig

    seed_cluster(server)

    rec = Reconciler(
        kube=client, prom=make_prom(arrival_rps=40.0),
        config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS, compute_backend="scalar",
                                direct_scale=True),
    )
    report = rec.run_cycle()
    assert report.errors == [], report.errors

    va = client.get_variant_autoscaling(NS, "llama-premium")
    desired = va.status.desired_optimized_alloc.num_replicas
    assert desired > 1
    # the Deployment object living behind real HTTP was scaled
    deploy = client.get_deployment(NS, "llama-premium")
    assert deploy["spec"]["replicas"] == desired
    # owner reference patched over the wire
    assert va.owner_references and va.owner_references[0]["kind"] == "Deployment"
    # status survived schema validation against the committed CRD
    cond = va.status.condition("OptimizationReady")
    assert cond is not None and cond.status == "True"


def test_run_cycle_scales_lws_groups_over_http(server, client):
    """Multi-host over the wire: a v5e-16 variant backed by a
    LeaderWorkerSet (4 pods per group) is collected in GROUP units,
    owner-ref'd to the LWS kind, and scaled in whole groups through the
    real HTTP API — no fractional-host state ever exists server-side."""
    from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig

    # config CMs (v5e-16 costs) + a multi-host VA, NO Deployment: the
    # workload resolver must fall through to the LeaderWorkerSet
    seed_config(server, accelerator="v5e-16", model="meta/llama-3.1-70b")
    doc = make_va_doc(name="llama-70b", model="meta/llama-3.1-70b")
    doc["metadata"]["labels"]["inference.optimization/acceleratorName"] = "v5e-16"
    doc["spec"]["modelProfile"]["accelerators"][0]["acc"] = "v5e-16"
    post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings", doc)
    post(server, f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{NS}/leaderworkersets", {
        "metadata": {"name": "llama-70b", "namespace": NS},
        "spec": {"replicas": 1, "leaderWorkerTemplate": {"size": 4}},
        "status": {"replicas": 1, "readyReplicas": 1},
    })

    rec = Reconciler(
        kube=client, prom=make_prom(arrival_rps=40.0),
        config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS, compute_backend="scalar",
                                direct_scale=True),
    )
    report = rec.run_cycle()
    assert report.errors == [], report.errors

    va = client.get_variant_autoscaling(NS, "llama-70b")
    desired = va.status.desired_optimized_alloc.num_replicas
    assert desired > 1
    # current replicas were read in GROUP units (1 group, not 4 pods)
    assert va.status.current_alloc.num_replicas == 1
    # the LWS behind real HTTP was scaled in whole groups
    lws = client.get_leader_worker_set(NS, "llama-70b")
    assert lws["spec"]["replicas"] == desired
    assert lws["spec"]["leaderWorkerTemplate"]["size"] == 4  # untouched
    # owner reference names the LWS kind, not Deployment
    assert va.owner_references and va.owner_references[0]["kind"] == "LeaderWorkerSet"


# -- kube-apiserver conformance ------------------------------------------------
# The semantics most likely to diverge between a fake and the real
# apiserver: resourceVersion discipline on updates, status-subresource
# isolation, patch Content-Type dispatch on the scale path, and watch
# bookmarks. Behaviors below mirror documented kube-apiserver responses.


def request(server, path, method, body=None, ctype="application/json"):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        server.url + path, method=method, data=data,
        headers={"Content-Type": ctype} if data is not None else {},
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestConformanceResourceVersion:
    def test_put_without_rv_rejected(self, server):
        seed_config(server)
        path = f"/api/v1/namespaces/{CFG_NS}/configmaps/inferno-autoscaler-config"
        _, cur = request(server, path, "GET")
        cur["metadata"].pop("resourceVersion")
        code, body = request(server, path, "PUT", cur)
        # kube: metadata.resourceVersion must be specified for an update
        assert code == 422, body
        assert "must be specified for an update" in body["message"]

    def test_stale_rv_conflict_has_kube_shape(self, server):
        seed_config(server)
        path = f"/api/v1/namespaces/{CFG_NS}/configmaps/inferno-autoscaler-config"
        _, cur = request(server, path, "GET")
        stale = json.loads(json.dumps(cur))
        # someone else writes first
        cur["data"]["GLOBAL_OPT_INTERVAL"] = "45s"
        code, _ = request(server, path, "PUT", cur)
        assert code == 200
        stale["data"]["GLOBAL_OPT_INTERVAL"] = "90s"
        code, body = request(server, path, "PUT", stale)
        assert code == 409
        assert body["reason"] == "Conflict"
        assert "please apply your changes to the latest version" in body["message"]

    def test_status_put_cannot_touch_spec(self, server):
        """Subresource isolation: a stale controller writing status must
        not be able to smuggle a spec change (kube-apiserver drops
        non-status fields on the status subresource)."""
        seed_config(server)
        post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
             make_va_doc())
        path = f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings/llama-premium"
        _, cur = request(server, path, "GET")
        cur["spec"]["modelID"] = "evil/other-model"
        cur["status"] = {"currentAlloc": {"numReplicas": 3}}
        code, _ = request(server, path + "/status", "PUT", cur)
        assert code == 200
        _, after = request(server, path, "GET")
        assert after["spec"]["modelID"] == "meta/llama-3.1-8b"  # untouched
        assert after["status"]["currentAlloc"]["numReplicas"] == 3

    def test_main_put_cannot_touch_status(self, server):
        seed_config(server)
        post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
             make_va_doc())
        path = f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings/llama-premium"
        _, cur = request(server, path, "GET")
        code, _ = request(server, path + "/status", "PUT",
                          {**cur, "status": {"currentAlloc": {"numReplicas": 2}}})
        assert code == 200
        _, cur = request(server, path, "GET")
        cur["status"] = {"currentAlloc": {"numReplicas": 99}}
        code, _ = request(server, path, "PUT", cur)
        assert code == 200
        _, after = request(server, path, "GET")
        assert after["status"]["currentAlloc"]["numReplicas"] == 2  # preserved


class TestConformancePatchDialect:
    def _lws(self, server):
        post(server, f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{NS}/leaderworkersets", {
            "metadata": {"name": "llama-70b", "namespace": NS},
            "spec": {"replicas": 1, "leaderWorkerTemplate": {"size": 4}},
            "status": {"replicas": 1, "readyReplicas": 1},
        })
        return (f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{NS}"
                f"/leaderworkersets/llama-70b")

    def test_scale_get_returns_scale_object(self, server):
        path = self._lws(server)
        code, scale = request(server, path + "/scale", "GET")
        assert code == 200
        assert scale["kind"] == "Scale" and scale["apiVersion"] == "autoscaling/v1"
        assert scale["spec"]["replicas"] == 1

    def test_scale_merge_patch(self, server):
        path = self._lws(server)
        code, _ = request(server, path + "/scale", "PATCH",
                          {"spec": {"replicas": 3}},
                          ctype="application/merge-patch+json")
        assert code == 200
        _, lws = request(server, path, "GET")
        assert lws["spec"]["replicas"] == 3
        assert lws["spec"]["leaderWorkerTemplate"]["size"] == 4  # untouched

    def test_scale_json_patch(self, server):
        path = self._lws(server)
        code, _ = request(server, path + "/scale", "PATCH",
                          [{"op": "replace", "path": "/spec/replicas", "value": 5}],
                          ctype="application/json-patch+json")
        assert code == 200
        _, lws = request(server, path, "GET")
        assert lws["spec"]["replicas"] == 5

    def test_json_patch_body_with_merge_content_type_rejected(self, server):
        """The dialect mismatch a silent fake would swallow: an op ARRAY
        declared as merge-patch is a 400 on kube-apiserver, never a
        merge."""
        path = self._lws(server)
        code, body = request(server, path + "/scale", "PATCH",
                             [{"op": "replace", "path": "/spec/replicas", "value": 9}],
                             ctype="application/merge-patch+json")
        assert code == 400, body
        _, lws = request(server, path, "GET")
        assert lws["spec"]["replicas"] == 1  # nothing applied

    def test_unknown_patch_content_type_415(self, server):
        path = self._lws(server)
        code, _ = request(server, path + "/scale", "PATCH",
                          {"spec": {"replicas": 2}}, ctype="text/plain")
        assert code == 415

    def test_missing_patch_content_type_415(self, server):
        """kube-apiserver 415s a PATCH with no declared patch type; the
        fake must not be laxer and quietly merge-patch.
        urllib silently injects a default Content-Type on bodied requests,
        so speak raw http.client to truly omit the header."""
        import http.client
        from urllib.parse import urlparse

        path = self._lws(server)
        u = urlparse(server.url)
        body = json.dumps({"spec": {"replicas": 2}}).encode()
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=5)
        try:
            conn.putrequest("PATCH", path + "/scale")
            conn.putheader("Content-Length", str(len(body)))
            conn.endheaders()
            conn.send(body)
            assert conn.getresponse().status == 415
        finally:
            conn.close()
        _, lws = request(server, path, "GET")
        assert lws["spec"]["replicas"] == 1  # nothing applied

    def test_json_patch_test_op_conflict(self, server):
        """RFC 6902 `test` is the optimistic-concurrency idiom on the
        patch path; a failing test is kube's 409."""
        path = self._lws(server)
        code, body = request(server, path, "PATCH",
                             [{"op": "test", "path": "/spec/replicas", "value": 7},
                              {"op": "replace", "path": "/spec/replicas", "value": 8}],
                             ctype="application/json-patch+json")
        assert code == 409, body
        _, lws = request(server, path, "GET")
        assert lws["spec"]["replicas"] == 1


class TestConformanceWatchBookmarks:
    def test_bookmarks_advance_resume_point(self, server):
        seed_config(server)
        url = (f"{server.url}/api/v1/namespaces/{CFG_NS}/configmaps"
               f"?watch=true&allowWatchBookmarks=true&timeoutSeconds=3")
        events = []
        with urllib.request.urlopen(url, timeout=10) as resp:
            deadline = time.time() + 4
            while time.time() < deadline:
                line = resp.readline()
                if not line:
                    break
                events.append(json.loads(line))
                if sum(1 for e in events if e["type"] == "BOOKMARK") >= 2:
                    break
        bookmarks = [e for e in events if e["type"] == "BOOKMARK"]
        assert len(bookmarks) >= 1, [e["type"] for e in events]
        bm = bookmarks[-1]["object"]
        # a bookmark is a bare object carrying only the resume rv
        assert bm["kind"] == "ConfigMap"
        assert set(bm["metadata"]) == {"resourceVersion"}
        assert "data" not in bm
        # resuming from the bookmark rv is accepted even after compaction
        rv = bm["metadata"]["resourceVersion"]
        server.compact()
        resume = (f"{server.url}/api/v1/namespaces/{CFG_NS}/configmaps"
                  f"?watch=true&resourceVersion={rv}&timeoutSeconds=1")
        with urllib.request.urlopen(resume, timeout=5) as resp:
            line = resp.readline()  # stream opens; no 410 status line
        # while an ancient rv (pre-compaction) still gets 410 Gone
        stale = (f"{server.url}/api/v1/namespaces/{CFG_NS}/configmaps"
                 f"?watch=true&resourceVersion=1&timeoutSeconds=1")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(stale, timeout=5)
        assert err.value.code == 410
        assert json.loads(err.value.read())["reason"] == "Expired"


class TestConformanceSubresourceIsolationPatch:
    def test_main_patch_cannot_touch_status(self, server):
        """Subresource isolation holds for PATCH too: a
        merge-patch carrying status through the main resource is a no-op
        on the status, like a real apiserver with the subresource
        enabled."""
        seed_config(server)
        post(server, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
             make_va_doc())
        path = f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings/llama-premium"
        code, _ = request(server, path + "/status", "PATCH",
                          {"status": {"currentAlloc": {"numReplicas": 2}}},
                          ctype="application/merge-patch+json")
        assert code == 200
        code, _ = request(server, path, "PATCH",
                          {"status": {"currentAlloc": {"numReplicas": 99}},
                           "metadata": {"labels": {"x": "y"}}},
                          ctype="application/merge-patch+json")
        assert code == 200
        _, after = request(server, path, "GET")
        assert after["status"]["currentAlloc"]["numReplicas"] == 2  # preserved
        assert after["metadata"]["labels"]["x"] == "y"  # non-status applied

    def test_put_scale_updates_replicas_only(self, server):
        """client-go ScaleInterface.Update issues PUT /scale with a Scale
        body; the stored object must be scaled, never REPLACED by the
        Scale projection."""
        post(server, f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{NS}/leaderworkersets", {
            "metadata": {"name": "g", "namespace": NS},
            "spec": {"replicas": 1, "leaderWorkerTemplate": {"size": 4}},
            "status": {"replicas": 1, "readyReplicas": 1},
        })
        path = f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{NS}/leaderworkersets/g"
        _, scale = request(server, path + "/scale", "GET")
        scale["spec"]["replicas"] = 6
        code, _ = request(server, path + "/scale", "PUT", scale)
        assert code == 200
        _, lws = request(server, path, "GET")
        assert lws["kind"] != "Scale"
        assert lws["spec"]["replicas"] == 6
        assert lws["spec"]["leaderWorkerTemplate"]["size"] == 4  # intact


# -- the same servers: the reference's MiniApiServer and the port's ----------


def _mask(body):
    """uid and creationTimestamp differ by construction; mask them."""
    if isinstance(body, dict):
        return {
            k: ("<masked>" if k in ("uid", "creationTimestamp") else _mask(v))
            for k, v in body.items()
        }
    if isinstance(body, list):
        return [_mask(v) for v in body]
    return body


def _watch_lines(server, path: str, n: int) -> list:
    """The first `n` JSON lines of a watch stream (or its error status)."""
    try:
        with urllib.request.urlopen(server.url + path, timeout=10) as resp:
            return [json.loads(resp.readline()) for _ in range(n)]
    except urllib.error.HTTPError as e:
        return [e.code, json.loads(e.read())]


def _scripted_session(server) -> list:
    """One request sequence touching every behaviour the controller's
    transports rely on; returns every (status, masked body) in order."""
    out = []

    def call(path, method="GET", body=None, ctype="application/json"):
        out.append((method, path, *request(server, path, method, body, ctype)))
        return out[-1][3]

    cm = f"/api/v1/namespaces/{CFG_NS}/configmaps"
    vas = f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings"
    deps = f"/apis/apps/v1/namespaces/{NS}/deployments"
    leases = f"/apis/coordination.k8s.io/v1/namespaces/{CFG_NS}/leases"
    # CRUD
    call(cm, "POST", {"metadata": {"name": "a", "namespace": CFG_NS}, "data": {"k": "1"}})
    call(cm, "POST", {"metadata": {"name": "a", "namespace": CFG_NS}, "data": {}})  # 409
    cur = call(f"{cm}/a")
    stale = json.loads(json.dumps(cur))
    cur["data"]["k"] = "2"
    call(f"{cm}/a", "PUT", cur)
    call(f"{cm}/a", "PUT", stale)  # stale rv: 409
    call(f"{cm}/a", "PUT", {"metadata": {"name": "a"}, "data": {}})  # no rv: 422
    call(cm)
    # CRD validation, status and main-resource isolation
    bad = make_va_doc(name="bad")
    bad["spec"]["modelID"] = 7
    call(vas, "POST", bad)  # 422
    call(vas, "POST", make_va_doc())
    call(f"{vas}/llama-premium/status", "PATCH",
         {"status": {"currentAlloc": {"numReplicas": 2}}},
         "application/merge-patch+json")
    call(f"{vas}/llama-premium", "PATCH",
         {"status": {"currentAlloc": {"numReplicas": 9}},
          "metadata": {"labels": {"x": "y"}}}, "application/merge-patch+json")
    call(f"{vas}/llama-premium/status", "PATCH",
         [{"op": "replace", "path": "/status/currentAlloc/numReplicas", "value": 3}],
         "application/json-patch+json")
    call(f"{vas}/llama-premium", "PATCH", {"spec": {}}, "text/plain")  # 415
    # scale subresource: merge, json, a failing json-patch test, PUT
    call(deps, "POST", {"metadata": {"name": "web", "namespace": NS},
                        "spec": {"replicas": 1},
                        "status": {"replicas": 1, "readyReplicas": 1}})
    call(f"{deps}/web/scale")
    call(f"{deps}/web/scale", "PATCH", {"spec": {"replicas": 3}},
         "application/merge-patch+json")
    call(f"{deps}/web/scale", "PATCH",
         [{"op": "replace", "path": "/spec/replicas", "value": 4}],
         "application/json-patch+json")
    call(f"{deps}/web", "PATCH",
         [{"op": "test", "path": "/spec/replicas", "value": 7},
          {"op": "replace", "path": "/spec/replicas", "value": 8}],
         "application/json-patch+json")  # 409
    call(f"{deps}/web/scale", "PATCH", [{"op": "add", "path": "/x"}],
         "application/merge-patch+json")  # 400
    scale = call(f"{deps}/web/scale")
    scale["spec"]["replicas"] = -1
    call(f"{deps}/web/scale", "PUT", scale)  # 422
    scale["spec"]["replicas"] = 6
    call(f"{deps}/web/scale", "PUT", scale)
    # watch from an rv: the events after it, in order
    since = int(call(f"{deps}/web")["metadata"]["resourceVersion"]) - 3
    out.append(("WATCH", since, _mask(_watch_lines(
        server, f"{deps}?watch=true&resourceVersion={since}&timeoutSeconds=2", 3))))
    # compaction: an rv below the floor is 410 Gone
    server.compact()
    out.append(("WATCH", 1, _mask(_watch_lines(
        server, f"{deps}?watch=true&resourceVersion=1&timeoutSeconds=1", 1))))
    # lease races: create twice, update with a stale rv
    lease = call(leases, "POST", {"metadata": {"name": "l", "namespace": CFG_NS},
                                  "spec": {"holderIdentity": "a"}})
    call(leases, "POST", {"metadata": {"name": "l", "namespace": CFG_NS},
                          "spec": {"holderIdentity": "b"}})  # 409
    won = json.loads(json.dumps(lease))
    won["spec"]["holderIdentity"] = "b"
    call(f"{leases}/l", "PUT", won)
    lease["spec"]["holderIdentity"] = "c"
    call(f"{leases}/l", "PUT", lease)  # stale rv: 409
    call(f"{deps}/web", "DELETE")
    call(f"{deps}/web", "DELETE")  # 404
    return [_mask(entry) for entry in out]


def test_reference_and_port_servers_answer_alike():
    """The port's MiniApiServer is the reference's: the same scripted
    session (CRUD, status and scale patches, a failing json-patch `test`,
    a stale PUT, a watch from an rv, compaction -> 410, lease races) gives
    the same status codes and bodies, uid and creationTimestamp masked."""
    from inferno_tpu.testing import MiniApiServer as RefMiniApiServer

    sessions = []
    for cls in (RefMiniApiServer, MiniApiServer):
        srv = cls().start()
        try:
            sessions.append(_scripted_session(srv))
        finally:
            srv.stop()
    ref, port = sessions
    codes = [e[2] for e in port if e[0] != "WATCH"]
    assert {200, 201, 400, 404, 409, 415, 422} <= set(codes), codes
    assert [e[2] for e in port if e[:2] == ("WATCH", 1)][0][0] == 410
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert a == b
