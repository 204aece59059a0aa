"""TPU node inventory -> limited-mode capacity (the reference's
CollectInventoryK8S stub made real, collector.go:23-42).

Port of tests/test_inventory.py on the port's modules, the expectations unchanged.
Every reconciler sizes on backend "torch" on the CPU, asked for
explicitly (`PORT_CPU`), and every clean cycle over an in-memory
cluster is held to the reference's decisions on the same inputs
(`test_torch_held_cycle.held_reconciler`).
"""

from inferno_tpu_torch.controller.inventory import (
    collect_tpu_inventory,
    generation_of,
    node_tpu_chips,
)
from inferno_tpu_torch.controller.kube import InMemoryCluster
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig

from test_torch_apiserver import CFG_NS, NS, make_cluster, make_prom
from test_torch_held_cycle import PORT_CPU, held_reconciler


def test_inventory_sums_chips_per_generation():
    cluster = InMemoryCluster()
    cluster.add_node("n1", tpu_chips=4, accelerator="tpu-v5-lite-podslice")
    cluster.add_node("n2", tpu_chips=4, accelerator="tpu-v5-lite-podslice")
    cluster.add_node("n3", tpu_chips=4, accelerator="tpu-v5p-slice")
    cluster.add_node("cpu-only")  # no TPU resource
    cluster.add_node("cordoned", tpu_chips=4, accelerator="tpu-v5-lite-podslice",
                     unschedulable=True)
    cap = collect_tpu_inventory(cluster)
    assert cap.chips == {"v5e": 8, "v5p": 4}


def test_unknown_accelerator_label_passes_through():
    node = {"metadata": {"labels": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v7x-slice"}}}
    assert generation_of(node) == "tpu-v7x-slice"
    assert generation_of({"metadata": {"labels": {}}}) is None


def test_chips_fall_back_to_capacity_field():
    node = {"status": {"capacity": {"google.com/tpu": "8"}}}
    assert node_tpu_chips(node) == 8
    assert node_tpu_chips({"status": {}}) == 0


def test_limited_mode_uses_discovered_capacity():
    cluster = make_cluster(replicas=1)
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "GLOBAL_OPT_INTERVAL": "30s",
        "OPTIMIZER_MODE": "limited",
        # best-effort under saturation, else an unsatisfiable demand gets
        # nothing rather than the capacity-capped allocation
        "SATURATION_POLICY": "PriorityExhaustive",
    })
    # enough v5e chips for a few 4-chip replicas
    for i in range(3):
        cluster.add_node(f"tpu-{i}", tpu_chips=4, accelerator="tpu-v5-lite-podslice")
    rec = held_reconciler(kube=cluster, prom=make_prom(arrival_rps=50.0),
                     config=ReconcilerConfig(config_namespace=CFG_NS,
                                             **PORT_CPU))
    optimizer, capacity = rec.read_optimizer_and_capacity()
    assert not optimizer.unlimited
    assert capacity.chips == {"v5e": 12}

    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    d = va.status.desired_optimized_alloc
    # demand wants ~9 replicas (see test_cycle_scales_out_under_load) but
    # 12 chips cap v5e-4 at 3 pod-slices
    assert d.accelerator == "v5e-4"
    assert d.num_replicas == 3


def test_static_capacity_wins_over_inventory():
    cluster = make_cluster(replicas=1)
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "GLOBAL_OPT_INTERVAL": "30s",
        "OPTIMIZER_MODE": "limited",
        "TPU_CAPACITY": '{"v5e": 64}',
    })
    cluster.add_node("tpu-0", tpu_chips=4, accelerator="tpu-v5-lite-podslice")
    rec = held_reconciler(kube=cluster, prom=make_prom(),
                     config=ReconcilerConfig(config_namespace=CFG_NS,
                                             **PORT_CPU))
    _, capacity = rec.read_optimizer_and_capacity()
    assert capacity.chips == {"v5e": 64}


def test_unlimited_mode_skips_inventory():
    cluster = make_cluster(replicas=1)
    cluster.add_node("tpu-0", tpu_chips=4, accelerator="tpu-v5-lite-podslice")
    rec = held_reconciler(kube=cluster, prom=make_prom(),
                     config=ReconcilerConfig(config_namespace=CFG_NS,
                                             **PORT_CPU))
    optimizer, capacity = rec.read_optimizer_and_capacity()
    assert optimizer.unlimited
    assert capacity.chips == {}


def test_unschedulable_and_malformed_nodes_skipped():
    from inferno_tpu_torch.controller.inventory import (
        collect_tpu_inventory,
        node_tpu_chips,
    )

    class K:
        @staticmethod
        def list_nodes():
            return [
                # cordoned: must not count
                {"metadata": {"labels": {
                    "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}},
                 "spec": {"unschedulable": True},
                 "status": {"allocatable": {"google.com/tpu": "4"}}},
                # garbage chip count -> 0
                {"metadata": {"labels": {
                    "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}},
                 "status": {"allocatable": {"google.com/tpu": "not-a-number"}}},
                # TPU chips but no accelerator label -> unattributable, skip
                {"metadata": {"labels": {}},
                 "status": {"allocatable": {"google.com/tpu": "4"}}},
                # healthy
                {"metadata": {"labels": {
                    "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}},
                 "status": {"allocatable": {"google.com/tpu": "8"}}},
            ]

    cap = collect_tpu_inventory(K())
    assert cap.chips == {"v5e": 8}
    assert node_tpu_chips({"status": {"allocatable": {"google.com/tpu": None}}}) == 0


def test_limited_mode_over_real_http_apiserver():
    """The kind CI job's limited-mode variant, rehearsed offline over the
    wire: Node objects with fake google.com/tpu capacity live behind the
    real-HTTP MiniApiServer, OPTIMIZER_MODE=limited with NO static
    TPU_CAPACITY, and the greedy solver's decision is capped by the
    DISCOVERED pool (2 nodes x 4 chips = 8 -> two v5e-4 pod-slices)."""
    import json as _json
    import urllib.request

    from inferno_tpu_torch.controller.kube import RestKubeClient
    from inferno_tpu_torch.testing.apiserver import MiniApiServer

    from test_torch_apiserver import add_deployment, make_va_doc, post, seed_config

    srv = MiniApiServer().start()
    try:
        seed_config(srv)
        # limited mode, no TPU_CAPACITY: inventory is the only source
        cm_path = f"/api/v1/namespaces/{CFG_NS}/configmaps/inferno-autoscaler-config"
        cur = _json.loads(urllib.request.urlopen(srv.url + cm_path).read())
        cur["data"].update({"OPTIMIZER_MODE": "limited",
                            "SATURATION_POLICY": "PriorityExhaustive"})
        req = urllib.request.Request(
            srv.url + cm_path, method="PATCH",
            data=_json.dumps({"data": cur["data"]}).encode(),
            headers={"Content-Type": "application/merge-patch+json"})
        urllib.request.urlopen(req)
        for i in range(2):
            post(srv, "/api/v1/nodes", {
                "metadata": {
                    "name": f"kind-worker-{i}",
                    "labels": {"cloud.google.com/gke-tpu-accelerator":
                               "tpu-v5-lite-podslice"},
                },
                "status": {"allocatable": {"google.com/tpu": "4"}},
            })
        post(srv, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings",
             make_va_doc())
        add_deployment(srv, NS, "llama-premium", replicas=1)

        client = RestKubeClient(base_url=srv.url, token="", namespace=CFG_NS)
        rec = held_reconciler(kube=client, prom=make_prom(arrival_rps=50.0),
                         config=ReconcilerConfig(config_namespace=CFG_NS,
                                                 **PORT_CPU,
                                                 direct_scale=True))
        optimizer, capacity = rec.read_optimizer_and_capacity()
        assert not optimizer.unlimited
        assert capacity.chips == {"v5e": 8}

        report = rec.run_cycle()
        assert report.errors == [], report.errors
        va = client.get_variant_autoscaling(NS, "llama-premium")
        d = va.status.desired_optimized_alloc
        # demand asks ~9-10 replicas (test_cycle_scales_out_under_load);
        # 8 discovered chips cap v5e-4 at 2 pod-slices
        assert d.accelerator == "v5e-4" and d.num_replicas == 2
        assert client.get_deployment(NS, "llama-premium")["spec"]["replicas"] == 2
    finally:
        srv.stop()
