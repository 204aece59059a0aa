"""Workload abstraction: Deployment vs LeaderWorkerSet resolution, group
semantics, and scaling dispatch (controller.workload — the replacement for
the reference's 1-replica=1-pod assumption,
upstream internal/collector/collector.go:243-244).

Port of tests/test_workload.py on the port's modules, the expectations unchanged.
"""

import pytest

from inferno_tpu_torch.controller.kube import InMemoryCluster, NotFound
from inferno_tpu_torch.controller.workload import (
    Workload,
    from_deployment,
    from_leader_worker_set,
    get_workload,
    scale_workload,
)


def test_deployment_resolution_wins_when_both_exist():
    c = InMemoryCluster()
    c.add_deployment("ns", "v", replicas=2)
    c.add_leader_worker_set("ns", "v", replicas=5, size=4)
    wl = get_workload(c, "ns", "v")
    assert wl.kind == "Deployment"
    assert wl.replicas == 2
    assert wl.group_size == 1


def test_lws_fallback_and_group_units():
    c = InMemoryCluster()
    c.add_leader_worker_set("ns", "v", replicas=3, size=4)
    wl = get_workload(c, "ns", "v")
    assert wl.kind == "LeaderWorkerSet"
    assert wl.api_version == "leaderworkerset.x-k8s.io/v1"
    assert wl.replicas == 3  # groups, not 12 pods
    assert wl.group_size == 4
    assert wl.ready_replicas == 3


def test_neither_workload_raises_not_found():
    c = InMemoryCluster()
    with pytest.raises(NotFound):
        get_workload(c, "ns", "missing")


def test_client_without_lws_support_propagates_not_found():
    class DeploymentOnly:
        def get_deployment(self, ns, name):
            raise NotFound(f"deployment {ns}/{name}")

    with pytest.raises(NotFound):
        get_workload(DeploymentOnly(), "ns", "v")


def test_scale_dispatches_by_kind():
    c = InMemoryCluster()
    c.add_deployment("ns", "d", replicas=1)
    c.add_leader_worker_set("ns", "l", replicas=1, size=4)

    scale_workload(c, get_workload(c, "ns", "d"), 4)
    assert c.get_deployment("ns", "d")["spec"]["replicas"] == 4

    scale_workload(c, get_workload(c, "ns", "l"), 2)
    lws = c.get_leader_worker_set("ns", "l")
    assert lws["spec"]["replicas"] == 2
    assert c.pod_count("ns", "l") == 8  # whole groups only


def test_workload_defaults_on_sparse_objects():
    wl = from_deployment({"metadata": {"name": "x"}, "spec": {}})
    assert wl.replicas == 0
    assert wl.ready_replicas is None
    assert wl.group_size == 1
    wl = from_leader_worker_set({"metadata": {}, "spec": {"replicas": 2}})
    assert wl.group_size == 1  # missing template -> size default
    assert isinstance(wl, Workload)
