"""Actuator + metrics-emitter behavior specs.

Analogue of the reference actuator suite
(upstream internal/actuator/actuator_test.go): the gauge contract
HPA/KEDA consume — ratio encoding incl. scale-from-zero, counter
direction labels, ready-vs-spec replica observation, direct-scale
dispatch per workload kind, and scale-failure isolation.

Port of tests/test_actuator.py on the port's modules, the expectations unchanged.
"""

import pytest

from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller import InMemoryCluster
from inferno_tpu_torch.controller.actuator import Actuator
from inferno_tpu_torch.controller.crd import (
    ACCELERATOR_LABEL,
    AcceleratorProfile,
    ConfigMapKeyRef,
    VariantAutoscaling,
    VariantAutoscalingSpec,
)
from inferno_tpu_torch.controller.engines import (
    LABEL_ACCELERATOR,
    LABEL_DIRECTION,
    LABEL_OUT_NAMESPACE,
    LABEL_VARIANT,
)
from inferno_tpu_torch.controller.kube import KubeError
from inferno_tpu_torch.controller.metrics import MetricsEmitter

NS = "workloads"


def make_va(desired=3, acc="v5e-4"):
    va = VariantAutoscaling(
        name="llama",
        namespace=NS,
        labels={ACCELERATOR_LABEL: acc},
        spec=VariantAutoscalingSpec(
            model_id="m",
            slo_class_ref=ConfigMapKeyRef(name="svc", key="Premium"),
            accelerators=[
                AcceleratorProfile(
                    acc=acc, acc_count=1, max_batch_size=8, at_tokens=128,
                    decode_parms=DecodeParms(alpha=10.0, beta=0.1),
                    prefill_parms=PrefillParms(gamma=2.0, delta=0.01),
                )
            ],
        ),
    )
    va.status.desired_optimized_alloc.num_replicas = desired
    va.status.desired_optimized_alloc.accelerator = acc
    return va


def labels(acc="v5e-4"):
    return {LABEL_OUT_NAMESPACE: NS, LABEL_VARIANT: "llama", LABEL_ACCELERATOR: acc}


def setup(replicas=2, ready=None, desired=3):
    cluster = InMemoryCluster()
    cluster.add_deployment(NS, "llama", replicas=replicas)
    if ready is not None:
        # get_deployment returns a copy; reach into the store
        cluster._deployments[(NS, "llama")]["status"]["readyReplicas"] = ready
    emitter = MetricsEmitter()
    act = Actuator(kube=cluster, emitter=emitter)
    return cluster, emitter, act, make_va(desired=desired)


def test_gauges_and_ratio():
    _, emitter, act, va = setup(replicas=2, desired=3)
    act.emit_metrics(va)
    assert emitter.current_replicas.get(labels()) == 2.0
    assert emitter.desired_replicas.get(labels()) == 3.0
    assert emitter.desired_ratio.get(labels()) == pytest.approx(1.5)


def test_scale_from_zero_ratio_encodes_absolute_target():
    """0 -> N cannot be a ratio; the gauge carries N itself
    (reference internal/metrics/metrics.go:118-124)."""
    _, emitter, act, va = setup(replicas=0, desired=4)
    act.emit_metrics(va)
    assert emitter.desired_ratio.get(labels()) == 4.0


def test_scaling_counter_directions():
    cluster, emitter, act, va = setup(replicas=2, desired=3)
    act.emit_metrics(va)  # up
    va.status.desired_optimized_alloc.num_replicas = 1
    act.emit_metrics(va)  # down
    act.emit_metrics(va)  # down again (2 observed each time: no refresh)
    up = emitter.scaling_total.get({**labels(), LABEL_DIRECTION: "up"})
    down = emitter.scaling_total.get({**labels(), LABEL_DIRECTION: "down"})
    assert up == 1.0
    assert down == 2.0


def test_ready_replicas_preferred_over_spec():
    """Observed capacity is what is Ready, not what is asked for
    (reference reads Status.ReadyReplicas, actuator.go:29-48)."""
    _, emitter, act, va = setup(replicas=5, ready=2, desired=5)
    act.emit_metrics(va)
    assert emitter.current_replicas.get(labels()) == 2.0
    assert act.current_replicas(va) == 2


def test_direct_scale_deployment():
    cluster, emitter, act, va = setup(replicas=1, desired=3)
    act.direct_scale = True
    act.emit_metrics(va)
    assert cluster.get_deployment(NS, "llama")["spec"]["replicas"] == 3


def test_direct_scale_noop_when_converged():
    cluster, emitter, act, va = setup(replicas=3, desired=3)
    act.direct_scale = True
    before = cluster.get_deployment(NS, "llama")["spec"]["replicas"]
    act.emit_metrics(va)
    assert cluster.get_deployment(NS, "llama")["spec"]["replicas"] == before


def test_direct_scale_lws_scales_groups():
    """A multi-host variant scales LeaderWorkerSet GROUPS; pod count is
    groups x group size and never fractional-host."""
    cluster = InMemoryCluster()
    cluster.add_leader_worker_set(NS, "llama", replicas=1, size=4)
    emitter = MetricsEmitter()
    act = Actuator(kube=cluster, emitter=emitter, direct_scale=True)
    va = make_va(desired=2, acc="v5e-16")
    act.emit_metrics(va)
    lws = cluster.get_leader_worker_set(NS, "llama")
    assert lws["spec"]["replicas"] == 2
    assert cluster.pod_count(NS, "llama") == 8  # 2 groups x 4 pods
    assert emitter.current_replicas.get(labels("v5e-16")) == 1.0  # pre-scale observation


def test_scale_failure_does_not_fail_emit():
    class Flaky(InMemoryCluster):
        def scale_deployment(self, namespace, name, replicas):
            raise KubeError("forbidden")

    cluster = Flaky()
    cluster.add_deployment(NS, "llama", replicas=1)
    emitter = MetricsEmitter()
    act = Actuator(kube=cluster, emitter=emitter, direct_scale=True)
    va = make_va(desired=3)
    act.emit_metrics(va)  # must not raise (next cycle retries)
    assert emitter.desired_replicas.get(labels()) == 3.0
    assert cluster.get_deployment(NS, "llama")["spec"]["replicas"] == 1


def test_missing_workload_propagates():
    cluster = InMemoryCluster()
    act = Actuator(kube=cluster, emitter=MetricsEmitter())
    with pytest.raises(KubeError):
        act.emit_metrics(make_va())


def test_exposition_renders_all_series():
    _, emitter, act, va = setup(replicas=2, desired=3)
    act.emit_metrics(va)
    text = emitter.registry.render()
    assert "inferno_desired_replicas" in text
    assert "inferno_current_replicas" in text
    assert "inferno_desired_ratio" in text
    assert 'variant_name="llama"' in text


def test_shape_migration_drops_old_accelerator_series():
    """A migration re-keys the variant's gauges by accelerator; the
    old-shape series must disappear or adapter queries aggregating over
    the variant read stale values forever."""
    cluster = InMemoryCluster()
    cluster.add_deployment(NS, "llama", replicas=2)
    emitter = MetricsEmitter()
    act = Actuator(kube=cluster, emitter=emitter)
    act.emit_metrics(make_va(desired=3, acc="v5e-4"))
    assert emitter.desired_replicas.get(labels("v5e-4")) == 3.0

    act.emit_metrics(make_va(desired=1, acc="v5e-16"))
    assert emitter.desired_replicas.get(labels("v5e-16")) == 1.0
    for series in (emitter.desired_replicas, emitter.current_replicas,
                   emitter.desired_ratio):
        assert series.get(labels("v5e-4")) is None
    # no GAUGE line still carries the old shape (the scaling counter keeps
    # its history — counters are cumulative by contract)
    for line in emitter.registry.render().splitlines():
        if 'accelerator="v5e-4"' in line:
            assert line.startswith("inferno_replica_scaling_total"), line


def test_deleted_variant_gauges_pruned():
    """prune_variants drops the gauge series of variants no longer
    managed; active variants and counter history are untouched."""
    emitter = MetricsEmitter()
    cluster = InMemoryCluster()
    cluster.add_deployment(NS, "llama", replicas=1)
    cluster.add_deployment(NS, "other", replicas=1)
    act = Actuator(kube=cluster, emitter=emitter)
    act.emit_metrics(make_va(desired=2))
    va2 = make_va(desired=1)
    va2.name = "other"
    act.emit_metrics(va2)

    emitter.prune_variants({(NS, "other")})  # "llama" was deleted
    assert emitter.desired_replicas.get(labels()) is None
    other = {**labels(), LABEL_VARIANT: "other"}
    assert emitter.desired_replicas.get(other) == 1.0
    # counter history survives (cumulative by contract)
    assert emitter.scaling_total.get({**labels(), LABEL_DIRECTION: "up"}) == 1.0
