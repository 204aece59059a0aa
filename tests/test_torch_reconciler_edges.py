"""Reconciler failure-path behavior specs, on the port's `Reconciler`.
Port of tests/test_reconciler_edges.py.

The analogue of the reference controller suite's failure scenarios
(upstream internal/controller/variantautoscaling_controller_test.go):
optimizer failure marking every prepared VA, per-VA skip-and-continue in
the apply phase, metric-emission failures not failing the cycle, and the
tolerant ConfigMap parsing the controller promises.

Every reconciler here sizes on backend "torch" on the CPU, asked for
explicitly (`reconciler()`), and every clean cycle over an in-memory
cluster is held to the reference's decisions on the same inputs
(`test_torch_held_cycle.held_reconciler`). The expectations are the
reference's, except `TestAutoBackend`: the port resolves "auto" by its own
rule (controller/reconciler.py `resolve_compute_backend`): `cuda` with a
CUDA card, and without one startup fails (the CPU is an explicit choice);
an explicit backend is kept; the reference's `tpu`, `tpu-pallas` and `jax`
are refused. The reference resolves to `tpu`, else `native`, else `jax`.
"""

import json

import pytest

from inferno_tpu_torch.controller import InMemoryCluster, Reconciler, ReconcilerConfig
from inferno_tpu_torch.controller.crd import (
    TYPE_OPTIMIZATION_READY,
    REASON_OPTIMIZATION_FAILED,
)
from inferno_tpu_torch.controller.kube import KubeError
from inferno_tpu_torch.controller.promclient import FakeProm

from test_torch_apiserver import CFG_NS, NS, make_cluster, make_prom
from test_torch_held_cycle import PORT_CPU, held_reconciler


def reconciler(cluster, prom, **kw):
    cfg = ReconcilerConfig(config_namespace=CFG_NS, **PORT_CPU, **kw)
    return held_reconciler(cluster, prom, cfg)


def flaky_cluster(cls):
    """make_cluster()'s seeded state rehosted onto an error-injecting
    subclass (one shared transplant point: instance state lives in
    __dict__ for InMemoryCluster)."""
    cluster = cls()
    cluster.__dict__.update(make_cluster().__dict__)
    return cluster


def add_second_variant(cluster):
    """A second healthy variant so per-VA skip behavior is observable."""
    import copy

    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    va2 = copy.deepcopy(va)
    va2.name = "llama-second"
    cluster.add_variant_autoscaling(va2)
    cluster.add_deployment(NS, "llama-second", replicas=1)
    return va2


# -- optimize failure marks ALL prepared VAs (controller.go:164-186) ---------


def test_optimize_failure_marks_every_prepared_va(monkeypatch):
    cluster = make_cluster()
    add_second_variant(cluster)
    rec = reconciler(cluster, make_prom())

    class Boom:
        def __init__(self, spec):
            pass

        def optimize(self, system, calculate=False):
            raise RuntimeError("solver exploded")

    monkeypatch.setattr("inferno_tpu_torch.controller.reconciler.Optimizer", Boom)
    report = rec.run_cycle()
    assert not report.optimization_ok
    assert any("solver exploded" in e for e in report.errors)
    for name in ("llama-premium", "llama-second"):
        va = cluster.get_variant_autoscaling(NS, name)
        cond = va.status.condition(TYPE_OPTIMIZATION_READY)
        assert cond is not None and cond.status == "False", name
        assert cond.reason == REASON_OPTIMIZATION_FAILED


def test_optimize_failure_is_retried_next_cycle(monkeypatch):
    cluster = make_cluster()
    rec = reconciler(cluster, make_prom())

    class Boom:
        def __init__(self, spec):
            pass

        def optimize(self, system, calculate=False):
            raise RuntimeError("transient")

    monkeypatch.setattr("inferno_tpu_torch.controller.reconciler.Optimizer", Boom)
    assert not rec.run_cycle().optimization_ok
    monkeypatch.undo()
    report = rec.run_cycle()  # no code change needed: next cycle recovers
    assert report.optimization_ok
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    assert va.status.condition(TYPE_OPTIMIZATION_READY).status == "True"


# -- apply-phase per-VA skip (controller.go:338-407) -------------------------


def test_refetch_failure_skips_one_applies_other():
    class Flaky(InMemoryCluster):
        def get_variant_autoscaling(self, namespace, name):
            if name == "llama-premium" and getattr(self, "_arm", False):
                raise KubeError("apiserver hiccup")
            return super().get_variant_autoscaling(namespace, name)

    cluster = flaky_cluster(Flaky)
    add_second_variant(cluster)
    rec = reconciler(cluster, make_prom())
    cluster._arm = True

    report = rec.run_cycle()
    assert any("refetch" in e for e in report.errors)
    # the healthy variant still got its status applied
    assert report.variants_applied == 1
    ok = cluster.get_variant_autoscaling(NS, "llama-second")
    assert ok.status.condition(TYPE_OPTIMIZATION_READY).status == "True"
    assert ok.status.desired_optimized_alloc.num_replicas >= 1


def test_status_update_failure_recorded_cycle_continues():
    class Flaky(InMemoryCluster):
        def update_variant_autoscaling_status(self, va):
            if va.name == "llama-premium" and getattr(self, "_arm", False):
                raise KubeError("write denied")
            return super().update_variant_autoscaling_status(va)

    cluster = flaky_cluster(Flaky)
    add_second_variant(cluster)
    rec = reconciler(cluster, make_prom())
    cluster._arm = True

    report = rec.run_cycle()
    assert any("status" in e and "write denied" in e for e in report.errors)
    assert report.variants_applied == 1  # the other one landed


def test_emit_metrics_failure_does_not_fail_cycle(monkeypatch):
    cluster = make_cluster()
    rec = reconciler(cluster, make_prom())

    def boom(va):
        raise KubeError("metrics sink down")

    monkeypatch.setattr(rec.actuator, "emit_metrics", boom)
    report = rec.run_cycle()
    # the cycle is healthy, status still written, actuation flagged false
    # (reference: actuator.go:69-74)
    assert report.optimization_ok
    assert report.variants_applied == 1
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    assert va.status.actuation_applied is False
    assert va.status.condition(TYPE_OPTIMIZATION_READY).status == "True"
    assert va.status.desired_optimized_alloc.num_replicas >= 1


def test_list_failure_aborts_cycle_cleanly():
    class Down(InMemoryCluster):
        def list_variant_autoscalings(self):
            raise KubeError("apiserver down")

    cluster = flaky_cluster(Down)
    rec = reconciler(cluster, make_prom())
    report = rec.run_cycle()
    assert not report.optimization_ok
    assert any("list" in e for e in report.errors)
    assert report.variants_seen == 0


# -- squeezed-out floor (limited mode, no feasible allocation) ---------------


@pytest.mark.parametrize("scale_to_zero,floor", [(False, 1), (True, 0)])
def test_capacity_exhausted_floors_desired(scale_to_zero, floor):
    cluster = make_cluster(replicas=3)
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "GLOBAL_OPT_INTERVAL": "30s",
        "OPTIMIZER_MODE": "limited",
        "TPU_CAPACITY": json.dumps({"v5e": 0}),  # nothing to give
    })
    rec = reconciler(cluster, make_prom(), scale_to_zero=scale_to_zero)
    report = rec.run_cycle()
    assert report.optimization_ok, report.errors
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    cond = va.status.condition(TYPE_OPTIMIZATION_READY)
    assert cond.status == "False" and cond.reason == REASON_OPTIMIZATION_FAILED
    assert va.status.desired_optimized_alloc.num_replicas == floor


# -- tolerant ConfigMap parsing ---------------------------------------------


@pytest.mark.parametrize("raw,expect", [
    ("45s", 45),
    ("45", 45),
    ("2m", 30),        # unsupported unit -> configured default (30 here)
    ("garbage", 30),
    ("0", 30),         # zero is not a usable interval
    ("", 30),
])
def test_interval_parsing(raw, expect):
    cluster = make_cluster()
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config",
                          {"GLOBAL_OPT_INTERVAL": raw})
    rec = reconciler(cluster, make_prom())
    rec.config.interval_seconds = 30
    assert rec.read_interval() == expect


def test_malformed_accelerator_entries_skipped():
    cluster = make_cluster()
    cluster.set_configmap(CFG_NS, "accelerator-unit-costs", {
        "v5e-4": json.dumps({"cost": 10.0}),
        "v5e-16": "{not json",
    })
    rec = reconciler(cluster, make_prom())
    accs = rec.read_accelerators()
    assert [a.name for a in accs] == ["v5e-4"]
    assert accs[0].cost_per_chip_hr == 10.0


def test_malformed_service_class_docs_skipped():
    cluster = make_cluster()
    cluster.set_configmap(CFG_NS, "service-classes-config", {
        "good.yaml": "name: Premium\npriority: 1\ndata:\n"
                     "  - model: m\n    slo-ttft: 500\n    slo-tpot: 24\n",
        "noname.yaml": "priority: 3\n",
        "notmap.yaml": "- just\n- a list\n",
        "broken.yaml": "::: not yaml {{{",
    })
    rec = reconciler(cluster, make_prom())
    classes = rec.read_service_classes()
    assert [c.name for c in classes] == ["Premium"]
    assert classes[0].model_targets[0].slo_ttft == 500.0


def test_capacity_parsing_tolerates_bad_json():
    cluster = make_cluster()
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "OPTIMIZER_MODE": "unlimited",
        "TPU_CAPACITY": "{broken",
    })
    rec = reconciler(cluster, make_prom())
    optimizer, capacity = rec.read_optimizer_and_capacity()
    assert optimizer.unlimited
    assert capacity.chips == {}


def test_migration_with_direct_scale_refused():
    """KEEP_ACCELERATOR=false + DIRECT_SCALE=true would actuate a shape
    migration as a bare scale-down on the old hardware; the config must
    refuse the combination."""
    with pytest.raises(ValueError, match="KEEP_ACCELERATOR"):
        ReconcilerConfig(keep_accelerator=False, direct_scale=True)
    # each alone is fine
    ReconcilerConfig(keep_accelerator=False)
    ReconcilerConfig(direct_scale=True)


def test_unknown_engine_refused_at_config_time():
    """A typo'd SERVING_ENGINE must fail fast, not silently scrape the
    wrong metric vocabulary for the life of the process."""
    with pytest.raises(ValueError, match="sglang"):
        ReconcilerConfig(engine="sglang")


def test_delayed_best_effort_cm_knob():
    """Limited-mode best-effort deferral is configurable via the config
    ConfigMap like the other optimizer knobs (reference
    OptimizerSpec.DelayedBestEffort, pkg/config/types.go:151-155)."""
    cluster = make_cluster()
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "OPTIMIZER_MODE": "limited",
        "SATURATION_POLICY": "PriorityRoundRobin",
        "DELAYED_BEST_EFFORT": "true",
        "TPU_CAPACITY": json.dumps({"v5e": 64}),
    })
    rec = reconciler(cluster, make_prom())
    optimizer, capacity = rec.read_optimizer_and_capacity()
    assert not optimizer.unlimited
    assert optimizer.saturation_policy == "PriorityRoundRobin"
    assert optimizer.delayed_best_effort is True
    assert capacity.chips == {"v5e": 64}

    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "OPTIMIZER_MODE": "limited",
    })
    optimizer, _ = rec.read_optimizer_and_capacity()
    assert optimizer.delayed_best_effort is False


def test_deleted_variant_gauges_removed_next_cycle():
    """The cycle prunes gauges of VAs that vanished: no frozen desired/
    current values for external actuators to keep consuming."""
    from inferno_tpu_torch.controller.engines import (
        LABEL_ACCELERATOR, LABEL_OUT_NAMESPACE, LABEL_VARIANT,
    )

    cluster = make_cluster()
    rec = reconciler(cluster, make_prom(), direct_scale=True)
    rec.run_cycle()
    lbl = {LABEL_OUT_NAMESPACE: NS, LABEL_VARIANT: "llama-premium",
           LABEL_ACCELERATOR: "v5e-4"}
    assert rec.emitter.desired_replicas.get(lbl) is not None

    cluster.delete_variant_autoscaling(NS, "llama-premium")
    rec.run_cycle()
    assert rec.emitter.desired_replicas.get(lbl) is None
    assert rec.emitter.current_replicas.get(lbl) is None


def test_shared_model_id_variants_keep_distinct_profiles():
    """Two variants serving the SAME modelID with different CR profiles
    must not overwrite each other in the per-cycle registry (the perf
    registry is keyed (model, acc) last-wins; the reconciler namespaces
    the key per variant)."""
    import copy

    cluster = make_cluster()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    va2 = copy.deepcopy(va)
    va2.name = "llama-premium-b"
    # same modelID, much slower decode profile: B needs far more replicas
    va2.spec.accelerators = [va2.spec.accelerators[0]]
    va2.spec.accelerators[0].decode_parms = type(
        va2.spec.accelerators[0].decode_parms
    )(alpha=23.0, beta=0.3)
    cluster.add_variant_autoscaling(va2)
    cluster.add_deployment(NS, "llama-premium-b", replicas=1)

    rec = reconciler(cluster, make_prom(arrival_rps=10.0))
    report = rec.run_cycle()
    assert report.optimization_ok, report.errors
    fast = cluster.get_variant_autoscaling(NS, "llama-premium")
    slow = cluster.get_variant_autoscaling(NS, "llama-premium-b")
    n_fast = fast.status.desired_optimized_alloc.num_replicas
    n_slow = slow.status.desired_optimized_alloc.num_replicas
    assert n_fast >= 1 and n_slow >= 1
    # the slow profile needs strictly more replicas for the same load; if
    # the registry had last-wins clobbered the profiles they'd be equal
    assert n_slow > n_fast, (n_fast, n_slow)


def test_run_forever_soak_with_gate_flaps_and_pokes():
    """Short soak of the production loop shape: a non-leader idles without
    reconciling, regaining leadership resumes cycles, watch pokes cut the
    interval short, and stop_check exits promptly."""
    import threading
    import time

    cluster = make_cluster()
    rec = reconciler(cluster, make_prom())
    rec.config.interval_seconds = 60  # poke must beat this
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config",
                          {"GLOBAL_OPT_INTERVAL": "60s"})

    cycles = []
    orig = rec.run_cycle

    def counting():
        report = orig()
        cycles.append(time.time())
        return report

    rec.run_cycle = counting
    state = {"stop": False, "leader": True}
    t = threading.Thread(
        target=rec.run_forever,
        kwargs=dict(stop_check=lambda: state["stop"],
                    gate=lambda: state["leader"]),
        daemon=True,
    )
    t.start()
    deadline = time.time() + 5
    while not cycles and time.time() < deadline:
        time.sleep(0.02)
    assert cycles, "first cycle never ran"

    # deposed: no cycles while the gate is closed
    state["leader"] = False
    rec.poke()
    n = len(cycles)
    time.sleep(1.5)
    assert len(cycles) == n, "non-leader reconciled"

    # re-elected: the gate loop notices leadership and cycles resume
    # (the wake-event poke path is proven by the shutdown step below —
    # with a 60s interval, a broken poke would hang the final join)
    state["leader"] = True
    deadline = time.time() + 5
    while len(cycles) <= n and time.time() < deadline:
        time.sleep(0.02)
    assert len(cycles) > n, "regained leadership did not resume cycles"

    # clean shutdown well inside the 60s interval: only a working poke
    # can interrupt the _wake.wait
    state["stop"] = True
    rec.poke()
    t.join(timeout=5)
    assert not t.is_alive()


class TestAutoBackend:
    """compute_backend="auto" (the default) resolves at Reconciler init, by
    the port's rule: `cuda` when a CUDA card is present; without one the
    Reconciler raises, naming the CPU route (never a silent CPU
    fallback); an explicit backend is kept without probing; the
    reference's backends are refused at config time."""

    def _rec(self, monkeypatch, cuda_present):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda_present)
        cluster = InMemoryCluster()
        return Reconciler(kube=cluster, prom=FakeProm(),
                          config=ReconcilerConfig(compute_backend="auto",
                                                  profile_correction=False))

    def test_default_is_auto(self):
        assert ReconcilerConfig().compute_backend == "auto"

    def test_cuda_when_device_present(self, monkeypatch):
        rec = self._rec(monkeypatch, cuda_present=True)
        assert rec.config.compute_backend == "cuda"

    def test_raises_without_device(self, monkeypatch):
        with pytest.raises(RuntimeError, match="COMPUTE_BACKEND=torch COMPUTE_DEVICE=cpu"):
            self._rec(monkeypatch, cuda_present=False)

    @pytest.mark.parametrize("backend", ["tpu", "tpu-pallas", "jax"])
    def test_reference_backends_refused(self, backend):
        with pytest.raises(ValueError, match="JAX"):
            ReconcilerConfig(compute_backend=backend)

    def test_explicit_backend_not_overridden(self, monkeypatch):
        import torch

        def boom():
            raise AssertionError("probe must not run for explicit backends")

        monkeypatch.setattr(torch.cuda, "is_available", boom)
        cluster = InMemoryCluster()
        rec = Reconciler(kube=cluster, prom=FakeProm(),
                         config=ReconcilerConfig(compute_backend="torch",
                                                 compute_device="cpu"))
        assert rec.config.compute_backend == "torch"
