"""Heterogeneous-generation economics (BASELINE config #4): the optimizer
choosing between TPU generations on cost, with COMMITTED profiles — the
v5e shapes measured on the real chip, the v6e shapes derived from them by
public hardware ratios (profiles/*.json, assumptions.cross_generation) —
not invented parms.

Scenarios mirror the reference's limited/greedy machinery
(upstream pkg/solver/greedy.go:35-104) on TPU vocabulary:

* economic migration: a tightened ITL SLO flips the cheapest feasible
  generation from v5e-4 (slower, cheaper chips: more replicas) to v6e-4
  (faster, pricier chips: one replica) — actuated only when
  KEEP_ACCELERATOR=false;
* limited-mode spillover: a constrained v5e pool forces the
  lower-priority variant onto the v6e pool while the Premium variant
  keeps the contended v5e capacity.

Port of tests/test_e2e_hetero.py on the port's controller and its copy of
the committed profiles; every Reconciler gets `compute_device="cpu"`.
"""

import json

import pytest

from inferno_tpu_torch.controller import InMemoryCluster, Reconciler, ReconcilerConfig, VariantAutoscaling
from inferno_tpu_torch.controller.crd import (
    ACCELERATOR_LABEL,
    AcceleratorProfile,
    ConfigMapKeyRef,
    VariantAutoscalingSpec,
)
from inferno_tpu_torch.models.profiles import load_named_profile

from test_torch_apiserver import CFG_NS, MODEL, NS, make_prom

FREE_MODEL = "other/model"


def committed_profile(acc: str) -> AcceleratorProfile:
    """CRD AcceleratorProfile from the committed profile store — the
    bench's own numbers, so the migration decision below is driven by
    measured/derived economics, not fixture constants."""
    spec = load_named_profile("llama-3.1-8b", acc)
    return AcceleratorProfile(
        acc=acc,
        acc_count=1,
        max_batch_size=spec.max_batch_size,
        at_tokens=spec.at_tokens,
        decode_parms=spec.decode_parms,
        prefill_parms=spec.prefill_parms,
    )


def service_classes_cm(premium_itl: float, free_itl: float = 200.0) -> dict:
    return {
        "premium.yaml": (
            "name: Premium\npriority: 1\ndata:\n"
            f"  - model: {MODEL}\n    slo-ttft: 500\n    slo-tpot: {premium_itl}\n"
        ),
        "freemium.yaml": (
            "name: Freemium\npriority: 10\ndata:\n"
            f"  - model: {MODEL}\n    slo-ttft: 2000\n    slo-tpot: {free_itl}\n"
        ),
    }


def make_hetero_cluster(premium_itl: float = 24.0, optimizer_cm: dict | None = None):
    cluster = InMemoryCluster()
    # public on-demand per-chip prices (bench.py): v5e $1.20, v6e $2.70
    cluster.set_configmap(CFG_NS, "accelerator-unit-costs", {
        "v5e-4": json.dumps({"cost": 1.20}),
        "v6e-4": json.dumps({"cost": 2.70}),
    })
    cluster.set_configmap(CFG_NS, "service-classes-config",
                          service_classes_cm(premium_itl))
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "GLOBAL_OPT_INTERVAL": "30s",
        **(optimizer_cm or {}),
    })
    va = VariantAutoscaling(
        name="llama-premium",
        namespace=NS,
        labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=[committed_profile("v5e-4-int8"),
                          committed_profile("v6e-4-int8")],
        ),
    )
    # the CR carries the committed profile names; the slice shapes they
    # occupy are v5e-4 / v6e-4 (the -int8 suffix names the dtype variant
    # of the profile, not a different slice) — relabel acc to the shape
    va.spec.accelerators[0].acc = "v5e-4"
    va.spec.accelerators[1].acc = "v6e-4"
    cluster.add_variant_autoscaling(va)
    cluster.add_deployment(NS, "llama-premium", replicas=2)
    return cluster


def run_cycle(cluster, prom, **cfg):
    rec = Reconciler(
        kube=cluster, prom=prom,
        config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS, compute_backend="scalar",
                                profile_correction=False, **cfg),
    )
    report = rec.run_cycle()
    assert report.errors == [], report.errors
    return cluster.get_variant_autoscaling(NS, "llama-premium")


def test_generation_migration_when_economics_demand():
    """At ITL 24 ms the slower-cheaper v5e-4 fleet wins ($9.6/hr for 2
    replicas vs $10.8 for one v6e-4); at ITL 8 ms v5e-4 must shrink its
    batch so far that 3 replicas ($14.4) lose to one v6e-4 ($10.8) — the
    optimizer must migrate GENERATIONS when allowed to."""
    prom = make_prom(arrival_rps=100.0, out_tok=128.0, in_tok=128.0)

    # relaxed SLO: stays on the cheap generation
    cluster = make_hetero_cluster(premium_itl=24.0)
    va = run_cycle(cluster, prom, keep_accelerator=False)
    assert va.status.desired_optimized_alloc.accelerator == "v5e-4"
    relaxed_replicas = va.status.desired_optimized_alloc.num_replicas
    assert relaxed_replicas == 2

    # tight SLO: economics flip to the faster generation
    cluster = make_hetero_cluster(premium_itl=8.0)
    va = run_cycle(cluster, prom, keep_accelerator=False)
    moved = va.status.desired_optimized_alloc
    assert moved.accelerator == "v6e-4", moved
    assert moved.num_replicas == 1

    # same tight SLO with the reference-default pin: no migration — the
    # variant pays in v5e replicas instead (utils.go:290 semantics)
    cluster = make_hetero_cluster(premium_itl=8.0)
    va = run_cycle(cluster, prom, keep_accelerator=True)
    pinned = va.status.desired_optimized_alloc
    assert pinned.accelerator == "v5e-4"
    assert pinned.num_replicas >= 3


def test_limited_mode_spills_low_priority_to_other_generation():
    """Heterogeneous POOL capacity: 8 v5e chips fit exactly the Premium
    variant's two v5e-4 slices; the Freemium variant's v5e candidate no
    longer fits and the greedy solver assigns it the v6e pool instead
    (reference machinery: pkg/solver/greedy.go:107-166 on chip pools)."""
    prom = make_prom(arrival_rps=100.0, out_tok=128.0, in_tok=128.0)
    cluster = make_hetero_cluster(
        premium_itl=24.0,
        optimizer_cm={
            "OPTIMIZER_MODE": "limited",
            "TPU_CAPACITY": json.dumps({"v5e": 8, "v6e": 64}),
        },
    )
    free_va = VariantAutoscaling(
        name="llama-freemium",
        namespace=NS,
        labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Freemium"),
            accelerators=[committed_profile("v5e-4-int8"),
                          committed_profile("v6e-4-int8")],
        ),
    )
    free_va.spec.accelerators[0].acc = "v5e-4"
    free_va.spec.accelerators[1].acc = "v6e-4"
    cluster.add_variant_autoscaling(free_va)
    cluster.add_deployment(NS, "llama-freemium", replicas=1)

    rec = Reconciler(
        kube=cluster, prom=prom,
        config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS, compute_backend="scalar",
                                profile_correction=False, keep_accelerator=False),
    )
    report = rec.run_cycle()
    assert report.errors == [], report.errors

    premium = cluster.get_variant_autoscaling(NS, "llama-premium")
    freemium = cluster.get_variant_autoscaling(NS, "llama-freemium")
    p_alloc = premium.status.desired_optimized_alloc
    f_alloc = freemium.status.desired_optimized_alloc
    # Premium (priority 1) keeps the contended cheap pool: 2 x v5e-4 = 8 chips
    assert p_alloc.accelerator == "v5e-4" and p_alloc.num_replicas == 2
    # Freemium spills to the v6e pool — served, not starved
    assert f_alloc.accelerator == "v6e-4", f_alloc
    assert f_alloc.num_replicas >= 1


def test_baseline_config4_v5e8_plus_v5p8_pool():
    """BASELINE.json config #4 verbatim: a heterogeneous v5e-8 + v5p-8
    pool with cost-optimal assignment. Committed profiles for BOTH shapes
    (v5e-8 measured-derived, v5p-8 cross-generation); the cheap v5e pool
    is capacity-limited, so the greedy solver keeps Premium on v5e-8 and
    spills Freemium to the v5p-8 pool."""
    prom = make_prom(arrival_rps=100.0, out_tok=128.0, in_tok=128.0)
    cluster = InMemoryCluster()
    cluster.set_configmap(CFG_NS, "accelerator-unit-costs", {
        "v5e-8": json.dumps({"cost": 1.20}),
        "v5p-8": json.dumps({"cost": 4.20}),
    })
    cluster.set_configmap(CFG_NS, "service-classes-config", service_classes_cm(24.0))
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "GLOBAL_OPT_INTERVAL": "30s",
        "OPTIMIZER_MODE": "limited",
        # one v5e-8 slice fits; everything else must use the v5p pool
        "TPU_CAPACITY": json.dumps({"v5e": 8, "v5p": 64}),
    })
    for name, klass in (("llama-premium", "Premium"), ("llama-freemium", "Freemium")):
        va = VariantAutoscaling(
            name=name, namespace=NS, labels={ACCELERATOR_LABEL: "v5e-8"},
            spec=VariantAutoscalingSpec(
                model_id=MODEL,
                slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key=klass),
                accelerators=[committed_profile("v5e-8-int8"),
                              committed_profile("v5p-8-int8")],
            ),
        )
        va.spec.accelerators[0].acc = "v5e-8"
        va.spec.accelerators[1].acc = "v5p-8"
        cluster.add_variant_autoscaling(va)
        cluster.add_deployment(NS, name, replicas=1)

    rec = Reconciler(
        kube=cluster, prom=prom,
        config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS, compute_backend="scalar",
                                profile_correction=False, keep_accelerator=False),
    )
    report = rec.run_cycle()
    assert report.errors == [], report.errors

    p = cluster.get_variant_autoscaling(NS, "llama-premium").status.desired_optimized_alloc
    f = cluster.get_variant_autoscaling(NS, "llama-freemium").status.desired_optimized_alloc
    # Premium (priority 1) takes the whole contended cheap pool
    assert p.accelerator == "v5e-8" and p.num_replicas == 1
    # Freemium is served from the v5p pool, not starved
    assert f.accelerator == "v5p-8", f
    assert f.num_replicas >= 1
