"""Context-length-bucketed profiles on the port (the cases of
tests/test_context_buckets.py): bucket selection on the port's CRD types,
and the port's reconciler sizing from the bucket its observed load
selects, with the same replicas as the reference's reconciler on the same
cluster and metrics."""

from __future__ import annotations

import json
import time as _time

import pytest

from inferno_tpu.controller import reconciler as ref_reconciler
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller import InMemoryCluster, Reconciler, ReconcilerConfig
from inferno_tpu_torch.controller.crd import (
    ACCELERATOR_LABEL,
    AcceleratorProfile,
    ConfigMapKeyRef,
    ContextBucket,
    VariantAutoscaling,
    VariantAutoscalingSpec,
)
from inferno_tpu_torch.controller.promclient import FakeProm, Sample
from tests import test_context_buckets as ref_cases
from tests import test_controller as ref_ctl

MODEL = "meta-llama/Llama-3.1-8B"
NS = "workloads"
CFG_NS = "inferno-system"


def profile_with_buckets():
    return AcceleratorProfile(
        acc="v5e-4", acc_count=1, max_batch_size=64, at_tokens=128,
        decode_parms=DecodeParms(30.0, 0.6),
        prefill_parms=PrefillParms(8.0, 0.05),
        context_buckets=[
            ContextBucket(max_in_tokens=4096,
                          decode_parms=DecodeParms(18.0, 0.3),
                          prefill_parms=PrefillParms(5.0, 0.02)),
            ContextBucket(max_in_tokens=16384,
                          decode_parms=DecodeParms(22.0, 0.45),
                          prefill_parms=PrefillParms(6.0, 0.03),
                          max_batch_size=32),
        ],
    )


def make_prom(arrival_rps=5.0, in_tok=128.0):
    """The reference test's fake Prometheus, on the port's client."""
    prom = FakeProm()

    def handler(q):
        def s(v):
            return [Sample(labels={}, value=v, timestamp=_time.time())]

        if "num_requests_running" in q or "slots_used" in q:
            return s(3.0)
        if "success" in q:
            return s(arrival_rps)
        if "prompt_tokens" in q or "input_length" in q:
            return s(in_tok)
        if "generation_tokens" in q or "output_length" in q:
            return s(128.0)
        if "first_token" in q:
            return s(0.05)
        if "per_output_token" in q:
            return s(0.02)
        return []

    prom.add_handler(lambda q: True, handler)
    return prom


def make_cluster(accelerators):
    """The reference test's cluster (tests/test_controller.make_cluster)
    on the port's types, with the given profiles."""
    cluster = InMemoryCluster()
    cluster.set_configmap(CFG_NS, "accelerator-unit-costs", {
        "v5e-4": json.dumps({"cost": 10.0}), "v5e-16": json.dumps({"cost": 10.0})})
    cluster.set_configmap(CFG_NS, "service-classes-config", {
        "premium.yaml": ("name: Premium\npriority: 1\ndata:\n"
                         f"  - model: {MODEL}\n    slo-ttft: 500\n    slo-tpot: 24\n"),
        "freemium.yaml": ("name: Freemium\npriority: 10\ndata:\n"
                          "  - model: other/model\n    slo-ttft: 2000\n    slo-tpot: 200\n"),
    })
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {"GLOBAL_OPT_INTERVAL": "30s"})
    cluster.add_variant_autoscaling(VariantAutoscaling(
        name="llama-premium", namespace=NS, labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=accelerators)))
    cluster.add_deployment(NS, "llama-premium", replicas=1)
    return cluster


def port_desired(in_tok):
    cluster = make_cluster([profile_with_buckets()])
    rec = Reconciler(kube=cluster, prom=make_prom(arrival_rps=20.0, in_tok=in_tok),
                     config=ReconcilerConfig(config_namespace=CFG_NS,
                                             compute_backend="scalar", compute_device="cpu"))
    rec.run_cycle()
    return cluster.get_variant_autoscaling(NS, "llama-premium").status \
        .desired_optimized_alloc.num_replicas


def reference_desired(in_tok):
    cluster = ref_ctl.make_cluster(replicas=1)
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    va.spec.accelerators = [ref_cases.profile_with_buckets()]
    cluster.add_variant_autoscaling(va)
    rec = ref_reconciler.Reconciler(
        kube=cluster, prom=ref_ctl.make_prom(arrival_rps=20.0, in_tok=in_tok),
        config=ref_reconciler.ReconcilerConfig(config_namespace=CFG_NS,
                                               compute_backend="scalar"))
    rec.run_cycle()
    return cluster.get_variant_autoscaling(NS, "llama-premium").status \
        .desired_optimized_alloc.num_replicas


def test_bucket_selection():
    prof = profile_with_buckets()
    assert prof.bucket_for(0) is None
    assert prof.bucket_for(512).max_in_tokens == 4096
    assert prof.bucket_for(4096).max_in_tokens == 4096
    assert prof.bucket_for(9000).max_in_tokens == 16384
    assert prof.bucket_for(30000) is None


def test_to_perf_spec_applies_bucket():
    prof = profile_with_buckets()
    short = prof.to_perf_spec("m", avg_in_tokens=1000)
    assert short.decode_parms.alpha == 18.0 and short.max_batch_size == 64
    mid = prof.to_perf_spec("m", avg_in_tokens=9000)
    assert mid.decode_parms.alpha == 22.0
    assert mid.max_batch_size == 32
    long = prof.to_perf_spec("m", avg_in_tokens=64000)
    assert long.decode_parms.alpha == 30.0


def test_round_trip_wire_format():
    prof = profile_with_buckets()
    again = AcceleratorProfile.from_dict(prof.to_dict())
    assert again.context_buckets == prof.context_buckets
    assert prof.to_dict() == ref_cases.profile_with_buckets().to_dict()


@pytest.mark.parametrize("in_tok", [1000, 9000])
def test_reconcile_selects_bucket_like_the_reference(in_tok):
    assert port_desired(in_tok) == reference_desired(in_tok)


def test_reconcile_selects_bucket_from_observed_load():
    assert port_desired(9000) > port_desired(1000)


def test_two_variants_sharing_model_id_keep_their_own_profiles():
    fast_profile = AcceleratorProfile(
        acc="v5e-4", acc_count=1, max_batch_size=64, at_tokens=128,
        decode_parms=DecodeParms(18.0, 0.3), prefill_parms=PrefillParms(5.0, 0.0005),
    )
    cluster = make_cluster([profile_with_buckets()])
    cluster.delete_variant_autoscaling(NS, "llama-premium")
    for name, prof in (("va-bucketed", profile_with_buckets()), ("va-fast", fast_profile)):
        cluster.add_variant_autoscaling(VariantAutoscaling(
            name=name, namespace=NS, labels={ACCELERATOR_LABEL: "v5e-4"},
            spec=VariantAutoscalingSpec(
                model_id=MODEL,
                slo_class_ref=ConfigMapKeyRef("service-classes-config", "Premium"),
                accelerators=[prof])))
        cluster.add_deployment(NS, name, replicas=1)
    prom = FakeProm()
    prom.add_handler(lambda q: True, lambda q: [Sample(labels={}, value=(
        20.0 if "success" in q else (9000.0 if ("prompt" in q or "input" in q) else 64.0)
    ), timestamp=_time.time())])
    rec = Reconciler(kube=cluster, prom=prom,
                     config=ReconcilerConfig(config_namespace=CFG_NS,
                                             compute_backend="scalar", compute_device="cpu"))
    report = rec.run_cycle()
    assert report.variants_applied == 2, report
    bucketed = cluster.get_variant_autoscaling(NS, "va-bucketed").status.desired_optimized_alloc
    fast = cluster.get_variant_autoscaling(NS, "va-fast").status.desired_optimized_alloc
    assert bucketed.num_replicas > fast.num_replicas >= 1, (bucketed, fast)


def test_bucket_resolution_rebases_at_tokens():
    prof = AcceleratorProfile(
        acc="v5e-4", acc_count=1, max_batch_size=64, at_tokens=1280,
        decode_parms=DecodeParms(16.0, 0.2),
        prefill_parms=PrefillParms(8.0, 0.001),
        context_buckets=[
            ContextBucket(max_in_tokens=8192, max_batch_size=12, at_tokens=8448,
                          decode_parms=DecodeParms(20.0, 0.3),
                          prefill_parms=PrefillParms(8.0, 0.001)),
            ContextBucket(max_in_tokens=32768, max_batch_size=4,
                          decode_parms=DecodeParms(26.0, 0.5),
                          prefill_parms=PrefillParms(8.0, 0.001)),
        ],
    )
    spec = prof.to_perf_spec("m", avg_in_tokens=6000)
    assert spec.max_batch_size == 12 and spec.at_tokens == 8448
    spec = prof.to_perf_spec("m", avg_in_tokens=20000)
    assert spec.max_batch_size == 4 and spec.at_tokens == 32768
    base = prof.to_perf_spec("m", avg_in_tokens=0)
    assert base.max_batch_size == 64 and base.at_tokens == 1280
    parms_only = AcceleratorProfile(
        acc="v5e-4", max_batch_size=64, at_tokens=1280,
        decode_parms=DecodeParms(16.0, 0.2),
        prefill_parms=PrefillParms(8.0, 0.001),
        context_buckets=[ContextBucket(max_in_tokens=4096,
                                       decode_parms=DecodeParms(18.0, 0.25),
                                       prefill_parms=PrefillParms(8.0, 0.001))],
    )
    spec = parms_only.to_perf_spec("m", avg_in_tokens=2000)
    assert spec.max_batch_size == 64 and spec.at_tokens == 1280
    assert spec.decode_parms.alpha == 18.0
