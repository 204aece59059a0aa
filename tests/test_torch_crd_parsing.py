"""CRD wire-shape parsing robustness.

The controller ingests VariantAutoscaling documents straight from the
API server; sparse, stringly-typed, or null-bearing manifests must parse
into safe defaults, mirroring the tolerance the reference gets from
OpenAPI defaulting + Go zero values (api/v1alpha1/variantautoscaling_types.go).

Port of tests/test_crd_parsing.py on the port's modules, the expectations unchanged.
"""

import pytest

from inferno_tpu_torch.controller.crd import (
    AcceleratorProfile,
    VariantAutoscaling,
    VariantAutoscalingSpec,
)


def test_minimal_document_parses():
    va = VariantAutoscaling.from_dict({
        "metadata": {"name": "v", "namespace": "ns"},
        "spec": {"modelID": "m"},
    })
    assert va.name == "v" and va.namespace == "ns"
    assert va.spec.model_id == "m"
    assert va.spec.accelerators == []
    assert va.active  # no deletionTimestamp
    assert va.status.desired_optimized_alloc.num_replicas == 0


def test_null_sections_treated_as_absent():
    """kubectl apply of a manifest with explicit nulls must not crash
    (yaml `field:` with no value arrives as None)."""
    va = VariantAutoscaling.from_dict({
        "metadata": {"name": "v", "namespace": "ns", "labels": None},
        "spec": {
            "modelID": "m",
            "sloClassRef": None,
            "modelProfile": None,
        },
        "status": None,
    })
    assert va.spec.slo_class_ref.name == ""
    assert va.spec.accelerators == []


def test_stringly_numeric_perf_parms():
    """The reference wire shape carries alpha/beta/gamma/delta as strings
    (variantautoscaling_types.go:41-50); numeric strings must coerce."""
    prof = AcceleratorProfile.from_dict({
        "acc": "v5e-4",
        "maxBatchSize": "64",
        "atTokens": "128",
        "perfParms": {
            "decodeParms": {"alpha": "20.58", "beta": "0.41"},
            "prefillParms": {"gamma": "5.2", "delta": "0.1"},
        },
    })
    assert prof.max_batch_size == 64
    assert prof.decode_parms.alpha == pytest.approx(20.58)
    assert prof.prefill_parms.delta == pytest.approx(0.1)


def test_empty_perf_parms_default_to_zero():
    prof = AcceleratorProfile.from_dict({"acc": "v5e-4", "perfParms": None})
    assert prof.decode_parms.alpha == 0.0
    assert prof.prefill_parms.gamma == 0.0
    assert prof.acc_count == 1  # Go-zero-value style defaults
    assert prof.max_batch_size == 1


def test_context_buckets_sorted_regardless_of_manifest_order():
    prof = AcceleratorProfile.from_dict({
        "acc": "v5e-4",
        "contextBuckets": [
            {"maxInTokens": 16384, "perfParms": {}},
            {"maxInTokens": 4096, "perfParms": {}},
            {"maxInTokens": 65536, "perfParms": {}},
        ],
    })
    assert [b.max_in_tokens for b in prof.context_buckets] == [4096, 16384, 65536]
    assert prof.bucket_for(5000).max_in_tokens == 16384
    assert prof.bucket_for(100000) is None  # beyond largest: base parms
    assert prof.bucket_for(0) is None


def test_deleted_variant_inactive():
    va = VariantAutoscaling.from_dict({
        "metadata": {"name": "v", "namespace": "ns",
                     "deletionTimestamp": "2026-07-30T00:00:00Z"},
        "spec": {"modelID": "m"},
    })
    assert not va.active


def test_round_trip_preserves_disagg_and_buckets():
    doc = {
        "metadata": {"name": "v", "namespace": "ns"},
        "spec": {
            "modelID": "m",
            "sloClassRef": {"name": "svc", "key": "Premium"},
            "modelProfile": {"accelerators": [{
                "acc": "v5e-16", "accCount": 1, "maxBatchSize": 32,
                "atTokens": 128,
                "perfParms": {
                    "decodeParms": {"alpha": "8", "beta": "0.2"},
                    "prefillParms": {"gamma": "3", "delta": "0.01"},
                },
                "disagg": {"prefillSlices": 1, "decodeSlices": 3},
                "contextBuckets": [{
                    "maxInTokens": 8192, "maxBatchSize": 16,
                    "perfParms": {"decodeParms": {"alpha": "9", "beta": "0.3"},
                                  "prefillParms": {"gamma": "4", "delta": "0.02"}},
                }],
            }]},
        },
    }
    va = VariantAutoscaling.from_dict(doc)
    again = VariantAutoscaling.from_dict(va.to_dict())
    prof = again.spec.accelerators[0]
    assert prof.disagg is not None and prof.disagg.decode_slices == 3
    assert prof.context_buckets[0].max_batch_size == 16

    # bucketed perf spec: observed 4k input selects the 8192 bucket
    perf = prof.to_perf_spec("m", avg_in_tokens=4000.0)
    assert perf.decode_parms.alpha == pytest.approx(9.0)
    assert perf.max_batch_size == 16
    # beyond the bucket: base parms
    perf = prof.to_perf_spec("m", avg_in_tokens=50000.0)
    assert perf.decode_parms.alpha == pytest.approx(8.0)
    assert perf.max_batch_size == 32


def test_spec_defaults_without_model_profile():
    spec = VariantAutoscalingSpec.from_dict({})
    assert spec.model_id == ""
    assert spec.accelerators == []
