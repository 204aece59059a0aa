"""The port's profile synthesis (inferno_tpu_torch.models.profiles, numpy)
against the reference's: every function gives the reference's result on
the same raws (the same numpy calls in the same order, so exactly equal),
and the cases of tests/test_profiles.py run on the port. The committed
profile documents load through the port as through the reference, and
the H100 documents this port measured are checked for shape and
provenance.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

from inferno_tpu.config import tpu_catalog as ref_catalog
from inferno_tpu.models import profiles as ref
from inferno_tpu.models.llama_block import MODEL_PRESETS as REF_PRESETS
from inferno_tpu_torch.config.tpu_catalog import TPU_GENERATIONS
from inferno_tpu_torch.config.types import ModelPerfSpec
from inferno_tpu_torch.models import profiles as port
from inferno_tpu_torch.models.llama_block import MODEL_PRESETS, LlamaDims
from inferno_tpu_torch.models.profiles import (
    PROFILES_DIR,
    build_profile_json,
    derive_tensor_parallel,
    fit_tpu_profile,
    load_profile,
    max_batch_from_memory,
    synthesize_full_model,
)
from tests.test_profiles import (
    TRUE_BETA_PER_LAYER,
    TRUE_HEAD_MS,
    TRUE_LAYER_MS,
    TRUE_MIXED_Q,
    TRUE_PREFILL_PER_LAYER_PER_TOK,
    fake_raw,
)

H100_DIR = PROFILES_DIR / "h100"


def _fitted(fp):
    return (dataclasses.asdict(fp.decode), dataclasses.asdict(fp.prefill),
            fp.decode_rmse, fp.prefill_rmse)


# -- parity with the reference ----------------------------------------------


def test_profiles_dir_is_the_repos():
    assert PROFILES_DIR == ref.PROFILES_DIR == Path(__file__).resolve().parent.parent / "profiles"


@pytest.mark.parametrize("mixed", [False, True])
def test_synthesis_equals_reference(mixed):
    raw = fake_raw(mixed=mixed)
    for n_full in (8, 32, 80):
        assert port.synthesize_full_model(raw, n_full) == ref.synthesize_full_model(raw, n_full)
        assert port.ttft_points(raw, n_full) == ref.ttft_points(raw, n_full)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n_chips", [1, 4, 16])
@pytest.mark.parametrize("multiplier", [0.0, 0.5, 1.0, 2.0])
def test_fit_equals_reference(mixed, n_chips, multiplier):
    raw = fake_raw(mixed=mixed)
    got, got_meta = port.fit_tpu_profile(raw, 32, n_chips=n_chips,
                                         ici_cost_multiplier=multiplier)
    want, want_meta = ref.fit_tpu_profile(raw, 32, n_chips=n_chips,
                                          ici_cost_multiplier=multiplier)
    assert _fitted(got) == _fitted(want) and got_meta == want_meta


@pytest.mark.parametrize("kwargs", [
    dict(acc="v5e-1"),
    dict(acc="v5e-4", n_chips=4, weight_bytes_per_param=2.0),
    dict(acc="v6e-8-int8", n_chips=8, hbm_per_chip_gb=32.0, ici_bw_gbs=90.0,
         ici_latency_us=0.5, cross_generation={"source_generation": "v5e"}),
    dict(acc="h100-1", hbm_per_chip_gb=79.18, weight_bytes_per_param=2.0),
])
@pytest.mark.parametrize("mixed", [False, True])
def test_build_profile_json_equals_reference(kwargs, mixed):
    raw = fake_raw(mixed=mixed)
    assert port.build_profile_json(raw, **kwargs) == ref.build_profile_json(raw, **kwargs)


def test_rescales_equal_reference():
    raw = fake_raw(mixed=True)
    raw["meta"]["dtype"] = "bfloat16"
    raw["meta"]["weight_dtype"] = "int8"
    for src, dst in (("v5e", "v5p"), ("v5e", "v6e"), ("v6e", "v5e")):
        assert port.rescale_raw_cross_generation(
            raw, TPU_GENERATIONS[src], TPU_GENERATIONS[dst]
        ) == ref.rescale_raw_cross_generation(
            raw, ref_catalog.TPU_GENERATIONS[src], ref_catalog.TPU_GENERATIONS[dst])
    for model in ("llama-3.1-70b", "llama-3.2-1b"):
        assert port.rescale_raw_cross_model(raw, MODEL_PRESETS[model], model) == \
            ref.rescale_raw_cross_model(raw, REF_PRESETS[model], model)


@pytest.mark.parametrize("n_chips", [1, 4])
def test_context_buckets_equal_reference(n_chips):
    dims = {"hidden": 3072, "n_heads": 24, "n_kv_heads": 8, "head_dim": 128,
            "ffn": 8192, "vocab": 128256, "n_layers_full": 28}

    def raw_at(alpha, beta, context):
        return {"meta": {"model": "m", "dims": dims, "decode_context": context},
                "decode": [{"n_layers": L, "batch": b, "step_ms": L * (alpha + beta * b)}
                           for L in (2, 4, 8) for b in (1, 8, 32)]}

    doc = {"maxBatchSize": 60, "prefillParms": {"gamma": 9.0, "delta": 0.0005},
           "measurement_meta": {"dims": dims}}
    ctx = [(32768, raw_at(1.4, 0.03, 32768)), (8192, raw_at(0.8, 0.015, 8192)),
           (4096, raw_at(0.6, 0.012, 4096))]
    got = port.attach_context_buckets(copy.deepcopy(doc), ctx, n_chips=n_chips,
                                      weight_bytes_per_param=1.0)
    want = ref.attach_context_buckets(copy.deepcopy(doc), ctx, n_chips=n_chips,
                                      weight_bytes_per_param=1.0)
    assert got == want
    for max_in, raw_ctx in ctx:
        d_got, r_got = port.fit_decode_at_context(raw_ctx, 28, n_chips)
        d_want, r_want = ref.fit_decode_at_context(raw_ctx, 28, n_chips)
        assert dataclasses.asdict(d_got) == dataclasses.asdict(d_want) and r_got == r_want


def test_memory_cap_and_tp_derivation_equal_reference():
    for model, dims in MODEL_PRESETS.items():
        for hbm, at, wbytes, chips in ((16.0, 1280, 1.0, 1), (16.0, 1280, 2.0, 4),
                                       (95.0, 4352, 2.0, 16), (79.18, 1280, 2.0, 1)):
            assert port.max_batch_from_memory(dims, hbm, at, wbytes, n_chips=chips) == \
                ref.max_batch_from_memory(REF_PRESETS[model], hbm, at, wbytes, n_chips=chips)
    fp, _ = port.fit_tpu_profile(fake_raw())
    rp, _ = ref.fit_tpu_profile(fake_raw())
    for n in (1, 2, 8):
        assert _fitted(port.derive_tensor_parallel(fp, n)) == \
            _fitted(ref.derive_tensor_parallel(rp, n))


@pytest.mark.parametrize("path", sorted(PROFILES_DIR.glob("*.json")), ids=lambda p: p.name)
def test_committed_documents_load_as_in_reference(path):
    spec, doc = port.load_named_profile_doc(*path.stem.split("_", 1))
    want_spec, want_doc = ref.load_named_profile_doc(*path.stem.split("_", 1))
    assert doc == want_doc
    assert spec.to_dict() == want_spec.to_dict()
    assert port.profile_path(*path.stem.split("_", 1)) == path


def test_unfittable_raw_is_the_same_error():
    raw = fake_raw()
    raw["decode"] = [s for s in raw["decode"] if s["n_layers"] == 4]
    with pytest.raises(port.UnfittableRawError):
        port.synthesize_full_model(raw)
    assert issubclass(port.UnfittableRawError, ValueError)


# -- the reference's own cases, on the port --------------------------------


def test_layer_extrapolation_recovers_ground_truth():
    decode, prefill, meta = synthesize_full_model(fake_raw(), n_layers_full=32)
    assert meta["decode_layer_linearity_r2"] > 0.999
    assert meta["prefill_layer_linearity_r2"] > 0.999
    by_batch = {p["batch"]: p["step_ms"] for p in decode}
    expected_b1 = TRUE_HEAD_MS + 32 * (TRUE_LAYER_MS + TRUE_BETA_PER_LAYER)
    assert by_batch[1] == pytest.approx(expected_b1, rel=1e-6)


def test_fit_recovers_linear_parms_from_mixed_sweep():
    fitted, meta = fit_tpu_profile(fake_raw(mixed=True))
    assert meta["ttft_calibration"] == "mixed-step"
    assert fitted.decode.alpha == pytest.approx(TRUE_HEAD_MS + 32 * TRUE_LAYER_MS, rel=1e-6)
    assert fitted.decode.beta == pytest.approx(32 * TRUE_BETA_PER_LAYER, rel=1e-6)
    assert fitted.prefill.delta == pytest.approx(32 * TRUE_MIXED_Q, rel=1e-6)
    assert fitted.decode_rmse < 1e-6


def test_fit_without_mixed_uses_upper_bound():
    fitted, meta = fit_tpu_profile(fake_raw())
    assert meta["ttft_calibration"].startswith("mixed-upper-bound")
    pred = fitted.prefill.gamma + fitted.prefill.delta * 2048 * 64
    true_decode = TRUE_HEAD_MS + 32 * (TRUE_LAYER_MS + TRUE_BETA_PER_LAYER * 64)
    true_chunk = TRUE_HEAD_MS + 32 * TRUE_PREFILL_PER_LAYER_PER_TOK * 2048
    assert pred < 3 * (true_decode + true_chunk)
    assert fitted.prefill.delta < TRUE_PREFILL_PER_LAYER_PER_TOK * 32


def test_extrapolation_rejects_single_depth():
    raw = fake_raw()
    raw["decode"] = [s for s in raw["decode"] if s["n_layers"] == 4]
    with pytest.raises(ValueError):
        synthesize_full_model(raw)


def test_max_batch_from_memory():
    dims = LlamaDims()
    mb1 = max_batch_from_memory(dims, 16.0, 1280, weight_bytes_per_param=1.0)
    assert 8 <= mb1 <= 64
    assert max_batch_from_memory(dims, 16.0, 1280, weight_bytes_per_param=2.0) == 0
    mb4 = max_batch_from_memory(dims, 16.0, 1280, weight_bytes_per_param=2.0, n_chips=4)
    assert mb4 > 2 * mb1


def test_derive_tensor_parallel_scales_and_adds_ici():
    fitted, _ = fit_tpu_profile(fake_raw())
    tp4 = derive_tensor_parallel(fitted, 4)
    assert tp4.decode.alpha > fitted.decode.alpha / 4
    assert tp4.decode.alpha < fitted.decode.alpha / 2
    assert tp4.decode.beta < fitted.decode.beta


def test_build_profile_json_roundtrips_to_perf_spec(tmp_path):
    doc = build_profile_json(fake_raw(), "v5e-1", n_chips=1)
    assert doc["derived"] is False
    p = tmp_path / "p.json"
    p.write_text(json.dumps(doc))
    spec = load_profile(p)
    assert isinstance(spec, ModelPerfSpec)
    assert spec.acc == "v5e-1"
    assert spec.decode_parms.alpha == doc["decodeParms"]["alpha"]
    assert spec.max_batch_size == doc["maxBatchSize"] > 0


def test_derived_profile_marked():
    doc = build_profile_json(fake_raw(), "v5e-4", n_chips=4, weight_bytes_per_param=2.0)
    assert doc["derived"] is True
    assert doc["assumptions"]["n_chips"] == 4
    doc1 = build_profile_json(fake_raw(), "v5e-1", n_chips=1)
    assert doc["maxBatchSize"] > doc1["maxBatchSize"]


@pytest.mark.parametrize("path", sorted(PROFILES_DIR.glob("*.json")) or [None])
def test_committed_profiles_load(path):
    if path is None:
        pytest.skip("no committed profiles yet")
    spec = load_profile(path)
    assert spec.decode_parms.alpha > 0
    doc = json.loads(Path(path).read_text())
    if spec.max_batch_size == 0:
        assert doc["assumptions"]["n_chips"] == 1
        assert doc["assumptions"]["weight_bytes_per_param"] == 2.0
    assert doc["fit"]["decode_layer_linearity_r2"] > 0.95
    assert isinstance(doc["derived"], bool)


def test_attach_context_buckets_synthetic():
    from inferno_tpu_torch.controller.crd import ContextBucket
    from inferno_tpu_torch.models.profiles import attach_context_buckets

    dims = {"hidden": 3072, "n_heads": 24, "n_kv_heads": 8, "head_dim": 128,
            "ffn": 8192, "vocab": 128256, "n_layers_full": 28}

    def raw_at(per_layer_alpha, per_layer_beta, context):
        return {
            "meta": {"model": "m", "dims": dims, "decode_context": context},
            "decode": [
                {"n_layers": L, "batch": b,
                 "step_ms": L * (per_layer_alpha + per_layer_beta * b)}
                for L in (2, 4, 8) for b in (1, 8, 32)
            ],
        }

    doc = {"maxBatchSize": 60, "prefillParms": {"gamma": 9.0, "delta": 0.0005},
           "measurement_meta": {"dims": dims}}
    out = attach_context_buckets(
        doc, [(8192, raw_at(0.8, 0.015, 8192)), (4096, raw_at(0.6, 0.012, 4096))],
        n_chips=1, weight_bytes_per_param=1.0,
    )
    buckets = out["contextBuckets"]
    assert [b["maxInTokens"] for b in buckets] == [4096, 8192]
    b4 = buckets[0]
    assert b4["perfParms"]["decodeParms"]["alpha"] == pytest.approx(16.8, rel=1e-3)
    assert b4["perfParms"]["decodeParms"]["beta"] == pytest.approx(0.336, rel=1e-3)
    assert b4["perfParms"]["prefillParms"] == {"gamma": 9.0, "delta": 0.0005}
    assert b4["fit"]["decode_layer_linearity_r2"] == pytest.approx(1.0)
    assert buckets[1]["maxBatchSize"] < b4["maxBatchSize"] < 60
    cb = ContextBucket.from_dict(b4)
    assert cb.max_in_tokens == 4096
    assert cb.decode_parms.alpha == pytest.approx(16.8, rel=1e-3)


def test_load_profile_keeps_context_buckets(tmp_path):
    doc = {
        "name": "m", "acc": "v5e-1", "slicesPerReplica": 1,
        "maxBatchSize": 60, "atTokens": 1280,
        "decodeParms": {"alpha": 4.0, "beta": 0.07},
        "prefillParms": {"gamma": 9.0, "delta": 0.0005},
        "contextBuckets": [
            {"maxInTokens": 8192, "maxBatchSize": 12,
             "perfParms": {"decodeParms": {"alpha": 6.0, "beta": 0.09},
                           "prefillParms": {"gamma": 9.0, "delta": 0.0005}}},
            {"maxInTokens": 4096, "maxBatchSize": 24,
             "perfParms": {"decodeParms": {"alpha": 5.0, "beta": 0.08},
                           "prefillParms": {"gamma": 9.0, "delta": 0.0005}}},
        ],
    }
    p = tmp_path / "p.json"
    p.write_text(json.dumps(doc))
    spec = load_profile(p)
    assert [b.max_in_tokens for b in spec.context_buckets] == [4096, 8192]
    at = spec.at_context(3000)
    assert at.decode_parms.alpha == 5.0 and at.max_batch_size == 24
    far = spec.at_context(100_000)
    assert far.decode_parms.alpha == 4.0 and far.max_batch_size == 60
    assert spec.at_context(0) is spec
    again = ModelPerfSpec.from_dict(spec.to_dict())
    assert again == spec


def test_derived_profiles_respect_hbm_roofline():
    for model in ("llama-3.1-8b", "llama-3.2-3b"):
        docs = {}
        for p in sorted(PROFILES_DIR.glob(f"{model}_v*.json")):
            doc = json.loads(p.read_text())
            if doc["maxBatchSize"] <= 0:
                continue
            docs[doc["acc"]] = doc
        if not docs:
            pytest.skip(f"no committed profiles for {model}")
        dims_by = {}
        for acc, doc in docs.items():
            d = dict(doc["measurement_meta"]["dims"])
            n_layers = d.pop("n_layers_full")
            dims = LlamaDims(**d, n_layers=n_layers)
            wbytes = doc["assumptions"]["weight_bytes_per_param"]
            n_chips = doc["assumptions"]["n_chips"]
            bw = TPU_GENERATIONS[acc.split("-")[0]].hbm_bw_gbs
            params = (dims.n_layers * dims.layer_params_bytes(dtype_bytes=1)
                      + 2 * dims.hidden * dims.vocab)
            per_chip_gb = params * wbytes / 2**30 / n_chips
            util = (per_chip_gb / (doc["decodeParms"]["alpha"] * 1e-3)) / bw
            assert 0.2 < util < 1.0, (acc, util)
            dims_by[acc] = (n_chips, wbytes, util)
        for acc, (n_chips, wbytes, util) in dims_by.items():
            if n_chips == 1:
                continue
            base = next((u for a, (c, w, u) in dims_by.items() if c == 1 and w == wbytes), None)
            if base is not None:
                assert util <= base * 1.001, (acc, util, base)


def test_cross_model_rescale_scales_slope_and_intercept_separately():
    raw = fake_raw()
    raw["meta"]["dtype"] = "bfloat16"
    dst = MODEL_PRESETS["llama-3.1-70b"]
    src = LlamaDims()
    out = port.rescale_raw_cross_model(raw, dst, "llama-3.1-70b")
    assert out["meta"]["model"] == "llama-3.1-70b"
    assert out["meta"]["dims"]["n_layers_full"] == 80
    kv = 1 * 1024 * 2 * src.kv_dim * 2
    ratio = (dst.layer_params_bytes(2) + kv) / (src.layer_params_bytes(2) + kv)
    icpt = dst.hidden / src.hidden
    by_depth = {s["n_layers"]: s["step_ms"] for s in out["decode"] if s["batch"] == 1}
    slope = (by_depth[8] - by_depth[2]) / 6
    intercept = by_depth[2] - 2 * slope
    assert slope == pytest.approx((TRUE_LAYER_MS + TRUE_BETA_PER_LAYER) * ratio, rel=1e-6)
    assert intercept == pytest.approx(TRUE_HEAD_MS * icpt, rel=1e-6)

    def flops(d, b, t):
        return 2.0 * d.layer_params_bytes(1) * b * t + 2.0 * b * t * t * d.q_dim

    t = 512
    fr = flops(dst, 1, t) / flops(src, 1, t)
    pre = {s["n_layers"]: s["prefill_ms"] for s in out["prefill"]
           if s["batch"] == 1 and s["in_tokens"] == t}
    pslope = (pre[8] - pre[2]) / 6
    assert pslope == pytest.approx(TRUE_PREFILL_PER_LAYER_PER_TOK * t * fr, rel=1e-6)


def test_committed_70b_profiles_are_derived_with_cross_model_assumptions():
    for acc in ["v5e-16", "v5e-16-int8", "v5p-16-int8", "v6e-16-int8"]:
        _, doc = port.load_named_profile_doc("llama-3.1-70b", acc)
        assert doc["derived"] is True
        assert doc["assumptions"]["cross_model"]["donor_model"] == "llama-3.1-8b"
        assert "derivationErrorBars" in doc
        assert doc["assumptions"]["n_chips"] == 16
        assert 0 < doc["maxBatchSize"] < 5000
    _, doc = port.load_named_profile_doc("llama-3.1-70b", "v5e-16-int8")
    dims = MODEL_PRESETS["llama-3.1-70b"]
    params = dims.n_layers * dims.layer_params_bytes(1) + 2 * dims.hidden * dims.vocab
    free_gb = 16 * 16.0 - params / 2**30 - 16.0
    kv_per_req = doc["atTokens"] * dims.kv_bytes_per_token() / 2**30
    assert doc["maxBatchSize"] == pytest.approx(free_gb / kv_per_req, rel=0.25)


def test_70b_decode_slope_exceeds_8b_at_same_chips():
    small = json.loads((PROFILES_DIR / "llama-3.1-8b_v5e-8-int8.json").read_text())
    big = json.loads((PROFILES_DIR / "llama-3.1-70b_v5e-16-int8.json").read_text())
    assert big["decodeParms"]["alpha"] > small["decodeParms"]["alpha"]
    assert big["prefillParms"]["gamma"] > small["prefillParms"]["gamma"]


def test_derived_profiles_carry_error_bars():
    seen_derived = 0
    for p in sorted(PROFILES_DIR.glob("*_v*.json")):
        doc = json.loads(p.read_text())
        if not doc["derived"]:
            assert "derivationErrorBars" not in doc
            continue
        seen_derived += 1
        bars = doc["derivationErrorBars"]
        assert bars["ici_cost_multiplier_range"] == [0.5, 2.0]
        for key, parms in (("alpha", "decodeParms"), ("beta", "decodeParms"),
                           ("gamma", "prefillParms"), ("delta", "prefillParms")):
            lo, hi = bars[key]
            assert lo <= doc[parms][key] <= hi, (p.name, key)
    assert seen_derived >= 10


# -- the H100 documents ---------------------------------------------------------


@pytest.mark.parametrize("path", sorted(H100_DIR.glob("*_h100-1.json")), ids=lambda p: p.name)
def test_h100_documents_are_measured_and_rebuild_from_their_raw(path):
    """A measured single-card document: not derived, bf16 weights in the
    card's recorded memory, a decode fit linear in depth, the card's name
    and power limit in its measurement meta, and equal to a rebuild from
    its committed raw."""
    spec = load_profile(path)
    doc = json.loads(path.read_text())
    assert doc["acc"] == spec.acc == "h100-1" and doc["derived"] is False
    assert doc["assumptions"]["n_chips"] == 1
    assert doc["assumptions"]["weight_bytes_per_param"] == 2.0
    assert spec.max_batch_size > 0 and spec.decode_parms.alpha > 0
    assert doc["fit"]["decode_layer_linearity_r2"] > 0.95
    assert doc["fit"]["ttft_calibration"] == "mixed-step"
    device = doc["measurement_meta"]["device"]
    assert device["platform"] == "gpu" and "H100" in device["kind"]
    assert device["power_limit"].endswith("W")
    assert doc["assumptions"]["hbm_per_chip_gb"] == device["total_memory_gb"]
    assert doc["measurement_meta"]["timing"] == "cuda-events"
    raw = json.loads((H100_DIR / "raw" / f"{doc['name']}_h100.json").read_text())
    assert build_profile_json(raw, "h100-1", hbm_per_chip_gb=device["total_memory_gb"],
                              weight_bytes_per_param=2.0) == doc
    assert all(math.isfinite(s["step_ms"]) and s["step_ms"] > 0 for s in raw["decode"])
    assert np.isfinite(doc["prefillParms"]["delta"])
