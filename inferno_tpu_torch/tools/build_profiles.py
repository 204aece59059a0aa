"""Build profile documents from raw on-device measurements.

Port of `tools/build_profiles.py` over the port's `config.tpu_catalog` and
`models.profiles`, run as `python -m inferno_tpu_torch.tools.build_profiles`.
On the TPU raws under profiles/raw/ (written by tools/profile_tpu.py)
`build_model`, `build_cross_model`, `discover_models` and `main` behave as
the reference's, verbatim apart from their imports, `main`'s arguments
and the docstrings, which leave out the reference's TPU sizes:

  profiles/raw/<model>_tpu.json       bf16 weights
  profiles/raw/<model>_tpu_int8.json  int8 weights (w8a16), optional

Outputs per model:
  <model>_v5e-1.json        MEASURED single-chip profile from the best
      memory-feasible raw (int8 preferred; bf16 when it fits). Not
      emitted when no raw is memory-feasible on one chip.
  <model>_v5e-1-bf16.json / _v5e-1-int8.json   MEASURED transparency
      points when that dtype does NOT fit one chip (maxBatchSize 0,
      quarantined; never the headline).
  <model>_v5e-4.json / _v5e-8.json            DERIVED TP shapes from the
      bf16 measurement: per-chip traffic divided, analytic ICI
      all-reduce cost added; marked "derived": true.
  <model>_v5e-4-int8.json / _v5e-8-int8.json  DERIVED TP shapes from the
      int8 measurement (the standard TPU serving config).

The GPU path (`--gpu`, `build_gpu`) is the port's own: exactly one
MEASURED document per bf16 GPU raw under profiles/h100/raw/ (written by
`inferno_tpu_torch.tools.profile_gpu`), `profiles/h100/<model>_h100-1.json`,
with the device memory the raw records. It derives no multi-GPU shape
(the tensor-parallel and cross-generation derivations use TPU ICI
constants; an NVLink derivation would be new modelling) and builds
nothing from an int8 GPU raw (torch casts the weights eagerly, so those
timings are not a w8a16 kernel's).

    python -m inferno_tpu_torch.tools.build_profiles --gpu
"""

import argparse
import json
import sys
from pathlib import Path

from inferno_tpu_torch.config.tpu_catalog import (
    TPU_GENERATIONS,
    generation_from_device_kind,
)
from inferno_tpu_torch.models.llama_block import MODEL_PRESETS
from inferno_tpu_torch.models.profiles import (
    PROFILES_DIR,
    UnfittableRawError,
    attach_context_buckets,
    build_profile_json,
    rescale_raw_cross_generation,
    rescale_raw_cross_model,
)

RAW_DIR = PROFILES_DIR / "raw"


def raw_source_generation(raw: dict, raw_name: str):
    """The TPU generation a raw sweep was MEASURED on, resolved from its
    recorded meta.device (ADVICE r5: the cross-model path hardcoded v5e,
    so a donor measured on another generation would have been silently
    rescaled from the wrong hardware baseline). A recorded device kind is
    authoritative and errors out when unresolvable; raws predating the
    device-meta convention (no meta.device) default to v5e, as the
    reference's."""
    device = (raw.get("meta") or {}).get("device") or {}
    kind = str(device.get("kind", ""))
    if not kind:
        return TPU_GENERATIONS["v5e"]
    try:
        return generation_from_device_kind(kind)
    except ValueError as e:
        raise SystemExit(f"{raw_name}: {e}")

# Cross-generation shapes derived from the v5e measurement by hardware
# ratios (HBM bandwidth for decode, bf16 FLOPs for prefill — see
# rescale_raw_cross_generation): the heterogeneous-pool economics of
# BASELINE config #4 need v5p/v6e profiles that are not invented numbers.
CROSS_GEN_SHAPES = [("v5p", 8), ("v6e", 4), ("v6e", 8)]

# Cross-MODEL derivations (BASELINE config #5: multi-host 70B): built
# ONLY when the target model has no raw measurement of its own — a real
# `tools/profile_tpu.py --model llama-3.1-70b` run (reduced depths; see
# MODEL_PRESETS) always takes precedence. Shapes are
# multi-host slices; profiles are marked derived with `cross_model`
# assumptions and carry the standard ICI error bars.
CROSS_MODEL = {
    "llama-3.1-70b": {
        "from": "llama-3.1-8b",
        # (generation, chips, dtype suffixes): v5e-16 is the BASELINE
        # config, v5p-16/v6e-16 the cross-generation economics rows
        "shapes": [("v5e", 16), ("v5p", 16), ("v6e", 16)],
    },
    # small-model breadth: the 1B from the measured 3B sweep (same GQA
    # family, head_dim 64 — the bytes/FLOPs rescale is dimension-exact)
    "llama-3.2-1b": {
        "from": "llama-3.2-3b",
        "shapes": [("v5e", 1), ("v5e", 4), ("v6e", 4)],
    },
}


def context_raws(model: str, dtype_suffix: str) -> list[tuple[int, dict]]:
    """[(max_in_tokens, raw)] for `<model>_tpu<dtype>_ctx<N>.json` sweeps."""
    out = []
    for p in sorted(RAW_DIR.glob(f"{model}_tpu{dtype_suffix}_ctx*.json")):
        tokens = int(p.stem.rsplit("_ctx", 1)[1])
        out.append((tokens, json.loads(p.read_text())))
    return out


def build_model(model: str) -> dict[str, dict]:
    """Profile documents for one model from whatever raws exist."""
    bf16_path = RAW_DIR / f"{model}_tpu.json"
    int8_path = RAW_DIR / f"{model}_tpu_int8.json"
    raw_bf16 = json.loads(bf16_path.read_text()) if bf16_path.exists() else None
    raw_int8 = json.loads(int8_path.read_text()) if int8_path.exists() else None
    if raw_bf16 is None and raw_int8 is None:
        raise SystemExit(f"no raw measurements for {model} under {RAW_DIR}")
    # every emitted profile name anchors on v5e ("v5e-1", "v5e-4", ...)
    # and the cross-generation rescale below uses v5e as its source
    # constants: verify the raws were actually measured there instead of
    # assuming it (the recorded meta.device is authoritative)
    for raw, nm in ((raw_bf16, bf16_path.name), (raw_int8, int8_path.name)):
        if raw is None:
            continue
        src_gen = raw_source_generation(raw, nm)
        if src_gen.name != "v5e":
            raise SystemExit(
                f"{nm}: measured on {src_gen.name} (meta.device), but the "
                "emitted profile names and TP derivations anchor on v5e — "
                "re-profile on v5e or extend build_model's naming"
            )

    ctx_bf16 = context_raws(model, "")
    ctx_int8 = context_raws(model, "_int8")
    outputs: dict[str, dict] = {}

    def register(suffix, doc, n_chips, wbytes):
        # attach measured long-context buckets from matching-dtype sweeps
        ctx = ctx_int8 if wbytes == 1.0 else ctx_bf16
        if ctx and doc["maxBatchSize"] > 0:
            attach_context_buckets(doc, ctx, n_chips=n_chips,
                                   weight_bytes_per_param=wbytes)
        outputs[f"{model}_{suffix}.json"] = doc

    def add(suffix, raw, n_chips, wbytes):
        register(suffix, build_profile_json(
            raw, suffix, n_chips=n_chips, weight_bytes_per_param=wbytes
        ), n_chips, wbytes)

    def headline_or_quarantine(raw, wbytes, dtype_tag):
        # publish as the headline v5e-1 only when memory-feasible on one
        # chip; otherwise quarantine under the dtype transparency name
        # (maxBatchSize 0 must never be the headline v5e-1 profile)
        doc = build_profile_json(raw, "v5e-1", n_chips=1,
                                 weight_bytes_per_param=wbytes)
        if doc["maxBatchSize"] > 0:
            register("v5e-1", doc, 1, wbytes)
        else:
            doc["acc"] = f"v5e-1-{dtype_tag}"
            register(f"v5e-1-{dtype_tag}", doc, 1, wbytes)

    # single-chip: prefer int8 (the denser serving config); keep the bf16
    # point either as the headline (when it actually fits one chip) or
    # quarantined under the -bf16 transparency name
    if raw_int8 is not None:
        headline_or_quarantine(raw_int8, 1.0, "int8")
        if raw_bf16 is not None:
            add("v5e-1-bf16", raw_bf16, 1, 2.0)
    elif raw_bf16 is not None:
        headline_or_quarantine(raw_bf16, 2.0, "bf16")

    # derived TP shapes
    if raw_bf16 is not None:
        add("v5e-4", raw_bf16, 4, 2.0)
        add("v5e-8", raw_bf16, 8, 2.0)
    if raw_int8 is not None:
        add("v5e-4-int8", raw_int8, 4, 1.0)
        add("v5e-8-int8", raw_int8, 8, 1.0)

    # cross-generation shapes: rescale the v5e raw by hardware ratios,
    # then run the SAME fit/TP pipeline with the generation's HBM size
    # and ICI constants. No context buckets (the ctx sweeps are
    # v5e-measured; cross-generation bucket estimates would stack two
    # derivations).
    src = TPU_GENERATIONS["v5e"]
    for gen_name, chips in CROSS_GEN_SHAPES:
        dst = TPU_GENERATIONS[gen_name]
        meta = {
            "source_generation": src.name,
            "target_generation": dst.name,
            "hbm_bw_scale": round(dst.hbm_bw_gbs / src.hbm_bw_gbs, 3),
            "bf16_tflops_scale": round(dst.bf16_tflops / src.bf16_tflops, 3),
        }
        for raw, wbytes, suffix in (
            (raw_bf16, 2.0, ""),
            (raw_int8, 1.0, "-int8"),
        ):
            if raw is None:
                continue
            doc = build_profile_json(
                rescale_raw_cross_generation(raw, src, dst),
                f"{gen_name}-{chips}{suffix}",
                n_chips=chips,
                hbm_per_chip_gb=dst.hbm_per_chip_gb,
                weight_bytes_per_param=wbytes,
                ici_bw_gbs=dst.ici_bw_gbs,
                ici_latency_us=dst.ici_latency_us,
                cross_generation=meta,
            )
            outputs[f"{model}_{gen_name}-{chips}{suffix}.json"] = doc
    return outputs


def build_cross_model(model: str) -> dict[str, dict]:
    """Profiles for a model with NO raw of its own, rescaled from a
    measured donor (rescale_raw_cross_model), then run through the exact
    same fit/TP/cross-generation pipeline as a measured raw."""
    cfg = CROSS_MODEL[model]
    donor = cfg["from"]
    dst_dims = MODEL_PRESETS[model]
    outputs: dict[str, dict] = {}
    for dtype_suffix, wbytes in (("", 2.0), ("_int8", 1.0)):
        donor_path = RAW_DIR / f"{donor}_tpu{dtype_suffix}.json"
        if not donor_path.exists():
            continue
        donor_raw = json.loads(donor_path.read_text())
        raw = rescale_raw_cross_model(donor_raw, dst_dims, model)
        # the generation the donor sweep was MEASURED on, from its
        # recorded meta.device — target shapes on the same generation
        # need no hardware rescale; every other generation rescales from
        # the donor's actual baseline (errors on unresolvable device)
        src = raw_source_generation(donor_raw, donor_path.name)
        cm_meta = {
            "donor_model": donor,
            "donor_raw": donor_path.name,
            "donor_generation": src.name,
            "method": "per-layer bytes/FLOPs rescale of the measured "
                      "donor sweep (rescale_raw_cross_model)",
        }
        for gen_name, chips in cfg["shapes"]:
            dst = TPU_GENERATIONS[gen_name]
            gen_raw = raw if gen_name == src.name else rescale_raw_cross_generation(
                raw, src, dst)
            cross_gen = None if gen_name == src.name else {
                "source_generation": src.name,
                "target_generation": dst.name,
                "hbm_bw_scale": round(dst.hbm_bw_gbs / src.hbm_bw_gbs, 3),
                "bf16_tflops_scale": round(dst.bf16_tflops / src.bf16_tflops, 3),
            }
            suffix = f"{gen_name}-{chips}{'-int8' if wbytes == 1.0 else ''}"
            doc = build_profile_json(
                gen_raw, suffix, n_chips=chips,
                hbm_per_chip_gb=dst.hbm_per_chip_gb,
                weight_bytes_per_param=wbytes,
                ici_bw_gbs=dst.ici_bw_gbs,
                ici_latency_us=dst.ici_latency_us,
                cross_generation=cross_gen,
                cross_model=cm_meta,
            )
            if doc["maxBatchSize"] <= 0:
                continue  # memory-infeasible shape (e.g. bf16 never fits)
            outputs[f"{model}_{suffix}.json"] = doc
    return outputs


def discover_models() -> list[str]:
    names = set()
    for p in RAW_DIR.glob("*_tpu.json"):
        names.add(p.name[: -len("_tpu.json")])
    for p in RAW_DIR.glob("*_tpu_int8.json"):
        names.add(p.name[: -len("_tpu_int8.json")])
    return sorted(names)

GPU_DIR = PROFILES_DIR / "h100"
GPU_RAW_DIR = GPU_DIR / "raw"
GPU_ACC = "h100-1"


def discover_gpu_models() -> list[str]:
    """Models with a bf16 GPU raw (`<model>_h100.json`)."""
    return sorted(p.name[: -len("_h100.json")] for p in GPU_RAW_DIR.glob("*_h100.json"))


def build_gpu(model: str) -> dict[str, dict]:
    """The one measured single-GPU document of `model`, from its bf16 GPU
    raw: bf16 weights (2 bytes a parameter) in the device memory the raw
    records."""
    path = GPU_RAW_DIR / f"{model}_h100.json"
    if not path.exists():
        raise SystemExit(f"no GPU raw for {model} under {GPU_RAW_DIR}")
    raw = json.loads(path.read_text())
    device = (raw.get("meta") or {}).get("device") or {}
    if device.get("platform") != "gpu" or not device.get("total_memory_gb"):
        raise SystemExit(
            f"{path.name}: meta.device {device!r} is not a GPU measurement "
            "with its total memory"
        )
    if "H100" not in str(device.get("kind", "")):
        # the document is named for the card, as build_model's are for v5e
        raise SystemExit(
            f"{path.name}: measured on {device.get('kind')!r} (meta.device), "
            f"but the document is named {GPU_ACC}"
        )
    if raw["meta"].get("weight_dtype", "bfloat16") != "bfloat16":
        raise SystemExit(f"{path.name}: only bf16 GPU raws are built")
    doc = build_profile_json(
        raw, acc=GPU_ACC, n_chips=1,
        hbm_per_chip_gb=float(device["total_memory_gb"]),
        weight_bytes_per_param=2.0,
    )
    return {f"{model}_{GPU_ACC}.json": doc}


def _write(out_dir: Path, built: dict[str, dict]) -> None:
    for name, doc in built.items():
        path = out_dir / name
        path.write_text(json.dumps(doc, indent=1) + "\n")
        print(
            f"{name}: alpha={doc['decodeParms']['alpha']} "
            f"beta={doc['decodeParms']['beta']} "
            f"gamma={doc['prefillParms']['gamma']} "
            f"delta={doc['prefillParms']['delta']} "
            f"maxBatch={doc['maxBatchSize']} derived={doc['derived']} "
            f"r2={doc['fit']['decode_layer_linearity_r2']}"
        )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Build profile documents from raw sweeps.")
    ap.add_argument("models", nargs="*", help="default: every model with raws")
    ap.add_argument("--gpu", action="store_true",
                    help="build the GPU documents (profiles/h100/) instead of the TPU ones")
    args = ap.parse_args(argv)
    if args.gpu:
        for model in args.models or discover_gpu_models():
            _write(GPU_DIR, build_gpu(model))
        return
    measured = discover_models()
    models = args.models or sorted(set(measured) | set(CROSS_MODEL))
    for model in models:
        try:
            if model in CROSS_MODEL and model not in measured:
                built = build_cross_model(model)
            else:
                built = build_model(model)
        except UnfittableRawError as e:
            # an in-progress sweep (single layer depth so far) must not
            # abort regeneration of every other model's profiles; any
            # other error (schema mismatch, corrupt file) propagates
            print(f"skipping {model}: raw sweep not fittable yet ({e})",
                  file=sys.stderr)
            continue
        _write(PROFILES_DIR, built)


if __name__ == "__main__":
    main()
