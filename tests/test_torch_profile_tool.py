"""The port's profiling tools on the CPU: `inferno_tpu_torch.tools.profile_gpu`
(resume refusals before any device is touched, no card without
`--device cpu`, a tiny `--device cpu` sweep whose raw the ported fit
accepts) and `inferno_tpu_torch.tools.build_profiles` (the reference's
build on the committed TPU raws, document for document, its refusals, and
the one-document GPU path)."""

from __future__ import annotations

import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from inferno_tpu_torch.models import profiles
from inferno_tpu_torch.models.llama_block import LlamaDims
from inferno_tpu_torch.tools import build_profiles as bp
from inferno_tpu_torch.tools import profile_gpu as pg
from tests.test_profiles import fake_raw

REPO = Path(__file__).resolve().parent.parent
TINY = LlamaDims(hidden=64, n_heads=4, n_kv_heads=2, head_dim=16, ffn=128, vocab=256,
                 n_layers=8)
TINY_SWEEP = ["--device", "cpu", "--iters", "1", "--decode-steps", "4", "--context", "16",
              "--decode-batches", "1", "4", "--prefill-batches", "1", "--prefill-tokens", "8",
              "--mixed-batches", "1", "4", "--mixed-tokens", "8", "--layer-depths", "1", "2",
              "--target-ms", "0.5"]


def run_tool(tmp_path, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "inferno_tpu_torch.tools.profile_gpu", *args],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
    )


def write_raw(path: Path, model: str, weight_dtype: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        "meta": {"model": model, "weight_dtype": weight_dtype,
                 "dims": {"n_layers_full": 32}},
        "decode": [], "prefill": [], "mixed": [],
    }))


def load_reference_build():
    spec = importlib.util.spec_from_file_location("ref_build_profiles",
                                                  REPO / "tools/build_profiles.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- profile_gpu -------------------------------------------------------------


def test_resume_refuses_cross_model_before_device_init(tmp_path):
    """No card here: a refusal that came after the device check would
    fail with the device error instead."""
    out = tmp_path / "raw.json"
    write_raw(out, "llama-3.2-1b", "bfloat16")
    res = run_tool(tmp_path, "--model", "llama-3.1-8b", "--resume", "--out", str(out))
    assert res.returncode != 0
    assert "refusing --resume" in res.stderr
    assert "llama-3.2-1b" in res.stderr


def test_resume_refuses_cross_dtype(tmp_path):
    out = tmp_path / "raw.json"
    write_raw(out, "llama-3.1-8b", "bfloat16")
    res = run_tool(tmp_path, "--model", "llama-3.1-8b", "--weight-dtype", "int8",
                   "--resume", "--out", str(out))
    assert res.returncode != 0
    assert "weight_dtype" in res.stderr


def test_unknown_model_rejected_by_argparse(tmp_path):
    res = run_tool(tmp_path, "--model", "gpt-oss-999b")
    assert res.returncode != 0
    assert "invalid choice" in res.stderr


def test_no_card_and_no_cpu_request_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = run_tool(tmp_path, "--model", "llama-3.1-8b", "--out", str(tmp_path / "r.json"))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "device='cpu'" in res.stderr
    assert not (tmp_path / "r.json").exists()


def test_defaults_match_the_reference_tool():
    spec = importlib.util.spec_from_file_location("ref_profile_tpu", REPO / "tools/profile_tpu.py")
    src = spec.loader.get_source("ref_profile_tpu")
    for name in ("DECODE_BATCHES", "PREFILL_BATCHES", "PREFILL_TOKENS", "MIXED_BATCHES",
                 "MIXED_TOKENS", "LAYER_DEPTHS"):
        assert f"{name} = {getattr(pg, name)!r}" in src
    args = pg.build_parser().parse_args([])
    assert (args.iters, args.decode_steps, args.context, args.target_ms, args.max_cache_gb,
            args.model, args.weight_dtype) == (7, 64, 1024, 250.0, 6.0, "llama-3.1-8b",
                                               "bfloat16")
    assert pg.default_out("gemma-2-9b", "int8") == \
        profiles.PROFILES_DIR / "h100" / "raw" / "gemma-2-9b_h100_int8.json"


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(pg.ALL_PRESETS, "tiny-llama", TINY)
    return "tiny-llama"


def test_cpu_sweep_writes_a_raw_the_fit_accepts(tmp_path, tiny_preset):
    out = tmp_path / "raw.json"
    pg.main(["--model", tiny_preset, "--out", str(out), *TINY_SWEEP])
    raw = json.loads(out.read_text())
    assert set(raw) == {"meta", "decode", "prefill", "mixed"}
    meta = raw["meta"]
    assert meta["device"]["platform"] == "cpu" and meta["timing"] == "host-clock"
    assert meta["dims"]["n_layers_full"] == 8 and meta["weight_dtype"] == "bfloat16"
    assert profiles.dims_from_meta(meta["dims"]) == TINY
    assert len(raw["decode"]) == 4 and len(raw["mixed"]) == 4 and len(raw["prefill"]) == 2
    assert set(raw["decode"][0]) == {"n_layers", "batch", "context", "step_ms"}
    assert set(raw["mixed"][0]) == {"n_layers", "batch", "in_tokens", "context", "step_ms"}
    assert set(raw["prefill"][0]) == {"n_layers", "batch", "in_tokens", "reps", "prefill_ms"}
    doc = profiles.build_profile_json(raw, "cpu-1", hbm_per_chip_gb=2.0,
                                      weight_bytes_per_param=2.0)
    assert doc["fit"]["ttft_calibration"] == "mixed-step"
    assert doc["fit"]["layer_depths"] == [1, 2]
    assert doc["maxBatchSize"] > 0


def test_cpu_sweep_resumes_and_records_int8(tmp_path, tiny_preset):
    out = tmp_path / "raw.json"
    first = TINY_SWEEP[:TINY_SWEEP.index("--layer-depths")] + ["--layer-depths", "1"]
    pg.main(["--model", tiny_preset, "--out", str(out), "--weight-dtype", "int8", *first])
    before = json.loads(out.read_text())
    assert before["meta"]["int8_dequant"] == "eager"
    pg.main(["--model", tiny_preset, "--out", str(out), "--weight-dtype", "int8", "--resume",
             *TINY_SWEEP])
    after = json.loads(out.read_text())
    # depth 1 kept as measured, depth 2 added
    assert after["decode"][:len(before["decode"])] == before["decode"]
    assert sorted({s["n_layers"] for s in after["decode"]}) == [1, 2]
    assert len(after["decode"]) == 2 * len(before["decode"])


# -- build_profiles: the TPU raws ------------------------------------------------


def test_build_equals_reference_on_committed_raws():
    """27 documents: the measured models' and the cross-model ones."""
    ref = load_reference_build()
    assert bp.discover_models() == ref.discover_models() == ["llama-3.1-8b", "llama-3.2-3b"]
    n = 0
    for model in ("llama-3.1-8b", "llama-3.2-3b"):
        got, want = bp.build_model(model), ref.build_model(model)
        assert got == want
        n += len(got)
    for model in ("llama-3.1-70b", "llama-3.2-1b"):
        got, want = bp.build_cross_model(model), ref.build_cross_model(model)
        assert got == want
        n += len(got)
    assert n == 27


@pytest.mark.parametrize("model, n_docs", [("llama-3.1-8b", 12), ("llama-3.2-3b", 6)])
def test_measured_documents_equal_committed_files(model, n_docs):
    """The 18 documents of the measured models rebuild exactly; the
    cross-model ones differ from the committed files in the
    `donor_generation` key the current code adds (a reference caveat:
    the committed files stay as they are)."""
    built = bp.build_model(model)
    assert len(built) == n_docs
    for name, doc in built.items():
        assert json.loads((profiles.PROFILES_DIR / name).read_text()) == doc, name
    for name, doc in bp.build_cross_model("llama-3.1-70b").items():
        committed = json.loads((profiles.PROFILES_DIR / name).read_text())
        assert "donor_generation" not in committed["assumptions"]["cross_model"]
        doc["assumptions"]["cross_model"].pop("donor_generation")
        assert committed == doc, name


def test_main_writes_what_the_reference_main_writes(tmp_path, monkeypatch):
    ref = load_reference_build()
    for mod, sub in ((bp, "port"), (ref, "ref")):
        out = tmp_path / sub
        out.mkdir()
        monkeypatch.setattr(mod, "PROFILES_DIR", out)
    monkeypatch.setattr(sys, "argv", ["build_profiles.py"])
    ref.main()
    bp.main([])
    got = {p.name: p.read_text() for p in (tmp_path / "port").iterdir()}
    want = {p.name: p.read_text() for p in (tmp_path / "ref").iterdir()}
    assert got == want and len(got) == 27


def _raw_dir(tmp_path, monkeypatch, raw, name):
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir(exist_ok=True)
    (raw_dir / name).write_text(json.dumps(raw))
    monkeypatch.setattr(bp, "RAW_DIR", raw_dir)
    return raw_dir


def test_cross_model_resolves_donor_generation_from_meta(tmp_path, monkeypatch):
    raw = fake_raw()
    raw["meta"]["device"] = {"kind": "TPU v5 lite", "platform": "tpu"}
    _raw_dir(tmp_path, monkeypatch, raw, "llama-3.1-8b_tpu_int8.json")
    built = bp.build_cross_model("llama-3.1-70b")
    doc = built["llama-3.1-70b_v5e-16-int8.json"]
    assert doc["assumptions"]["cross_model"]["donor_generation"] == "v5e"
    assert "cross_generation" not in doc["assumptions"]
    v6e = built["llama-3.1-70b_v6e-16-int8.json"]
    assert v6e["assumptions"]["cross_generation"]["source_generation"] == "v5e"


def test_cross_model_errors_on_unresolvable_donor_device(tmp_path, monkeypatch):
    raw = fake_raw()
    raw["meta"]["device"] = {"kind": "TPU v9 hyper", "platform": "tpu"}
    _raw_dir(tmp_path, monkeypatch, raw, "llama-3.1-8b_tpu_int8.json")
    with pytest.raises(SystemExit, match="cannot resolve TPU generation"):
        bp.build_cross_model("llama-3.1-70b")


def test_build_model_rejects_non_v5e_measured_raw(tmp_path, monkeypatch):
    raw = fake_raw()
    raw["meta"]["device"] = {"kind": "TPU v5p", "platform": "tpu"}
    _raw_dir(tmp_path, monkeypatch, raw, "llama-3.1-8b_tpu_int8.json")
    with pytest.raises(SystemExit, match="measured on v5p"):
        bp.build_model("llama-3.1-8b")


def test_build_profiles_quarantines_memory_infeasible_int8(tmp_path, monkeypatch):
    raw = fake_raw()
    raw["meta"]["dims"] = {
        "hidden": 8192, "n_heads": 64, "n_kv_heads": 8, "head_dim": 128,
        "ffn": 28672, "vocab": 128256, "n_layers_full": 80,
    }
    raw["meta"]["model"] = "big-70b"
    _raw_dir(tmp_path, monkeypatch, raw, "big-70b_tpu_int8.json")
    built = bp.build_model("big-70b")
    assert "big-70b_v5e-1.json" not in built
    quarantined = built["big-70b_v5e-1-int8.json"]
    assert quarantined["maxBatchSize"] == 0
    assert quarantined["acc"] == "v5e-1-int8"
    assert built["big-70b_v5e-8-int8.json"]["maxBatchSize"] > 0


# -- build_profiles: the GPU path --------------------------------------------


def gpu_raw(kind="NVIDIA H100 80GB HBM3", weight_dtype="bfloat16"):
    raw = fake_raw(mixed=True)
    raw["meta"].update({
        "device": {"platform": "gpu", "kind": kind, "power_limit": "700.00 W",
                   "total_memory_gb": 79.18},
        "dtype": "bfloat16", "weight_dtype": weight_dtype, "timing": "cuda-events",
    })
    return raw


@pytest.fixture
def gpu_dirs(tmp_path, monkeypatch):
    out = tmp_path / "h100"
    (out / "raw").mkdir(parents=True)
    monkeypatch.setattr(bp, "GPU_DIR", out)
    monkeypatch.setattr(bp, "GPU_RAW_DIR", out / "raw")
    monkeypatch.setattr(bp, "PROFILES_DIR", tmp_path / "tpu-docs-must-not-appear")
    return out


def test_gpu_path_builds_one_measured_document(gpu_dirs):
    raw = gpu_raw()
    (gpu_dirs / "raw" / "llama-3.1-8b_h100.json").write_text(json.dumps(raw))
    (gpu_dirs / "raw" / "llama-3.1-8b_h100_int8.json").write_text(
        json.dumps(gpu_raw(weight_dtype="int8")))
    assert bp.discover_gpu_models() == ["llama-3.1-8b"]
    bp.main(["--gpu"])
    written = sorted(p.name for p in gpu_dirs.iterdir() if p.is_file())
    assert written == ["llama-3.1-8b_h100-1.json"]
    assert not (gpu_dirs.parent / "tpu-docs-must-not-appear").exists()
    doc = json.loads((gpu_dirs / written[0]).read_text())
    assert doc == profiles.build_profile_json(raw, "h100-1", n_chips=1, hbm_per_chip_gb=79.18,
                                              weight_bytes_per_param=2.0)
    assert doc["derived"] is False and doc["assumptions"]["n_chips"] == 1
    assert doc["maxBatchSize"] == profiles.max_batch_from_memory(
        LlamaDims(), 79.18, 1280, weight_bytes_per_param=2.0)


@pytest.mark.parametrize("change, match", [
    ({"kind": "NVIDIA A100-SXM4-80GB"}, "named h100-1"),
    ({"platform": "cpu"}, "not a GPU measurement"),
    ({"total_memory_gb": None}, "not a GPU measurement"),
])
def test_gpu_path_refuses_what_it_cannot_name(gpu_dirs, change, match):
    raw = gpu_raw()
    raw["meta"]["device"].update(change)
    (gpu_dirs / "raw" / "llama-3.1-8b_h100.json").write_text(json.dumps(raw))
    with pytest.raises(SystemExit, match=match):
        bp.build_gpu("llama-3.1-8b")


def test_gpu_path_refuses_int8_raw(gpu_dirs):
    raw = gpu_raw(weight_dtype="int8")
    (gpu_dirs / "raw" / "llama-3.1-8b_h100.json").write_text(json.dumps(raw))
    with pytest.raises(SystemExit, match="only bf16"):
        bp.build_gpu("llama-3.1-8b")


def test_reference_discovery_never_reads_gpu_raws():
    ref = load_reference_build()
    names = ref.discover_models()
    assert all(not n.endswith("h100") for n in names)
    assert bp.discover_models() == names


def test_committed_gpu_raws_rebuild_to_committed_documents():
    models = bp.discover_gpu_models()
    for model in models:
        for name, doc in bp.build_gpu(model).items():
            assert json.loads((bp.GPU_DIR / name).read_text()) == copy.deepcopy(doc)
