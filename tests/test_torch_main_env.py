"""The port's process entry (`inferno_tpu_torch.controller.main`): every
documented environment variable reaches its `ReconcilerConfig` field with
the reference's default, `COMPUTE_DEVICE` is the port's one addition,
`auto` without a CUDA card raises instead of falling back to the CPU, and
the reference-only backends are refused. FLIGHT_RECORDER_DIR maps to a
working recorder, and the planner's backend resolution follows the same
rule: auto is the card or an error. So does the twin's: TWIN_BACKEND takes
numpy|torch, and its default, torch, runs on the card or raises."""

from __future__ import annotations

import dataclasses

import pytest

from inferno_tpu.controller.reconciler import ReconcilerConfig as RefConfig
from inferno_tpu_torch.controller import main as p_main
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.testing.fleet import (
    FLEET_NS,
    fleet_cluster,
    fleet_fake_prom,
    fleet_model,
)

ENV = (
    "CONFIG_NAMESPACE", "SERVING_ENGINE", "WVA_SCALE_TO_ZERO", "COMPUTE_BACKEND",
    "USE_TPU_FLEET", "COMPUTE_DEVICE", "DIRECT_SCALE", "PROFILE_CORRECTION",
    "KEEP_ACCELERATOR", "PREDICTIVE_SCALING", "SCALE_DOWN_STABILIZATION_SECONDS",
    "RECONCILE_CONCURRENCY", "GROUPED_COLLECTION", "SIZING_CACHE",
    "SIZING_CACHE_TOLERANCE", "FLIGHT_RECORDER_DIR", "FLIGHT_RECORDER_MAX_MB",
    "FLIGHT_RECORDER_MAX_AGE_S", "ATTAINMENT_EWMA_GAIN", "CYCLE_PROFILER",
    "PROFILE_TRACEMALLOC", "PROMETHEUS_BASE_URL",
)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_defaults_match_the_reference_config():
    cfg = p_main.reconciler_config_from_env()
    assert cfg.compute_backend == "auto" and cfg.compute_device is None
    ref_defaults = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    for f in dataclasses.fields(cfg):
        if f.name in ("compute_backend", "compute_device"):
            continue
        assert getattr(cfg, f.name) == ref_defaults[f.name], f.name


def test_every_variable_maps_to_its_field(clean_env):
    values = {
        "CONFIG_NAMESPACE": ("ops", "config_namespace", "ops"),
        "SERVING_ENGINE": ("jetstream", "engine", "jetstream"),
        "WVA_SCALE_TO_ZERO": ("true", "scale_to_zero", True),
        "COMPUTE_BACKEND": ("TORCH", "compute_backend", "torch"),
        "COMPUTE_DEVICE": (" cpu ", "compute_device", "cpu"),
        "PROFILE_CORRECTION": ("false", "profile_correction", False),
        "KEEP_ACCELERATOR": ("false", "keep_accelerator", False),
        "PREDICTIVE_SCALING": ("1", "predictive_scaling", True),
        "SCALE_DOWN_STABILIZATION_SECONDS": ("120", "scale_down_stabilization_s", 120.0),
        "RECONCILE_CONCURRENCY": ("4", "reconcile_concurrency", 4),
        "GROUPED_COLLECTION": ("false", "grouped_collection", False),
        "SIZING_CACHE": ("true", "sizing_cache", True),
        "SIZING_CACHE_TOLERANCE": ("0.05", "sizing_cache_tolerance", 0.05),
        "FLIGHT_RECORDER_MAX_MB": ("16", "flight_recorder_max_mb", 16.0),
        "FLIGHT_RECORDER_MAX_AGE_S": ("60", "flight_recorder_max_age_s", 60.0),
        "ATTAINMENT_EWMA_GAIN": ("0.5", "attainment_ewma_gain", 0.5),
        "CYCLE_PROFILER": ("false", "cycle_profiler", False),
        "PROFILE_TRACEMALLOC": ("true", "profiler_tracemalloc", True),
    }
    for var, (raw, _, _) in values.items():
        clean_env.setenv(var, raw)
    cfg = p_main.reconciler_config_from_env()
    for var, (_, field, want) in values.items():
        assert getattr(cfg, field) == want, var


def test_use_tpu_fleet_false_selects_scalar(clean_env):
    clean_env.setenv("USE_TPU_FLEET", "false")
    assert p_main.reconciler_config_from_env().compute_backend == "scalar"
    clean_env.setenv("COMPUTE_BACKEND", "cuda")
    assert p_main.reconciler_config_from_env().compute_backend == "cuda"


@pytest.mark.parametrize("backend", ["tpu", "tpu-pallas", "jax"])
def test_reference_only_backends_are_rejected(clean_env, backend):
    clean_env.setenv("COMPUTE_BACKEND", backend)
    with pytest.raises(ValueError, match="reference"):
        p_main.reconciler_config_from_env()


def test_native_backend_is_accepted(clean_env):
    """The C++ solver is the port's too: COMPUTE_BACKEND=native maps to
    the config unchanged (it needs g++, never a card)."""
    clean_env.setenv("COMPUTE_BACKEND", "native")
    assert p_main.reconciler_config_from_env().compute_backend == "native"


def test_unknown_backend_is_rejected():
    with pytest.raises(ValueError, match="auto|cuda|torch|scalar"):
        ReconcilerConfig(compute_backend="gpu")


def test_flight_recorder_is_not_ported_yet(clean_env, tmp_path):
    """The recorder was once refused here; it is ported now, so
    FLIGHT_RECORDER_DIR maps to a working recorder: the env builds a
    config, the Reconciler records every cycle, and close() flushes."""
    from inferno_tpu_torch.obs.recorder import read_artifact

    clean_env.setenv("FLIGHT_RECORDER_DIR", str(tmp_path / "rec"))
    clean_env.setenv("COMPUTE_BACKEND", "torch")
    clean_env.setenv("COMPUTE_DEVICE", "cpu")
    cfg = p_main.reconciler_config_from_env()
    assert cfg.flight_recorder_dir == str(tmp_path / "rec")
    rows = {(fleet_model(i), FLEET_NS): {"running": 3.0, "arrival_rps": 4.0,
            "in_tokens": 128.0, "out_tokens": 128.0, "ttft_s": 0.05,
            "itl_s": 0.02} for i in range(2)}
    rec = Reconciler(fleet_cluster(2), fleet_fake_prom(rows), cfg)
    assert rec.recorder is not None
    for _ in range(2):
        assert rec.run_cycle().errors == []
    rec.close()
    recorded = read_artifact(str(tmp_path / "rec"))
    assert recorded.num_cycles == 2 and recorded.warnings == []


def test_planner_auto_without_cuda_raises(monkeypatch):
    """The planner's auto backend (flag or PLANNER_BACKEND=auto) needs a
    card and names the CPU route without one; nothing falls back."""
    from inferno_tpu_torch.planner.__main__ import _resolve_backend, main

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for env in ("", "auto"):
        monkeypatch.setenv("PLANNER_BACKEND", env)
        with pytest.raises(SystemExit, match="--backend torch --device cpu"):
            _resolve_backend("auto")
        with pytest.raises(SystemExit, match="--backend torch --device cpu"):
            main(["--variants", "4", "--steps", "2"])


@pytest.mark.parametrize("env", ["jax", "tpu", "gpu"])
def test_unknown_planner_backend_fails_fast(monkeypatch, env):
    from inferno_tpu_torch.planner.__main__ import main

    monkeypatch.setenv("PLANNER_BACKEND", env)
    with pytest.raises(SystemExit, match="PLANNER_BACKEND"):
        main(["--variants", "4", "--steps", "2"])


def test_auto_without_cuda_raises_naming_the_cpu_choice(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    cfg = p_main.reconciler_config_from_env()
    with pytest.raises(RuntimeError, match="COMPUTE_BACKEND=torch COMPUTE_DEVICE=cpu"):
        Reconciler(fleet_cluster(1), fleet_fake_prom({}), cfg)


def test_cuda_backend_without_a_card_raises_in_the_solve(monkeypatch):
    """Backend cuda with no card does not size on the CPU: the solve span
    records the failure and every prepared variant is marked failed."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rows = {(fleet_model(i), FLEET_NS): {"running": 3.0, "arrival_rps": 4.0,
            "in_tokens": 128.0, "out_tokens": 128.0, "ttft_s": 0.05,
            "itl_s": 0.02} for i in range(2)}
    rec = Reconciler(fleet_cluster(2), fleet_fake_prom(rows), ReconcilerConfig(
        compute_backend="cuda", compute_device="cpu",
    ))
    report = rec.run_cycle()
    assert report.variants_prepared == 2 and not report.optimization_ok
    assert "needs a CUDA device" in report.errors[0]
    assert all(r.reason == "error" for r in report.decisions)


def test_main_requires_prometheus(clean_env):
    assert p_main.main() == 2


@pytest.mark.parametrize("env", ["jax", "cuda", "gpu"])
def test_unknown_twin_backend_fails_fast(monkeypatch, env):
    """TWIN_BACKEND=jax (the reference's optional backend) and any other
    unknown value raise at once, naming both backends, in the plant and
    in the twin CLI before any trace is built."""
    from inferno_tpu_torch.emulator.engine import EngineProfile
    from inferno_tpu_torch.twin import TwinPlant
    from inferno_tpu_torch.twin.__main__ import main

    monkeypatch.setenv("TWIN_BACKEND", env)
    with pytest.raises(ValueError, match="numpy|torch"):
        TwinPlant(EngineProfile(), 2)
    with pytest.raises(ValueError, match="numpy|torch"):
        main(["--engines", "2", "--duration", "4"])
    with pytest.raises(SystemExit):
        main(["--engines", "2", "--backend", env])


def test_twin_default_backend_without_cuda_raises(monkeypatch, capsys):
    """The twin's default (TWIN_BACKEND unset: torch on the card) raises
    without a card, naming the two ways to run on the host; nothing
    falls back to the CPU."""
    from inferno_tpu_torch.emulator.engine import EngineProfile
    from inferno_tpu_torch.twin import TwinPlant
    from inferno_tpu_torch.twin.__main__ import main

    monkeypatch.delenv("TWIN_BACKEND", raising=False)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for build in (lambda: TwinPlant(EngineProfile(), 2),
                  lambda: TwinPlant(EngineProfile(), 2, backend="torch",
                                    device="cuda"),
                  lambda: main(["--engines", "2", "--duration", "4"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    with pytest.raises(RuntimeError, match="--backend numpy.*--device cpu"):
        main(["--engines", "2", "--duration", "4"])
    assert capsys.readouterr().out == ""
    # the two explicit host routes run
    assert TwinPlant(EngineProfile(), 2, backend="numpy").device is None
    assert TwinPlant(EngineProfile(), 2, device="cpu").backend == "torch"
