"""The port stands alone: no module of inferno_tpu_torch, and not
chip_smoke.py, imports jax, flax, optax or the JAX package inferno_tpu.

Checked twice: statically (an AST scan of every import statement) and
dynamically (subprocesses in which those imports are blocked size a fleet,
run three reconcile cycles, run the planner and a recorded `--trace`
replay, run the twin CLI and an emulator scenario, run the profiling
blocks, a tiny profiler sweep and a profile build, and close the HPA loop
over the port's MiniApiServer on backend native, all through the port on
the CPU; the port's invariant analyzer lints the port's tree with torch
blocked as well). The scan
also holds every import to what the card's installation has: the
standard library, torch, numpy, PyYAML, triton, and the port itself.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "inferno_tpu")
# third-party packages the card's installation provides and the port uses
ALLOWED_THIRD_PARTY = ("torch", "numpy", "yaml", "triton", "inferno_tpu_torch")


def _sources():
    files = sorted((ROOT / "inferno_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_scan_covers_the_socket_fixtures_and_native():
    files = set(_sources())
    for rel in ("testing/apiserver.py", "testing/hpa.py", "testing/fleet.py",
                "native/__init__.py"):
        assert ROOT / "inferno_tpu_torch" / rel in files, rel


def test_scan_covers_the_analyzer():
    files = set(_sources())
    for rel in ("__init__.py", "__main__.py", "core.py", "config_registry.py", "clocks.py",
                "numerics.py", "locks.py", "purity.py"):
        assert ROOT / "inferno_tpu_torch" / "analysis" / rel in files, rel


def test_scan_covers_the_prebuild():
    assert ROOT / "inferno_tpu_torch" / "tools" / "prebuild.py" in set(_sources())


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_no_forbidden_import_in_port_sources():
    bad = []
    for path in _sources():
        for lineno, module in _imported_modules(path):
            if module.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}:{lineno}: {module}")
    assert not bad, bad


def test_port_imports_only_what_the_card_has():
    bad = []
    for path in _sources():
        for lineno, module in _imported_modules(path):
            top = module.split(".")[0]
            if top not in sys.stdlib_module_names and top not in ALLOWED_THIRD_PARTY:
                bad.append(f"{path.relative_to(ROOT)}:{lineno}: {module}")
    assert not bad, bad


def _run_blocked(code: str, extra_env=None) -> subprocess.CompletedProcess:
    """Run `code` in a fresh interpreter in which importing any forbidden
    package fails."""
    prelude = textwrap.dedent(f"""
        import sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None  # `import name` now raises ImportError
        sys.path.insert(0, {str(ROOT)!r})
    """)
    env = dict(os.environ, **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT), env=env,
    )


def test_port_sizes_a_fleet_with_jax_blocked():
    proc = _run_blocked("""
        import torch
        from inferno_tpu_torch.core.system import System
        from inferno_tpu_torch.parallel import calculate_fleet
        from inferno_tpu_torch.solver import solve_unlimited
        from inferno_tpu_torch.testing.fleet import fleet_system_spec

        system = System(fleet_system_spec(20, shapes_per_variant=3, tandem_every=5))
        lanes = calculate_fleet(system, backend="torch", device="cpu")
        solve_unlimited(system)
        picked = sum(s.allocation is not None for s in system.servers.values())
        assert lanes > 20 and picked > 10, (lanes, picked)
        assert not any(m.split(".")[0] in ("jax", "inferno_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", lanes, picked)
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_reconciles_with_jax_blocked():
    """Three reconcile cycles of the port's controller (backend torch on
    the CPU): cold, unchanged, and with arrival rates moved."""
    proc = _run_blocked("""
        from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
        from inferno_tpu_torch.testing.fleet import (
            FLEET_NS, fleet_cluster, fleet_fake_prom, fleet_model,
        )

        rows = {(fleet_model(i), FLEET_NS): {
            "running": 3.0, "arrival_rps": 2.0 + i, "in_tokens": 128.0,
            "out_tokens": 128.0, "ttft_s": 0.05, "itl_s": 0.02,
            "max_batch": 64.0} for i in range(8)}
        rec = Reconciler(fleet_cluster(8), fleet_fake_prom(rows), ReconcilerConfig(
            compute_backend="torch", compute_device="cpu"))
        applied = []
        for cycle in range(3):
            if cycle == 2:
                rows = {k: dict(v, arrival_rps=v["arrival_rps"] * 1.5)
                        for k, v in rows.items()}
                rec.prom = fleet_fake_prom(rows)
            report = rec.run_cycle()
            assert report.optimization_ok and not report.errors, report.errors
            assert report.profile["counters"]["prom_queries"] > 0
            applied.append(report.variants_applied)
        assert applied == [8, 8, 8], applied
        assert not any(m.split(".")[0] in ("jax", "inferno_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", applied)
    """, extra_env={"LOG_LEVEL": "warn"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_socket_loop_on_native_runs_with_jax_blocked():
    """The port's MiniApiServer, RestKubeClient, MetricsServer, MiniProm,
    ExternalMetricsAdapter and HpaEmulator close one HPA loop around a
    reconcile cycle on backend native (the port's C++ solver)."""
    proc = _run_blocked("""
        import json, urllib.request
        from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
        from inferno_tpu_torch.controller.kube import RestKubeClient
        from inferno_tpu_torch.controller.metrics import MetricsEmitter, MetricsServer
        from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
        from inferno_tpu_torch.emulator.miniprom import MiniProm
        from inferno_tpu_torch.testing import MiniApiServer
        from inferno_tpu_torch.testing.fleet import fleet_fake_prom
        from inferno_tpu_torch.testing.hpa import ExternalMetricsAdapter, HpaEmulator

        api = MiniApiServer().start()

        def post(path, body):
            req = urllib.request.Request(api.url + path, method="POST",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req).read()

        cms = "/api/v1/namespaces/inferno-system/configmaps"
        post(cms, {"metadata": {"name": "accelerator-unit-costs"},
                   "data": {"v5e-4": json.dumps({"cost": 10.0})}})
        post(cms, {"metadata": {"name": "service-classes-config"},
                   "data": {"p.yaml": "name: Premium\\npriority: 1\\ndata:\\n"
                            "  - model: m/a\\n    slo-ttft: 500\\n    slo-tpot: 24\\n"}})
        post(cms, {"metadata": {"name": "inferno-autoscaler-config"}, "data": {}})
        post("/apis/llmd.ai/v1alpha1/namespaces/ns/variantautoscalings", {
            "apiVersion": "llmd.ai/v1alpha1", "kind": "VariantAutoscaling",
            "metadata": {"name": "a", "namespace": "ns", "labels": {
                "inference.optimization/acceleratorName": "v5e-4"}},
            "spec": {"modelID": "m/a", "sloClassRef": {
                "name": "service-classes-config", "key": "Premium"},
                "modelProfile": {"accelerators": [{
                    "acc": "v5e-4", "accCount": 1, "maxBatchSize": 64,
                    "atTokens": 128, "perfParms": {
                        "decodeParms": {"alpha": "18.0", "beta": "0.3"},
                        "prefillParms": {"gamma": "5.0", "delta": "0.02"}}}]}}})
        post("/apis/apps/v1/namespaces/ns/deployments", {
            "metadata": {"name": "a", "namespace": "ns"}, "spec": {"replicas": 1},
            "status": {"replicas": 1, "readyReplicas": 1}})
        kube = RestKubeClient(base_url=api.url, token="", namespace="inferno-system")
        emitter = MetricsEmitter()
        msrv = MetricsServer(emitter.registry, port=0, host="127.0.0.1")
        msrv.start()
        rows = {("m/a", "ns"): {"running": 3.0, "arrival_rps": 40.0,
                "in_tokens": 128.0, "out_tokens": 128.0, "ttft_s": 0.05,
                "itl_s": 0.02, "max_batch": 64.0}}
        rec = Reconciler(kube, fleet_fake_prom(rows), ReconcilerConfig(
            compute_backend="native", compute_device="cpu"), emitter=emitter)
        report = rec.run_cycle()
        assert report.optimization_ok and not report.errors, report.errors
        prom = MiniProm([f"http://127.0.0.1:{msrv.port}/metrics"],
                        scrape_interval=3600.0, window_seconds=60.0)
        prom.start()
        prom.scrape_once()
        hpa = HpaEmulator(kube=kube, adapter=ExternalMetricsAdapter(
            prom=HttpPromClient(PromConfig(base_url=prom.url, allow_http=True))),
            namespace="ns", name="a")
        applied = hpa.step()
        assert applied and applied > 1, applied
        assert kube.get_deployment("ns", "a")["spec"]["replicas"] == applied
        prom.stop(); msrv.stop(); api.stop()
        assert not any(m.split(".")[0] in ("jax", "inferno_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", applied)
    """, extra_env={"LOG_LEVEL": "warn"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_planner_runs_with_jax_blocked(tmp_path):
    """`python -m inferno_tpu_torch.planner` on the CPU (a small fleet,
    one scenario, a few seeds), then a reconcile recorded by the port's
    flight recorder and replayed by `--trace`, all with jax blocked."""
    proc = _run_blocked(f"""
        import json, runpy
        from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
        from inferno_tpu_torch.testing.fleet import (
            FLEET_NS, fleet_cluster, fleet_fake_prom, fleet_model,
        )

        def planner(*args):
            sys.argv = ["inferno_tpu_torch.planner", *args]
            try:
                runpy.run_module("inferno_tpu_torch.planner", run_name="__main__")
            except SystemExit as e:
                assert e.code in (0, None), e.code

        out = {str(tmp_path)!r} + "/mc.json"
        planner("--variants", "8", "--steps", "6", "--shapes", "1",
                "--scenarios", "flash_crowd", "--seeds", "3",
                "--backend", "torch", "--device", "cpu", "--out", out)
        mc = json.load(open(out))
        assert mc["seeds"] == 3 and mc["scenarios"][0]["scenario"] == "flash_crowd"

        rec_dir = {str(tmp_path)!r} + "/rec"
        rows = {{(fleet_model(i), FLEET_NS): {{
            "running": 3.0, "arrival_rps": 20.0 + i, "in_tokens": 128.0,
            "out_tokens": 128.0, "ttft_s": 0.05, "itl_s": 0.02,
            "max_batch": 64.0}} for i in range(5)}}
        rec = Reconciler(fleet_cluster(5), fleet_fake_prom(rows), ReconcilerConfig(
            compute_backend="torch", compute_device="cpu",
            flight_recorder_dir=rec_dir))
        for _ in range(2):
            assert not rec.run_cycle().errors
        rec.close()
        out = {str(tmp_path)!r} + "/trace.json"
        planner("--trace", rec_dir, "--backend", "torch", "--device", "cpu",
                "--out", out)
        doc = json.load(open(out))
        assert doc["recorded"]["drift"]["coverage"] == 1.0
        assert all(p["match"] for p in doc["parity_sampled"]), doc["parity_sampled"]
        assert not any(m.split(".")[0] in ("jax", "inferno_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", len(doc["parity_sampled"]))
    """, extra_env={"LOG_LEVEL": "warn"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_twin_and_emulator_run_with_jax_blocked():
    """`python -m inferno_tpu_torch.twin --engines 8 --duration 10
    --backend torch --device cpu` (the step cost in torch on the CPU) and
    one emulator `run_scenario`, with jax blocked."""
    proc = _run_blocked("""
        import contextlib, io, json, runpy
        from inferno_tpu_torch.emulator.engine import EngineProfile
        from inferno_tpu_torch.emulator.experiment import RateSpec, Scenario, run_scenario
        from inferno_tpu_torch.twin import plant

        sys.argv = ["inferno_tpu_torch.twin", "--engines", "8", "--duration", "10",
                    "--backend", "torch", "--device", "cpu"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                runpy.run_module("inferno_tpu_torch.twin", run_name="__main__")
            except SystemExit as e:
                assert e.code in (0, None), e.code
        report = json.loads(buf.getvalue())
        assert report["scenario"]["engines"] == 8
        assert report["reactive"]["completed"] > 0, report["reactive"]
        assert plant.STEP_COST_EVALS["torch"] > 0 == plant.STEP_COST_EVALS["numpy"]

        res = run_scenario(Scenario(
            name="blocked", rate=RateSpec(((1.0, 20.0),)), time_scale=0.002,
            out_tokens=16, profile=EngineProfile(alpha=10.0, beta=0.2, gamma=2.0,
                                                 delta=0.005, max_batch=16)))
        assert res["requests"] > 0 and "itl_ms" in res["model"]
        assert not any(m.split(".")[0] in ("jax", "inferno_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", report["reactive"]["completed"], res["requests"])
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_profiling_blocks_run_with_jax_blocked(tmp_path):
    """One tiny decode of each profiling block on the CPU, a tiny
    `profile_gpu --device cpu` sweep, and the profile build of its raw
    and of the committed TPU raws, with jax blocked."""
    proc = _run_blocked(f"""
        import json, torch
        from inferno_tpu_torch.models import gemma_block, llama_block, profiles
        from inferno_tpu_torch.tools import build_profiles, profile_gpu

        for blk, dims in ((llama_block, llama_block.LlamaDims(
                hidden=32, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64, vocab=64)),
                          (gemma_block, gemma_block.GemmaDims(
                hidden=32, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64, vocab=64,
                sliding_window=4, query_pre_attn_scalar=8.0))):
            params = blk.init_stack(torch.Generator().manual_seed(0), dims, 2, "float32",
                                    device="cpu")
            caches = [torch.zeros(2, 2, 12, 8) for _ in range(4)]
            s, x, _ = blk.make_decode_fn(dims, 2, 3)(params, torch.ones(2, 1, 32) * 0.1,
                                                     caches, 8)
            assert torch.isfinite(s) and x.shape == (2, 1, 32)

        profile_gpu.ALL_PRESETS["tiny"] = llama_block.LlamaDims(
            hidden=32, n_heads=4, n_kv_heads=2, head_dim=8, ffn=64, vocab=64, n_layers=4)
        out = {str(tmp_path)!r} + "/raw.json"
        profile_gpu.main(["--model", "tiny", "--device", "cpu", "--out", out, "--iters", "1",
                          "--decode-steps", "2", "--context", "8", "--decode-batches", "1", "2",
                          "--prefill-batches", "1", "--prefill-tokens", "4",
                          "--mixed-batches", "1", "2", "--mixed-tokens", "4",
                          "--layer-depths", "1", "2", "--target-ms", "0.1"])
        doc = profiles.build_profile_json(json.load(open(out)), "cpu-1", hbm_per_chip_gb=2.0,
                                          weight_bytes_per_param=2.0)
        assert doc["fit"]["ttft_calibration"] == "mixed-step", doc["fit"]
        built = build_profiles.build_model("llama-3.1-8b")
        assert len(built) == 12 and len(build_profiles.build_cross_model("llama-3.2-1b")) == 3
        assert not any(m.split(".")[0] in ("jax", "inferno_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", doc["maxBatchSize"], len(built))
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("ok")


def test_analyzer_runs_with_jax_and_torch_blocked():
    """The port's analyzer lints its own tree with jax, the reference and
    torch all blocked: it lints source and needs none of them."""
    proc = _run_blocked("""
        sys.modules["torch"] = None
        from inferno_tpu_torch.analysis.__main__ import main

        rc = main(["--root", ROOT, "--budget-seconds", "30"])
        assert rc == 0, rc
        assert not any(m.split(".")[0] in ("jax", "inferno_tpu", "torch")
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """.replace("ROOT", repr(str(ROOT))))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok", proc.stdout


def test_kernel_module_imports_without_nvcc_or_cuda(tmp_path):
    """ops.cuda_queueing imports (and its CPU path runs) with no nvcc on
    PATH; the kernel library is built only at the first CUDA launch."""
    proc = _run_blocked("""
        import os, torch
        from inferno_tpu_torch.ops import cuda_queueing as cq
        from inferno_tpu_torch.ops import queueing as q

        p = q.FleetParams(*[torch.ones(3) for _ in q.FleetParams._fields])
        p = p._replace(max_batch=torch.full((3,), 8, dtype=torch.int32),
                       occupancy_cap=torch.full((3,), 88, dtype=torch.int32))
        grid = q._make_grid(p, 128)
        out = cq.solve_stats(torch.full((3,), 0.01), grid)
        assert cq._lib is None and cq.LAUNCHES == 0 and cq.BUILD_LOG == ""
        assert cq.library_path().startswith(cq.BUILD_DIR)
        assert all(t.shape == (3,) for t in out)
        print("ok")
    """, extra_env={"PATH": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero, printing no result, where there is no
    CUDA device (this machine) or no checkout beside it."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                              text=True, timeout=120, cwd=str(script.parent))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
