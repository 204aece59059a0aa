"""The port stands alone: no module of inferno_tpu_torch, and not
chip_smoke.py, imports jax, flax, optax or the JAX package inferno_tpu.

Checked twice: statically (an AST scan of every import statement) and
dynamically (subprocesses in which those imports are blocked size a fleet
and run three reconcile cycles through the port on the CPU). The scan
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
