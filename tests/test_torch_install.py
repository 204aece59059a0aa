"""The port runs from an installed copy, not only from a checkout.

A wheel of the tree is built offline and installed with `pip install
--target` into a temporary directory. The installed copy must carry every
file the port opens through `__file__`, and, in a subprocess that sees
only that directory (the checkout is off `sys.path`), build the native
solver inside the installed package, size an edge fleet on backend
"native" with the checkout's decisions, and run the port's invariant
analyzer over the checkout with its own shipped allowlist. A wheel of a
tree that already holds a built native library ships it (the package data
lists `*.so`, as the reference's does), and the installed copy loads that
library as it is, without a rebuild. The same holds for the CUDA kernel
library (`ops/_build/*.so`): a wheel of a tree that holds it ships it, and
the installed copy's `cuda_queueing.build()` returns it without nvcc.

Each step has a time limit of its own (the subprocess timeouts below);
the whole test takes about half a minute on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from functools import cache
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FLEET_KW = dict(shapes_per_variant=3, tandem_every=5, zero_load_every=7,
                pinned_every=11, infeasible_every=13)
N_VARIANTS = 200
# the data files the port opens through __file__ (relative to its package)
SHIPPED = ("native/queueing.cc", "ops/csrc/stats_kernel.cu", "ops/csrc/bisect_kernel.cu",
           "ops/csrc/lane_solve.cuh", "ops/csrc/fold_tail.cuh",
           "models/surrogate_init.npz", "analysis/allowlist.txt")
BUILD_S, INSTALL_S, RUN_S = 240, 120, 300


def _decisions(system) -> dict:
    return {
        name: None if s.allocation is None else [
            s.allocation.accelerator, s.allocation.num_replicas, repr(s.allocation.cost),
            repr(s.allocation.max_arrv_rate_per_replica),
        ]
        for name, s in sorted(system.servers.items())
    }


def _install(tmp_path: Path, prebuilt: bool = False, kernels: bytes | None = None) -> Path:
    """Wheel of the tree (built from a copy without caches or built
    libraries, so the checkout stays untouched), installed into a target.
    With `prebuilt`, the copy builds its native library before the wheel
    is made; with `kernels`, the copy holds these bytes at the kernel
    library's content-addressed path (`cuda_queueing.library_path()`), as
    a tree where `cuda_queueing.build()` has run does."""
    src = tmp_path / "src"
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "_build")
    for pkg in ("inferno_tpu", "inferno_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=ignore)
    shutil.copy(REPO / "pyproject.toml", src)
    if kernels is not None:
        from inferno_tpu_torch.ops import cuda_queueing

        rel = Path(cuda_queueing.library_path()).relative_to(REPO)
        (src / rel).parent.mkdir(parents=True)
        (src / rel).write_bytes(kernels)
    if prebuilt:
        subprocess.run([sys.executable, "-c",
                        "from inferno_tpu_torch import native; native._load()"],
                       cwd=src, env={**_env_without_pythonpath(), "PYTHONPATH": str(src)},
                       check=True, capture_output=True, text=True, timeout=RUN_S)
    wheels, target = tmp_path / "wheels", tmp_path / "site"
    pip = [sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-input"]
    subprocess.run([*pip, "wheel", "--no-deps", "--no-build-isolation", "--no-index",
                    "-w", str(wheels), str(src)],
                   check=True, capture_output=True, text=True, timeout=BUILD_S)
    (wheel,) = wheels.glob("inferno_tpu-*.whl")
    subprocess.run([*pip, "install", "--no-deps", "--no-index", "--target", str(target),
                    str(wheel)],
                   check=True, capture_output=True, text=True, timeout=INSTALL_S)
    return target


def _env_without_pythonpath() -> dict:
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _run_installed(tmp_path: Path, target: Path, load: str, lint: bool) -> dict:
    """In a subprocess that sees only `target`: run `load` (which loads the
    native library and leaves its path in `lib`), size the edge fleet on
    backend "native", and, with `lint`, run the analyzer over the checkout.
    Returns what the subprocess printed as JSON."""
    work = tmp_path / "work"
    work.mkdir()
    code = textwrap.dedent(f"""
        import json, os, subprocess, sys
        target, repo = {str(target)!r}, {str(REPO)!r}
        assert not any(os.path.abspath(p or ".").startswith(repo) for p in sys.path), sys.path
        import inferno_tpu_torch
        from inferno_tpu_torch import native
        assert inferno_tpu_torch.__file__.startswith(target + os.sep), inferno_tpu_torch.__file__
        assert native.BUILD_DIR.startswith(target + os.sep), native.BUILD_DIR
    """) + textwrap.dedent(load) + textwrap.dedent(f"""
        assert os.path.dirname(lib) == os.path.join(target, "inferno_tpu_torch", "native"), lib
        assert os.path.isfile(lib)

        from inferno_tpu_torch.core.system import System
        from inferno_tpu_torch.parallel import calculate_fleet
        from inferno_tpu_torch.solver import solve_unlimited
        from inferno_tpu_torch.testing.fleet import fleet_system_spec

        system = System(fleet_system_spec({N_VARIANTS}, **{FLEET_KW!r}))
        lanes = calculate_fleet(system, backend="native")
        solve_unlimited(system)
        decisions = {{
            name: None if s.allocation is None else [
                s.allocation.accelerator, s.allocation.num_replicas, repr(s.allocation.cost),
                repr(s.allocation.max_arrv_rate_per_replica),
            ]
            for name, s in sorted(system.servers.items())
        }}
        lint = None
        if {lint!r}:
            lint = subprocess.run([sys.executable, "-m", "inferno_tpu_torch.analysis",
                                   "--root", repo, "--budget-seconds", "30"],
                                  capture_output=True, text=True, timeout=120)
            lint = [lint.returncode, lint.stdout + lint.stderr]
        print(json.dumps({{"lib": lib, "lanes": lanes, "decisions": decisions,
                          "lint": lint}}))
    """)
    env = {**_env_without_pythonpath(), "PYTHONPATH": str(target)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=work, env=env,
                          capture_output=True, text=True, timeout=RUN_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@cache
def _checkout_run() -> tuple[int, dict]:
    from inferno_tpu_torch.core.system import System
    from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
    from inferno_tpu_torch.solver import solve_unlimited
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    reset_fleet_state()
    system = System(fleet_system_spec(N_VARIANTS, **FLEET_KW))
    lanes = calculate_fleet(system, backend="native")
    solve_unlimited(system)
    reset_fleet_state()
    return lanes, _decisions(system)


def _assert_sizes_like_the_checkout(got: dict) -> None:
    lanes, want = _checkout_run()
    assert got["lanes"] == lanes
    assert got["decisions"] == want
    assert sum(d is not None for d in want.values()) > N_VARIANTS // 2


def test_installed_copy_builds_native_and_sizes_like_the_checkout(tmp_path):
    target = _install(tmp_path)
    pkg = target / "inferno_tpu_torch"
    missing = [rel for rel in SHIPPED if not (pkg / rel).is_file()]
    assert missing == []
    assert not list((pkg / "native").glob("*.so")), \
        "a wheel of a tree without a built library carries none"

    got = _run_installed(tmp_path, target, """
        native._load()
        lib = native._lib_path()
    """, lint=True)
    rc, out = got["lint"]
    assert rc == 0 and "clean" in out, out
    assert Path(got["lib"]).is_file() and Path(got["lib"]).is_relative_to(pkg / "native")
    _assert_sizes_like_the_checkout(got)


def test_installed_copy_loads_a_shipped_library_as_it_is(tmp_path):
    target = _install(tmp_path, prebuilt=True)
    pkg = target / "inferno_tpu_torch"
    (shipped,) = (pkg / "native").glob("libinferno_queueing-*.so")

    # the shipped library carries the source's hash, so the installed copy
    # loads that very file: no g++ runs (a rebuild renames a new inode in)
    got = _run_installed(tmp_path, target, """
        lib = native._lib_path()
        before = os.stat(lib)
        native._load()
        after = os.stat(lib)
        assert (after.st_ino, after.st_mtime_ns) == (before.st_ino, before.st_mtime_ns)
    """, lint=False)
    assert got["lib"] == str(shipped)
    assert sorted((pkg / "native").glob("*.so")) == [shipped]
    _assert_sizes_like_the_checkout(got)


def _tree(root: Path) -> dict:
    """{relative path: bytes} of every file under `root`, and None for
    every directory."""
    return {str(p.relative_to(root)): None if p.is_dir() else p.read_bytes()
            for p in sorted(root.rglob("*"))}


def test_installed_copy_takes_a_shipped_kernel_library_without_nvcc(tmp_path):
    """A wheel of a tree that holds the kernel library ships it under its
    content-addressed name (the package data lists `ops/_build/*.so`), and
    the installed copy's `build()` returns that file at its exists check:
    no nvcc (here it raises if called), no write into the installed tree,
    an empty BUILD_LOG. The library is a placeholder and is never loaded
    (there is no card here)."""
    placeholder = b"a kernel library built elsewhere"
    target = _install(tmp_path, kernels=placeholder)
    pkg = target / "inferno_tpu_torch"
    (shipped,) = (pkg / "ops" / "_build").glob("libinferno_kernels-*.so")
    assert shipped.read_bytes() == placeholder
    before = _tree(target)
    work = tmp_path / "work"
    work.mkdir()
    code = textwrap.dedent(f"""
        import json, os, sys
        repo = {str(REPO)!r}
        assert not any(os.path.abspath(p or ".").startswith(repo) for p in sys.path), sys.path
        from inferno_tpu_torch.ops import cuda_queueing

        def no_nvcc():
            raise AssertionError("nvcc was asked for")

        cuda_queueing._nvcc = no_nvcc
        path = cuda_queueing.build()
        print(json.dumps({{"path": path, "log": cuda_queueing.BUILD_LOG,
                          "loaded": cuda_queueing._lib is not None}}))
    """)
    env = {**_env_without_pythonpath(), "PYTHONPATH": str(target),
           "PYTHONDONTWRITEBYTECODE": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=work, env=env,
                          capture_output=True, text=True, timeout=RUN_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"path": str(shipped), "log": "", "loaded": False}
    assert _tree(target) == before



def test_prebuild_builds_both_libraries_without_a_card(tmp_path, monkeypatch, capsys):
    """`python -m inferno_tpu_torch.tools.prebuild`, the image's build
    step: both libraries built (the kernel build is a stand-in here, there
    is no nvcc), one line each, CUDA never initialised; a library that is
    missing afterwards raises."""
    from inferno_tpu_torch import native
    from inferno_tpu_torch.ops import cuda_queueing
    from inferno_tpu_torch.tools import prebuild

    kernels = tmp_path / "inferno_tpu_torch" / "ops" / "_build" / "libinferno_kernels-x.so"
    kernels.parent.mkdir(parents=True)
    kernels.write_bytes(b"12345")
    monkeypatch.setattr(cuda_queueing, "build", lambda: str(kernels))
    monkeypatch.chdir(tmp_path)
    assert prebuild.main() == 0
    first, second = capsys.readouterr().out.splitlines()
    assert first.startswith("inferno_tpu_torch/ops/_build/libinferno_kernels-x.so 5 bytes ")
    assert os.path.basename(native._lib_path()) in second

    kernels.unlink()
    with pytest.raises(RuntimeError, match="was not built"):
        prebuild.main()
