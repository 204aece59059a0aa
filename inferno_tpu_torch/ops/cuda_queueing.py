"""The stationary-solve kernel on the GPU: build, bind and launch.

Port of `inferno_tpu/ops/pallas_queueing.py`. `solve_stats(lam, grid)`
has the contract of the reference's `solve_stats` and of the plain
`ops.queueing._solve_stats`: it returns (wait, serv, in_servers,
throughput), each f32[P].

* On a CUDA tensor it launches the hand-written kernel
  `csrc/stats_kernel.cu` (sm_90a) on the current stream, and raises on
  anything the kernel does not take or a launch CUDA refuses.
* On a CPU tensor it calls the plain torch version `_solve_stats`.

The kernel is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes, at its first launch (never at import:
this module imports without nvcc or CUDA). Like the reference's native
build (inferno_tpu/native/__init__.py) the library is named by a sha256
of its sources and flags, written to a temporary name and renamed into
place atomically; it goes to `build/kernels/` at the repo root. Nothing
is caught: a failed nvcc raises with its stderr.

`LAUNCHES` counts kernel launches (and nothing else), so a run can show
that the sizing path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import uuid

import torch

from inferno_tpu_torch.ops.queueing import _Grid, _solve_stats

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCES = ("stats_kernel.cu", "fold_tail.cuh")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES = 0  # stats_kernel launches since import (or the caller's reset)
BUILD_LOG = ""  # nvcc's output of the build this process made ("" if it loaded one)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernel needs the CUDA toolkit")
    return nvcc


def library_path() -> str:
    """Content-addressed library path: sources and flags hashed into the
    name, so a changed source never loads a stale build."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libinferno_stats-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library if it is not built yet; returns its path."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-o", tmp,
           os.path.join(_CSRC, "stats_kernel.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.rename(tmp, path)
    BUILD_LOG = (
        f"built {os.path.basename(path)} in {time.perf_counter() - t0:.1f} s\n"
        f"{proc.stdout}{proc.stderr}"
    )
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.inferno_stats_launch
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.inferno_set_device.argtypes = [ctypes.c_int]
            lib.inferno_set_device.restype = ctypes.c_int
            err = lib.inferno_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: {lib.inferno_cuda_error_string(rc).decode()}")


def _check_lane_vector(name: str, t: torch.Tensor, p: int, device) -> None:
    if t.dtype != torch.float32 or t.shape != (p,) or not t.is_contiguous():
        raise ValueError(
            f"stats_kernel: {name} must be a contiguous f32[{p}] tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.device != device:
        raise ValueError(f"stats_kernel: {name} is on {t.device}, lam on {device}")


def solve_stats(lam: torch.Tensor, grid: _Grid):
    """Stationary statistics for all lanes: (wait, serv, in_servers,
    throughput), each f32[P]. `grid` is an `ops.queueing._Grid`."""
    global LAUNCHES
    device = lam.device
    if device.type == "cpu":
        return _solve_stats(lam, grid)
    if device.type != "cuda":
        raise ValueError(f"stats_kernel: unsupported device {device}")
    cml = grid.cml
    if cml.dim() != 2 or cml.dtype != torch.float32 or not cml.is_contiguous():
        raise ValueError(
            f"stats_kernel: cml must be a contiguous f32[P, K] tensor, got "
            f"{cml.dtype} {tuple(cml.shape)}"
        )
    if cml.device != device:
        raise ValueError(f"stats_kernel: cml is on {cml.device}, lam on {device}")
    p, k = cml.shape
    if grid.kk.shape[-1] != k + 1:
        raise ValueError("stats_kernel: grid.kk must span states 0..K")
    for name, t in (("lam", lam), ("nmax", grid.nmax),
                    ("log_mu_full", grid.log_mu_full), ("tail_len", grid.tail_len)):
        _check_lane_vector(name, t, p, device)
    out = torch.empty((4, p), dtype=torch.float32, device=device)
    if p == 0:
        return out[0], out[1], out[2], out[3]
    lib = _load()
    index = device.index if device.index is not None else torch.cuda.current_device()
    _raise_on(lib, lib.inferno_set_device(index), f"stats_kernel: cudaSetDevice({index})")
    rc = lib.inferno_stats_launch(
        cml.data_ptr(), lam.data_ptr(), grid.nmax.data_ptr(),
        grid.log_mu_full.data_ptr(), grid.tail_len.data_ptr(), out.data_ptr(),
        p, k, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, rc, f"stats_kernel launch failed (P={p}, K={k})")
    LAUNCHES += 1
    return out[0], out[1], out[2], out[3]
