"""The sizing kernels on the GPU: build, bind and launch.

Port of `inferno_tpu/ops/pallas_queueing.py`. Two hand-written kernels
(sm_90a) share the stationary solve of `csrc/lane_solve.cuh`:

* `solve_stats(lam, grid)` launches `csrc/stats_kernel.cu`, one stationary
  solve of every lane. It has the contract of the reference's
  `solve_stats` and of the plain `ops.queueing._solve_stats`: it returns
  (wait, serv, in_servers, throughput), each f32[P].
* `bisect(case, n_iters)` launches `csrc/bisect_kernel.cu`, a whole
  bisection of every lane (`ops.queueing.BisectCase`), with the contract
  of the plain `ops.queueing._bisect_plain`: it returns (lam_star f32[P],
  feasible bool[P]).

On a CUDA tensor each wrapper launches its kernel on the current stream,
and raises on anything the kernel does not take or a launch CUDA refuses.
On a CPU tensor it calls the plain torch version.

The kernels are compiled with nvcc (one process per source, all started
together) and linked into one shared library with a plain C interface,
loaded with ctypes at the first launch (never at import: this module
imports without nvcc or CUDA). Like the reference's native build
(inferno_tpu/native/__init__.py) the library is named by a sha256 of its
sources and flags, written to a temporary name and renamed into place
atomically; it goes to `build/kernels/` at the repo root. Nothing is
caught: a failed nvcc raises with its stderr.

`LAUNCHES` and `BISECT_LAUNCHES` count the launches of each kernel (and
nothing else), so a run can show that the sizing path went through them.
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

from inferno_tpu_torch.ops.queueing import (
    BISECT_METRICS,
    TAN_ITL,
    BisectCase,
    _bisect_plain,
    _Grid,
    _solve_stats,
)

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_KERNEL_SOURCES = ("stats_kernel.cu", "bisect_kernel.cu")
_SOURCES = (*_KERNEL_SOURCES, "lane_solve.cuh", "fold_tail.cuh")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
# the widths whose rows a kernel holds in registers (16-byte loads): the
# bucket widths of parallel.fleet._bucket_k; any other K runs a strided body
_REGISTER_WIDTHS = (128, 512, 2048)

LAUNCHES = 0  # stats_kernel launches since import (or the caller's reset)
BISECT_LAUNCHES = 0  # bisect_kernel launches since import (or the caller's reset)
BUILD_LOG = ""  # nvcc's output of the build this process made ("" if it loaded one)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path() -> str:
    """Content-addressed library path: sources and flags hashed into the
    name, so a changed source never loads a stale build."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libinferno_kernels-{digest.hexdigest()[:16]}.so")


def _nvcc_jobs(cmds: list[list[str]]) -> str:
    """Run the nvcc commands at once and wait for every one of them, then
    raise on the first that failed; returns their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    done = [(cmd, proc, *proc.communicate()) for cmd, proc in zip(cmds, procs)]
    for cmd, proc, _, err in done:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
    return "".join(out + err for _, _, out, err in done)


def build() -> str:
    """Compile the kernel library if it is not built yet; returns its path.
    Each source compiles in its own nvcc process, all at once; one more
    nvcc links the objects."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    nvcc = _nvcc()
    objects = [f"{tmp}.{src}.o" for src in _KERNEL_SOURCES]
    t0 = time.perf_counter()
    log = _nvcc_jobs([
        [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", "-o", obj, os.path.join(_CSRC, src)]
        for src, obj in zip(_KERNEL_SOURCES, objects)
    ])
    log += _nvcc_jobs([[nvcc, *_ARCH, "-shared", "-o", tmp, *objects]])
    for obj in objects:
        os.remove(obj)
    os.rename(tmp, path)
    BUILD_LOG = f"built {os.path.basename(path)} in {time.perf_counter() - t0:.1f} s\n{log}"
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.inferno_stats_launch.argtypes = [ptr] * 6 + [i32, i32, ptr]
            lib.inferno_stats_launch.restype = i32
            lib.inferno_bisect_launch.argtypes = (
                [i32] + [ptr] * 16 + [i32, i32, i32, ctypes.c_float, ptr]
            )
            lib.inferno_bisect_launch.restype = i32
            lib.inferno_set_device.argtypes = [i32]
            lib.inferno_set_device.restype = i32
            lib.inferno_cuda_error_string.argtypes = [i32]
            lib.inferno_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: {lib.inferno_cuda_error_string(rc).decode()}")


def _check_lane_vector(kernel: str, name: str, t: torch.Tensor, p: int, device) -> None:
    if t.dtype != torch.float32 or t.shape != (p,) or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous f32[{p}] tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, the lanes on {device}")


def _check_grid(kernel: str, name: str, grid: _Grid, device) -> tuple[int, int]:
    """(P, K) of a grid the kernels take: a contiguous f32[P, K] cml, 16-byte
    aligned where K is a register width, and f32[P] lane vectors."""
    cml = grid.cml
    if cml.dim() != 2 or cml.dtype != torch.float32 or not cml.is_contiguous():
        raise ValueError(
            f"{kernel}: {name}.cml must be a contiguous f32[P, K] tensor, got "
            f"{cml.dtype} {tuple(cml.shape)} contiguous={cml.is_contiguous()}"
        )
    if cml.device != device:
        raise ValueError(f"{kernel}: {name}.cml is on {cml.device}, the lanes on {device}")
    p, k = cml.shape
    if grid.kk.shape[-1] != k + 1:
        raise ValueError(f"{kernel}: {name}.kk must span states 0..K")
    if device.type == "cuda" and k in _REGISTER_WIDTHS and cml.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name}.cml must be 16-byte aligned")
    for field in ("nmax", "log_mu_full", "tail_len"):
        _check_lane_vector(kernel, f"{name}.{field}", getattr(grid, field), p, device)
    return p, k


def _set_device(lib: ctypes.CDLL, device: torch.device, kernel: str) -> None:
    index = device.index if device.index is not None else torch.cuda.current_device()
    _raise_on(lib, lib.inferno_set_device(index), f"{kernel}: cudaSetDevice({index})")


def solve_stats(lam: torch.Tensor, grid: _Grid):
    """Stationary statistics for all lanes: (wait, serv, in_servers,
    throughput), each f32[P]. `grid` is an `ops.queueing._Grid`."""
    global LAUNCHES
    device = lam.device
    if device.type == "cpu":
        return _solve_stats(lam, grid)
    if device.type != "cuda":
        raise ValueError(f"stats_kernel: unsupported device {device}")
    p, k = _check_grid("stats_kernel", "grid", grid, device)
    _check_lane_vector("stats_kernel", "lam", lam, p, device)
    out = torch.empty((4, p), dtype=torch.float32, device=device)
    if p == 0:
        return out[0], out[1], out[2], out[3]
    lib = _load()
    _set_device(lib, device, "stats_kernel")
    rc = lib.inferno_stats_launch(
        grid.cml.data_ptr(), lam.data_ptr(), grid.nmax.data_ptr(),
        grid.log_mu_full.data_ptr(), grid.tail_len.data_ptr(), out.data_ptr(),
        p, k, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, rc, f"stats_kernel launch failed (P={p}, K={k})")
    LAUNCHES += 1
    return out[0], out[1], out[2], out[3]


def _check_case(case: BisectCase, n_iters: int) -> tuple[int, int]:
    """(P, K) of a bisection the kernel takes; raises on anything else."""
    kernel = "bisect_kernel"
    if case.metric not in BISECT_METRICS:
        raise ValueError(f"{kernel}: unknown metric {case.metric}")
    if not isinstance(n_iters, int) or n_iters < 0:
        raise ValueError(f"{kernel}: n_iters must be a non-negative int, got {n_iters!r}")
    device = case.lam_min.device
    p, k = _check_grid(kernel, "gp", case.gp, device)
    if case.metric == TAN_ITL:
        if case.gd is None or _check_grid(kernel, "gd", case.gd, device) != (p, k):
            raise ValueError(f"{kernel}: the decode grid must match the prefill grid's [P, K]")
    for name in ("lam_min", "lam_max", "target", "y_lo", "y_hi"):
        _check_lane_vector(kernel, name, getattr(case, name), p, device)
    c = case.consts
    rows = BISECT_METRICS[case.metric]
    if c.dtype != torch.float32 or c.shape != (rows, p) or not c.is_contiguous():
        raise ValueError(
            f"{kernel}: consts must be a contiguous f32[{rows}, {p}] tensor, got "
            f"{c.dtype} {tuple(c.shape)} contiguous={c.is_contiguous()}"
        )
    if c.device != device:
        raise ValueError(f"{kernel}: consts is on {c.device}, the lanes on {device}")
    return p, k


def bisect(case: BisectCase, n_iters: int):
    """One bisection of every lane, `n_iters` fixed steps: (lam_star f32[P],
    feasible bool[P]), as `ops.queueing._bisect_plain(case, n_iters)`."""
    global BISECT_LAUNCHES
    device = case.lam_min.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"bisect_kernel: unsupported device {device}")
    p, k = _check_case(case, n_iters)
    if device.type == "cpu":
        return _bisect_plain(case, n_iters)
    lam = torch.empty(p, dtype=torch.float32, device=device)
    ok = torch.empty(p, dtype=torch.bool, device=device)
    if p == 0:
        return lam, ok
    lib = _load()
    _set_device(lib, device, "bisect_kernel")
    gp = case.gp
    gd = case.gd if case.metric == TAN_ITL else None
    rc = lib.inferno_bisect_launch(
        case.metric,
        gp.cml.data_ptr(), gp.nmax.data_ptr(), gp.log_mu_full.data_ptr(),
        gp.tail_len.data_ptr(),
        *((gd.cml.data_ptr(), gd.nmax.data_ptr(), gd.log_mu_full.data_ptr(),
           gd.tail_len.data_ptr()) if gd is not None else (None,) * 4),
        case.consts.data_ptr(), case.lam_min.data_ptr(), case.lam_max.data_ptr(),
        case.target.data_ptr(), case.y_lo.data_ptr(), case.y_hi.data_ptr(),
        lam.data_ptr(), ok.data_ptr(), p, k, n_iters, case.wait_margin,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, rc, f"bisect_kernel launch failed (metric {case.metric}, P={p}, K={k})")
    BISECT_LAUNCHES += 1
    return lam, ok
