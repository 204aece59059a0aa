"""The hand-written kernels on the GPU: build, bind and launch.

Port of `inferno_tpu/ops/pallas_queueing.py`. Two hand-written kernels
(sm_90a) share the stationary solve of `csrc/lane_solve.cuh`:

* `solve_stats(lam, grid)` launches `csrc/stats_kernel.cu`, one stationary
  solve of every lane. It has the contract of the reference's
  `solve_stats` and of the plain `ops.queueing._solve_stats`: it returns
  (wait, serv, in_servers, throughput), each f32[P].
* `bisect(case, n_iters)` launches `csrc/bisect_kernel.cu`, a whole
  bisection of every lane (`ops.queueing.BisectCase`), with the contract
  of the plain `ops.queueing._bisect_plain`: it returns (lam_star f32[P],
  feasible bool[P]). The kernel runs `depth` steps a round on 2^depth - 1
  thread groups a lane (`choose_depth` picks the largest depth whose lanes
  fit on the card in one wave, from `bisect_shape`), solves only the
  bucket's `real_lanes` (the rest copy lane 0 and take its result), and
  stops a lane's warp or block once all its lanes reach a fixed point;
  every schedule gives the same bits.

A third kernel serves the capacity planner, not the sizing:
`plan_rows(rates, lanes, ...)` launches `csrc/plan_rows_kernel.cu` over
a [rows, S] slab of rates, the per-row replica fold, transition
penalties, segment argmin, zero-load overlay and bucket chip demand of
`parallel.fleet.FleetBatchPrep`, bit for bit its numpy path (which is
its plain version: there is no torch one, and a CPU tensor raises).

On a CUDA tensor each wrapper launches its kernel on the current stream,
and raises on anything the kernel does not take or a launch CUDA refuses.
On a CPU tensor the two sizing wrappers call their plain torch versions.

The kernels are compiled with nvcc (one process per object, all started
together: stats_kernel.cu once, bisect_kernel.cu once per metric,
plan_rows_kernel.cu once) and
linked into one shared library with a plain C interface,
loaded with ctypes at the first launch (never at import: this module
imports without nvcc or CUDA). Like the reference's native build
(inferno_tpu/native/__init__.py) the library is named by a sha256 of its
sources and flags, written to a temporary name and renamed into place
atomically; it goes to `_build/` beside this module, in the checkout or
the installed copy alike (a directory that cannot be written raises,
naming it). Nothing is caught: a failed nvcc raises with its stderr. A
wheel built from a tree where `build()` has run ships the library under
that name (`tools/prebuild.py`, the image's build step), and an installed
copy whose sources hash to it loads it as it is: `build()` returns at its
exists check, before it needs nvcc or a writable directory.

`LAUNCHES`, `BISECT_LAUNCHES` and `PLAN_ROWS_LAUNCHES` count the launches
of each kernel (and nothing else), so a run can show that its path went
through them; the cycle profiler (`obs/profiler.py`) counts them too, per
cycle, as `stats_kernel_launches`, `bisect_kernel_launches` and
`plan_rows_kernel_launches`. The library's first
load in the process is the profiler's span `kernel_library_load` and
bumps `kernel_library_loads`: the one build the port has.
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
from typing import NamedTuple

import torch

from inferno_tpu_torch.native import ensure_build_dir

# cycle-profiler hooks (obs/profiler.py): thread-local no-ops unless a
# profiler is active; observation only
from inferno_tpu_torch.obs import profiler as _prof
from inferno_tpu_torch.ops.queueing import (
    BISECT_METRICS,
    TAN_ITL,
    BisectCase,
    _bisect_plain,
    _Grid,
    _solve_stats,
)

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# the objects of the library: (source, its own flags); the bisection is
# built once per metric, so its instantiations compile in parallel
_OBJECTS = (
    ("stats_kernel.cu", ()),
    *(("bisect_kernel.cu", (f"-DINFERNO_BISECT_METRIC={m}",)) for m in BISECT_METRICS),
    ("plan_rows_kernel.cu", ()),
)
_SOURCES = ("stats_kernel.cu", "bisect_kernel.cu", "lane_solve.cuh", "fold_tail.cuh",
            "plan_rows_kernel.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
# the widths whose rows a kernel holds in registers (16-byte loads): the
# bucket widths of parallel.fleet._bucket_k; any other K runs a strided body
_REGISTER_WIDTHS = (128, 512, 2048)

LAUNCHES = 0  # stats_kernel launches since import (or the caller's reset)
BISECT_LAUNCHES = 0  # bisect_kernel launches since import (or the caller's reset)
PLAN_ROWS_LAUNCHES = 0  # plan_rows_kernel launches since import (or the caller's reset)
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
    digest.update(repr(_OBJECTS).encode())
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
    ensure_build_dir(BUILD_DIR, "the CUDA kernel library")
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    nvcc = _nvcc()
    objects = [f"{tmp}.{i}.o" for i in range(len(_OBJECTS))]
    t0 = time.perf_counter()  # noqa: INF005 (the build's own duration, reported in BUILD_LOG)
    log = _nvcc_jobs([
        [nvcc, *NVCC_FLAGS, *flags, "-I", _CSRC, "-c", "-o", obj, os.path.join(_CSRC, src)]
        for (src, flags), obj in zip(_OBJECTS, objects)
    ])
    log += _nvcc_jobs([[nvcc, *_ARCH, "-shared", "-o", tmp, *objects]])
    for obj in objects:
        os.remove(obj)
    os.rename(tmp, path)
    seconds = time.perf_counter() - t0  # noqa: INF005 (as above)
    BUILD_LOG = f"built {os.path.basename(path)} in {seconds:.1f} s\n{log}"
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            with _prof.span("kernel_library_load"):
                lib = ctypes.CDLL(build())
                ptr, i32 = ctypes.c_void_p, ctypes.c_int
                lib.inferno_stats_launch.argtypes = [ptr] * 6 + [i32, i32, ptr]
                lib.inferno_stats_launch.restype = i32
                for m in BISECT_METRICS:
                    launch = getattr(lib, f"inferno_bisect_launch_{m}")
                    launch.argtypes = [ptr] * 17 + [i32] * 4 + [ctypes.c_float, i32, i32, ptr]
                    launch.restype = i32
                    shape = getattr(lib, f"inferno_bisect_shape_{m}")
                    shape.argtypes = [i32, i32, ptr]
                    shape.restype = i32
                lib.inferno_plan_rows_launch.argtypes = (
                    [ptr, i32, i32] + [ptr] * 12 + [ctypes.c_double] + [ptr] * 8
                    + [i32, i32] + [ptr] * 8
                )
                lib.inferno_plan_rows_launch.restype = i32
                lib.inferno_set_device.argtypes = [i32]
                lib.inferno_set_device.restype = i32
                lib.inferno_cuda_error_string.argtypes = [i32]
                lib.inferno_cuda_error_string.restype = ctypes.c_char_p
                _lib = lib
            _prof.count("kernel_library_loads")
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
    _prof.count("stats_kernel_launches")
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


# the deepest round bisect_kernel is built for (csrc/bisect_kernel.cu MAX_DEPTH)
BISECT_MAX_DEPTH = 4


class BisectShape(NamedTuple):
    """How one instantiation of bisect_kernel (metric, K, depth) launches
    on a card, from CUDA's own account of the compiled kernel."""

    depth: int
    threads: int  # a block's threads
    lanes_per_block: int  # 1 where a lane spans a cluster
    cluster: int  # blocks a lane spans (1: no cluster)
    blocks_per_sm: int  # blocks an SM holds at once
    resident_lanes: int  # lanes the card holds at once
    registers: int  # a thread's
    spill_bytes: int  # local memory a thread


def resident_lanes(sm_count: int, blocks_per_sm: int, lanes_per_block: int,
                   cluster: int, active_clusters: int) -> int:
    """Lanes the card runs at once: those of every block its SMs hold, or,
    where a lane spans a cluster, the clusters the card holds."""
    if cluster > 1:
        return active_clusters
    return sm_count * blocks_per_sm * lanes_per_block


def waves(lanes: int, resident: int) -> int:
    """Waves of a launch of `lanes` lanes on a card that holds `resident`
    at once (0 when it holds none: the launch cannot run)."""
    if resident <= 0:
        return 0
    return -(-lanes // resident)


def choose_depth(lanes: int, resident: dict[int, int]) -> int:
    """The depth of a bisection of `lanes` lanes: the largest whose lanes
    all fit on the card in one wave (`resident[d]`: lanes the card holds at
    once at depth d), or 1 where none fits. A deeper round spends 2^d - 1
    thread groups a lane to take d steps at once, which pays only while the
    groups run side by side."""
    fits = [d for d, cap in resident.items() if d >= 1 and lanes <= cap]
    return max(fits, default=1)


_shapes: dict = {}


def bisect_shape(metric: int, k: int, depth: int, device) -> BisectShape:
    """The launch shape of bisect_kernel at (metric, K, depth) on `device`
    (a CUDA device; K outside the register widths takes the strided
    body). Cached: a compiled kernel's shape does not change."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"bisect_kernel: a launch shape needs a CUDA device, got {device}")
    if metric not in BISECT_METRICS:
        raise ValueError(f"bisect_kernel: unknown metric {metric}")
    _check_depth(depth)
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, metric, k if k in _REGISTER_WIDTHS else 0, depth)
    if key not in _shapes:
        lib = _load()
        _set_device(lib, torch.device("cuda", index), "bisect_kernel")
        out = (ctypes.c_int * 7)()
        rc = getattr(lib, f"inferno_bisect_shape_{metric}")(k, depth, out)
        _raise_on(lib, rc, f"bisect_kernel shape (metric {metric}, K={k}, depth {depth})")
        threads, lanes_per_block, cluster, per_sm, clusters, regs, local = out
        sm_count = torch.cuda.get_device_properties(index).multi_processor_count
        _shapes[key] = BisectShape(
            depth, threads, lanes_per_block, cluster, per_sm,
            resident_lanes(sm_count, per_sm, lanes_per_block, cluster, clusters), regs, local,
        )
    return _shapes[key]


def bisect_depth(metric: int, k: int, lanes: int, device) -> int:
    """The depth `bisect` picks for `lanes` lanes at (metric, K) on `device`."""
    return choose_depth(lanes, {
        d: bisect_shape(metric, k, d, device).resident_lanes
        for d in range(1, BISECT_MAX_DEPTH + 1)
    })


def _check_depth(depth) -> None:
    if not isinstance(depth, int) or not 1 <= depth <= BISECT_MAX_DEPTH:
        raise ValueError(
            f"bisect_kernel: depth must be an int in 1..{BISECT_MAX_DEPTH}, got {depth!r}")


def _check_schedule(p: int, real_lanes, depth, steps_out, device) -> int:
    """The real lane count of a bisection; raises on a schedule the kernel
    does not take."""
    kernel = "bisect_kernel"
    real = p if real_lanes is None else real_lanes
    if not isinstance(real, int) or not (min(p, 1) <= real <= p):
        raise ValueError(f"{kernel}: real_lanes must be an int in 1..{p}, got {real_lanes!r}")
    if depth is not None:
        _check_depth(depth)
    if steps_out is not None and (
        steps_out.dtype != torch.int32 or steps_out.shape != (p,)
        or not steps_out.is_contiguous() or steps_out.device != device
    ):
        raise ValueError(f"{kernel}: steps_out must be a contiguous int32[{p}] tensor "
                         f"on {device}")
    return real


def bisect(case: BisectCase, n_iters: int, *, real_lanes: int | None = None,
           depth: int | None = None, early_exit: bool = True,
           steps_out: torch.Tensor | None = None):
    """One bisection of every lane, `n_iters` steps: (lam_star f32[P],
    feasible bool[P]), as `ops.queueing._bisect_plain(case, n_iters)`.

    `real_lanes` (default P): the lanes past it repeat lane 0's inputs
    (the fleet's pad lanes) and take its result. `depth` (default: the
    largest that fits in one wave, `bisect_depth`) is the steps a round;
    `early_exit` lets a warp or block stop once its lanes reach their fixed
    points. Neither changes a bit of the result. `steps_out`, an int32[P]
    tensor, receives the steps each lane ran (n_iters on the CPU)."""
    global BISECT_LAUNCHES
    device = case.lam_min.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"bisect_kernel: unsupported device {device}")
    p, k = _check_case(case, n_iters)
    real = _check_schedule(p, real_lanes, depth, steps_out, device)
    if device.type == "cpu":
        if steps_out is not None:
            steps_out.fill_(n_iters)
        return _bisect_plain(case, n_iters)
    lam = torch.empty(p, dtype=torch.float32, device=device)
    ok = torch.empty(p, dtype=torch.bool, device=device)
    if p == 0:
        return lam, ok
    if depth is None:
        depth = bisect_depth(case.metric, k, real, device)
    lib = _load()
    _set_device(lib, device, "bisect_kernel")
    gp = case.gp
    gd = case.gd if case.metric == TAN_ITL else None
    rc = getattr(lib, f"inferno_bisect_launch_{case.metric}")(
        gp.cml.data_ptr(), gp.nmax.data_ptr(), gp.log_mu_full.data_ptr(),
        gp.tail_len.data_ptr(),
        *((gd.cml.data_ptr(), gd.nmax.data_ptr(), gd.log_mu_full.data_ptr(),
           gd.tail_len.data_ptr()) if gd is not None else (None,) * 4),
        case.consts.data_ptr(), case.lam_min.data_ptr(), case.lam_max.data_ptr(),
        case.target.data_ptr(), case.y_lo.data_ptr(), case.y_hi.data_ptr(),
        lam.data_ptr(), ok.data_ptr(), None if steps_out is None else steps_out.data_ptr(),
        p, real, k, n_iters, case.wait_margin, depth, int(bool(early_exit)),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, rc, f"bisect_kernel launch failed (metric {case.metric}, P={p}, K={k}, "
                       f"depth {depth})")
    BISECT_LAUNCHES += 1
    _prof.count("bisect_kernel_launches")
    return lam, ok


class PlanLanes(NamedTuple):
    """A prepared planner fleet's columns on the card, for `plan_rows`:
    per server, the lanes it owns (`lane_lo`, lanes sorted by server) and
    its zero-load flags (1: has load, 2: no output tokens); per lane, the
    replica fold's, the cost's and the transition penalty's inputs."""

    lane_lo: torch.Tensor  # int32[S + 1]
    flags: torch.Tensor  # uint8[S]
    rate_star: torch.Tensor  # f32[L]
    tps: torch.Tensor  # f32[L]
    out_tokens: torch.Tensor  # f32[L]
    min_reps: torch.Tensor  # int32[L]
    cpr: torch.Tensor  # f32[L]: cost a replica
    same: torch.Tensor  # uint8[L]: the lane's shape is the server's current one
    cur_reps: torch.Tensor  # int64[L]
    cur_cost: torch.Tensor  # f64[L]
    rank: torch.Tensor  # int32[L]
    chips: torch.Tensor  # int64[L]: chips a replica


class PlanZero(NamedTuple):
    """The zero-load table on the card, per server."""

    choice: torch.Tensor  # int32[S]
    replicas: torch.Tensor  # int32[S]
    chips: torch.Tensor  # int64[S]
    cost: torch.Tensor  # f32[S]
    value: torch.Tensor  # f64[S]


class PlanBuckets(NamedTuple):
    """A capacity ledger's bucket map on the card: rank -> pool column and
    rank -> quota columns (-1: none), `n` columns in all."""

    pid: torch.Tensor  # int32[ranks]
    q1: torch.Tensor  # int32[ranks]
    q2: torch.Tensor  # int32[ranks]
    n_pools: int
    n: int


# the outputs plan_rows can write, [rows, S] each
PLAN_ROW_DTYPES = {
    "choice": torch.int32, "replicas": torch.int32, "chips": torch.int64,
    "cost": torch.float32, "value": torch.float64,
}


def _check_columns(kernel: str, cols: tuple, dtypes: dict, sizes: dict, device) -> None:
    for name, t in cols._asdict().items():
        if not isinstance(t, torch.Tensor):
            continue
        dtype, size = dtypes[name], sizes[name]
        if t.dtype != dtype or t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous {dtype}[{size}] tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the rates on {device}")


def plan_rows(rates: torch.Tensor, lanes: PlanLanes, penalty: float, zero: PlanZero | None,
              out: dict, buckets: PlanBuckets | None = None,
              demand: torch.Tensor | None = None, need_zero: torch.Tensor | None = None) -> None:
    """One launch of `csrc/plan_rows_kernel.cu` over a [rows, S] f64 slab of
    rates (req/min) on the card: each server's winning lane (the replica
    fold, cost, transition penalty at `penalty` and (value, cost, rank)
    argmin of `FleetBatchPrep`'s numpy path, bit for bit) into the [rows, S]
    tensors of `out` (any of `PLAN_ROW_DTYPES`), the zero-load table's
    columns where a server with load has rate 0 or no output tokens,
    and, with `buckets`, each row's winner chips summed into its columns
    of `demand` (int64[rows, buckets.n]). `zero` None: the table is not
    built yet; the kernel then sets `need_zero` (int32[1]) where it met
    such a cell. Launches on the current stream; raises on anything the
    kernel does not take. No CPU version: the host path is the numpy
    fold of `FleetBatchPrep`."""
    global PLAN_ROWS_LAUNCHES
    kernel = "plan_rows_kernel"
    device = rates.device
    if device.type != "cuda":
        raise ValueError(f"{kernel}: rates are on {device}; the host's rows are "
                         "FleetBatchPrep's numpy path")
    if rates.dtype != torch.float64 or rates.dim() != 2 or not rates.is_contiguous():
        raise ValueError(f"{kernel}: rates must be a contiguous f64[rows, S] tensor, got "
                         f"{rates.dtype} {tuple(rates.shape)}")
    rows, s = rates.shape
    n_lanes = lanes.rate_star.shape[0]
    lane_dtypes = {
        "lane_lo": torch.int32, "flags": torch.uint8, "rate_star": torch.float32,
        "tps": torch.float32, "out_tokens": torch.float32, "min_reps": torch.int32,
        "cpr": torch.float32, "same": torch.uint8, "cur_reps": torch.int64,
        "cur_cost": torch.float64, "rank": torch.int32, "chips": torch.int64,
    }
    lane_sizes = dict.fromkeys(lane_dtypes, n_lanes)
    lane_sizes.update(lane_lo=s + 1, flags=s)
    _check_columns(kernel, lanes, lane_dtypes, lane_sizes, device)
    if zero is not None:
        _check_columns(kernel, zero, {k: PLAN_ROW_DTYPES[k] for k in PlanZero._fields},
                       dict.fromkeys(PlanZero._fields, s), device)
    for name, t in out.items():
        if name not in PLAN_ROW_DTYPES:
            raise ValueError(f"{kernel}: unknown output {name!r}")
        if t.dtype != PLAN_ROW_DTYPES[name] or t.shape != (rows, s) or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{kernel}: output {name} must be a contiguous "
                             f"{PLAN_ROW_DTYPES[name]}[{rows}, {s}] tensor on {device}")
    if (buckets is None) != (demand is None):
        raise ValueError(f"{kernel}: buckets and demand go together")
    if buckets is not None:
        ranks = buckets.pid.shape[0]
        _check_columns(kernel, buckets, dict.fromkeys(("pid", "q1", "q2"), torch.int32),
                       dict.fromkeys(("pid", "q1", "q2"), ranks), device)
        if demand.dtype != torch.int64 or demand.shape != (rows, buckets.n) \
                or not demand.is_contiguous() or demand.device != device:
            raise ValueError(f"{kernel}: demand must be a contiguous int64[{rows}, "
                             f"{buckets.n}] tensor on {device}")
    if need_zero is None:
        need_zero = torch.empty(1, dtype=torch.int32, device=device)
    elif need_zero.dtype != torch.int32 or need_zero.shape != (1,) or need_zero.device != device:
        raise ValueError(f"{kernel}: need_zero must be an int32[1] tensor on {device}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _load()
    _set_device(lib, device, kernel)
    rc = lib.inferno_plan_rows_launch(
        rates.data_ptr(), rows, s, *(ptr(t) for t in lanes), float(penalty),
        *((ptr(t) for t in zero) if zero is not None else (None,) * 5),
        *((ptr(buckets.pid), ptr(buckets.q1), ptr(buckets.q2), buckets.n_pools, buckets.n)
          if buckets is not None else (None, None, None, 0, 0)),
        *(ptr(out.get(name)) for name in PLAN_ROW_DTYPES), ptr(demand), need_zero.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, rc, f"{kernel} launch failed (rows={rows}, S={s}, lanes={n_lanes})")
    PLAN_ROWS_LAUNCHES += 1
    _prof.count("plan_rows_kernel_launches")
