"""The native (C++) queueing solver, loaded through ctypes.

Port of `inferno_tpu/native/__init__.py`. `queueing.cc` beside this file
is the reference's source verbatim (apart from a header comment naming
it), and the library keeps the reference's plain C ABI, its
content-hashed name and its atomic temp-then-rename build with the same
`g++ -O3 -std=c++17 -shared -fPIC -pthread`, so the port's solver and the
reference's agree bit for bit. It is the fleet solve of backend "native"
(`parallel.calculate_fleet`, the Reconciler's `COMPUTE_BACKEND=native`,
the planner's `--backend native`): a CPU solve in f64, for controllers
without a card. It needs g++ and no CUDA device.

Changes against the reference:

* the library is built beside its source, in this package's directory,
  as the reference builds it, so a checkout and an installed copy build
  the same way; a directory that cannot be written raises, naming it;
* a build or load that fails raises, with g++'s message, from every
  solver call (the reference reports the library unavailable and its
  callers fall back to the scalar analyzer; the port never falls back:
  backend "native" is used only when it is named). `available()` stays
  as a probe.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import uuid
from typing import NamedTuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "queueing.cc")
BUILD_DIR = _DIR  # beside queueing.cc, in the checkout or the installed copy
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

DEFAULT_BISECT_ITERS = 64  # double precision; deeper than the f32 GPU kernel


def _lib_path() -> str:
    """Content-addressed artifact path: the library name embeds the source
    hash, so a changed queueing.cc can never be satisfied by a stale
    prebuilt .so — and a rebuild loads from a fresh path (dlopen caches
    handles by pathname, so reloading the SAME path after a rebuild would
    silently return the old library)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libinferno_queueing-{digest}.so")


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_error: str | None = None

_D = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def ensure_build_dir(path: str, what: str) -> None:
    """Create `path` if needed; raise, naming it, if it cannot be written
    (the build never moves elsewhere without a word). The kernel library
    of `ops.cuda_queueing` builds through it too."""
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot build {what}: {path} cannot be created ({e})") from e
    if not os.access(path, os.W_OK):
        raise RuntimeError(f"cannot build {what}: {path} is not writable")


def _build(lib_path: str) -> None:
    # Compile to a call-private temp name and os.rename() into the hashed
    # path (atomic on POSIX): two processes building concurrently must
    # never CDLL a half-written .so, and a loser's rename simply
    # overwrites with identical content. The name must be unique per
    # call, not per process — threads share a pid.
    ensure_build_dir(BUILD_DIR, "the native library")
    tmp_path = f"{lib_path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp_path, _SRC, "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.rename(tmp_path, lib_path)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"g++ failed (exit {e.returncode}): {' '.join(cmd)}\n{e.stderr}"
        ) from e
    finally:
        if os.path.exists(tmp_path):
            try:
                os.remove(tmp_path)
            except OSError:
                pass
    # Only after the current artifact is in place, drop superseded hashed
    # artifacts (never the one just built) so the build directory does
    # not accumulate dead libraries.
    for old in glob.glob(os.path.join(BUILD_DIR, "libinferno_queueing-*.so")):
        if old != lib_path:
            try:
                os.remove(old)
            except OSError:
                pass


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.inferno_fleet_size
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int32,  # n_lanes
        _D, _D, _D, _D,  # alpha beta gamma delta
        _D, _D,  # in_tokens out_tokens
        _I, _I,  # max_batch occupancy_cap
        _D, _D, _D,  # targets ttft itl tps
        _D, _I, _D,  # total_rate min_replicas cost_per_replica
        ctypes.c_int32,  # n_iters
        ctypes.c_double,  # ttft_tail_margin
        ctypes.c_int32,  # n_threads
        _U8, _D, _D, _I, _D, _D, _D, _D,  # outputs
    ]
    tfn = lib.inferno_tandem_size
    tfn.restype = ctypes.c_int
    tfn.argtypes = [
        ctypes.c_int32,  # n_lanes
        _D, _D, _D, _D,  # alpha beta gamma delta
        _D, _D,  # in_tokens out_tokens
        _I, _I, _I, _I,  # prefill/decode batch, prefill/decode cap
        _D, _D,  # prefill_slices decode_slices
        _D, _D, _D,  # targets ttft itl tps
        _D, _I, _D,  # total_rate min_replicas cost_per_replica
        ctypes.c_int32,  # n_iters
        ctypes.c_double,  # ttft_tail_margin
        ctypes.c_int32,  # n_threads
        _U8, _D, _D, _I, _D, _D, _D, _D,  # outputs
    ]
    rfn = lib.inferno_fleet_refold
    rfn.restype = ctypes.c_int
    rfn.argtypes = [
        ctypes.c_int32,  # n_lanes
        _D, _D, _D, _D,  # alpha beta gamma delta
        _D, _D,  # in_tokens out_tokens
        _I, _I,  # max_batch occupancy_cap
        _D, _D, _D,  # targets ttft itl tps
        _D, _I, _D,  # total_rate min_replicas cost_per_replica
        _D, _D, _U8,  # cached lambda_star rate_star feasible
        ctypes.c_int32,  # n_threads
        _U8, _D, _D, _I, _D, _D, _D, _D,  # outputs
    ]
    trfn = lib.inferno_tandem_refold
    trfn.restype = ctypes.c_int
    trfn.argtypes = [
        ctypes.c_int32,  # n_lanes
        _D, _D, _D, _D,  # alpha beta gamma delta
        _D, _D,  # in_tokens out_tokens
        _I, _I, _I, _I,  # prefill/decode batch, prefill/decode cap
        _D, _D,  # prefill_slices decode_slices
        _D, _D, _D,  # targets ttft itl tps
        _D, _I, _D,  # total_rate min_replicas cost_per_replica
        _D, _D, _U8,  # cached lambda_star rate_star feasible
        ctypes.c_int32,  # n_threads
        _U8, _D, _D, _I, _D, _D, _D, _D,  # outputs
    ]


def _try_load() -> ctypes.CDLL | None:
    """Build (once) and load the library; on failure remember why."""
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            lib_path = _lib_path()
            if not os.path.exists(lib_path):
                _build(lib_path)
            lib = ctypes.CDLL(lib_path)
            _bind(lib)
            _lib = lib
        except (OSError, RuntimeError, AttributeError) as e:
            # AttributeError: a stale build missing a newer symbol
            _load_error = str(e)
    return _lib


def _load() -> ctypes.CDLL:
    """The loaded library; raises when it cannot be built or loaded."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


def available() -> bool:
    """Whether the native library can be (built and) loaded."""
    return _try_load() is not None


def load_error() -> str | None:
    """Why the library could not be built or loaded (None if it was, or
    has not been tried)."""
    return _load_error


class NativeFleetResult(NamedTuple):
    """Mirrors ops.queueing.FleetResult (numpy, float64)."""

    feasible: np.ndarray
    lambda_star: np.ndarray
    rate_star: np.ndarray
    num_replicas: np.ndarray
    cost: np.ndarray
    itl: np.ndarray
    ttft: np.ndarray
    rho: np.ndarray


def _d(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.float64)


def _i(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _zero_result(n: int) -> NativeFleetResult:
    return NativeFleetResult(
        feasible=np.zeros(n, np.uint8),
        lambda_star=np.zeros(n, np.float64),
        rate_star=np.zeros(n, np.float64),
        num_replicas=np.zeros(n, np.int32),
        cost=np.zeros(n, np.float64),
        itl=np.zeros(n, np.float64),
        ttft=np.zeros(n, np.float64),
        rho=np.zeros(n, np.float64),
    )


def _run_sizer(symbol: str, inputs: tuple, n: int, n_iters: int,
               ttft_tail_margin: float | None, n_threads: int) -> NativeFleetResult:
    """Shared marshalling for the C sizers: zero-init the 8 result arrays,
    invoke `symbol` as (n, *inputs, n_iters, margin, n_threads, *outputs),
    check rc, and re-type feasibility."""
    if ttft_tail_margin is None:
        from inferno_tpu_torch.config.defaults import SLO_MARGIN

        ttft_tail_margin = SLO_MARGIN
    lib = _load()
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    out = _zero_result(n)
    rc = getattr(lib, symbol)(
        n, *inputs, n_iters, ttft_tail_margin, n_threads,
        out.feasible, out.lambda_star, out.rate_star, out.num_replicas,
        out.cost, out.itl, out.ttft, out.rho,
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} failed with code {rc}")
    return out._replace(feasible=out.feasible.astype(bool))


def _run_refold(symbol: str, inputs: tuple, n: int, lambda_star, rate_star,
                feasible, n_threads: int) -> NativeFleetResult:
    """Shared marshalling for the C refold kernels: like _run_sizer but
    the cached bisection outputs go IN and there is no bisection depth or
    tail margin to pass (the refold never bisects)."""
    lib = _load()
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    out = _zero_result(n)
    lam_in = _d(lambda_star)
    rate_in = _d(rate_star)
    feas_in = np.ascontiguousarray(np.asarray(feasible), dtype=np.uint8)
    rc = getattr(lib, symbol)(
        n, *inputs, lam_in, rate_in, feas_in, n_threads,
        out.feasible, out.lambda_star, out.rate_star, out.num_replicas,
        out.cost, out.itl, out.ttft, out.rho,
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} failed with code {rc}")
    return out._replace(feasible=out.feasible.astype(bool))


def _fleet_inputs(params) -> tuple:
    return (
        _d(params.alpha), _d(params.beta), _d(params.gamma), _d(params.delta),
        _d(params.in_tokens), _d(params.out_tokens),
        _i(params.max_batch), _i(params.occupancy_cap),
        _d(params.target_ttft), _d(params.target_itl), _d(params.target_tps),
        _d(params.total_rate), _i(params.min_replicas),
        _d(params.cost_per_replica),
    )


def _tandem_inputs(params) -> tuple:
    return (
        _d(params.alpha), _d(params.beta), _d(params.gamma), _d(params.delta),
        _d(params.in_tokens), _d(params.out_tokens),
        _i(params.prefill_batch), _i(params.decode_batch),
        _i(params.prefill_cap), _i(params.decode_cap),
        _d(params.prefill_slices), _d(params.decode_slices),
        _d(params.target_ttft), _d(params.target_itl), _d(params.target_tps),
        _d(params.total_rate), _i(params.min_replicas),
        _d(params.cost_per_replica),
    )


def fleet_refold_native(
    params, lambda_star, rate_star, feasible, n_threads: int = 0,
) -> NativeFleetResult:
    """λ-only refold of a FleetParams batch with the C++ solver: the
    cached rate-independent bisection outputs (lambda_star / rate_star /
    feasible, from any previous full solve) pass through; only the
    offered-load fold and the per-replica operating point recompute.
    Semantics match ops.queueing.fleet_refold — the decision surface
    (num_replicas, cost) is folded in f32 — and itl/ttft/rho come from
    the f64 stationary solve."""
    inputs = _fleet_inputs(params)
    return _run_refold(
        "inferno_fleet_refold", inputs, inputs[0].shape[0],
        lambda_star, rate_star, feasible, n_threads,
    )


def tandem_refold_native(
    params, lambda_star, rate_star, feasible, n_threads: int = 0,
) -> NativeFleetResult:
    """λ-only refold of a TandemParams batch with the C++ solver: the
    disaggregated analogue of fleet_refold_native (semantics of
    ops.queueing.tandem_refold, same f32 decision-surface contract)."""
    inputs = _tandem_inputs(params)
    return _run_refold(
        "inferno_tandem_refold", inputs, inputs[0].shape[0],
        lambda_star, rate_star, feasible, n_threads,
    )


def fleet_size_native(
    params, n_iters: int = DEFAULT_BISECT_ITERS, n_threads: int = 0,
    ttft_tail_margin: float | None = None,
) -> NativeFleetResult:
    """Size every lane of a FleetParams batch with the C++ solver.

    `params` is any structure with the FleetParams fields (numpy arrays or
    CPU tensors). Semantics match ops.queueing.fleet_size, including the
    percentile TTFT interpretation (default SLO_MARGIN); precision is f64.
    """
    inputs = _fleet_inputs(params)
    return _run_sizer(
        "inferno_fleet_size", inputs, inputs[0].shape[0],
        n_iters, ttft_tail_margin, n_threads,
    )


def tandem_size_native(
    params, n_iters: int = DEFAULT_BISECT_ITERS, n_threads: int = 0,
    ttft_tail_margin: float | None = None,
) -> NativeFleetResult:
    """Size every disaggregated lane of a TandemParams batch with the C++
    solver. Semantics match ops.queueing.tandem_fleet_size (the batched
    equivalent of analyzer.disagg); precision is f64."""
    inputs = _tandem_inputs(params)
    return _run_sizer(
        "inferno_tandem_size", inputs, inputs[0].shape[0],
        n_iters, ttft_tail_margin, n_threads,
    )


__all__ = [
    "DEFAULT_BISECT_ITERS",
    "NativeFleetResult",
    "available",
    "fleet_refold_native",
    "fleet_size_native",
    "load_error",
    "tandem_refold_native",
    "tandem_size_native",
]
