"""Hierarchical cycle profiler: attribute every millisecond of a cycle.

The profiler extends the tracer's premise: the Tracer (obs/trace.py) says
*which phase* of a reconcile cycle ran and for how long, but not *why* —
the solve's dispatch, snapshot re-derivation vs memo replay, cache
hits vs fresh solves, heap fallbacks vs bulk ledger paths. This module
adds the missing dimension as **typed counters** aggregated per cycle
into a self-describing profile document, without threading a parameter
through every layer: instrumentation sites call the module-level hooks
(`count`/`add_ms`/`span`), which are ~two dict ops when a profiler is
active on the calling thread and a single thread-local read when not.

Counter typing is carried by the name, so the document needs no side
schema:

* ``*_ms``  — accumulated wall milliseconds (float)
* ``*_kb``  — a per-cycle high-water mark in kilobytes (float)
* anything else — an event count (int)

The profiler is **observation-only by contract**: activating it must
never change a decision. Sites read clocks and bump counters; nothing
downstream consults the profiler. tests/test_profiler.py pins
bit-identical decisions with the profiler on vs off, and `make
bench-profile` pins the overhead at <= 1% of the reference cycle.

Threading model mirrors the Tracer's: a `CycleProfiler` is bound to ONE
thread (the reconcile thread) via `activate()`; collect-pool workers do
not see it, which is correct — every instrumented site (snapshot update,
plan packing, the gathered solve, the capacity ledgers) runs on the
reconcile thread during the solve phase. The profile *buffer* is the
cross-thread surface and reuses `obs.trace.TraceBuffer` (reconcile
thread appends, `/debug/profile` handler threads snapshot).

Memory high-water: `tracemalloc` sees numpy data allocations (numpy
routes them through ``PyTraceMalloc_Track``), so the per-cycle traced
peak is the closest stdlib proxy for "how much array memory did this
solve actually touch". Tracing costs real CPU, so it is OFF by default
and gated behind ``PROFILE_TRACEMALLOC`` — the <= 1% overhead contract
is measured with the default configuration.

Spans (`span(name)`, the port's own): a layer's wall time is taken by
one context manager, not by hand at each site. While a profiler is
active on the thread the span adds its milliseconds to ``<name>_ms``, on
the profiler's clock; while `torch.profiler` records, it also opens the
range ``inferno.<name>``, so the program's layers sit in the device
trace on the trace's own clock, nested as they run. A span opened with
``own=True`` also adds its own time, less that of the spans that closed
inside it, to ``<name>_self_ms``. The range is a
function-scope record (`_RecordFunctionFast`), not a user-scope
`record_function`: CUPTI copies a user-scope range onto the device's
timeline around the kernels it launched, and a reader of the trace
would count that copy as device work. With neither active, `span`
returns one shared no-op context. Names the port times this way:
``calculate_fleet``, ``snapshot_update``, ``plan_repack``, ``dispatch``,
``incremental_scatter``, ``incremental_writeback``, ``solver_assign``,
``solver_diff``, ``solver_pools``, ``solver_solution``, ``plan_fold``,
``plan_feed``, ``kernel_library_load``, and the reconcile cycle's phases
``reconcile_collect``, ``reconcile_analyze``, ``reconcile_solve``,
``reconcile_actuate`` and ``reconcile_finish`` (the last opens after the
cycle's own profile is sealed, so it charges the profiler active around
the cycle, if any). Counters the reconcile cycle bumps on its own profile:
``status_writes``, ``collect_fallback_variants``, and, inside
``reconcile_collect``, ``service_class_docs_parsed`` and
``service_class_docs_reused`` (the service-classes ConfigMap's keys whose
text was parsed, and those whose unchanged text reused the last parse).

Port of `inferno_tpu/obs/profiler.py`: the reference's hooks and
document, plus `span`, a profiler clock, and profilers that nest: each
thread keeps a stack of the active ones.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import tracemalloc
from typing import Any, Callable

from inferno_tpu_torch.obs.trace import Span

PROFILE_SCHEMA = "inferno.profile/v1"

_tls = threading.local()


def current() -> "CycleProfiler | None":
    """The profiler active on THIS thread, or None."""
    return getattr(_tls, "profiler", None)


def _stack() -> "list[CycleProfiler]":
    """The profilers activated on THIS thread and not yet deactivated,
    oldest first; the last is the active one."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def count(name: str, by: int = 1) -> None:
    """Bump an event counter on the active profiler (no-op when none)."""
    p = getattr(_tls, "profiler", None)
    if p is not None:
        c = p.counters
        c[name] = c.get(name, 0) + by


def add_ms(name: str, ms: float) -> None:
    """Accumulate wall milliseconds on the active profiler (no-op when
    none). `name` must end in ``_ms`` — the suffix IS the type."""
    p = getattr(_tls, "profiler", None)
    if p is not None:
        c = p.counters
        c[name] = c.get(name, 0.0) + ms


_NOOP = contextlib.nullcontext()


def _recording() -> bool:
    """Whether `torch.profiler` records in this process (never when torch
    was not imported: this module imports only the standard library)."""
    autograd_profiler = sys.modules.get("torch.autograd.profiler")
    return autograd_profiler is not None and autograd_profiler._is_profiler_enabled


class _Span:
    """One open span: the profiler it charges (or None), the trace range
    it holds open (or None), and, while it is open on its profiler, the
    milliseconds of the spans that closed inside it."""

    __slots__ = ("_profiler", "_key", "_self_key", "_range", "_t0",
                 "_inner_ms", "_up")

    def __init__(self, profiler: "CycleProfiler | None", name: str,
                 recording: bool, own: bool):
        self._profiler = profiler
        self._key = name + "_ms"
        self._self_key = name + "_self_ms" if own else None
        self._range = (
            sys.modules["torch"]._C._profiler._RecordFunctionFast("inferno." + name)
            if recording else None
        )

    def __enter__(self) -> None:
        if self._range is not None:
            self._range.__enter__()
        p = self._profiler
        if p is not None:
            self._up = p._open
            p._open = self
            self._inner_ms = 0.0
            self._t0 = p.clock()

    def __exit__(self, *exc) -> None:
        p = self._profiler
        if p is not None:
            ms = (p.clock() - self._t0) * 1000.0
            up = p._open = self._up
            if up is not None:
                up._inner_ms += ms
            c = p.counters
            c[self._key] = c.get(self._key, 0.0) + ms
            if self._self_key is not None:
                own_ms = ms - self._inner_ms
                c[self._self_key] = c.get(self._self_key, 0.0) + own_ms
        if self._range is not None:
            self._range.__exit__(*exc)


def span(name: str, own: bool = False):
    """Context manager timing one layer: ``<name>_ms`` on the active
    profiler (with `own`, also ``<name>_self_ms``: its time less that of
    the spans that closed inside it), the range ``inferno.<name>`` while
    `torch.profiler` records, and a shared no-op with neither.
    Observation only."""
    p = getattr(_tls, "profiler", None)
    recording = _recording()
    if p is None and not recording:
        return _NOOP
    return _Span(p, name, recording, own)


class CycleProfiler:
    """Per-cycle counter aggregator. Lifecycle::

        prof = CycleProfiler()
        prof.activate()          # bind to this thread
        ...                      # instrumented sites bump counters
        prof.deactivate()        # unbind + seal malloc sampling
        doc = build_profile_doc(root_span, prof, ...)

    `sample_malloc=True` additionally samples the tracemalloc traced-peak
    over the activation window into ``mem_py_peak_kb`` (starting
    tracemalloc if nothing else did, and leaving it running — stopping a
    tracer someone else started would corrupt *their* measurement).

    `clock` (seconds, monotonic) is what `span` reads. Profilers nest:
    each thread keeps a stack of the profilers activated on it, and
    `deactivate` takes this one out of it, wherever it stands, leaving
    the newest still active one on the thread. A cycle profiled inside a
    profiled window leaves the window's profiler active after it, and a
    profiler deactivated out of order is never put back.
    """

    def __init__(self, sample_malloc: bool = False,
                 clock: Callable[[], float] = time.perf_counter):
        self.counters: dict[str, Any] = {}
        self.sample_malloc = sample_malloc
        self.clock = clock
        self._owner: int | None = None
        self._open: _Span | None = None  # the innermost open span

    def activate(self) -> "CycleProfiler":
        stack = _stack()
        if self in stack:
            stack.remove(self)
        stack.append(self)
        _tls.profiler = self
        self._owner = threading.get_ident()
        if self.sample_malloc:
            if not tracemalloc.is_tracing():
                tracemalloc.start()
            tracemalloc.reset_peak()
        return self

    def deactivate(self) -> None:
        stack = _stack()
        if self in stack:
            stack.remove(self)
            _tls.profiler = stack[-1] if stack else None
        if self.sample_malloc and tracemalloc.is_tracing():
            _, peak = tracemalloc.get_traced_memory()
            self.counters["mem_py_peak_kb"] = round(peak / 1024.0, 1)

    # context-manager sugar for bench/test drivers
    def __enter__(self) -> "CycleProfiler":
        return self.activate()

    def __exit__(self, *exc) -> None:
        self.deactivate()


def _phase_entry(span: Span) -> dict[str, Any]:
    entry: dict[str, Any] = {"wall_ms": round(span.duration_ms, 3)}
    if span.cpu_ms is not None:
        entry["cpu_ms"] = round(span.cpu_ms, 3)
    return entry


def build_profile_doc(
    root: Span,
    profiler: CycleProfiler | None,
    started_at: str = "",
    interval_seconds: float = 0.0,
) -> dict[str, Any]:
    """Fold a finished cycle trace + the profiler's counters into the
    self-describing per-cycle profile document served at
    ``/debug/profile``, recorded by the flight recorder, and diffed by
    ``python -m inferno_tpu_torch.obs.perfdiff``.

    Phases are the root's DIRECT children (collect/analyze/solve/actuate
    for a reconcile cycle); repeated names merge by summation so a trace
    with two spans of one phase still yields one attribution row.
    """
    phases: dict[str, dict[str, Any]] = {}
    for child in root.children:
        entry = _phase_entry(child)
        prev = phases.get(child.name)
        if prev is None:
            phases[child.name] = entry
        else:
            prev["wall_ms"] = round(prev["wall_ms"] + entry["wall_ms"], 3)
            if "cpu_ms" in entry:
                prev["cpu_ms"] = round(
                    prev.get("cpu_ms", 0.0) + entry["cpu_ms"], 3
                )
    cycle: dict[str, Any] = {"wall_ms": round(root.duration_ms, 3)}
    if root.cpu_ms is not None:
        cycle["cpu_ms"] = round(root.cpu_ms, 3)
    counters = dict(profiler.counters) if profiler is not None else {}
    return {
        "schema": PROFILE_SCHEMA,
        "started_at": started_at,
        "interval_seconds": interval_seconds,
        "cycle": cycle,
        "phases": phases,
        "counters": {
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in sorted(counters.items())
        },
    }
