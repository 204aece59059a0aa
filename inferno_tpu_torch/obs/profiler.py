"""Hierarchical cycle profiler: attribute every millisecond of a cycle.

The profiler extends the tracer's premise: the Tracer (obs/trace.py) says
*which phase* of a reconcile cycle ran and for how long, but not *why* —
jit compile vs execute, snapshot re-derivation vs memo replay, cache
hits vs fresh solves, heap fallbacks vs bulk ledger paths. This module
adds the missing dimension as **typed counters** aggregated per cycle
into a self-describing profile document, without threading a parameter
through every layer: instrumentation sites call the module-level hooks
(`count`/`add_ms`), which are ~two dict ops when a profiler is active
on the calling thread and a single thread-local read when not.

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
plan packing, the jitted solve, the capacity ledgers) runs on the
reconcile thread during the solve phase. The profile *buffer* is the
cross-thread surface and reuses `obs.trace.TraceBuffer` (reconcile
thread appends, `/debug/profile` handler threads snapshot).

Memory high-water: `tracemalloc` sees numpy data allocations (numpy
routes them through ``PyTraceMalloc_Track``), so the per-cycle traced
peak is the closest stdlib proxy for "how much array memory did this
solve actually touch". Tracing costs real CPU, so it is OFF by default
and gated behind ``PROFILE_TRACEMALLOC`` — the <= 1% overhead contract
is measured with the default configuration.

Port copy of `inferno_tpu/obs/profiler.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import threading
import tracemalloc
from typing import Any

from inferno_tpu_torch.obs.trace import Span

PROFILE_SCHEMA = "inferno.profile/v1"

_tls = threading.local()


def current() -> "CycleProfiler | None":
    """The profiler active on THIS thread, or None."""
    return getattr(_tls, "profiler", None)


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
    """

    def __init__(self, sample_malloc: bool = False):
        self.counters: dict[str, Any] = {}
        self.sample_malloc = sample_malloc
        self._owner: int | None = None

    def activate(self) -> "CycleProfiler":
        _tls.profiler = self
        self._owner = threading.get_ident()
        if self.sample_malloc:
            if not tracemalloc.is_tracing():
                tracemalloc.start()
            tracemalloc.reset_peak()
        return self

    def deactivate(self) -> None:
        if getattr(_tls, "profiler", None) is self:
            _tls.profiler = None
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
