"""Lightweight monotonic-clock span tracing for decision observability.

The autoscaler's product is a decision, and the premise of its tracing is that
every reconcile cycle must be explainable after the fact: which phase
ran, how long it took, and what per-variant facts the sizing saw. This
module is the substrate — a context-manager span tracer in the spirit of
OpenTelemetry's API surface but with zero dependencies and zero
exporters: spans are plain dataclasses, durations come from
`time.perf_counter()` (monotonic — wall-clock steps from NTP must never
produce negative phase durations), and a bounded ring buffer retains the
last K cycle traces for the `/debug/decisions` route.

Threading model: a `Tracer` is single-threaded by design (spans nest via
a plain stack, exactly matching the reconciler's sequential phases); the
`TraceBuffer` is the only cross-thread surface (reconcile thread appends,
HTTP handler threads snapshot) and locks accordingly.

Port copy of `inferno_tpu/obs/trace.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Iterator


@dataclasses.dataclass
class Span:
    """One timed operation. `start_ms` is the offset from the trace root's
    start on the monotonic clock, so sibling spans order correctly even
    across wall-clock adjustments."""

    name: str
    start_ms: float = 0.0
    duration_ms: float = 0.0
    # process CPU milliseconds consumed while the span was open (all
    # threads — a collect phase with pool workers can exceed its wall
    # time, which is itself a finding). None unless the owning Tracer
    # was created with cpu=True (the cycle profiler's mode);
    # the default trace stays byte-identical to the pre-profiler format.
    cpu_ms: float | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    children: list["Span"] = dataclasses.field(default_factory=list)

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes mid-span (e.g. counts known only at the end)."""
        self.attrs.update(attrs)
        return self

    def walk(self) -> Iterator["Span"]:
        """Depth-first over this span and all descendants."""
        yield self
        for child in self.children:
            yield from child.walk()

    def find(self, name: str) -> "Span | None":
        """First span named `name` in depth-first order (test/summary aid)."""
        return next((s for s in self.walk() if s.name == name), None)

    def to_dict(self) -> dict[str, Any]:
        """JSON-ready tree. Durations are rounded to microseconds — the
        exported artifact is for operators, not for re-deriving timings."""
        out: dict[str, Any] = {
            "name": self.name,
            "start_ms": round(self.start_ms, 3),
            "duration_ms": round(self.duration_ms, 3),
        }
        if self.cpu_ms is not None:
            out["cpu_ms"] = round(self.cpu_ms, 3)
        if self.attrs:
            out["attrs"] = self.attrs
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class Tracer:
    """Per-cycle trace builder with a context-manager span API:

        tracer = Tracer("reconcile-cycle")
        with tracer.span("collect", namespace="ns") as sp:
            ...
            sp.set(variants=3)
        root = tracer.finish()

    Spans opened while another span is active nest under it. `finish()`
    stamps the root duration and is idempotent, so every exit path of a
    traced operation can call it safely.
    """

    def __init__(self, name: str = "trace", cpu: bool = False):
        self.started_at = time.time()  # wall clock, operator display only
        self._t0 = time.perf_counter()
        # cpu=True (the cycle profiler's mode) additionally stamps each
        # span's process-CPU milliseconds; off by default so plain traces
        # pay nothing and serialize exactly as before
        self._cpu = cpu
        self._c0 = time.process_time() if cpu else 0.0
        self.root = Span(name=name)
        self._stack: list[Span] = [self.root]
        self._finished = False

    def _now_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        sp = Span(name=name, start_ms=self._now_ms(), attrs=dict(attrs))
        # CPU time only for TOP-LEVEL phases: they are what the profile
        # document attributes (obs/profiler.py reads root children), and
        # per-variant child spans — hundreds per cycle on a large fleet —
        # must not each pay two process-clock reads for a value nothing
        # consumes
        track_cpu = self._cpu and len(self._stack) == 1
        c0 = time.process_time() if track_cpu else 0.0
        self._stack[-1].children.append(sp)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            sp.duration_ms = self._now_ms() - sp.start_ms
            if track_cpu:
                sp.cpu_ms = (time.process_time() - c0) * 1000.0
            self._stack.pop()

    def finish(self) -> Span:
        if not self._finished:
            self.root.duration_ms = self._now_ms()
            if self._cpu:
                self.root.cpu_ms = (time.process_time() - self._c0) * 1000.0
            self._finished = True
        return self.root


class TraceBuffer:
    """Bounded ring of recent cycle-trace documents (plain dicts, already
    JSON-ready). Appends evict the oldest entry beyond `capacity`; every
    document is stamped with a monotonically increasing `seq` so a reader
    polling `/debug/decisions` can detect cycles it missed."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._items: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def append(self, doc: dict[str, Any]) -> int:
        # the stamp is written AFTER the document spread: a doc that
        # already carries a "seq" key (e.g. a recorded cycle replayed
        # back through a buffer) must not override the monotonic stamp —
        # readers detect missed cycles by seq gaps, and a stale embedded
        # seq would fake gaps or reversals under concurrent polling
        with self._lock:
            self._seq += 1
            self._items.append({**doc, "seq": self._seq})
            return self._seq

    def snapshot(self) -> list[dict[str, Any]]:
        """Oldest-first copy of the retained traces. Documents are
        append-once (the buffer never mutates them after `append`
        returns), so the locked list copy is a consistent view even
        while another thread keeps appending."""
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
