"""The device trace of a window: busy time, the operations that took it,
and what the host was doing while the card idled.

`torch.profiler` records the card's kernels, copies and sets, and the
benchmark's own named ranges (`bench.<span>`, see `common.Spans`) on the
same clock. Busy time is the union of the device intervals inside the
window's range; an idle gap is charged to the `bench.` range that covers
its middle.
"""

from __future__ import annotations

import bisect

WINDOW = "bench.window"


NAME_CHARS = 160  # a kernel's name is its C++ signature: its head names it


def _raw_events(prof):
    """(name, on the device, start us, end us) of every traced event: the
    profiler's raw records where this torch has them (cheap), else its
    event list."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == DeviceType.CUDA,
                 e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3) for e in raw]
    except AttributeError:
        return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start, e.time_range.end)
                for e in prof.events()]


def _union(intervals):
    merged = []
    for start, end in sorted((s, e) for s, e, _ in intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(prof) -> dict:
    """{"busy_s", "window_s", "device_ops", "idle_gaps"} of the traced
    window (the `bench.window` range)."""
    events = _raw_events(prof)
    # the benchmark's ranges: host records, and their device-side copies
    # (which span the device work a range launched: not an operation)
    ranges = [(s, e, n) for n, dev, s, e in events if n.startswith("bench.") and not dev]
    window = [r for r in ranges if r[2] == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = window[0][0], window[0][1]
    dev = [(max(s, w0), min(e, w1), n) for n, on_dev, s, e in events
           if on_dev and not n.startswith("bench.") and e > w0 and s < w1]
    merged = _union(dev)
    busy_us = sum(e - s for s, e in merged)
    by_op: dict[str, float] = {}
    for s, e, n in dev:
        by_op[n[:NAME_CHARS]] = by_op.get(n[:NAME_CHARS], 0.0) + (e - s)
    # the benchmark's ranges inside the window are siblings: none nests
    # in another, so the one that covers a point starts last before it
    inner = sorted(r for r in ranges if r[2] != WINDOW)
    starts = [r[0] for r in inner]
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for start, end in zip(edges[0::2], edges[1::2]):
        if end <= start:
            continue
        mid = 0.5 * (start + end)
        at = bisect.bisect_right(starts, mid) - 1
        name = inner[at][2] if at >= 0 and inner[at][1] >= mid else "outside the benchmark's spans"
        gaps[name] = gaps.get(name, 0.0) + (end - start)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": [[n, us / 1e6] for n, us in top],
        "idle_gaps": [[n, us / 1e6] for n, us in idle],
    }
