"""Scale-down stabilization: the peak-over-window gate.

Mirrors HPA v2's `behavior.scaleDown.stabilizationWindowSeconds`
semantics exactly as `inferno_tpu/testing/hpa.py::HpaEmulator._recommend`
models them: every cycle's RAW replica recommendation is recorded, and
the enacted recommendation is the MAX seen within the trailing window —
upscales pass through immediately, downscales wait until every higher
recommendation has aged out. A noisy rate therefore cannot flap the
replica count down-and-up (each down-up pair re-pays the replica
spin-up latency as an SLO breach), while a genuine load drop scales
down after one window.

The window a blind controller needs is long (HPA defaults to 300 s)
because the only evidence that a dip is real is its duration. A
forecast-assisted controller can run a much shorter window — the risk
stabilization bounds is "scale in, then need the capacity again before
a replacement replica can spin up", so a window of a few spin-up
latencies suffices (docs/forecasting.md#stabilization).

Port copy of `inferno_tpu/forecast/stabilizer.py`, verbatim apart from its imports.
"""

from __future__ import annotations


class ScaleDownStabilizer:
    """Per-variant peak-over-window gate on replica recommendations."""

    def __init__(self, window_s: float):
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        self.window_s = window_s
        # key -> [(timestamp, raw recommendation), ...] trailing window
        self._recs: dict[str, list[tuple[float, int]]] = {}

    def recommend(self, key: str, raw: int, now: float) -> tuple[int, bool]:
        """Record `raw` and return (enacted, held): the peak raw
        recommendation within the window, and whether the gate HELD the
        count above `raw` (the `stabilization_hold` decision reason).
        A zero window degrades to a pass-through."""
        history = self._recs.setdefault(key, [])
        history.append((now, raw))
        cutoff = now - self.window_s
        # in-place trim: entries are appended in time order
        self._recs[key] = history = [(t, r) for t, r in history if t >= cutoff]
        peak = max(r for _, r in history)
        return peak, peak > raw

    def prune(self, active: set[str]) -> None:
        """Drop window state for variants no longer reconciled. Keys may
        carry an "@<qualifier>" suffix (the reconciler keys windows by
        "<variant>@<slice shape>" so shape migrations start a fresh
        window); membership is tested on the prefix, same convention as
        `models/corrector.py::prune`."""
        for key in [k for k in self._recs if k.split("@", 1)[0] not in active]:
            del self._recs[key]

    def variants(self) -> set[str]:
        return set(self._recs)
