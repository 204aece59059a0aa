"""SLO-attainment / model-error scoreboard.

WVA's premise (PAPER.md §modeling) is that the analytic queueing model —
``ITL = α + β·batch``, M/M/1/K with state-dependent rates — can stand in
for reality. This module measures how far it actually drifts: per
variant, an EWMA of the absolute error between the latency the model
*predicted* for the decided size and the latency telemetry *observed*
one cycle later, an SLO-attainment ratio (EWMA of the "observed within
SLO" indicator), and an error-budget burn rate in the SRE sense
(burn = unattained fraction / allowed unattained fraction; > 1 means the
variant is spending its error budget faster than the objective allows).

Scoring convention: the prediction made at cycle *t* (for the size the
cycle decided) is scored against the observation collected at cycle
*t + 1* — the first telemetry window that reflects the decided
operating point. `AttainmentTracker.observe` therefore both *scores*
the pending prediction against the new observation and *stores* the new
prediction for the next cycle.

Stdlib-only by design, like the rest of `inferno_tpu/obs/` — the
reconciler, the emulator experiment driver, and the offline report tool
all share it without import cycles. Thread model: one writer (the
reconcile thread via `observe`/`prune`), many readers (`snapshot` for
the `/debug/attainment` route) — locked accordingly.

Port copy of `inferno_tpu/obs/attainment.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any


def relative_error(predicted: float, observed: float) -> float | None:
    """|observed − predicted| / predicted, or None when either side is
    missing/non-positive (the shared guard of the emulator experiment
    driver's model-check and this scoreboard)."""
    if predicted is None or observed is None:
        return None
    if predicted <= 0.0 or observed <= 0.0:
        return None
    return abs(observed - predicted) / predicted


@dataclasses.dataclass
class AttainmentConfig:
    # EWMA gain for both the |model error| and the attainment indicator
    # (env ATTAINMENT_EWMA_GAIN): 0.2 weighs ~the last 5 cycles
    ewma_gain: float = 0.2
    # attainment objective the error budget is defined against: burn =
    # (1 − attainment) / (1 − slo_objective)
    slo_objective: float = 0.99

    def __post_init__(self) -> None:
        if not (0.0 < self.ewma_gain <= 1.0):
            raise ValueError(f"ewma_gain must be in (0, 1], got {self.ewma_gain}")
        if not (0.0 <= self.slo_objective < 1.0):
            raise ValueError(
                f"slo_objective must be in [0, 1), got {self.slo_objective}"
            )


@dataclasses.dataclass
class AttainmentScore:
    """One variant's scoreboard state after an `observe` call."""

    # this cycle's signed error (observed − pending prediction); None
    # when no scorable pair existed (first cycle, missing telemetry)
    ttft_error_ms: float | None = None
    itl_error_ms: float | None = None
    # EWMA of |error|; 0.0 until the first scorable pair. The *_scored
    # flags say whether that dimension EVER scored — a 0.0 EWMA with
    # scored False means "no data", not "perfect model" (gauges for the
    # dimension must stay un-emitted)
    ttft_error_ewma_ms: float = 0.0
    itl_error_ewma_ms: float = 0.0
    ttft_error_scored: bool = False
    itl_error_scored: bool = False
    # EWMA of the "observed ≤ SLO" indicator; None when the dimension is
    # unconstrained (SLO 0) or never observed
    ttft_attainment: float | None = None
    itl_attainment: float | None = None
    burn_rate: float = 0.0
    scored_cycles: int = 0  # cycles with at least one scorable error pair


class _VariantState:
    __slots__ = (
        "pending_ttft", "pending_itl",
        "ewma_ttft", "ewma_itl",
        "attain_ttft", "attain_itl",
        "scored",
    )

    def __init__(self) -> None:
        self.pending_ttft: float | None = None  # last cycle's prediction
        self.pending_itl: float | None = None
        self.ewma_ttft: float | None = None
        self.ewma_itl: float | None = None
        self.attain_ttft: float | None = None
        self.attain_itl: float | None = None
        self.scored = 0


class AttainmentTracker:
    def __init__(self, config: AttainmentConfig | None = None):
        self.config = config or AttainmentConfig()
        self._variants: dict[str, _VariantState] = {}
        self._lock = threading.Lock()

    def _ewma(self, prev: float | None, value: float) -> float:
        g = self.config.ewma_gain
        return value if prev is None else g * value + (1.0 - g) * prev

    def observe(
        self,
        variant: str,
        *,
        predicted_ttft_ms: float = 0.0,
        predicted_itl_ms: float = 0.0,
        observed_ttft_ms: float = 0.0,
        observed_itl_ms: float = 0.0,
        slo_ttft_ms: float = 0.0,
        slo_itl_ms: float = 0.0,
    ) -> AttainmentScore:
        """Score the pending (previous-cycle) prediction against this
        cycle's observation, fold attainment, then store this cycle's
        prediction as pending. Non-positive values mean "missing" on
        every input (a skipped/asleep variant must not corrupt the
        running state with zeros)."""
        with self._lock:
            st = self._variants.setdefault(variant, _VariantState())
            score = AttainmentScore()
            scored = False
            if st.pending_ttft is not None and observed_ttft_ms > 0.0:
                score.ttft_error_ms = observed_ttft_ms - st.pending_ttft
                st.ewma_ttft = self._ewma(st.ewma_ttft, abs(score.ttft_error_ms))
                scored = True
            if st.pending_itl is not None and observed_itl_ms > 0.0:
                score.itl_error_ms = observed_itl_ms - st.pending_itl
                st.ewma_itl = self._ewma(st.ewma_itl, abs(score.itl_error_ms))
                scored = True
            if scored:
                st.scored += 1
            if slo_ttft_ms > 0.0 and observed_ttft_ms > 0.0:
                st.attain_ttft = self._ewma(
                    st.attain_ttft, 1.0 if observed_ttft_ms <= slo_ttft_ms else 0.0
                )
            if slo_itl_ms > 0.0 and observed_itl_ms > 0.0:
                st.attain_itl = self._ewma(
                    st.attain_itl, 1.0 if observed_itl_ms <= slo_itl_ms else 0.0
                )
            # a fresh prediction replaces the pending one; a cycle with
            # no prediction (error path) clears it — next cycle's
            # telemetry would not reflect a decided operating point
            st.pending_ttft = predicted_ttft_ms if predicted_ttft_ms > 0.0 else None
            st.pending_itl = predicted_itl_ms if predicted_itl_ms > 0.0 else None
            self._fill(score, st)
            return score

    def _fill(self, score: AttainmentScore, st: _VariantState) -> None:
        score.ttft_error_ewma_ms = st.ewma_ttft or 0.0
        score.itl_error_ewma_ms = st.ewma_itl or 0.0
        score.ttft_error_scored = st.ewma_ttft is not None
        score.itl_error_scored = st.ewma_itl is not None
        score.ttft_attainment = st.attain_ttft
        score.itl_attainment = st.attain_itl
        score.scored_cycles = st.scored
        attained = [a for a in (st.attain_ttft, st.attain_itl) if a is not None]
        if attained:
            budget = max(1.0 - self.config.slo_objective, 1e-9)
            score.burn_rate = (1.0 - min(attained)) / budget

    def score_of(self, variant: str) -> AttainmentScore | None:
        """Current scoreboard state without observing (readers)."""
        with self._lock:
            st = self._variants.get(variant)
            if st is None:
                return None
            score = AttainmentScore()
            self._fill(score, st)
            return score

    def prune(self, active: set[str]) -> None:
        """Drop state of variants no longer managed (same contract as
        the metric emitters' prune_variants)."""
        with self._lock:
            for name in [n for n in self._variants if n not in active]:
                del self._variants[name]

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready scoreboard for the `/debug/attainment` route."""
        with self._lock:
            variants = {}
            for name, st in sorted(self._variants.items()):
                score = AttainmentScore()
                self._fill(score, st)
                variants[name] = {
                    "ttft_error_ewma_ms": round(score.ttft_error_ewma_ms, 4),
                    "itl_error_ewma_ms": round(score.itl_error_ewma_ms, 4),
                    "ttft_attainment": (
                        None if score.ttft_attainment is None
                        else round(score.ttft_attainment, 6)
                    ),
                    "itl_attainment": (
                        None if score.itl_attainment is None
                        else round(score.itl_attainment, 6)
                    ),
                    "error_budget_burn": round(score.burn_rate, 4),
                    "scored_cycles": score.scored_cycles,
                }
            return {
                "ewma_gain": self.config.ewma_gain,
                "slo_objective": self.config.slo_objective,
                "variants": variants,
            }
