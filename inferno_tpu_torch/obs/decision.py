"""Per-variant sizing rationale: the DecisionRecord.

The control-plane framing (PAPERS: WVA; inference-fleet-sim) treats the
per-variant sizing rationale — observed arrival rate, the profile
parameters actually used, the computed sustainable-rate ceiling, SLO
headroom, and cost — as first-class output, not log prose. One
DecisionRecord is produced per variant per reconcile cycle; it rides the
cycle trace (`/debug/decisions`), is emitted as a structured JSON log
event, and answers the operator question "why did replicas jump?".

Units follow the controller's internal conventions: arrival rates are
requests/minute (the collector's `arrival_rate` unit), latencies are
milliseconds, costs are the accelerator catalog's cents/hr.

Port copy of `inferno_tpu/obs/decision.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# Reason codes — why the cycle decided what it decided for this variant.
REASON_SLO_BOUND = "slo_bound"  # replicas sized up by load vs the SLO ceiling
REASON_COST_BOUND = "cost_bound"  # at the replica floor; cost-minimal choice
REASON_CAPACITY_LIMITED = "capacity_limited"  # squeezed out / infeasible
REASON_ASLEEP = "asleep"  # scaled to zero; sized from gateway demand
REASON_ERROR = "error"  # preparation or optimization failed this cycle
# predictive scaling (inferno_tpu/forecast/):
REASON_FORECAST_BOUND = "forecast_bound"  # forecast upper band, not observed λ, set N
REASON_STABILIZATION_HOLD = "stabilization_hold"  # scale-down gated by the window
# spot-market economics (inferno_tpu/spot/): eviction risk — not price —
# capped the variant's spot placement below its full replica count (the
# hazard-implied premium outweighed the discount for SLO-critical replicas)
REASON_SPOT_RISK_BOUND = "spot_risk_bound"

REASON_CODES = (
    REASON_SLO_BOUND,
    REASON_COST_BOUND,
    REASON_CAPACITY_LIMITED,
    REASON_ASLEEP,
    REASON_ERROR,
    REASON_FORECAST_BOUND,
    REASON_STABILIZATION_HOLD,
    REASON_SPOT_RISK_BOUND,
)

# Profile-parameter provenance values
PROVENANCE_CR = "cr"  # CR-carried static profile used as-is
PROVENANCE_CORRECTED = "corrected"  # corrector-calibrated parameters

# Sizing arrival-rate provenance values: which λ the sizing actually ran
# against (forecast provenance for the predictive-scaling path)
RATE_PROVENANCE_OBSERVED = "observed"  # the collector's observed λ
RATE_PROVENANCE_FORECAST = "forecast"  # the forecast upper band exceeded it

# Sizing-result provenance values: whether this cycle's candidate
# allocations were freshly solved or replayed from the input-signature
# sizing cache (controller/sizing_cache.py) because every sizing input
# was unchanged within tolerance
SIZING_PROVENANCE_SOLVED = "solved"
SIZING_PROVENANCE_CACHED = "cached"


@dataclasses.dataclass
class DecisionRecord:
    """What the cycle observed, assumed, and decided for one variant."""

    variant: str  # namespace/name
    namespace: str = ""
    name: str = ""
    model: str = ""
    reason: str = REASON_ERROR
    detail: str = ""  # human-readable amplification (error text, notes)

    # -- observed state (the collector's view this cycle) -------------------
    arrival_rpm: float = 0.0  # observed λ, requests/minute
    ttft_observed_ms: float = 0.0
    itl_observed_ms: float = 0.0
    # observed request token mix (the collector's averages this cycle) —
    # with arrival_rpm, the full load vector the flight recorder
    # (obs/recorder.py) needs to make the cycle replayable
    avg_in_tokens: float = 0.0
    avg_out_tokens: float = 0.0
    asleep: bool = False  # scaled to zero, sized from gateway demand

    # -- sizing inputs ------------------------------------------------------
    profile_provenance: str = PROVENANCE_CR  # "cr" | "corrected"
    # the linear-profile parameters sizing actually ran with for the
    # variant's CURRENT slice shape (post-corrector when calibration is
    # active): ITL = alpha + beta·batch, prefill = gamma + delta·in·batch.
    # Recorded per cycle so model-error drift is attributable to the
    # parameter set that produced the prediction.
    decode_alpha: float = 0.0
    decode_beta: float = 0.0
    prefill_gamma: float = 0.0
    prefill_delta: float = 0.0
    slo_ttft_ms: float = 0.0
    slo_itl_ms: float = 0.0
    # predictive scaling (inferno_tpu/forecast/): the λ the sizing RAN
    # against (max of observed and the forecast upper band when the
    # feature is enabled; equal to arrival_rpm otherwise), and the
    # forecast that produced it
    sizing_rpm: float = 0.0
    rate_provenance: str = RATE_PROVENANCE_OBSERVED  # "observed" | "forecast"
    forecast_rpm: float = 0.0  # point estimate at the horizon
    forecast_upper_rpm: float = 0.0  # rate + band (the sizing bound)
    forecast_band_rpm: float = 0.0  # band half-width
    forecast_horizon_s: float = 0.0  # replica spin-up latency (catalog)
    forecast_burst: bool = False  # burst detector fired this cycle

    # -- the decision -------------------------------------------------------
    # "solved" | "cached" — cached means the candidate allocations were
    # replayed from the sizing cache (inputs unchanged within tolerance)
    sizing_provenance: str = SIZING_PROVENANCE_SOLVED
    # capacity degradation (limited mode, solver/greedy.py ladder): which
    # rung this variant landed on ("" = none) — "shape" (value-worse
    # slice shape), "int8" (stepped onto a quantized -int8 catalog
    # entry), "replicas" (best-effort scaled below the SLO count),
    # "zeroed" (nothing fit) — and the chip deficit of its preferred
    # candidate in the binding pool/quota bucket
    degradation_step: str = ""
    chip_shortfall: int = 0
    accelerator: str = ""
    replicas: int = 0
    # replicas of the decision placed on the pool's preemptible (spot)
    # tier (spot/market.py) — recorded per cycle so a flight-recorder
    # replay reproduces the spot placement bit-faithfully
    spot_replicas: int = 0
    prev_accelerator: str = ""
    prev_replicas: int = 0
    # per-replica sustainable arrival-rate ceiling λ_max at the chosen
    # operating point, requests/minute (Allocation.max_rpm)
    lambda_max_rpm: float = 0.0
    ttft_predicted_ms: float = 0.0
    itl_predicted_ms: float = 0.0
    # SLO minus prediction: positive = margin, negative = expected breach
    ttft_headroom_ms: float = 0.0
    itl_headroom_ms: float = 0.0
    # model-error scoreboard (obs/attainment.py): this cycle's observed
    # latency minus the prediction the PREVIOUS cycle made for the size
    # it decided (signed; 0.0 until a scorable pair exists), and the
    # EWMA of the absolute error (ATTAINMENT_EWMA_GAIN)
    ttft_model_error_ms: float = 0.0
    itl_model_error_ms: float = 0.0
    ttft_model_error_ewma_ms: float = 0.0
    itl_model_error_ewma_ms: float = 0.0
    cost: float = 0.0  # cents/hr of the chosen allocation
    prev_cost: float = 0.0
    cost_delta: float = 0.0  # chosen minus previous

    def __post_init__(self) -> None:
        if self.reason not in REASON_CODES:
            raise ValueError(
                f"reason must be one of {REASON_CODES}, got {self.reason!r}"
            )

    def decide(
        self,
        reason: str,
        *,
        accelerator: str = "",
        replicas: int = 0,
        detail: str = "",
    ) -> "DecisionRecord":
        """Stamp the outcome; returns self for chaining."""
        if reason not in REASON_CODES:
            raise ValueError(
                f"reason must be one of {REASON_CODES}, got {reason!r}"
            )
        self.reason = reason
        self.accelerator = accelerator
        self.replicas = replicas
        if detail:
            self.detail = detail
        return self

    def to_dict(self) -> dict[str, Any]:
        """JSON-ready flat dict; floats rounded so log lines stay legible."""
        out: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, float):
                v = round(v, 4)
            out[f.name] = v
        return out
