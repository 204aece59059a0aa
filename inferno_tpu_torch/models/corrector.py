"""Profile corrector: closes the loop between CR-carried linear profiles
and observed telemetry, consulting the learned surrogate where the linear
model's residuals are large.

The reference ships profiles as static CR fields and never validates them
against reality (SURVEY §0: the decision engine is purely analytic). Here
each reconcile cycle feeds an observation — per-replica concurrency,
request shape, observed ITL/TTFT — into a per-variant ring buffer. When
the median decode residual (observed / predicted ITL at the observed
concurrency) leaves the calibration band:

1. the surrogate (models/surrogate.py, trained on this variant's window
   with parallel/train.py's dp x tp SPMD step) learns the true
   latency(batch) shape, non-linearities included;
2. its predictions over the *observed concurrency range* are re-fit to
   the linear alpha + beta*batch form the sizing kernels consume — a
   local linearization around the operating point, so every backend
   (scalar, XLA fleet kernel, pallas, C++) benefits without interface
   changes;
3. prefill gamma/delta get a bounded multiplicative residual correction
   (TTFT observations fold queueing wait in, so a shape-refit would chase
   noise there). The prefill residual band is evaluated INDEPENDENTLY of
   the decode band with its own hysteresis: prefill-only
   drift activates correction on its own, and a decode release never
   drops a still-out-of-band prefill correction.

With fewer observations than the surrogate needs, correction falls back
to the same bounded multiplicative scaling for decode, so calibration
degrades gracefully rather than flapping.

Stability properties (the no-flapping contract the reconciler and the
bench's closed-loop calibration rely on):

* **Hysteresis.** Correction ACTIVATES when the median residual leaves
  `residual_band` (default 1.2 — deliberately wide for live telemetry,
  which folds scrape jitter and load-balancer skew into the residual),
  and once active it RELEASES only when the residual comes back inside
  the narrower `sqrt(residual_band)` (~1.095 at the default): a residual
  hovering at the activation edge cannot toggle correction on and off
  across cycles, which would flap the sized replica count. Offline
  calibration against the low-noise discrete-event emulator (bench.py)
  constructs the corrector with a much tighter band — the band is
  evidence-noise policy, not model policy.
* **Bounded corrections.** Multiplicative corrections are clamped to
  CORRECTION_BOUNDS, so one window of corrupt telemetry cannot move the
  sizing by more than 4x in either direction.
* **Stability-cap interaction.** Corrected alpha/beta rescale the whole
  service-rate curve mu(n), so the analyzer's stable-rate ceiling
  lambda_max = mu(max_batch)·(1-RATE_EPSILON) moves WITH the correction:
  an optimistic correction (ratio < 1) raises the rate the sizing will
  admit per replica. The 0.9 throughput-headroom cap
  (STABILITY_SAFETY_FRACTION, config/defaults.py) applies only to
  explicit TPS targets and does NOT guard latency-target sizing, which
  binds via bisection against the corrected curve — so an over-correction
  can claim rates the real engine cannot sustain. Consumers must
  therefore validate corrected sizing against measurement before acting
  at fleet scale (bench.py walks the corrected pick back replica by
  replica against a fresh emulator run; the live loop is protected by the
  hysteresis band + bounds above and by re-observing every cycle).

Port copy of `inferno_tpu/models/corrector.py`, verbatim apart from its
imports and the surrogate refit. The refit trains the torch surrogate
(`models/surrogate.py`, `parallel/train.py`) on one device, `device`
(None = the CUDA card; the reference refits on a dp mesh of every local
device, which needs a process group the one-process controller does not
have), from the reference's own initial weights (see
`models/surrogate.py`). As in the reference, any failure of the refit
falls back to ratio scaling for that variant only; the port also logs it
and counts it in `refit_errors`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections import deque

import numpy as np

from inferno_tpu_torch.config.types import DecodeParms, PrefillParms

RESIDUAL_BAND = 1.2  # |log-ratio| beyond log(this) triggers correction
MIN_OBSERVATIONS = 6
SURROGATE_MIN_OBSERVATIONS = 12
WINDOW = 64
CORRECTION_BOUNDS = (0.25, 4.0)  # clamp on multiplicative corrections

log = logging.getLogger("inferno.corrector")


@dataclasses.dataclass(frozen=True)
class Observation:
    concurrency: float  # observed per-replica batch occupancy
    in_tokens: float
    out_tokens: float
    itl_ms: float  # observed inter-token latency
    ttft_ms: float  # observed time-to-first-token (incl. queueing)


@dataclasses.dataclass
class CorrectionState:
    # any correction in force (decode OR prefill) — the reconciler's
    # "use corrected parms / mark provenance corrected" switch
    active: bool = False
    # Decoupled per-phase activation: decode (alpha/beta)
    # and prefill (gamma/delta) drift independently — a prefill-only
    # profile drift must activate correction without waiting on a decode
    # residual, and a decode release must not drop a still-out-of-band
    # prefill correction. Each phase carries its own hysteresis state.
    decode_active: bool = False
    prefill_active: bool = False
    decode_ratio: float = 1.0
    prefill_ratio: float = 1.0
    surrogate_used: bool = False
    observations: int = 0


def _clamp(x: float) -> float:
    return float(min(max(x, CORRECTION_BOUNDS[0]), CORRECTION_BOUNDS[1]))


class ProfileCorrector:
    """Per-variant calibration of linear perf profiles from telemetry."""

    def __init__(
        self,
        residual_band: float = RESIDUAL_BAND,
        window: int = WINDOW,
        use_surrogate: bool = True,
        device=None,
    ):
        self.residual_band = residual_band
        self.use_surrogate = use_surrogate
        # where the surrogate trains (None = the CUDA card)
        self.device = device
        self.window = window
        self._obs: dict[str, deque[Observation]] = {}
        self._state: dict[str, CorrectionState] = {}
        # surrogate refits are expensive (jit + epochs): cache per key and
        # only retrain after the window accrues materially new evidence
        self._refit_cache: dict[str, tuple[int, DecodeParms | None]] = {}
        self.refit_every = 8  # new observations between retrains
        self.refit_errors = 0  # refits that raised (ratio scaling used)
        self._seen: dict[str, int] = {}  # total observations ever per key

    def prune(self, active_prefixes: set[str]) -> None:
        """Drop state for variants no longer reconciled (key format
        "<variant full name>@<acc>"): a long-lived controller must not
        accumulate windows for deleted VAs forever."""
        for store in (self._obs, self._state, self._refit_cache, self._seen):
            for key in [k for k in store if k.split("@", 1)[0] not in active_prefixes]:
                del store[key]

    def observe(self, key: str, obs: Observation) -> None:
        """Record one cycle's observation for a variant. Zero/garbage
        telemetry (idle variant, scrape gap) is skipped."""
        if obs.itl_ms <= 0 or obs.concurrency <= 0:
            return
        self._obs.setdefault(key, deque(maxlen=self.window)).append(obs)
        self._seen[key] = self._seen.get(key, 0) + 1

    def state(self, key: str) -> CorrectionState:
        return self._state.get(key, CorrectionState())

    # -- correction ----------------------------------------------------------

    def corrected_parms(
        self, key: str, decode: DecodeParms, prefill: PrefillParms
    ) -> tuple[DecodeParms, PrefillParms, CorrectionState]:
        """Profile parms to use for sizing this cycle: unchanged while the
        linear profile tracks reality, corrected once residuals leave the
        calibration band."""
        window = list(self._obs.get(key, ()))
        state = CorrectionState(observations=len(window))
        if len(window) < MIN_OBSERVATIONS:
            self._state[key] = state
            return decode, prefill, state

        prev = self._state.get(key, CorrectionState())
        conc = np.array([o.concurrency for o in window])

        # -- decode (alpha/beta) residual, with its OWN hysteresis ----------
        # Activation needs the residual outside the full band; an
        # ALREADY-ACTIVE decode correction releases only when the
        # residual returns inside the narrower sqrt(band) — a residual
        # hovering at the activation edge must not toggle the sizing
        # between corrected and uncorrected parms across cycles. The
        # decode band consults only the DECODE history: the
        # two phases drift independently, so neither residual may gate
        # the other's activation or release.
        obs_itl = np.array([o.itl_ms for o in window])
        pred_itl = decode.alpha + decode.beta * conc
        log_ratio = np.log(obs_itl / np.maximum(pred_itl, 1e-9))
        median_ratio = float(np.exp(np.median(log_ratio)))
        d_band = (
            math.sqrt(self.residual_band) if prev.decode_active
            else self.residual_band
        )
        new_decode = decode
        if abs(math.log(max(median_ratio, 1e-9))) > math.log(d_band):
            state.decode_active = True
            state.decode_ratio = _clamp(median_ratio)
            refit: DecodeParms | None = None
            if self.use_surrogate and len(window) >= SURROGATE_MIN_OBSERVATIONS:
                seen = self._seen.get(key, len(window))
                cached = self._refit_cache.get(key)
                if cached is not None and seen - cached[0] < self.refit_every:
                    refit = cached[1]
                else:
                    refit = self._surrogate_refit(window, decode)
                    self._refit_cache[key] = (seen, refit)
                state.surrogate_used = refit is not None
            if refit is not None:
                new_decode = refit
            else:
                # graceful fallback: bounded multiplicative rescale
                new_decode = DecodeParms(
                    alpha=decode.alpha * state.decode_ratio,
                    beta=decode.beta * state.decode_ratio,
                )

        # -- prefill (gamma/delta) residual, independent hysteresis --------
        # Bounded ratio on the prefill-only component. Observed TTFT
        # includes queue wait, so only correct when observation is
        # clearly ABOVE prediction (wait inflates, never deflates). A
        # prefill-only drift activates here even with decode in-band,
        # and a decode release leaves an out-of-band prefill correction
        # standing.
        obs_ttft = np.array([o.ttft_ms for o in window])
        in_toks = np.array([o.in_tokens for o in window])
        pred_prefill = prefill.gamma + prefill.delta * in_toks * conc
        p_ratio = float(np.exp(np.median(np.log(
            np.maximum(obs_ttft, 1e-9) / np.maximum(pred_prefill, 1e-9)
        ))))
        p_band = (
            math.sqrt(self.residual_band) if prev.prefill_active
            else self.residual_band
        )
        new_prefill = prefill
        if p_ratio > p_band:
            state.prefill_active = True
            state.prefill_ratio = _clamp(p_ratio)
            new_prefill = PrefillParms(
                gamma=prefill.gamma * state.prefill_ratio,
                delta=prefill.delta * state.prefill_ratio,
            )

        state.active = state.decode_active or state.prefill_active
        self._state[key] = state
        return new_decode, new_prefill, state

    def _surrogate_refit(
        self, window: list[Observation], decode: DecodeParms
    ) -> DecodeParms | None:
        """Train the surrogate on the window, then linearize its ITL
        prediction over the observed concurrency range. Any failure falls
        back to ratio scaling (None), for this variant only."""
        try:
            return self._fit_and_linearize(window, decode)
        except Exception:
            self.refit_errors += 1
            log.warning("surrogate refit failed; ratio scaling for this "
                        "variant", exc_info=True)
            return None

    def _fit_and_linearize(
        self, window: list[Observation], decode: DecodeParms
    ) -> DecodeParms | None:
        conc = np.array([o.concurrency for o in window])
        lo, hi = float(conc.min()), float(conc.max())
        if hi - lo < 1.0:
            return None  # no spread: a line through one point is noise
        from inferno_tpu_torch.models.surrogate import featurize, surrogate_forward
        from inferno_tpu_torch.parallel.train import fit_surrogate

        def feats(c: np.ndarray, in_toks: np.ndarray, out_toks: np.ndarray) -> np.ndarray:
            n = c.shape[0]
            ones = np.ones(n)
            return featurize(
                chips=ones, cost_per_chip=ones,
                alpha=np.full(n, decode.alpha), beta=np.full(n, decode.beta),
                gamma=ones, delta=ones,
                batch=c,
                in_tokens=in_toks,
                out_tokens=out_toks,
                rate=ones,
            )

        obs_in = np.array([o.in_tokens for o in window])
        obs_out = np.array([o.out_tokens for o in window])
        x = feats(conc, obs_in, obs_out)
        y = np.stack(
            [
                np.log1p([o.itl_ms for o in window]),
                np.log1p([o.ttft_ms for o in window]),
                np.zeros(len(window)),
            ],
            axis=-1,
        ).astype(np.float32)
        state, _ = fit_surrogate(
            x, y, device=self.device, epochs=80, learning_rate=3e-3,
        )

        probe = np.linspace(lo, hi, 16)
        px = feats(
            probe,
            np.full(16, float(obs_in.mean())),
            np.full(16, float(obs_out.mean())),
        )
        pred = surrogate_forward(state.model, px).cpu().numpy()
        itl_pred = np.expm1(pred[:, 0])
        if not np.all(np.isfinite(itl_pred)) or np.any(itl_pred <= 0):
            return None
        a_mat = np.stack([np.ones_like(probe), probe], axis=1)
        coef, *_ = np.linalg.lstsq(a_mat, itl_pred, rcond=None)
        alpha, beta = float(coef[0]), float(coef[1])
        if alpha <= 0 or beta < 0:
            return None
        return DecodeParms(alpha=alpha, beta=beta)
