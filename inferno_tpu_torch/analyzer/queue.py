"""State-dependent batch-service queueing model of an LLM inference server.

Models one replica of a continuous-batching inference engine (JetStream /
vLLM-TPU) as a birth-death chain: requests arrive Poisson(λ), up to
`max_batch` requests are served concurrently, and the *aggregate* service
rate at occupancy n is

    mu(n) = n / (prefill_time(n) + num_decodes * decode_time(n))

with the linear latency profile

    prefill_time(n) = gamma + delta * avg_in_tokens * n      (msec)
    decode_time(n)  = alpha + beta * n                       (msec)

capturing batch-size interference on the TPU (MXU occupancy for prefill,
HBM-bandwidth-bound decode steps). Occupancy is capped at
K = max_batch + max_queue; arrivals beyond K are rejected.

Capability parity with the reference analyzer
(upstream pkg/analyzer/{queueanalyzer.go:99-302,
mm1modelstatedependent.go:28-116, mm1kmodel.go:32-92}), with two
deliberate departures:

* the stationary distribution is computed in **log-space with a single
  vectorized cumsum + logsumexp** instead of the reference's sequential
  float64 recursion with ad-hoc overflow rescaling — numerically robust
  for any K and directly portable to the batched JAX/TPU path in
  `inferno_tpu_torch.ops.queueing`;
* there is **no mutable module state**: analyzers are immutable values and
  every evaluation is a pure function, so the analyzer is trivially
  thread-safe (the reference's package globals are thread-unsafe by its
  own admission).

Units follow the reference: rates are requests/sec at the public API and
requests/msec internally; times are msec.

Calibration note: the alpha/beta/gamma/delta fed in here may be
corrector-calibrated rather than CR-carried (models/corrector.py; the
reconciler rewrites the ModelPerfSpec parms in place, so this analyzer,
the batched XLA kernel in ops/queueing.py, and the C++ backend all see
the same corrected curve). Corrected parms rescale mu(n) and therefore
lambda_max itself — the sizing bisection in size_with_targets admits
rates up to the CORRECTED ceiling. The STABILITY_SAFETY_FRACTION (0.9)
headroom cap only applies to explicit TPS targets, so latency-target
sizing on an optimistically-corrected curve has no analytic guard:
consumers acting on corrected sizing at fleet scale validate against
measurement first (bench.py's calibrated block walks the corrected pick
back against fresh emulator runs).

Port copy of `inferno_tpu/analyzer/queue.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from inferno_tpu_torch.config.defaults import SLO_MARGIN, STABILITY_SAFETY_FRACTION
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.analyzer.sizing import bisect_monotone

# Relative margin keeping the stability rate range strictly inside (0, mu_max)
# (reference: pkg/analyzer/queueanalyzer.go:8).
RATE_EPSILON = 1e-3


class AnalyzerError(ValueError):
    """Raised for invalid inputs or infeasible sizing targets."""


@dataclasses.dataclass(frozen=True)
class RequestSize:
    """Average request shape (reference: pkg/analyzer/queueanalyzer.go:49-52)."""

    avg_in_tokens: int
    avg_out_tokens: int

    def validate(self) -> None:
        if self.avg_in_tokens < 0 or self.avg_out_tokens < 1:
            raise AnalyzerError(f"invalid request size {self}")


@dataclasses.dataclass(frozen=True)
class TargetPerf:
    """SLO targets; 0 disables a target
    (reference: pkg/analyzer/queueanalyzer.go:73-77)."""

    target_ttft: float = 0.0  # msec, queueing + prefill
    target_itl: float = 0.0  # msec
    target_tps: float = 0.0  # tokens/sec

    def validate(self) -> None:
        if self.target_ttft < 0 or self.target_itl < 0 or self.target_tps < 0:
            raise AnalyzerError(f"invalid targets {self}")


@dataclasses.dataclass(frozen=True)
class TargetRate:
    """Max request rates (req/sec) satisfying each individual target
    (reference: pkg/analyzer/queueanalyzer.go:80-84)."""

    rate_target_ttft: float
    rate_target_itl: float
    rate_target_tps: float


@dataclasses.dataclass(frozen=True)
class QueueStats:
    """Raw stationary statistics of the birth-death chain (internal units:
    rates req/msec, times msec)."""

    throughput: float  # effective departure rate, req/msec
    avg_num_in_system: float
    avg_num_in_servers: float
    avg_resp_time: float
    avg_serv_time: float
    avg_wait_time: float
    utilization: float  # 1 - p0
    blocking_probability: float  # p[K]


@dataclasses.dataclass(frozen=True)
class AnalysisMetrics:
    """Server-level metrics at a given request rate
    (reference: pkg/analyzer/queueanalyzer.go:61-70)."""

    throughput: float  # req/sec
    avg_resp_time: float  # msec
    avg_wait_time: float  # msec
    avg_num_in_serv: float
    avg_prefill_time: float  # msec
    avg_token_time: float  # msec (ITL)
    max_rate: float  # req/sec
    rho: float  # avg in service / max batch, clamped [0, 1]

    @property
    def ttft(self) -> float:
        """Expected time-to-first-token: queueing + prefill (msec)."""
        return self.avg_wait_time + self.avg_prefill_time


def prefill_time(parms: PrefillParms, avg_in_tokens: int, batch: float) -> float:
    """(reference: pkg/analyzer/queueanalyzer.go:257-262)"""
    if avg_in_tokens == 0:
        return 0.0
    return parms.gamma + parms.delta * avg_in_tokens * batch


def decode_time(parms: DecodeParms, batch: float) -> float:
    """(reference: pkg/analyzer/queueanalyzer.go:264-266)"""
    return parms.alpha + parms.beta * batch


def service_rates(
    decode: DecodeParms,
    prefill: PrefillParms,
    request: RequestSize,
    max_batch: int,
) -> np.ndarray:
    """Aggregate service rate mu(n), n = 1..max_batch, in req/msec
    (reference: pkg/analyzer/queueanalyzer.go:102-113)."""
    n = np.arange(1, max_batch + 1, dtype=np.float64)
    num_decodes = request.avg_out_tokens - 1
    if request.avg_in_tokens == 0 and request.avg_out_tokens == 1:
        # decode-only single-token requests still take one decode step
        num_decodes = 1
    pf = prefill.gamma + prefill.delta * request.avg_in_tokens * n if request.avg_in_tokens > 0 else np.zeros_like(n)
    dc = num_decodes * (decode.alpha + decode.beta * n)
    total = pf + dc
    if np.any(total <= 0):
        raise AnalyzerError(
            f"non-positive service time for decode={decode} prefill={prefill} request={request}"
        )
    return n / total


def solve_birth_death(lam: float, serv_rates_arr: np.ndarray, occupancy_cap: int) -> QueueStats:
    """Stationary solution of the birth-death chain with arrival rate `lam`
    (req/msec), state-dependent service rates and occupancy capped at
    `occupancy_cap` = max_batch + max_queue.

    Log-space equivalent of the reference recursion
    p[n+1] = p[n] * lam / mu(n+1) with normalization
    (upstream pkg/analyzer/mm1modelstatedependent.go:70-116) and the
    statistics at mm1modelstatedependent.go:38-67.
    """
    if lam <= 0:
        raise AnalyzerError(f"invalid arrival rate {lam}")
    n_serv = len(serv_rates_arr)
    k_cap = int(occupancy_cap)
    if k_cap < n_serv:
        raise AnalyzerError(f"occupancy cap {k_cap} below max batch {n_serv}")

    # mu for states 1..K (state k>max_batch keeps the full-batch rate)
    mu = np.concatenate(
        [serv_rates_arr, np.full(k_cap - n_serv, serv_rates_arr[-1], dtype=np.float64)]
    )
    log_ratio = np.log(lam) - np.log(mu)
    logp = np.concatenate([[0.0], np.cumsum(log_ratio)])
    m = np.max(logp)
    logz = m + np.log(np.sum(np.exp(logp - m)))
    p = np.exp(logp - logz)

    k = np.arange(k_cap + 1, dtype=np.float64)
    avg_in_system = float(np.sum(k * p))
    # queue mass summed directly, not as 1 - (mass in service): the
    # complement is rounding residue at low load and n_serv amplifies it
    # (decisive in the f32 kernels, ops/queueing.py; kept identical here)
    queue_mass = float(np.sum(p[n_serv + 1 :]))
    avg_in_servers = (
        float(np.sum(k[1 : n_serv + 1] * p[1 : n_serv + 1])) + n_serv * queue_mass
    )
    throughput = lam * (1.0 - float(p[k_cap]))
    avg_resp = avg_in_system / throughput
    avg_serv = avg_in_servers / throughput
    avg_wait = max(0.0, avg_resp - avg_serv)
    return QueueStats(
        throughput=throughput,
        avg_num_in_system=avg_in_system,
        avg_num_in_servers=avg_in_servers,
        avg_resp_time=avg_resp,
        avg_serv_time=avg_serv,
        avg_wait_time=avg_wait,
        utilization=1.0 - float(p[0]),
        blocking_probability=float(p[k_cap]),
    )


def effective_concurrency(
    avg_serv_time: float,
    decode: DecodeParms,
    prefill: PrefillParms,
    request: RequestSize,
    max_batch: int,
) -> float:
    """Invert the per-request service-time curve to recover the average
    concurrency n the request experienced:
    prefill_time(n) + (out_tokens - 1) * decode_time(n) = avg_serv_time
    (reference: pkg/analyzer/queueanalyzer.go:296-302)."""
    tokens = float(request.avg_out_tokens - 1)
    numerator = avg_serv_time - (prefill.gamma + decode.alpha * tokens)
    denominator = prefill.delta * request.avg_in_tokens + decode.beta * tokens
    if denominator <= 0:
        return float(max_batch) if numerator > 0 else 0.0
    return float(np.clip(numerator / denominator, 0.0, float(max_batch)))


def size_with_targets(
    analyzer, targets: TargetPerf, ttft_tail_margin: float = SLO_MARGIN
) -> tuple[TargetRate, AnalysisMetrics, TargetPerf]:
    """Shared sizing driver for any analyzer exposing lambda_min/lambda_max,
    _tail_ttft_at, _itl_at, analyze, and a request (QueueAnalyzer and
    DisaggAnalyzer): bisect the max rate for each active target, cap TPS by
    the stability headroom, evaluate at the binding minimum
    (reference: pkg/analyzer/queueanalyzer.go:185-255).

    TTFT targets are interpreted at SLO_PERCENTILE: the bisection bounds
    `ttft_tail_margin * wait + prefill`, so the percentile (not just the
    mean) of TTFT meets the target under the exponential-wait assumption
    the reference documents but never applies (pkg/core/allocation.go:117).
    Pass ttft_tail_margin=1.0 for reference-exact mean semantics, or
    slo_margin_for(0.99) for a p99 interpretation."""
    targets.validate()
    lam_min, lam_max = analyzer.lambda_min, analyzer.lambda_max

    lam_ttft = lam_max
    if targets.target_ttft > 0:
        res = bisect_monotone(
            lam_min, lam_max, targets.target_ttft,
            lambda lam: analyzer._tail_ttft_at(lam, ttft_tail_margin),
        )
        if res.indicator < 0:
            raise AnalyzerError(
                f"TTFT target {targets.target_ttft} ms unachievable: "
                f"below value at minimum rate"
            )
        lam_ttft = res.x

    lam_itl = lam_max
    if targets.target_itl > 0:
        res = bisect_monotone(lam_min, lam_max, targets.target_itl, analyzer._itl_at)
        if res.indicator < 0:
            raise AnalyzerError(
                f"ITL target {targets.target_itl} ms unachievable: "
                f"below value at minimum rate"
            )
        lam_itl = res.x

    lam_tps = lam_max
    if targets.target_tps > 0:
        lam_tps = lam_max * (1.0 - STABILITY_SAFETY_FRACTION)

    lam_star = min(lam_ttft, lam_itl, lam_tps)
    metrics = analyzer.analyze(lam_star * 1000.0)
    achieved = TargetPerf(
        target_ttft=metrics.avg_wait_time + metrics.avg_prefill_time,
        target_itl=metrics.avg_token_time,
        target_tps=metrics.throughput * analyzer.request.avg_out_tokens,
    )
    rates = TargetRate(
        rate_target_ttft=lam_ttft * 1000.0,
        rate_target_itl=lam_itl * 1000.0,
        rate_target_tps=lam_tps * 1000.0,
    )
    return rates, metrics, achieved


@dataclasses.dataclass(frozen=True)
class QueueAnalyzer:
    """Immutable analyzer for one (server, slice-shape) configuration
    (reference: pkg/analyzer/queueanalyzer.go:14-21)."""

    max_batch: int
    max_queue: int
    decode: DecodeParms
    prefill: PrefillParms
    request: RequestSize
    serv_rates: np.ndarray  # mu(n), n=1..max_batch, req/msec
    lambda_min: float  # req/msec
    lambda_max: float  # req/msec

    @property
    def occupancy_cap(self) -> int:
        return self.max_batch + self.max_queue

    @property
    def max_rate(self) -> float:
        """Maximum stable request rate, req/sec."""
        return self.lambda_max * 1000.0

    # -- evaluation ---------------------------------------------------------

    def _solve(self, lam: float) -> QueueStats:
        return solve_birth_death(lam, self.serv_rates, self.occupancy_cap)

    def _ttft_at(self, lam: float) -> float:
        return self._tail_ttft_at(lam, 1.0)

    def _tail_ttft_at(self, lam: float, margin: float = SLO_MARGIN) -> float:
        """TTFT with the queueing-wait component scaled to its SLO
        percentile (margin = 1.0 gives the mean)."""
        stats = self._solve(lam)
        conc = effective_concurrency(
            stats.avg_serv_time, self.decode, self.prefill, self.request, self.max_batch
        )
        return margin * stats.avg_wait_time + prefill_time(
            self.prefill, self.request.avg_in_tokens, conc
        )

    def _itl_at(self, lam: float) -> float:
        stats = self._solve(lam)
        conc = effective_concurrency(
            stats.avg_serv_time, self.decode, self.prefill, self.request, self.max_batch
        )
        return decode_time(self.decode, conc)

    def analyze(self, request_rate: float) -> AnalysisMetrics:
        """Performance metrics at `request_rate` (req/sec)
        (reference: pkg/analyzer/queueanalyzer.go:134-174)."""
        if request_rate <= 0:
            raise AnalyzerError(f"invalid request rate {request_rate}")
        if request_rate > self.max_rate:
            raise AnalyzerError(
                f"rate={request_rate} req/s exceeds max stable rate {self.max_rate} req/s"
            )
        stats = self._solve(request_rate / 1000.0)
        conc = effective_concurrency(
            stats.avg_serv_time, self.decode, self.prefill, self.request, self.max_batch
        )
        rho = float(np.clip(stats.avg_num_in_servers / self.max_batch, 0.0, 1.0))
        return AnalysisMetrics(
            throughput=stats.throughput * 1000.0,
            avg_resp_time=stats.avg_resp_time,
            avg_wait_time=stats.avg_wait_time,
            avg_num_in_serv=stats.avg_num_in_servers,
            avg_prefill_time=prefill_time(self.prefill, self.request.avg_in_tokens, conc),
            avg_token_time=decode_time(self.decode, conc),
            max_rate=self.max_rate,
            rho=rho,
        )

    def size(
        self, targets: TargetPerf, ttft_tail_margin: float = SLO_MARGIN
    ) -> tuple[TargetRate, AnalysisMetrics, TargetPerf]:
        """Max request rates meeting each SLO target, plus metrics and
        achieved values at the binding (minimum) rate
        (reference: pkg/analyzer/queueanalyzer.go:185-255). TTFT targets
        bind at SLO_PERCENTILE via `ttft_tail_margin` (see
        size_with_targets).

        Raises AnalyzerError when a target is unachievable even at the
        lowest stable rate.
        """
        return size_with_targets(self, targets, ttft_tail_margin)


def build_analyzer(
    max_batch: int,
    max_queue: int,
    decode: DecodeParms,
    prefill: PrefillParms,
    request: RequestSize,
) -> QueueAnalyzer:
    """Construct an analyzer, precomputing service-rate curve and the
    stable rate range (reference: pkg/analyzer/queueanalyzer.go:87-131)."""
    if max_batch <= 0 or max_queue < 0:
        raise AnalyzerError(f"invalid configuration max_batch={max_batch} max_queue={max_queue}")
    request.validate()
    rates = service_rates(decode, prefill, request, max_batch)
    return QueueAnalyzer(
        max_batch=max_batch,
        max_queue=max_queue,
        decode=decode,
        prefill=prefill,
        request=request,
        serv_rates=rates,
        lambda_min=float(rates[0]) * RATE_EPSILON,
        lambda_max=float(rates[-1]) * (1.0 - RATE_EPSILON),
    )
