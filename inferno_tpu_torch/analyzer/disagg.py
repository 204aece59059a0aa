"""Disaggregated prefill/decode queueing model (JetStream-style serving).

JetStream separates prefill and decode onto distinct engines: prefill
slices run the prompt pass and hand the KV cache to decode slices that do
continuous-batching generation (the reference names this gap explicitly:
its single mu(n) curve assumes one engine does both — SURVEY §7 "hard
parts"; reference analyzer at upstream pkg/analyzer/
queueanalyzer.go:99-131).

The model here is a **tandem of two birth-death chains** under the
standard independence approximation for finite-buffer tandems (analyze
each stage against its own offered rate; the inter-stage flow is the
prefill throughput):

* prefill stage — batch server with aggregate rate
      mu_p(n) = n / (gamma + delta * in_tokens * n),  n = 1..Bp
  over `prefill_slices` engines per replica unit, each seeing
  lambda / prefill_slices;
* decode stage — batch server with aggregate rate
      mu_d(n) = n / ((out_tokens - 1) * (alpha + beta * n)),  n = 1..Bd
  over `decode_slices` engines, each seeing the per-engine share of the
  prefill stage's throughput.

TTFT = prefill-stage queueing wait + prefill execution at the effective
prefill concurrency (KV-transfer time can be folded into gamma).
ITL = decode step time at the effective decode concurrency.

A "replica unit" for sizing/cost purposes is the atomic group of
(prefill_slices + decode_slices) engines — each engine occupying
`slices_per_replica` pod-slices of the shape — and `create_allocation`
scales whole units. The two stages share a slice shape in this build
(profiles are measured per shape); heterogeneous prefill/decode shapes
would enter as separate catalog entries with their own profiles.

Thread-safety and units follow `inferno_tpu_torch.analyzer.queue`: immutable
values, rates req/sec at the public API and req/msec internally, times
in msec.

Port copy of `inferno_tpu/analyzer/disagg.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from inferno_tpu_torch.analyzer.queue import (
    AnalysisMetrics,
    AnalyzerError,
    QueueStats,
    RequestSize,
    TargetPerf,
    TargetRate,
    RATE_EPSILON,
    decode_time,
    prefill_time,
    size_with_targets,
    solve_birth_death,
)
from inferno_tpu_torch.config.defaults import SLO_MARGIN
from inferno_tpu_torch.config.types import DecodeParms, DisaggSpec, PrefillParms


def _prefill_rates(prefill: PrefillParms, in_tokens: int, max_batch: int) -> np.ndarray:
    """mu_p(n) = n / prefill_time(n), n = 1..max_batch, req/msec."""
    n = np.arange(1, max_batch + 1, dtype=np.float64)
    t = prefill.gamma + prefill.delta * in_tokens * n
    if np.any(t <= 0):
        raise AnalyzerError(f"non-positive prefill time for {prefill} in_tokens={in_tokens}")
    return n / t


def _decode_rates(decode: DecodeParms, out_tokens: int, max_batch: int) -> np.ndarray:
    """mu_d(n) = n / (num_decodes * decode_time(n)), n = 1..max_batch, req/msec."""
    n = np.arange(1, max_batch + 1, dtype=np.float64)
    num_decodes = max(out_tokens - 1, 1)
    t = num_decodes * (decode.alpha + decode.beta * n)
    if np.any(t <= 0):
        raise AnalyzerError(f"non-positive decode time for {decode}")
    return n / t


def _effective_concurrency(avg_serv_time: float, base: float, slope: float, max_batch: int) -> float:
    """Invert t(n) = base + slope*n to the concurrency giving avg_serv_time."""
    if slope <= 0:
        return float(max_batch) if avg_serv_time > base else 0.0
    return float(np.clip((avg_serv_time - base) / slope, 0.0, float(max_batch)))


@dataclasses.dataclass(frozen=True)
class DisaggAnalyzer:
    """Immutable analyzer for one (server, slice shape) configuration of a
    disaggregated prefill/decode engine pair.

    Public surface mirrors `QueueAnalyzer` (analyze / size / max_rate) so
    `create_allocation` can use either interchangeably.
    """

    spec: DisaggSpec
    prefill_max_batch: int
    decode_max_batch: int
    max_queue: int  # per stage, in requests
    decode: DecodeParms
    prefill: PrefillParms
    request: RequestSize
    prefill_serv_rates: np.ndarray  # req/msec, per prefill engine
    decode_serv_rates: np.ndarray  # req/msec, per decode engine
    lambda_min: float  # req/msec, whole unit
    lambda_max: float  # req/msec, whole unit

    @property
    def max_rate(self) -> float:
        """Maximum stable request rate for one replica unit, req/sec."""
        return self.lambda_max * 1000.0

    # -- internal ------------------------------------------------------------

    def _solve_prefill(self, lam_unit: float) -> QueueStats:
        return solve_birth_death(
            lam_unit / self.spec.prefill_slices,
            self.prefill_serv_rates,
            self.prefill_max_batch + self.max_queue,
        )

    def _solve_decode(self, lam_unit: float) -> QueueStats:
        return solve_birth_death(
            lam_unit / self.spec.decode_slices,
            self.decode_serv_rates,
            self.decode_max_batch + self.max_queue,
        )

    def _ttft_at(self, lam_unit: float) -> float:
        return self._tail_ttft_at(lam_unit, 1.0)

    def _tail_ttft_at(self, lam_unit: float, margin: float = SLO_MARGIN) -> float:
        """TTFT with the prefill-stage wait scaled to its SLO percentile
        (margin = 1.0 gives the mean; see queue.size_with_targets)."""
        stats = self._solve_prefill(lam_unit)
        conc = _effective_concurrency(
            stats.avg_serv_time,
            self.prefill.gamma,
            self.prefill.delta * self.request.avg_in_tokens,
            self.prefill_max_batch,
        )
        return margin * stats.avg_wait_time + prefill_time(
            self.prefill, self.request.avg_in_tokens, conc
        )

    def _itl_at(self, lam_unit: float) -> float:
        # decode stage sees the prefill stage's departures
        through = self._solve_prefill(lam_unit).throughput * self.spec.prefill_slices
        stats = self._solve_decode(through)
        num_decodes = max(self.request.avg_out_tokens - 1, 1)
        conc = _effective_concurrency(
            stats.avg_serv_time / num_decodes,
            self.decode.alpha,
            self.decode.beta,
            self.decode_max_batch,
        )
        return decode_time(self.decode, conc)

    # -- public --------------------------------------------------------------

    def analyze(self, request_rate: float) -> AnalysisMetrics:
        """Performance metrics of one replica unit at `request_rate` (req/sec)."""
        if request_rate <= 0:
            raise AnalyzerError(f"invalid request rate {request_rate}")
        if request_rate > self.max_rate:
            raise AnalyzerError(
                f"rate={request_rate} req/s exceeds max stable rate {self.max_rate} req/s"
            )
        lam = request_rate / 1000.0
        pstats = self._solve_prefill(lam)
        through_unit = pstats.throughput * self.spec.prefill_slices
        dstats = self._solve_decode(through_unit)

        pconc = _effective_concurrency(
            pstats.avg_serv_time,
            self.prefill.gamma,
            self.prefill.delta * self.request.avg_in_tokens,
            self.prefill_max_batch,
        )
        num_decodes = max(self.request.avg_out_tokens - 1, 1)
        dconc = _effective_concurrency(
            dstats.avg_serv_time / num_decodes,
            self.decode.alpha,
            self.decode.beta,
            self.decode_max_batch,
        )
        avg_prefill = prefill_time(self.prefill, self.request.avg_in_tokens, pconc)
        avg_itl = decode_time(self.decode, dconc)
        # end-to-end response: prefill wait+exec, then decode wait+generation
        resp = pstats.avg_wait_time + avg_prefill + dstats.avg_wait_time + dstats.avg_serv_time
        # utilization of the binding stage: a prefill-bound unit is saturated
        # even when its decode engines idle
        rho = float(
            np.clip(
                max(
                    pstats.avg_num_in_servers / self.prefill_max_batch,
                    dstats.avg_num_in_servers / self.decode_max_batch,
                ),
                0.0,
                1.0,
            )
        )
        # avg_wait_time is the TTFT-relevant wait: only the prefill stage
        # delays the first token — a decode-slot wait stretches later tokens
        # (it is part of avg_resp_time above), keeping analyze() consistent
        # with the _ttft_at() the sizing bisection uses.
        return AnalysisMetrics(
            throughput=dstats.throughput * self.spec.decode_slices * 1000.0,
            avg_resp_time=resp,
            avg_wait_time=pstats.avg_wait_time,
            avg_num_in_serv=dstats.avg_num_in_servers,
            avg_prefill_time=avg_prefill,
            avg_token_time=avg_itl,
            max_rate=self.max_rate,
            rho=rho,
        )

    def size(
        self, targets: TargetPerf, ttft_tail_margin: float = SLO_MARGIN
    ) -> tuple[TargetRate, AnalysisMetrics, TargetPerf]:
        """Max unit request rates meeting each SLO target; shares the
        sizing driver (and its percentile TTFT semantics) with
        `QueueAnalyzer.size`."""
        return size_with_targets(self, targets, ttft_tail_margin)


def build_disagg_analyzer(
    max_batch: int,
    max_queue: int,
    decode: DecodeParms,
    prefill: PrefillParms,
    request: RequestSize,
    spec: DisaggSpec,
) -> DisaggAnalyzer:
    """Construct a disaggregated analyzer.

    `max_batch` is the decode-engine batch (the capacity-binding one, same
    meaning as the aggregated analyzer's); the prefill batch defaults to it
    unless the spec overrides.
    """
    if max_batch <= 0 or max_queue < 0:
        raise AnalyzerError(
            f"invalid configuration max_batch={max_batch} max_queue={max_queue}"
        )
    try:
        spec.validate()
    except ValueError as e:
        raise AnalyzerError(str(e)) from None
    request.validate()
    if request.avg_in_tokens <= 0:
        raise AnalyzerError(
            "disaggregated model requires avg_in_tokens > 0 (a prefill stage)"
        )
    prefill_batch = spec.prefill_max_batch or max_batch
    p_rates = _prefill_rates(prefill, request.avg_in_tokens, prefill_batch)
    d_rates = _decode_rates(decode, request.avg_out_tokens, max_batch)

    # stable range of the whole unit: the binding stage saturates first
    unit_max = min(
        float(p_rates[-1]) * spec.prefill_slices,
        float(d_rates[-1]) * spec.decode_slices,
    )
    return DisaggAnalyzer(
        spec=spec,
        prefill_max_batch=prefill_batch,
        decode_max_batch=max_batch,
        max_queue=max_queue,
        decode=decode,
        prefill=prefill,
        request=request,
        prefill_serv_rates=p_rates,
        decode_serv_rates=d_rates,
        lambda_min=unit_max * RATE_EPSILON,
        lambda_max=unit_max * (1.0 - RATE_EPSILON),
    )
