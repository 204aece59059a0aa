"""Prometheus metrics exposition for the controller's own outputs.

Minimal stdlib registry (the actuation contract is just four series,
reference: internal/metrics/metrics.go:20-65): gauges + a counter with
labels, plus a text-exposition histogram kind (`_bucket`/`_sum`/`_count`)
for the cycle-latency instrumentation, rendered in the text
exposition format and served over HTTP together with health probes
(reference serves these via controller-runtime, cmd/main.go:157-169,
250-257). The metrics listener also exposes `/debug/decisions` — the
last-K reconcile-cycle traces with their per-variant DecisionRecords —
when given a TraceBuffer.

Port copy of `inferno_tpu/controller/metrics.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Iterable

from inferno_tpu_torch.controller.engines import (
    LABEL_ACCELERATOR,
    LABEL_DIRECTION,
    LABEL_OUT_NAMESPACE,
    LABEL_VARIANT,
    METRIC_CURRENT_REPLICAS,
    METRIC_DESIRED_RATIO,
    METRIC_DESIRED_REPLICAS,
    METRIC_SCALING_TOTAL,
)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Series:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind  # "gauge" | "counter"
        self.values: dict[tuple, tuple[dict[str, str], float]] = {}
        # mutation lock: the reconciler's bounded-concurrency pipeline
        # emits from pool workers, and inc() is a read-modify-write
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple:
        return tuple(sorted(labels.items()))

    def set(self, labels: dict[str, str], value: float) -> None:
        with self._lock:
            self.values[self._key(labels)] = (labels, value)

    def inc(self, labels: dict[str, str], by: float = 1.0) -> None:
        with self._lock:
            key = self._key(labels)
            old = self.values.get(key, (labels, 0.0))[1]
            self.values[key] = (labels, old + by)

    def get(self, labels: dict[str, str]) -> float | None:
        v = self.values.get(self._key(labels))
        return v[1] if v else None

    def remove(self, labels: dict[str, str]) -> None:
        self.values.pop(self._key(labels), None)

    def labelsets(self) -> list[dict[str, str]]:
        """Snapshot of the label sets with samples (pruning support —
        same contract as _Histogram.labelsets)."""
        return [dict(lbls) for lbls, _v in list(self.values.values())]

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        # snapshot: mutators (set/inc/remove, incl. per-cycle pruning) run
        # on the reconcile thread while /metrics scrapes render here
        for labels, value in list(self.values.values()):
            yield f"{self.name}{_fmt_labels(labels)} {value}"


# Latency bucket boundaries in seconds, sized for the cycle's observed
# dynamic range: sub-ms scalar sizing of one variant up through multi-
# second full-fleet cycles on a cold XLA cache.
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def _fmt_le(bound: float) -> str:
    """Prometheus renders integral bounds without a trailing .0."""
    return str(int(bound)) if float(bound).is_integer() else repr(bound)


class _Histogram:
    """Cumulative-bucket histogram in the text exposition format: per
    label set, `name_bucket{...,le="b"}` lines (cumulative, ending at
    +Inf), plus `name_sum` and `name_count`."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, buckets: tuple[float, ...]):
        if not buckets or tuple(sorted(buckets)) != tuple(buckets):
            raise ValueError(f"buckets must be sorted and non-empty: {buckets}")
        self.name = name
        self.help = help_
        self.buckets = tuple(float(b) for b in buckets)
        # label key -> (labels, per-bucket counts (non-cumulative), sum, count)
        self.values: dict[tuple, tuple[dict[str, str], list[int], float, int]] = {}
        # observe() is read-modify-write; pool workers observe concurrently
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple:
        return tuple(sorted(labels.items()))

    def observe(self, labels: dict[str, str], value: float) -> None:
        with self._lock:
            key = self._key(labels)
            entry = self.values.get(key)
            if entry is None:
                entry = (dict(labels), [0] * (len(self.buckets) + 1), 0.0, 0)
            lbls, counts, total, n = entry
            # copy-on-write: a concurrent /metrics render snapshots the
            # stored tuples, so mutating the shared counts list in place
            # could show a finite bucket ahead of _count (+Inf) — an
            # invalid cumulative exposition. A fresh list + atomic dict
            # assignment keeps every rendered view internally consistent
            # (old or new, never mixed).
            counts = list(counts)
            # last slot is the +Inf overflow bucket
            idx = next(
                (i for i, b in enumerate(self.buckets) if value <= b),
                len(self.buckets),
            )
            counts[idx] += 1
            self.values[key] = (lbls, counts, total + value, n + 1)

    def remove(self, labels: dict[str, str]) -> None:
        self.values.pop(self._key(labels), None)

    def labelsets(self) -> list[dict[str, str]]:
        """Snapshot of the label sets with observations (pruning support)."""
        return [dict(lbls) for lbls, *_ in list(self.values.values())]

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        # snapshot: observe/remove run on the reconcile thread while
        # /metrics scrapes render here
        for labels, counts, total, n in list(self.values.values()):
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                le = {**labels, "le": _fmt_le(bound)}
                yield f"{self.name}_bucket{_fmt_labels(le)} {cum}"
            inf = {**labels, "le": "+Inf"}
            yield f"{self.name}_bucket{_fmt_labels(inf)} {n}"
            yield f"{self.name}_sum{_fmt_labels(labels)} {total}"
            yield f"{self.name}_count{_fmt_labels(labels)} {n}"


class Registry:
    def __init__(self):
        self._series: dict[str, _Series | _Histogram] = {}
        self._lock = threading.Lock()

    def gauge(self, name: str, help_: str = "") -> _Series:
        return self._get(name, "gauge", lambda: _Series(name, help_, "gauge"))

    def counter(self, name: str, help_: str = "") -> _Series:
        return self._get(name, "counter", lambda: _Series(name, help_, "counter"))

    def histogram(
        self,
        name: str,
        help_: str = "",
        buckets: tuple[float, ...] = LATENCY_BUCKETS_S,
    ) -> _Histogram:
        # NOTE: a repeat registration returns the existing instance; like
        # help text, a differing `buckets` argument on the second call is
        # ignored (first registration wins)
        return self._get(name, "histogram", lambda: _Histogram(name, help_, buckets))

    def _get(self, name: str, kind: str, make):
        """Single register-or-fetch path for every series kind: the name
        is the identity, and re-registering under a different kind is a
        hard error, never a silent alias."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = make()
                self._series[name] = s
            if s.kind != kind:
                raise ValueError(f"{name} is already registered as a {s.kind}")
            return s

    def catalog(self) -> list[tuple[str, str, str]]:
        """(name, help, kind) of every registered series — the lint and
        documentation surface (obs/lint.py, docs/observability.md)."""
        with self._lock:
            return [(s.name, s.help, s.kind) for s in self._series.values()]

    def histograms(self) -> list[tuple[str, tuple[float, ...]]]:
        """(name, bucket boundaries) of every registered histogram — the
        bucket-sanity lint surface (obs/lint.py: boundaries must be
        strictly increasing and finite, or the rendered cumulative
        counts are silently wrong)."""
        with self._lock:
            return [
                (s.name, s.buckets)
                for s in self._series.values()
                if isinstance(s, _Histogram)
            ]

    def labelsets(self) -> list[tuple[str, list[dict[str, str]]]]:
        """(name, label sets with live samples) of every series — the
        label-name lint surface (obs/lint.py: label names must be
        lower_snake_case)."""
        with self._lock:
            return [(s.name, s.labelsets()) for s in self._series.values()]

    def render(self) -> str:
        with self._lock:
            lines: list[str] = []
            for s in self._series.values():
                lines.extend(s.render())
        return "\n".join(lines) + "\n"


class MetricsEmitter:
    """The four actuation series
    (reference MetricsEmitter: internal/metrics/metrics.go:68-126)."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        # (namespace, variant) -> accelerator of the last emission
        self._last_accelerator: dict[tuple[str, str], str] = {}
        self.scaling_total = self.registry.counter(
            METRIC_SCALING_TOTAL, "Replica scaling decisions by direction"
        )
        self.desired_replicas = self.registry.gauge(
            METRIC_DESIRED_REPLICAS, "Optimizer-desired replicas per variant"
        )
        self.current_replicas = self.registry.gauge(
            METRIC_CURRENT_REPLICAS, "Observed replicas per variant"
        )
        self.desired_ratio = self.registry.gauge(
            METRIC_DESIRED_RATIO, "desired/current ratio (0->N encoded as N)"
        )

    def emit_replica_metrics(
        self,
        namespace: str,
        variant: str,
        accelerator: str,
        current: int,
        desired: int,
    ) -> None:
        """(reference EmitReplicaMetrics: internal/metrics/metrics.go:103-126)"""
        labels = {
            LABEL_OUT_NAMESPACE: namespace,
            LABEL_VARIANT: variant,
            LABEL_ACCELERATOR: accelerator,
        }
        # A shape migration (KEEP_ACCELERATOR=false) re-keys the variant's
        # series by accelerator; the old-shape gauges must be dropped or
        # HPA/adapter queries that aggregate over the variant keep reading
        # stale values forever.
        prev = self._last_accelerator.get((namespace, variant))
        if prev is not None and prev != accelerator:
            self._drop_gauges(namespace, variant, prev)
        self._last_accelerator[(namespace, variant)] = accelerator
        self.desired_replicas.set(labels, float(desired))
        self.current_replicas.set(labels, float(current))
        # scale-from-zero: ratio encodes the absolute target
        # (internal/metrics/metrics.go:118-124)
        ratio = float(desired) if current == 0 else float(desired) / float(current)
        self.desired_ratio.set(labels, ratio)
        if desired != current:
            direction = "up" if desired > current else "down"
            self.scaling_total.inc({**labels, LABEL_DIRECTION: direction})

    def _drop_gauges(self, namespace: str, variant: str, accelerator: str) -> None:
        """Remove the variant's gauge series for one accelerator keying —
        the single removal point for shape migrations and deletions (the
        scaling counter keeps its history; counters are cumulative)."""
        old = {
            LABEL_OUT_NAMESPACE: namespace,
            LABEL_VARIANT: variant,
            LABEL_ACCELERATOR: accelerator,
        }
        for series in (self.desired_replicas, self.current_replicas,
                       self.desired_ratio):
            series.remove(old)

    def prune_variants(self, active: set[tuple[str, str]]) -> None:
        """Drop gauge series of variants no longer managed — a deleted VA
        must not leave frozen desired/current/ratio values that HPA or
        the adapter keep reading (the reference never removes them,
        internal/metrics/metrics.go; a controller-restart-only cleanup).
        The scaling counter keeps its history (counters are cumulative)."""
        for key in list(self._last_accelerator):
            if key in active:
                continue
            ns, variant = key
            self._drop_gauges(ns, variant, self._last_accelerator.pop(key))


# Cycle-latency histogram names. All carry the
# inferno_ prefix asserted by `make lint-metrics` (obs/lint.py).
METRIC_CYCLE_DURATION = "inferno_cycle_duration_seconds"
METRIC_VARIANT_ANALYSIS = "inferno_variant_analysis_seconds"
METRIC_SOLVER_LATENCY = "inferno_solver_seconds"
METRIC_PROM_SCRAPE = "inferno_prom_scrape_seconds"

# Fleet-scale cycle instrumentation: Prometheus query volume
# (the coalesced collector turns Q x V round trips into ~Q — this
# counter is how you SEE that), per-cycle sizing-cache outcome counts
# (labelled result="hit"|"miss"), and the collect-pool width actually
# used per cycle.
METRIC_PROM_QUERIES = "inferno_cycle_prom_queries_total"
METRIC_SIZING_CACHE = "inferno_sizing_cache_lookups"
METRIC_COLLECT_CONCURRENCY = "inferno_collect_concurrency"
LABEL_RESULT = "result"

# Flight recorder (obs/recorder.py): cycles the bounded capture queue
# DROPPED because the writer thread (disk) could not keep up — the
# recorder's explicit never-stall-a-cycle tradeoff made visible.
METRIC_RECORDER_DROPPED = "inferno_recorder_dropped_total"
# incremental dirty-set cycle (parallel/incremental.py)
METRIC_DIRTY_LANES = "inferno_cycle_dirty_lanes_total"
METRIC_SKIPPED_SERVERS = "inferno_cycle_skipped_servers_total"
METRIC_DIRTY_RATIO = "inferno_cycle_dirty_ratio"

# Collect-pool width buckets: powers of two up to the practical ceiling
# of RECONCILE_CONCURRENCY (a thread per in-flight variant collect).
CONCURRENCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class CycleInstruments:
    """Latency histograms for the reconcile loop: whole-cycle duration,
    per-variant analysis (prepare) latency, assignment-solver latency,
    and Prometheus scrape latency. The per-variant analysis series is
    labeled (namespace, variant_name) and therefore participates in the
    deleted-variant pruning the gauges already get — frozen latency
    series of dead variants would misrepresent the fleet's percentiles
    forever (histogram buckets only ever grow)."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.cycle = self.registry.histogram(
            METRIC_CYCLE_DURATION, "Reconcile cycle wall-clock duration"
        )
        self.analysis = self.registry.histogram(
            METRIC_VARIANT_ANALYSIS,
            "Per-variant analysis (prepare) latency within a cycle",
        )
        self.solver = self.registry.histogram(
            METRIC_SOLVER_LATENCY, "Allocation assignment solver latency"
        )
        self.scrape = self.registry.histogram(
            METRIC_PROM_SCRAPE,
            "Prometheus query latency for load/metrics collection",
        )
        self.prom_queries = self.registry.counter(
            METRIC_PROM_QUERIES,
            "Prometheus queries issued by reconcile cycles",
        )
        self.cache_lookups = self.registry.gauge(
            METRIC_SIZING_CACHE,
            "Sizing-cache lookups of the last reconcile cycle by result "
            "(hit: candidate allocations reused; miss: variant re-solved)",
        )
        self.collect_concurrency = self.registry.histogram(
            METRIC_COLLECT_CONCURRENCY,
            "Concurrent collect workers used per reconcile cycle",
            buckets=CONCURRENCY_BUCKETS,
        )
        self.recorder_dropped = self.registry.counter(
            METRIC_RECORDER_DROPPED,
            "Reconcile cycles the flight recorder dropped because its "
            "bounded capture queue was full (slow disk)",
        )
        # incremental dirty-set cycle: registered
        # unconditionally like every instrument block; populated only
        # when the incremental fleet path ran this cycle
        self.dirty_lanes = self.registry.counter(
            METRIC_DIRTY_LANES,
            "Lanes re-solved through a sizing kernel by incremental "
            "reconcile cycles (clean lanes replay and are not counted)",
        )
        self.skipped_servers = self.registry.counter(
            METRIC_SKIPPED_SERVERS,
            "Servers whose sizing, writeback, and allocation were "
            "replayed untouched by incremental reconcile cycles",
        )
        self.dirty_ratio = self.registry.gauge(
            METRIC_DIRTY_RATIO,
            "Whether the variant was dirty (1) or replayed clean (0) in "
            "the last incremental reconcile cycle",
        )

    def observe_cycle(self, seconds: float) -> None:
        self.cycle.observe({}, seconds)

    def observe_analysis(self, namespace: str, variant: str, seconds: float) -> None:
        self.analysis.observe(
            {LABEL_OUT_NAMESPACE: namespace, LABEL_VARIANT: variant}, seconds
        )

    def observe_solver(self, seconds: float) -> None:
        self.solver.observe({}, seconds)

    def observe_scrape(self, seconds: float) -> None:
        self.scrape.observe({}, seconds)

    def count_prom_queries(self, n: int) -> None:
        if n > 0:
            self.prom_queries.inc({}, float(n))

    def set_cache_outcome(self, hits: int, misses: int) -> None:
        self.cache_lookups.set({LABEL_RESULT: "hit"}, float(hits))
        self.cache_lookups.set({LABEL_RESULT: "miss"}, float(misses))

    def observe_collect_concurrency(self, workers: int) -> None:
        self.collect_concurrency.observe({}, float(workers))

    def count_recorder_dropped(self, n: int) -> None:
        if n > 0:
            self.recorder_dropped.inc({}, float(n))

    def set_dirty_outcome(
        self, dirty_lanes: int, skipped: int,
        per_variant: list[tuple[str, str, bool]],
    ) -> None:
        """Publish one incremental cycle's dirty outcome: the fleet-wide
        counters plus the per-variant dirty marker gauge."""
        if dirty_lanes > 0:
            self.dirty_lanes.inc({}, float(dirty_lanes))
        if skipped > 0:
            self.skipped_servers.inc({}, float(skipped))
        for namespace, variant, dirty in per_variant:
            self.dirty_ratio.set(
                {LABEL_OUT_NAMESPACE: namespace, LABEL_VARIANT: variant},
                1.0 if dirty else 0.0,
            )

    def prune_variants(self, active: set[tuple[str, str]]) -> None:
        """Drop per-variant analysis/dirty series of variants no longer
        managed (same contract as MetricsEmitter.prune_variants)."""
        for series in (self.analysis, self.dirty_ratio):
            for labels in series.labelsets():
                key = (
                    labels.get(LABEL_OUT_NAMESPACE, ""),
                    labels.get(LABEL_VARIANT, ""),
                )
                if key not in active:
                    series.remove(labels)


# Predictive-scaling forecast series (forecast/forecaster.py). All carry
# the inferno_ prefix asserted by `make lint-metrics` (obs/lint.py).
METRIC_FORECAST_RATE = "inferno_forecast_arrival_rpm"
METRIC_FORECAST_BAND = "inferno_forecast_band_rpm"
METRIC_FORECAST_ERROR = "inferno_forecast_abs_error_rpm"


class ForecastInstruments:
    """Per-variant forecast gauges: the point estimate the sizing will
    consult one spin-up horizon ahead, the confidence band half-width,
    and the REALIZED absolute error of the previous one-step forecast —
    the operator's calibration check (a forecast error persistently
    above the band means the band_z knob is too tight). Labeled
    (namespace, variant_name) and pruned with the actuation gauges, so a
    deleted variant leaves no frozen forecast series behind."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.rate = self.registry.gauge(
            METRIC_FORECAST_RATE,
            "Forecast arrival rate (req/min) at the spin-up horizon",
        )
        self.band = self.registry.gauge(
            METRIC_FORECAST_BAND,
            "Forecast confidence-band half-width (req/min)",
        )
        self.error = self.registry.gauge(
            METRIC_FORECAST_ERROR,
            "Realized absolute error (req/min) of the last one-step forecast",
        )

    def _labels(self, namespace: str, variant: str) -> dict[str, str]:
        return {LABEL_OUT_NAMESPACE: namespace, LABEL_VARIANT: variant}

    def set_forecast(
        self,
        namespace: str,
        variant: str,
        rate_rpm: float,
        band_rpm: float,
        abs_error_rpm: float,
    ) -> None:
        labels = self._labels(namespace, variant)
        self.rate.set(labels, rate_rpm)
        self.band.set(labels, band_rpm)
        self.error.set(labels, abs_error_rpm)

    def prune_variants(self, active: set[tuple[str, str]]) -> None:
        """Drop forecast series of variants no longer managed (same
        contract as MetricsEmitter.prune_variants)."""
        for series in (self.rate, self.band, self.error):
            for _, (labels, _v) in list(series.values.items()):
                key = (labels.get(LABEL_OUT_NAMESPACE, ""),
                       labels.get(LABEL_VARIANT, ""))
                if key not in active:
                    series.remove(labels)


# SLO-attainment / model-error scoreboard series (obs/attainment.py).
# All carry the inferno_ prefix AND a unit suffix per obs/lint.py.
METRIC_MODEL_ERROR_TTFT = "inferno_model_error_ttft_ms"
METRIC_MODEL_ERROR_ITL = "inferno_model_error_itl_ms"
METRIC_SLO_ATTAINMENT = "inferno_slo_attainment_ratio"
METRIC_ERROR_BUDGET_BURN = "inferno_error_budget_burn_ratio"
LABEL_DIMENSION = "dimension"  # ttft | itl


class AttainmentInstruments:
    """Per-variant scoreboard gauges: EWMA |model error| for TTFT and
    ITL (how far the queueing model's prediction drifts from observed
    telemetry), the SLO-attainment ratio per latency dimension, and the
    error-budget burn rate (unattained fraction over the allowed
    fraction; > 1 = burning budget faster than the objective allows).
    Registered unconditionally, like the forecast gauges, so the metric
    catalog (and `make lint-metrics`) is independent of configuration;
    labeled (namespace, variant_name) and pruned with the actuation
    gauges."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.error_ttft = self.registry.gauge(
            METRIC_MODEL_ERROR_TTFT,
            "EWMA absolute model error of predicted vs observed TTFT",
        )
        self.error_itl = self.registry.gauge(
            METRIC_MODEL_ERROR_ITL,
            "EWMA absolute model error of predicted vs observed ITL",
        )
        self.attainment = self.registry.gauge(
            METRIC_SLO_ATTAINMENT,
            "EWMA fraction of cycles with observed latency within the SLO, "
            "per latency dimension",
        )
        self.burn = self.registry.gauge(
            METRIC_ERROR_BUDGET_BURN,
            "Error-budget burn rate: unattained fraction over the allowed "
            "fraction (>1 = burning faster than the objective allows)",
        )

    def _labels(self, namespace: str, variant: str) -> dict[str, str]:
        return {LABEL_OUT_NAMESPACE: namespace, LABEL_VARIANT: variant}

    def set_score(self, namespace: str, variant: str, score) -> None:
        """Publish one variant's obs.attainment.AttainmentScore.
        Dimensions without data (no SLO, never observed) emit nothing —
        a 0.0 attainment gauge would read as a total outage."""
        labels = self._labels(namespace, variant)
        # per-dimension gating: a variant whose engine reports only one
        # latency dimension must not publish a 0.0 "perfect model" gauge
        # for the other
        if score.ttft_error_scored:
            self.error_ttft.set(labels, score.ttft_error_ewma_ms)
        if score.itl_error_scored:
            self.error_itl.set(labels, score.itl_error_ewma_ms)
        if score.ttft_attainment is not None:
            self.attainment.set(
                {**labels, LABEL_DIMENSION: "ttft"}, score.ttft_attainment
            )
        if score.itl_attainment is not None:
            self.attainment.set(
                {**labels, LABEL_DIMENSION: "itl"}, score.itl_attainment
            )
        if score.ttft_attainment is not None or score.itl_attainment is not None:
            self.burn.set(labels, score.burn_rate)

    def prune_variants(self, active: set[tuple[str, str]]) -> None:
        """Drop scoreboard series of variants no longer managed (same
        contract as MetricsEmitter.prune_variants)."""
        for series in (self.error_ttft, self.error_itl, self.attainment,
                       self.burn):
            for _, (labels, _v) in list(series.values.items()):
                key = (labels.get(LABEL_OUT_NAMESPACE, ""),
                       labels.get(LABEL_VARIANT, ""))
                if key not in active:
                    series.remove(labels)


# Spot-market placement / preemption series (inferno_tpu/spot/). All
# carry the inferno_ prefix AND a unit suffix per obs/lint.py.
METRIC_SPOT_REPLICAS = "inferno_spot_replicas"
METRIC_RESERVED_HEADROOM = "inferno_reserved_headroom_chips"
METRIC_PREEMPTIONS = "inferno_preemptions_total"
LABEL_POOL = "pool"


class SpotInstruments:
    """Per-pool spot-market series: replicas the last solve placed on
    the preemptible tier, the reserved-headroom chips the pre-positioner
    holds free for the configured blast radius, and a counter of
    detected preemptions (a cycle observing a spot-placed variant's
    replicas below the previous desired count). Registered
    unconditionally, like the forecast gauges, so the metric catalog
    (and `make lint-metrics`) is independent of whether TPU_SPOT_POOLS
    is set; pools that stop placing spot zero their gauges rather than
    freeze them."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.spot_replicas = self.registry.gauge(
            METRIC_SPOT_REPLICAS,
            "Replicas placed on the pool's preemptible (spot) tier by the "
            "last solve",
        )
        self.headroom = self.registry.gauge(
            METRIC_RESERVED_HEADROOM,
            "Reserved chips the pre-positioner holds free to absorb the "
            "pool's configured spot blast radius",
        )
        self.preemptions = self.registry.counter(
            METRIC_PREEMPTIONS,
            "Detected spot preemptions: cycles observing a spot-placed "
            "variant's replicas below the previously desired count",
        )

    def set_pool(self, pool: str, spot_replicas: int,
                 headroom_chips: int) -> None:
        labels = {LABEL_POOL: pool}
        self.spot_replicas.set(labels, float(spot_replicas))
        self.headroom.set(labels, float(headroom_chips))

    def zero_missing_pools(self, live: set[str]) -> None:
        """Pools with a gauge series but no spot placement this cycle
        read 0, not their last value — an operator watching a drained
        pool must see the drain."""
        for series in (self.spot_replicas, self.headroom):
            for _, (labels, _v) in list(series.values.items()):
                if labels.get(LABEL_POOL, "") not in live:
                    series.set(labels, 0.0)

    def count_preemptions(self, pool: str, n: int) -> None:
        if n > 0:
            self.preemptions.inc({LABEL_POOL: pool}, float(n))


# Cycle-profiler series (obs/profiler.py). All carry the
# inferno_ prefix AND a unit suffix per obs/lint.py; the per-phase label
# set is bounded by the cycle's phase names (collect/analyze/solve/
# actuate), and the budget-burn gauges prune phases that stop appearing.
METRIC_PROFILE_PHASE = "inferno_profile_phase_seconds"
METRIC_PROFILE_PHASE_CPU = "inferno_profile_phase_cpu_seconds"
METRIC_PROFILE_BURN = "inferno_profile_budget_burn_ratio"
METRIC_PROFILE_EVENTS = "inferno_profile_events_total"
METRIC_PROFILE_COUNTER_MS = "inferno_profile_counter_ms"
METRIC_PROFILE_MEM_PEAK = "inferno_profile_mem_peak_bytes"
LABEL_PHASE = "phase"
LABEL_EVENT = "event"
LABEL_COUNTER = "counter"


class ProfilerInstruments:
    """Prometheus surface of the per-cycle profile documents: per-phase
    wall/CPU latency histograms, a per-phase budget-burn gauge (the
    fraction of the reconcile interval that phase consumed — burn > 1/N
    phases means the cycle is outgrowing its interval), the typed
    counters as labelled Prometheus counters (event counts and
    accumulated milliseconds kept in separate series so each keeps one
    unit), and the tracemalloc high-water gauge. Registered
    unconditionally, like every other instrument block, so the metric
    catalog (and `make lint-metrics`) is independent of whether
    CYCLE_PROFILER is on."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.phase = self.registry.histogram(
            METRIC_PROFILE_PHASE,
            "Wall-clock duration of one reconcile-cycle phase",
        )
        self.phase_cpu = self.registry.histogram(
            METRIC_PROFILE_PHASE_CPU,
            "Process-CPU time consumed during one reconcile-cycle phase",
        )
        self.burn = self.registry.gauge(
            METRIC_PROFILE_BURN,
            "Fraction of the reconcile interval the phase consumed last "
            "cycle (budget burn; the phases of a healthy cycle sum well "
            "below 1)",
        )
        self.events = self.registry.counter(
            METRIC_PROFILE_EVENTS,
            "Cycle-profiler event counts (jit compiles/dispatches, plan "
            "and solve memo hits/misses, ledger bulk-vs-heap paths)",
        )
        self.counter_ms = self.registry.counter(
            METRIC_PROFILE_COUNTER_MS,
            "Cycle-profiler accumulated milliseconds by attribution "
            "(jit compile vs execute, snapshot update, plan repack)",
        )
        self.mem_peak = self.registry.gauge(
            METRIC_PROFILE_MEM_PEAK,
            "tracemalloc traced-memory peak of the last profiled cycle "
            "(0 until PROFILE_TRACEMALLOC sampling is enabled)",
        )

    def observe_profile(self, doc: dict, interval_seconds: float) -> None:
        """Publish one per-cycle profile document (obs.profiler
        build_profile_doc output)."""
        phases = doc.get("phases", {})
        budget_s = max(float(interval_seconds), 1.0)
        for name, entry in phases.items():
            labels = {LABEL_PHASE: name}
            wall_ms = float(entry.get("wall_ms", 0.0))
            self.phase.observe(labels, wall_ms / 1000.0)
            if "cpu_ms" in entry:
                self.phase_cpu.observe(labels, float(entry["cpu_ms"]) / 1000.0)
            self.burn.set(labels, wall_ms / 1000.0 / budget_s)
        # prune burn gauges of phases that stopped appearing (e.g. a
        # cycle that exited before solve): a frozen burn value would
        # misreport the phase as still consuming budget
        for _, (labels, _v) in list(self.burn.values.items()):
            if labels.get(LABEL_PHASE, "") not in phases:
                self.burn.remove(labels)
        mem_seen = False
        for name, value in doc.get("counters", {}).items():
            if name.endswith("_ms"):
                if value > 0:
                    self.counter_ms.inc({LABEL_COUNTER: name}, float(value))
            elif name.endswith("_kb"):
                mem_seen = True
                self.mem_peak.set({}, float(value) * 1024.0)
            elif value > 0:
                self.events.inc({LABEL_EVENT: name}, float(value))
        if not mem_seen:
            # the documented contract: the series READS 0 until
            # PROFILE_TRACEMALLOC sampling is on — an absent series would
            # break absent-series alerts built on that promise
            self.mem_peak.set({}, 0.0)


# -- fleet-twin series -----------------------------------------------------------

METRIC_TWIN_EVENTS = "inferno_twin_events_total"
METRIC_TWIN_ADVANCE_MS = "inferno_twin_advance_ms"
METRIC_TWIN_ENGINES = "inferno_twin_engines_replicas"
LABEL_POLICY = "policy"


class TwinInstruments:
    """Prometheus surface of the vectorized fleet twin (twin/plant.py):
    decode-round events executed, virtual milliseconds advanced, and the
    emulated pool size, labelled by the closed-loop policy driving the
    plant. Registered unconditionally, like every other instrument
    block, so the metric catalog is independent of whether a twin run is
    in progress — a controller that never hosts a twin just exports the
    series at zero."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.events = self.registry.counter(
            METRIC_TWIN_EVENTS,
            "Decode-round engine-step events executed by the fleet twin "
            "(one per engine per vectorized round it participated in)",
        )
        self.advance_ms = self.registry.counter(
            METRIC_TWIN_ADVANCE_MS,
            "Virtual (emulated-clock) milliseconds the twin plant has "
            "been advanced through",
        )
        self.engines = self.registry.gauge(
            METRIC_TWIN_ENGINES,
            "Emulated engines in the twin plant's pool (allocated "
            "columns, enabled or not)",
        )

    def observe_plant(self, plant, policy: str = "") -> None:
        """Publish one twin plant's cumulative progress. Counters are
        monotone in the plant's own cumulative totals, so call this
        after each advance_to with the same plant/policy pair."""
        labels = {LABEL_POLICY: policy} if policy else {}
        delta = float(plant.events_total) - (self.events.get(labels) or 0.0)
        if delta > 0:
            self.events.inc(labels, delta)
        delta_ms = float(plant.now_ms) - (self.advance_ms.get(labels) or 0.0)
        if delta_ms > 0:
            self.advance_ms.inc(labels, delta_ms)
        self.engines.set(labels, float(plant.engines))


METRIC_EVENT_QUEUE_DEPTH = "inferno_event_queue_depth"
METRIC_SHARD_OWNED = "inferno_shard_owned_servers"
LABEL_SHARD = "shard"


class EventInstruments:
    """Prometheus surface of the event-driven reconcile path:
    the DirtyQueue's coalescing behavior and, under sharded controllers
    (controller/shard.py), each shard's owned-variant count. Registered
    unconditionally, like every other instrument block, so the metric
    catalog is independent of whether events or shards are in use — an
    interval-only controller just exports the series at zero."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.queue_depth = self.registry.gauge(
            METRIC_EVENT_QUEUE_DEPTH,
            "Dirty variants pending in the event DirtyQueue when the "
            "reconcile cycle drained it (coalesced distinct names, all "
            "sources: watch, lambda-delta, config)",
        )
        self.shard_owned = self.registry.gauge(
            METRIC_SHARD_OWNED,
            "Variants owned by each controller shard under the "
            "consistent-hash fleet partition (label: shard member name); "
            "unsharded controllers export nothing here",
        )

    def observe_drain(self, depth: int) -> None:
        """Publish the queue depth seen by the cycle's drain."""
        self.queue_depth.set({}, float(depth))

    def observe_shard(self, shard: str, owned: int) -> None:
        """Publish one shard's owned-variant count after a (re)partition."""
        self.shard_owned.set({LABEL_SHARD: shard}, float(owned))


class TLSConfig:
    """Serve-side TLS with cert reload (the reference uses certwatchers on
    its metrics endpoint, cmd/main.go:122-199). Certs are re-read when the
    file mtime changes — rotation (cert-manager, service CA) needs no
    restart."""

    def __init__(self, cert_file: str, key_file: str, min_version=None):
        import ssl

        self.cert_file = cert_file
        self.key_file = key_file
        self._mtime = 0.0
        self.ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self.ctx.minimum_version = min_version or ssl.TLSVersion.TLSv1_2
        # fail fast: a bad cert path would otherwise black-hole every
        # scrape with no diagnostic (wrap_socket failures are per-conn)
        self.ctx.load_cert_chain(cert_file, key_file)
        self._mtime = self._files_mtime()

    def _files_mtime(self) -> float:
        import os

        return max(os.path.getmtime(self.cert_file), os.path.getmtime(self.key_file))

    def maybe_reload(self) -> None:
        try:
            mtime = self._files_mtime()
            if mtime > self._mtime:
                self.ctx.load_cert_chain(self.cert_file, self.key_file)
                self._mtime = mtime
        except OSError:
            # mid-rotation race (files briefly absent): keep serving the
            # previously loaded certs and retry on the next connection
            return

    @classmethod
    def from_env(cls) -> "TLSConfig | None":
        from inferno_tpu_torch.config.defaults import env_str

        cert = env_str("METRICS_TLS_CERT_PATH")
        key = env_str("METRICS_TLS_KEY_PATH")
        if bool(cert) != bool(key):
            # Half-configured TLS must fail loudly, not silently serve
            # /metrics over plaintext.
            raise ValueError(
                "METRICS_TLS_CERT_PATH and METRICS_TLS_KEY_PATH must be set "
                f"together (cert={'set' if cert else 'unset'}, "
                f"key={'set' if key else 'unset'})"
            )
        return cls(cert, key) if cert and key else None


class _RouteServer:
    """Threaded HTTP(S) listener serving a map of path -> (query: dict)
    -> (code, content-type, body). The query dict holds the URL's query
    parameters (last value wins on repeats); routes that take no
    parameters simply ignore it."""

    def __init__(self, routes: dict, port: int, host: str = "", tls: TLSConfig | None = None):
        from urllib.parse import parse_qs, urlsplit

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                parsed = urlsplit(self.path)
                route = routes.get(parsed.path)
                query = {
                    k: v[-1]
                    for k, v in parse_qs(
                        parsed.query, keep_blank_values=True
                    ).items()
                }
                code, ctype, body = (
                    route(query) if route else (404, None, b"not found")
                )
                self.send_response(code)
                if ctype:
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request logging
                pass

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.tls = tls
        if tls is not None:
            # TLS handshake happens in the per-connection thread, never on
            # the accept loop: a client that connects and stays silent must
            # not block every other scrape/probe. Certs are re-checked per
            # connection, so rotation needs no restart.
            httpd = self.httpd
            plain_thread = type(httpd).process_request_thread

            def process_request_thread(request, client_address):
                import ssl as _ssl

                try:
                    tls.maybe_reload()
                    request.settimeout(10)  # bound the handshake
                    request = tls.ctx.wrap_socket(request, server_side=True)
                    request.settimeout(None)
                except (OSError, _ssl.SSLError):
                    httpd.shutdown_request(request)
                    return
                plain_thread(httpd, request, client_address)

            httpd.process_request_thread = process_request_thread
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _probe_routes(ready_flag: dict) -> dict:
    def readyz(query=None):
        if not ready_flag["ready"]:
            return (503, None, b"not ready")
        # Stale-controller detection: the reconciler heartbeats
        # `last_cycle_monotonic` after every cycle (and while idling as a
        # non-leader standby) and publishes the freshness budget as
        # `max_cycle_age_s` (3x the configured interval). A loop that
        # stopped cycling — deadlocked solver, hung Kube/Prom client —
        # fails readiness: the condition surfaces in `kubectl get pods`
        # and alerts instead of silently freezing the fleet at its last
        # decision. (Readiness alone does not restart the pod; operators
        # who want that wire the livenessProbe to /readyz, trading
        # restarts for standby safety.) Monotonic clock: wall steps must
        # not fake staleness. Before the first cycle completes there is
        # no heartbeat and no verdict — startup is governed by `ready`.
        last = ready_flag.get("last_cycle_monotonic")
        max_age = ready_flag.get("max_cycle_age_s", 0)
        if last is not None and max_age > 0:
            age = time.monotonic() - last
            if age > max_age:
                return (503, None,
                        f"stale: last reconcile cycle {age:.0f}s ago "
                        f"(budget {max_age:.0f}s)".encode())
        return (200, None, b"ok")

    return {"/healthz": lambda query=None: (200, None, b"ok"), "/readyz": readyz}


class HealthServer(_RouteServer):
    """/healthz + /readyz on the dedicated probe port (reference serves
    probes on their own port, cmd/main.go:250-257; the manager Deployment
    probes :8081). Readiness additionally fails when the reconcile loop's
    heartbeat goes stale — see _probe_routes."""

    def __init__(self, ready_flag: dict, port: int = 8081, host: str = ""):
        super().__init__(_probe_routes(ready_flag), port, host)


class _QueryError(ValueError):
    """Malformed /debug/* query parameters (rendered as a 400)."""


def _bad_query(e: "_QueryError"):
    return (400, "application/json", json.dumps({"error": str(e)}).encode())


def parse_debug_query(
    query: dict | None,
    str_params: frozenset[str] | set[str] = frozenset(),
    int_params: frozenset[str] | set[str] = frozenset(),
) -> dict:
    """THE query-parameter contract of every /debug/* route (decisions,
    attainment, profile): unknown parameters, empty string values, and
    non-positive/non-integer counts each raise _QueryError — a malformed
    request is a 400, never a silent full-payload download. Returns only
    the parameters present, validated and typed."""
    query = query or {}
    allowed = set(str_params) | set(int_params)
    unknown = sorted(set(query) - allowed)
    if unknown:
        raise _QueryError(
            f"unknown parameter(s) {unknown}; "
            f"supported: {', '.join(sorted(allowed))}"
        )
    out: dict = {}
    for key in sorted(str_params):
        if key in query:
            if not query[key]:
                raise _QueryError(f"{key} must be a non-empty value")
            out[key] = query[key]
    for key in sorted(int_params):
        if key in query:
            try:
                n = int(query[key])
            except ValueError:
                raise _QueryError(
                    f"{key} must be an integer, got {query[key]!r}"
                ) from None
            if n < 1:
                raise _QueryError(f"{key} must be >= 1, got {n}")
            out[key] = n
    return out


def _decisions_route(traces):
    """The /debug/decisions handler: the last-K cycle traces, optionally
    narrowed by query filters so a large-fleet ring is inspectable
    without downloading everything:

      ?cycles=<N>      only the newest N cycles
      ?variant=<id>    per cycle, only that variant's DecisionRecords
                       (matched on the record's full `variant` id); the
                       span tree is omitted — it is fleet-wide and would
                       dwarf the filtered payload

    Unknown or malformed parameters are a 400, never a silent
    full-ring download (parse_debug_query — shared with /debug/profile
    and /debug/attainment)."""

    def decisions(query=None):
        try:
            params = parse_debug_query(
                query, str_params={"variant"}, int_params={"cycles"}
            )
        except _QueryError as e:
            return _bad_query(e)
        variant = params.get("variant", "")
        cycles = traces.snapshot()
        if "cycles" in params:
            cycles = cycles[-params["cycles"]:]
        if variant:
            cycles = [
                {
                    **{k: v for k, v in cyc.items() if k != "spans"},
                    "decisions": [
                        d for d in cyc.get("decisions", [])
                        if d.get("variant") == variant
                    ],
                }
                for cyc in cycles
            ]
        body = json.dumps(
            {"capacity": traces.capacity, "cycles": cycles}, default=str
        )
        return (200, "application/json", body.encode())

    return decisions


def _attainment_route(attainment):
    """The /debug/attainment handler: the per-variant SLO-attainment /
    model-error scoreboard, optionally narrowed to one variant:

      ?variant=<id>    only that variant's scoreboard row (matched on
                       the full variant id; an unknown id returns an
                       empty `variants` map, mirroring the decisions
                       route's never-reported-variant semantics)

    Same 400-on-malformed contract as /debug/decisions
    (parse_debug_query)."""

    def route(query=None):
        try:
            params = parse_debug_query(query, str_params={"variant"})
        except _QueryError as e:
            return _bad_query(e)
        doc = attainment.snapshot()
        variant = params.get("variant", "")
        if variant:
            doc = {
                **doc,
                "variants": {
                    k: v for k, v in doc.get("variants", {}).items()
                    if k == variant
                },
            }
        return (200, "application/json", json.dumps(doc, default=str).encode())

    return route


def _profile_route(profiles):
    """The /debug/profile handler: the last-K per-cycle profile
    documents (obs/profiler.py) — per-phase wall/CPU attribution plus
    the typed counters — with filters matching /debug/decisions
    semantics:

      ?cycles=<N>      only the newest N cycles
      ?phase=<name>    per cycle, only that phase's attribution; the
                       fleet-wide counters map is omitted, mirroring how
                       the variant filter omits the span tree

    Unknown or malformed parameters are a 400 (parse_debug_query)."""

    def route(query=None):
        try:
            params = parse_debug_query(
                query, str_params={"phase"}, int_params={"cycles"}
            )
        except _QueryError as e:
            return _bad_query(e)
        cycles = profiles.snapshot()
        if "cycles" in params:
            cycles = cycles[-params["cycles"]:]
        phase = params.get("phase", "")
        if phase:
            cycles = [
                {
                    **{k: v for k, v in cyc.items() if k != "counters"},
                    "phases": {
                        k: v for k, v in cyc.get("phases", {}).items()
                        if k == phase
                    },
                }
                for cyc in cycles
            ]
        body = json.dumps(
            {"capacity": profiles.capacity, "cycles": cycles}, default=str
        )
        return (200, "application/json", body.encode())

    return route


class MetricsServer(_RouteServer):
    """Serves /metrics (plus the probe routes, for single-port setups) on
    a background thread. Given a TraceBuffer, also serves
    /debug/decisions: the last-K reconcile-cycle traces, each carrying
    its per-variant DecisionRecords — the operator's "why did replicas
    jump?" endpoint, with `?variant=`/`?cycles=` filters for large
    fleets. Given an obs.attainment.AttainmentTracker, also serves
    /debug/attainment: the per-variant SLO-attainment / model-error
    scoreboard, with `?variant=` filtering (docs/observability.md).
    Given a profile buffer (obs.TraceBuffer of per-cycle profile
    documents), also serves /debug/profile: the last-K cycles'
    per-phase wall/CPU/counter attribution with `?cycles=`/`?phase=`
    filters. All three debug routes share one query-param validation
    contract (parse_debug_query): malformed input is a 400."""

    def __init__(
        self,
        registry: Registry,
        port: int = 8443,
        host: str = "",
        tls: TLSConfig | None = None,
        traces=None,  # obs.TraceBuffer
        attainment=None,  # obs.attainment.AttainmentTracker
        profiles=None,  # obs.TraceBuffer of profile documents
    ):
        self.registry = registry
        self.traces = traces
        self.attainment = attainment
        self.profiles = profiles
        self.ready_flag = {"ready": True}

        def metrics(query=None):
            return (200, "text/plain; version=0.0.4", registry.render().encode())

        routes = {"/metrics": metrics, **_probe_routes(self.ready_flag)}
        if traces is not None:
            routes["/debug/decisions"] = _decisions_route(traces)
        if attainment is not None:
            routes["/debug/attainment"] = _attainment_route(attainment)
        if profiles is not None:
            routes["/debug/profile"] = _profile_route(profiles)
        super().__init__(routes, port, host, tls=tls)
