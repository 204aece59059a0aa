"""Load/metrics collection from the serving engines via Prometheus.

Capability parity with upstream internal/collector/collector.go:
87-285, engine-pluggable (vllm-tpu / jetstream vocabularies from
`inferno_tpu.controller.engines`) instead of hardcoded vLLM names.

Port copy of `inferno_tpu/controller/collector.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
import math
import re
import time

from inferno_tpu_torch.controller.crd import (
    REASON_METRICS_FOUND,
    REASON_METRICS_MISSING,
    REASON_METRICS_STALE,
    REASON_PROMETHEUS_ERROR,
    ACCELERATOR_LABEL,
    CurrentAlloc,
    LoadProfile,
    VariantAutoscaling,
)
from inferno_tpu_torch.controller.engines import (
    GATEWAY_MODEL_LABEL,
    LABEL_NAMESPACE,
    EngineMetrics,
)
from inferno_tpu_torch.controller.promclient import PromClient, PromError, Sample

STALENESS_LIMIT_SECONDS = 300.0  # 5 min (reference: collector.go:139-149)

# Last-resort fallback only: the collector prefers the engine-reported max
# batch, then the CR profile's maxBatchSize (the reference hardcodes this
# 256 with a TODO, collector.go:257-259 — that wart is fixed here).
DEFAULT_MAX_BATCH = 256


@dataclasses.dataclass(frozen=True)
class MetricsValidation:
    """(reference MetricsValidationResult: collector.go:79-84).

    `running` carries the probed num_requests_running sum (the validation
    query's own payload): the profile corrector uses it as the observed
    fleet concurrency without a sixth query."""

    available: bool
    reason: str
    message: str
    running: float = 0.0


def fix_value(x: float) -> float:
    """NaN/Inf -> 0 (reference FixValue: collector.go:281-285)."""
    if math.isnan(x) or math.isinf(x):
        return 0.0
    return x


def _selector(engine: EngineMetrics, model: str, namespace: str | None) -> str:
    parts = [f'{engine.model_label}="{model}"']
    if namespace is not None:
        parts.append(f'{LABEL_NAMESPACE}="{namespace}"')
    return "{" + ",".join(parts) + "}"


def _rate_ratio(engine: EngineMetrics, num: str, den: str, model: str, ns: str) -> str:
    sel = _selector(engine, model, ns)
    return f"sum(rate({num}{sel}[1m]))/sum(rate({den}{sel}[1m]))"


def _first_value(samples: list[Sample]) -> float:
    return fix_value(samples[0].value) if samples else 0.0


def validate_metrics_availability(
    prom: PromClient, engine: EngineMetrics, model: str, namespace: str
) -> MetricsValidation:
    """Probe one engine series for presence and freshness, with a
    namespace-less fallback for emulators
    (reference ValidateMetricsAvailability: collector.go:87-156)."""
    query = f"{engine.num_requests_running}{_selector(engine, model, namespace)}"
    try:
        samples = prom.query(query)
    except PromError as e:
        return MetricsValidation(False, REASON_PROMETHEUS_ERROR, f"Failed to query Prometheus: {e}")

    if not samples:
        fallback = f"{engine.num_requests_running}{_selector(engine, model, None)}"
        try:
            samples = prom.query(fallback)
        except PromError as e:
            return MetricsValidation(
                False, REASON_PROMETHEUS_ERROR, f"Failed to query Prometheus: {e}"
            )
        if not samples:
            return MetricsValidation(
                False,
                REASON_METRICS_MISSING,
                f"No {engine.name} metrics found for model '{model}' in namespace "
                f"'{namespace}'. Check ServiceMonitor configuration and that serving "
                "pods expose /metrics.",
            )

    now = time.time()
    for s in samples:
        age = now - s.timestamp
        if age > STALENESS_LIMIT_SECONDS:
            return MetricsValidation(
                False,
                REASON_METRICS_STALE,
                f"{engine.name} metrics for model '{model}' are stale "
                f"(last update {age:.0f}s ago).",
            )
    return MetricsValidation(
        True,
        REASON_METRICS_FOUND,
        f"{engine.name} metrics are available and fresh",
        running=sum(fix_value(s.value) for s in samples),
    )


def _observed_max_batch(
    prom: PromClient,
    engine: EngineMetrics,
    model: str,
    ns: str,
    va: VariantAutoscaling,
    accelerator: str,
) -> int:
    """Max concurrent batch for CurrentAlloc, in preference order: the
    engine-reported series (per-replica max, so `max()` across pods), the
    CR profile's maxBatchSize for the current slice shape, then the
    constant fallback. Replaces the reference's hardcoded 256
    (collector.go:257-259)."""
    if engine.max_batch_metric:
        try:
            samples = prom.query(
                f"max({engine.max_batch_metric}{_selector(engine, model, ns)})"
            )
        except PromError:
            samples = []  # batch is advisory; never fail the collection over it
        if not samples:
            try:
                samples = prom.query(
                    f"max({engine.max_batch_metric}{_selector(engine, model, None)})"
                )
            except PromError:
                samples = []
        value = int(_first_value(samples))
        if value > 0:
            return value
    for prof in va.spec.accelerators:
        if prof.acc == accelerator and prof.max_batch_size > 0:
            return prof.max_batch_size
    return DEFAULT_MAX_BATCH


def collect_sleeping_alloc(
    prom: PromClient,
    engine: EngineMetrics,
    va: VariantAutoscaling,
    workload,
) -> CurrentAlloc:
    """CurrentAlloc for a variant scaled to ZERO replicas
    (WVA_SCALE_TO_ZERO): every engine series died with the pods, so the
    only live demand signal is the gateway-side request counter
    (engine.gateway_request_total — e.g. the llm-d inference-gateway's
    per-model series, which exist independently of engine pods). The load
    SHAPE (avg in/out tokens) is reused from the last observed cycle
    persisted in CR status — no token telemetry exists while asleep, and
    the profile-anchor default (128/128) covers a variant that never ran.

    This is the metric-series stranding mitigation: without it, a
    scaled-to-zero variant is skipped as MetricsMissing forever (stale
    desired gauge, KEDA fallback firing), and demand can never wake it.
    Raises PromError on query failure like collect_current_alloc."""
    ns = workload.namespace or va.namespace
    model = va.spec.model_id
    arrival = 0.0
    if engine.gateway_request_total:
        # The gateway names models with ITS label convention
        # (GATEWAY_MODEL_LABEL), never the engine's — a JetStream
        # variant's wake query must not filter on `id`. NO namespace-less
        # fallback here (unlike validate_metrics_availability's
        # presence probe): this value feeds the optimizer directly, and
        # a fallback would let another namespace's traffic for the same
        # model wake — and keep re-provisioning — a variant with zero
        # real demand.
        sel = f'{{{GATEWAY_MODEL_LABEL}="{model}",{LABEL_NAMESPACE}="{ns}"}}'
        samples = prom.query(
            f"sum(rate({engine.gateway_request_total}{sel}[1m]))"
        )
        arrival = _first_value(samples) * 60.0  # req/sec -> req/min
    last = va.status.current_alloc.load
    accelerator = va.labels.get(ACCELERATOR_LABEL, "")
    return CurrentAlloc(
        accelerator=accelerator,
        num_replicas=0,
        max_batch=_observed_max_batch(prom, engine, model, ns, va, accelerator),
        variant_cost=0.0,
        itl_average=0.0,
        ttft_average=0.0,
        load=LoadProfile(
            arrival_rate=arrival,
            # 128/128 fallback = the profile-calibration anchor shape
            # (models/profiles.TTFT_ANCHOR_TOKENS; not imported — that
            # module pulls numpy into this otherwise-stdlib path)
            avg_input_tokens=last.avg_input_tokens or 128.0,
            avg_output_tokens=last.avg_output_tokens or 128.0,
        ),
    )


def collect_current_alloc(
    prom: PromClient,
    engine: EngineMetrics,
    va: VariantAutoscaling,
    workload,
    accelerator_cost: float,
) -> CurrentAlloc:
    """Build the observed CurrentAlloc from five Prometheus queries plus
    workload state (reference AddMetricsToOptStatus: collector.go:158-278).

    `workload` is a controller.workload.Workload: replicas are counted in
    REPLICA units — pods for a Deployment, whole pod groups for a
    multi-host LeaderWorkerSet — so a v5e-16 slice spanning 4 hosts reads
    as 1 replica, not 4 pods (replaces the reference's 1-replica=1-pod
    assumption, collector.go:243-244).

    Raises PromError on query failure (callers skip the variant for this
    cycle, like the reference).
    """
    ns = workload.namespace or va.namespace
    model = va.spec.model_id
    sel = _selector(engine, model, ns)

    arrival = _first_value(
        prom.query(f"sum(rate({engine.request_success_total}{sel}[1m]))")
    ) * 60.0  # req/sec -> req/min (collector.go:217)
    avg_in = _first_value(
        prom.query(_rate_ratio(engine, engine.prompt_tokens_sum, engine.prompt_tokens_count, model, ns))
    )
    avg_out = _first_value(
        prom.query(_rate_ratio(engine, engine.generation_tokens_sum, engine.generation_tokens_count, model, ns))
    )
    ttft_ms = _first_value(
        prom.query(_rate_ratio(engine, engine.ttft_seconds_sum, engine.ttft_seconds_count, model, ns))
    ) * 1000.0
    itl_ms = _first_value(
        prom.query(_rate_ratio(engine, engine.tpot_seconds_sum, engine.tpot_seconds_count, model, ns))
    ) * 1000.0

    replicas = workload.replicas
    accelerator = va.labels.get(ACCELERATOR_LABEL, "")
    return CurrentAlloc(
        accelerator=accelerator,
        num_replicas=replicas,
        max_batch=_observed_max_batch(prom, engine, model, ns, va, accelerator),
        variant_cost=replicas * accelerator_cost,
        itl_average=itl_ms,
        ttft_average=ttft_ms,
        load=LoadProfile(
            arrival_rate=arrival,
            avg_input_tokens=avg_in,
            avg_output_tokens=avg_out,
        ),
    )


# -- coalesced (grouped) collection ------------------------------------------
#
# The per-variant path above issues ~6 queries per variant per cycle: at
# "hundreds of variants" scale the cycle is O(variants x queries) round
# trips. The grouped path issues ONE PromQL per metric, selecting every
# active variant with regex matchers and splitting per variant with
# `by (<model label>, namespace)` — Q queries total, fanned back out to
# per-variant CurrentAllocs. A variant missing from the grouped presence
# probe falls back to its per-variant queries (emulator setups without a
# namespace label, engines mid-rollout), so the grouped path is an
# optimization, never a new failure mode.


def _promql_quote(regex: str) -> str:
    """Escape a regex for embedding in a PromQL double-quoted string.

    PromQL string literals follow Go escape rules, so the backslashes
    `re.escape` emits (`\\.`, `\\-`) are INVALID escape sequences at the
    string layer — real Prometheus rejects the whole query with "unknown
    escape sequence". Doubling them makes the string literal unescape
    back to the intended regex."""
    return regex.replace("\\", "\\\\").replace('"', '\\"')


def _group_selector(engine: EngineMetrics, pairs: set[tuple[str, str]]) -> str:
    """Regex label selector covering all active (model, namespace) pairs.

    Values are regex-escaped (model ids routinely contain `.` and `/`),
    then string-escaped for the PromQL literal; Prometheus anchors label
    regexes, so alternation is exact-match per value. The selector is the
    cross product of models x namespaces — over-selection is harmless
    because the fan-out only reads the keys it asked for."""
    models = _promql_quote("|".join(sorted({re.escape(m) for m, _ in pairs})))
    namespaces = _promql_quote(
        "|".join(sorted({re.escape(ns) for _, ns in pairs}))
    )
    return (
        f'{{{engine.model_label}=~"{models}",'
        f'{LABEL_NAMESPACE}=~"{namespaces}"}}'
    )


def grouped_queries(engine: EngineMetrics, pairs: set[tuple[str, str]]) -> dict[str, str]:
    """The coalesced per-metric PromQL, keyed by FleetSamples field name.
    ~Q queries regardless of variant count (7 with a max-batch metric)."""
    sel = _group_selector(engine, pairs)
    by = f" by ({engine.model_label}, {LABEL_NAMESPACE})"

    def ratio(num: str, den: str) -> str:
        return (
            f"sum(rate({num}{sel}[1m])){by}"
            f"/sum(rate({den}{sel}[1m])){by}"
        )

    queries = {
        "running": f"sum({engine.num_requests_running}{sel}){by}",
        "arrival": f"sum(rate({engine.request_success_total}{sel}[1m])){by}",
        "avg_in": ratio(engine.prompt_tokens_sum, engine.prompt_tokens_count),
        "avg_out": ratio(engine.generation_tokens_sum, engine.generation_tokens_count),
        "ttft": ratio(engine.ttft_seconds_sum, engine.ttft_seconds_count),
        "itl": ratio(engine.tpot_seconds_sum, engine.tpot_seconds_count),
    }
    if engine.max_batch_metric:
        queries["max_batch"] = f"max({engine.max_batch_metric}{sel}){by}"
    return queries


@dataclasses.dataclass
class FleetSamples:
    """Per-(model, namespace) values from one cycle's coalesced queries.

    `running` doubles as the presence/freshness probe: a variant whose
    key is absent here takes the per-variant fallback path. Timestamps
    ride along so the staleness check survives coalescing (real
    Prometheus instant vectors already exclude series beyond the
    staleness lookback, which equals STALENESS_LIMIT_SECONDS)."""

    engine: EngineMetrics
    running: dict[tuple[str, str], tuple[float, float]] = dataclasses.field(
        default_factory=dict
    )  # key -> (summed value, newest timestamp)
    arrival: dict[tuple[str, str], float] = dataclasses.field(default_factory=dict)
    avg_in: dict[tuple[str, str], float] = dataclasses.field(default_factory=dict)
    avg_out: dict[tuple[str, str], float] = dataclasses.field(default_factory=dict)
    ttft: dict[tuple[str, str], float] = dataclasses.field(default_factory=dict)
    itl: dict[tuple[str, str], float] = dataclasses.field(default_factory=dict)
    max_batch: dict[tuple[str, str], float] = dataclasses.field(default_factory=dict)
    queries_issued: int = 0

    def has(self, model: str, namespace: str) -> bool:
        return (model, namespace) in self.running


def _fan_out(
    engine: EngineMetrics, samples: list[Sample]
) -> dict[tuple[str, str], tuple[float, float]]:
    """Grouped vector -> {(model, namespace): (value, newest ts)}.
    Samples missing either grouping label (an emulator exposition with no
    namespace label) are dropped — those variants take the fallback."""
    out: dict[tuple[str, str], tuple[float, float]] = {}
    for s in samples:
        model = s.labels.get(engine.model_label)
        ns = s.labels.get(LABEL_NAMESPACE)
        if model is None or ns is None:
            continue
        prev = out.get((model, ns))
        if prev is None:
            out[(model, ns)] = (fix_value(s.value), s.timestamp)
        else:  # defensive: one group should appear once per vector
            out[(model, ns)] = (prev[0] + fix_value(s.value),
                                max(prev[1], s.timestamp))
    return out


def collect_fleet_samples(
    prom: PromClient, engine: EngineMetrics, pairs: set[tuple[str, str]]
) -> FleetSamples | None:
    """Issue the ~Q coalesced queries for all active variants. Returns
    None when any grouped query fails (a Prometheus outage fails in Q
    queries, not Q x V; callers then run the per-variant path whose
    per-variant PromErrors keep today's skip/error isolation)."""
    if not pairs:
        return None
    fleet = FleetSamples(engine=engine)
    try:
        for field, promql in grouped_queries(engine, pairs).items():
            table = _fan_out(engine, prom.query(promql))
            fleet.queries_issued += 1
            if field == "running":
                fleet.running = table
            else:
                getattr(fleet, field).update(
                    {k: v for k, (v, _ts) in table.items()}
                )
    except PromError:
        return None
    return fleet


def validate_from_fleet(
    fleet: FleetSamples, model: str, namespace: str
) -> MetricsValidation | None:
    """MetricsValidation from the coalesced presence probe; None when the
    variant is absent from the grouped response (caller falls back to
    validate_metrics_availability, which keeps the namespace-less
    emulator fallback and the exact per-variant messages)."""
    entry = fleet.running.get((model, namespace))
    if entry is None:
        return None
    value, ts = entry
    age = time.time() - ts
    if age > STALENESS_LIMIT_SECONDS:
        return MetricsValidation(
            False,
            REASON_METRICS_STALE,
            f"{fleet.engine.name} metrics for model '{model}' are stale "
            f"(last update {age:.0f}s ago).",
        )
    return MetricsValidation(
        True,
        REASON_METRICS_FOUND,
        f"{fleet.engine.name} metrics are available and fresh",
        running=value,
    )


def collect_alloc_from_fleet(
    fleet: FleetSamples,
    va: VariantAutoscaling,
    workload,
    accelerator_cost: float,
) -> CurrentAlloc | None:
    """CurrentAlloc from the coalesced tables — the fan-out counterpart
    of collect_current_alloc, zero additional queries. None when the
    presence probe never saw the variant (fallback path). A missing
    per-metric group with the variant present means the underlying rate
    is empty — the same 0.0 an empty per-variant vector produces."""
    ns = workload.namespace or va.namespace
    model = va.spec.model_id
    key = (model, ns)
    if key not in fleet.running:
        return None

    def val(table: dict[tuple[str, str], float]) -> float:
        return fix_value(table.get(key, 0.0))

    replicas = workload.replicas
    accelerator = va.labels.get(ACCELERATOR_LABEL, "")
    # max batch preference order matches _observed_max_batch: the grouped
    # engine-reported value, the CR profile for the current shape, the
    # constant fallback. (No namespace-less retry here: a variant present
    # in the grouped probe exposes namespaced series.)
    max_batch = int(val(fleet.max_batch))
    if max_batch <= 0:
        max_batch = 0
        for prof in va.spec.accelerators:
            if prof.acc == accelerator and prof.max_batch_size > 0:
                max_batch = prof.max_batch_size
                break
        if max_batch <= 0:
            max_batch = DEFAULT_MAX_BATCH
    return CurrentAlloc(
        accelerator=accelerator,
        num_replicas=replicas,
        max_batch=max_batch,
        variant_cost=replicas * accelerator_cost,
        itl_average=val(fleet.itl) * 1000.0,
        ttft_average=val(fleet.ttft) * 1000.0,
        load=LoadProfile(
            arrival_rate=val(fleet.arrival) * 60.0,  # req/sec -> req/min
            avg_input_tokens=val(fleet.avg_in),
            avg_output_tokens=val(fleet.avg_out),
        ),
    )
