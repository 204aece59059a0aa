"""Metric-catalog lint (`make lint-metrics`).

Asserts every series the controller registers carries (1) non-empty help
text that (2) does more than restate the metric name, (3) the `inferno_`
name prefix, (4) a unit suffix from the house convention, and (5) only
lower_snake_case label names on sampled series — the properties
docs/observability.md relies on to stay a complete, readable catalogue.
Runs as a CLI (wired into the Makefile) and from
tests/test_metrics_lint.py, both against the same registry construction
the production entry point uses. Its source-code sibling is the
invariant analyzer (`make lint-invariants`, docs/analysis.md).

Port of `inferno_tpu/obs/lint.py`, verbatim apart from its imports: it
lints the port's own registry (`inferno_tpu_torch.controller.metrics`).
Run it with ``python -m inferno_tpu_torch.obs.lint``.
"""

from __future__ import annotations

import math
import re
import sys

METRIC_NAME_PREFIX = "inferno_"

# Prometheus-conventional label names: lower_snake_case, no leading
# digit/underscore ("le" is the histogram bucket label and passes).
LABEL_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def _normalize(text: str) -> str:
    """Case/punctuation-insensitive comparison form for the
    help-duplicates-name rule: 'Inferno_Cycle-Dirty lanes  total' and
    'inferno_cycle_dirty_lanes_total' normalize identically."""
    return re.sub(r"[^a-z0-9]+", " ", text.lower()).strip()

# Unit-suffix convention: every series name ends in the unit it is
# measured in. `_total` marks counters (unitless cumulative counts),
# `_ratio` dimensionless gauges, the rest physical units (`_chips` and
# `_replicas` are the capacity units of the spot/fleet gauges;
# `_bytes` the profiler's memory high-water gauge; `_servers`
# the shard-partition ownership unit).
UNIT_SUFFIXES = ("_seconds", "_ms", "_total", "_ratio", "_rpm", "_chips",
                 "_replicas", "_bytes", "_servers")

# Grandfathered pre-convention names: these shipped before the suffix
# rule and are part of the external actuation/dashboard contract, so
# renaming them would break HPA/KEDA queries. New series must NOT be
# added here without a contract-level reason. (The two *_replicas
# entries predate `_replicas` joining UNIT_SUFFIXES and are now
# redundant; they stay pinned because the membership is an external
# contract, not a style list.)
UNIT_SUFFIX_ALLOWLIST = frozenset({
    "inferno_desired_replicas",  # HPA/KEDA actuation contract
    "inferno_current_replicas",  # HPA/KEDA actuation contract
    "inferno_sizing_cache_lookups",  # cycle instrument
    "inferno_collect_concurrency",  # cycle instrument
    # matches controller-runtime's conventional `workqueue_depth` shape
    # so fleet dashboards can treat the event queue like any kube
    # controller workqueue
    "inferno_event_queue_depth",
})


def lint_registry(registry) -> list[str]:
    """Violations in a `controller.metrics.Registry`; empty means clean."""
    violations: list[str] = []
    for name, help_, kind in registry.catalog():
        if not name.startswith(METRIC_NAME_PREFIX):
            violations.append(
                f"{name} ({kind}): missing the {METRIC_NAME_PREFIX!r} name prefix"
            )
        if not help_.strip():
            violations.append(f"{name} ({kind}): empty help text")
        if (
            not name.endswith(UNIT_SUFFIXES)
            and name not in UNIT_SUFFIX_ALLOWLIST
        ):
            violations.append(
                f"{name} ({kind}): missing a unit suffix "
                f"({'|'.join(UNIT_SUFFIXES)}) and not allowlisted"
            )
        # help must DESCRIBE the series, not restate its name:
        # a dashboard tooltip reading "inferno cycle dirty lanes total"
        # under inferno_cycle_dirty_lanes_total documents nothing
        norm_help = _normalize(help_)
        if norm_help and norm_help in (
            _normalize(name),
            _normalize(name.removeprefix(METRIC_NAME_PREFIX)),
        ):
            violations.append(
                f"{name} ({kind}): help text merely restates the metric "
                f"name; describe what the series measures"
            )
    # histogram bucket sanity: boundaries must be strictly
    # increasing and finite. The registry constructor only rejects
    # unsorted/empty tuples — duplicates and infinities pass it, and
    # either renders broken cumulative counts (a duplicated `le` emits
    # two conflicting lines; an explicit +Inf boundary collides with the
    # synthesized overflow bucket).
    for name, buckets in getattr(registry, "histograms", lambda: [])():
        if any(not math.isfinite(b) for b in buckets):
            violations.append(
                f"{name} (histogram): non-finite bucket boundary in "
                f"{tuple(buckets)} (the +Inf bucket is synthesized; "
                f"explicit inf/nan boundaries corrupt the exposition)"
            )
        elif any(b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])):
            violations.append(
                f"{name} (histogram): bucket boundaries not strictly "
                f"increasing: {tuple(buckets)}"
            )
    # label-name convention: every label key on a live sample
    # is lower_snake_case, so PromQL selectors stay guessable and the
    # grouped-collection regex joins (`by (model_label, namespace)`)
    # never quote-escape. Checked over sampled labelsets — the catalog
    # itself is label-free, so the suite emits representative samples.
    flagged: set[tuple[str, str]] = set()
    for name, labelsets in getattr(registry, "labelsets", lambda: [])():
        for labels in labelsets:
            for key in labels:
                if key != "le" and not LABEL_NAME_RE.match(key) and (
                    name, key
                ) not in flagged:
                    flagged.add((name, key))
                    violations.append(
                        f"{name}: label name {key!r} is not lower_snake_case"
                    )
    return violations


def build_controller_registry():
    """The full production metric catalog, exactly as main() assembles
    it: the four actuation series (MetricsEmitter), the cycle-latency
    histograms + fleet-cycle instruments + recorder drop counter
    (CycleInstruments), the predictive-scaling forecast gauges
    (ForecastInstruments), the SLO-attainment / model-error scoreboard
    gauges (AttainmentInstruments), the spot-market placement /
    preemption series (SpotInstruments), the cycle-profiler series
    (ProfilerInstruments), the fleet-twin progress series
    (TwinInstruments), and the event-driven reconcile series
    (EventInstruments) — each registered unconditionally, like the
    Reconciler does, so the catalog is identical whatever features are
    enabled."""
    from inferno_tpu_torch.controller.metrics import (
        AttainmentInstruments,
        CycleInstruments,
        EventInstruments,
        ForecastInstruments,
        MetricsEmitter,
        ProfilerInstruments,
        Registry,
        SpotInstruments,
        TwinInstruments,
    )

    registry = Registry()
    MetricsEmitter(registry)
    CycleInstruments(registry)
    ForecastInstruments(registry)
    AttainmentInstruments(registry)
    SpotInstruments(registry)
    ProfilerInstruments(registry)
    TwinInstruments(registry)
    EventInstruments(registry)
    return registry


def main() -> int:
    registry = build_controller_registry()
    violations = lint_registry(registry)
    for v in violations:
        print(f"lint-metrics: {v}", file=sys.stderr)
    if violations:
        return 1
    print(f"lint-metrics: {len(list(registry.catalog()))} series clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
