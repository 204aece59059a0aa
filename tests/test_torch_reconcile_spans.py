"""The reconcile cycle's own spans and counters (`controller/reconciler.py`):
each phase of `run_cycle` is an `obs.profiler.span` charged to the cycle's
profile, the cycle's finish (after its profile is sealed) is charged to
the profiler active around the cycle, and the status writes that land and
the collect fallbacks are counted. Observation only: decisions are bit-identical with
the cycle profiler on and off. On the CPU, 60 variants."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from inferno_tpu_torch.config.types import ServiceClassSpec
from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
from inferno_tpu_torch.controller.kube import Conflict
from inferno_tpu_torch.obs import CycleProfiler
from inferno_tpu_torch.parallel import reset_fleet_state
from inferno_tpu_torch.testing.fleet import (
    FLEET_NS,
    fleet_cluster,
    fleet_fake_prom,
    fleet_model,
    fleet_variant,
)

N = 60
PHASES = ("reconcile_collect_ms", "reconcile_analyze_ms", "reconcile_solve_ms",
          "reconcile_actuate_ms")


def _rows(cycle: int) -> dict:
    """Cycle `cycle`'s Prometheus table: every 7th variant idle, the
    others' rates drawn afresh, latencies on a line the corrector accepts."""
    rng = np.random.default_rng([N, cycle])
    rows = {}
    for i in range(N):
        idle = i % 7 == 6
        running = 0.0 if idle else float(rng.uniform(1.0, 8.0))
        rows[(fleet_model(i), FLEET_NS)] = {
            "running": running,
            "arrival_rps": 0.0 if idle else float(rng.uniform(0.5, 8.0)),
            "in_tokens": 0.0 if idle else 128.0, "out_tokens": 0.0 if idle else 128.0,
            "ttft_s": 0.0 if idle else (5.0 + 0.02 * 128.0 * running) / 1e3,
            "itl_s": 0.0 if idle else (18.0 + 0.3 * running) / 1e3,
            "max_batch": 64.0,
        }
    return rows


def _reconciler(**cfg):
    reset_fleet_state()
    cluster = fleet_cluster(N)
    rec = Reconciler(cluster, fleet_fake_prom(_rows(0)),
                     ReconcilerConfig(compute_backend="torch", compute_device="cpu", **cfg))
    return rec, cluster


def _status(cluster, i: int) -> dict:
    st = cluster.get_variant_autoscaling(FLEET_NS, fleet_variant(i)).status.to_dict()
    st["desiredOptimizedAlloc"].pop("lastRunTime", None)
    for c in st.get("conditions", []):
        c.pop("lastTransitionTime", None)
    return st


def test_phases_charge_the_cycle_and_the_finish_the_outer_profiler():
    rec, _ = _reconciler()
    outer = CycleProfiler().activate()
    try:
        report = rec.run_cycle()
    finally:
        outer.deactivate()
        rec.close()
    assert report.optimization_ok and not report.errors, report.errors[:3]
    counters = report.profile["counters"]
    for name in PHASES:
        assert counters[name] > 0.0, (name, counters)
    assert counters["status_writes"] == report.variants_applied == N
    assert counters["collect_fallback_variants"] == 0
    assert "reconcile_finish_ms" not in counters
    # the outer profiler sees the finish and none of the cycle's own spans
    assert set(outer.counters) == {"reconcile_finish_ms"}, outer.counters
    assert outer.counters["reconcile_finish_ms"] > 0.0
    # the phases' spans sit inside the tracer's phases of the same names
    phases = report.profile["phases"]
    for name in PHASES:
        phase = name[len("reconcile_"):-len("_ms")]
        assert counters[name] <= phases[phase]["wall_ms"] + 1e-3, (name, phases)


def test_a_grouped_miss_counts_every_variant_that_fell_back():
    """With the grouped queries unanswered, every variant takes its own
    per-variant queries, and each is counted once."""
    rec, _ = _reconciler()
    rec.prom = fleet_fake_prom(_rows(0), grouped=False)
    try:
        report = rec.run_cycle()
    finally:
        rec.close()
    assert report.optimization_ok and not report.errors, report.errors[:3]
    assert report.profile["counters"]["collect_fallback_variants"] == N
    assert report.profile["counters"]["status_writes"] == N


def test_slo_lookups_do_not_scan_the_class_lists(monkeypatch):
    """A cycle answers its SLO lookups from its per-class index, never by
    `ServiceClassSpec.target_for`'s scan of the list (one scan per variant
    over a class listing every model is quadratic in the fleet), and
    leaves each class's list as the shipped entries followed by one
    model-key entry per prepared variant, in variant order."""
    calls = []
    scan = ServiceClassSpec.target_for
    monkeypatch.setattr(ServiceClassSpec, "target_for",
                        lambda sc, model: calls.append(model) or scan(sc, model))
    rec, _ = _reconciler()
    read = rec.read_service_classes
    shipped = [[dataclasses.replace(t) for t in sc.model_targets] for sc in read()]
    seen = []
    rec.read_service_classes = lambda: seen.append(read()) or seen[-1]
    try:
        report = rec.run_cycle()
    finally:
        rec.close()
    assert report.optimization_ok and not report.errors, report.errors[:3]
    assert report.variants_prepared == N
    assert calls == []
    (classes,) = seen
    for sc, entries in zip(classes, shipped, strict=True):
        first = {t.model: t for t in reversed(entries)}
        assert sc.model_targets == entries + [
            dataclasses.replace(first[d.model], model=f"{d.model}@{d.variant}")
            for d in report.decisions
        ]


@pytest.mark.parametrize("workers", [1, 4])
def test_a_status_write_that_fails_is_not_counted(workers):
    """`status_writes` counts the writes that landed: with the API server
    refusing three variants' status updates, on one worker and on a pool
    (whose threads carry no profiler), 3 fewer than the variants."""
    rec, cluster = _reconciler(reconcile_concurrency=workers)
    refused = {fleet_variant(i) for i in (0, 1, 2)}
    real = cluster.update_variant_autoscaling_status

    def update(va):
        if va.name in refused:
            raise Conflict(f"{va.name}: refused")
        return real(va)

    cluster.update_variant_autoscaling_status = update
    try:
        report = rec.run_cycle()
    finally:
        rec.close()
    assert len(report.errors) == len(refused), report.errors
    assert report.profile["counters"]["status_writes"] == report.variants_applied == N - 3


@pytest.mark.parametrize("outer", [False, True], ids=["alone", "in_a_window"])
def test_decisions_bit_identical_with_the_cycle_profiler_on_and_off(outer):
    """Three cycles of moving traffic decide alike, decision records,
    statuses and gauges, with CYCLE_PROFILER on and off, alone and inside
    a profiled window (the benchmark's)."""
    runs = []
    for on in (True, False):
        rec, cluster = _reconciler(cycle_profiler=on)
        window = CycleProfiler().activate() if outer else None
        seen = []
        try:
            for c in range(3):
                rec.prom = fleet_fake_prom(_rows(c))
                report = rec.run_cycle()
                assert (report.profile is not None) == on
                seen.append({
                    "decisions": [r.to_dict() for r in report.decisions],
                    "statuses": [_status(cluster, i) for i in range(N)],
                    "gauges": sorted(
                        (tuple(sorted(labels.items())), v)
                        for labels, v in rec.emitter.desired_replicas.values.values()),
                })
        finally:
            if window is not None:
                window.deactivate()
            rec.close()
        runs.append(seen)
    assert runs[0] == runs[1]
