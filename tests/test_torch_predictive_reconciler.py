"""Predictive scaling through the reconciler: forecast-bounded
scale-up sizing, the scale-down stabilization gate, the new
DecisionRecord reason codes and forecast provenance, the forecast
gauges, and per-variant state eviction — all against the in-memory
cluster with a canned-metrics Prometheus, on an injected clock (no
sleeps).

Port of tests/test_predictive_reconciler.py on the port's modules, the expectations unchanged.
Every reconciler sizes on backend "torch" on the CPU, asked for
explicitly (`PORT_CPU`), and every clean cycle over an in-memory
cluster is held to the reference's decisions on the same inputs
(`test_torch_held_cycle.held_reconciler`).
"""

import pytest

from inferno_tpu_torch.controller import Reconciler, ReconcilerConfig
from inferno_tpu_torch.controller.engines import LABEL_OUT_NAMESPACE, LABEL_VARIANT
from inferno_tpu_torch.controller.promclient import FakeProm, Sample
from inferno_tpu_torch.obs import (
    RATE_PROVENANCE_FORECAST,
    RATE_PROVENANCE_OBSERVED,
    REASON_FORECAST_BOUND,
    REASON_SLO_BOUND,
    REASON_STABILIZATION_HOLD,
)

from test_torch_apiserver import CFG_NS, NS, make_cluster
from test_torch_held_cycle import PORT_CPU, held_reconciler

import time as _time

VARIANT = "llama-premium"


def mutable_prom(state):
    """FakeProm whose arrival rate reads `state['arrival_rps']` at query
    time, so one reconciler can see a different rate every cycle."""
    prom = FakeProm()

    def handler(q):
        def s(v):
            return [Sample(labels={}, value=v, timestamp=_time.time())]

        if "num_requests_running" in q:
            return s(3.0)
        if "success" in q:
            return s(state["arrival_rps"])
        if "prompt_tokens" in q or "generation_tokens" in q:
            return s(128.0)
        if "first_token" in q:
            return s(0.05)
        if "per_output_token" in q:
            return s(0.02)
        return []

    prom.add_handler(lambda q: True, handler)
    return prom


def make_rec(cluster, prom, **cfg):
    rec = held_reconciler(
        kube=cluster,
        prom=prom,
        config=ReconcilerConfig(
            config_namespace=CFG_NS,
            **PORT_CPU,
            direct_scale=True,
            profile_correction=False,
            **cfg,
        ),
    )
    clock = {"t": 1000.0}
    rec.clock = lambda: clock["t"]
    return rec, clock


def drive(rec, clock, state, rates_rps, step_s=60.0):
    """One cycle per rate, advancing the injected clock one reconcile
    interval each time; returns the reports."""
    reports = []
    for r in rates_rps:
        state["arrival_rps"] = r
        clock["t"] += step_s
        reports.append(rec.run_cycle())
    return reports


def desired_of(cluster):
    va = cluster.get_variant_autoscaling(NS, VARIANT)
    return va.status.desired_optimized_alloc.num_replicas


RAMP = [5.0, 15.0, 25.0, 35.0, 45.0]  # req/s, a steep steady ramp


def test_predictive_sizes_above_observed_on_ramp():
    """On a ramp, the predictive reconciler sizes against the forecast
    upper band at the spin-up horizon — strictly above observed — and
    explains the gap with the forecast_bound reason code."""
    state = {"arrival_rps": 0.0}
    cluster = make_cluster(replicas=1)
    rec, clock = make_rec(cluster, mutable_prom(state), predictive_scaling=True)
    reports = drive(rec, clock, state, RAMP)
    last = reports[-1].decisions[0]
    assert last.rate_provenance == RATE_PROVENANCE_FORECAST
    assert last.sizing_rpm > last.arrival_rpm
    assert last.forecast_upper_rpm == pytest.approx(last.sizing_rpm)
    # horizon = catalog spin-up (v5e-4: 60s) + one reconcile interval
    # (the fixture ConfigMap's GLOBAL_OPT_INTERVAL: 30s): sizing must
    # see as far ahead as its actuation is slow
    assert last.forecast_horizon_s == pytest.approx(60.0 + 30.0)
    desired_predictive = desired_of(cluster)

    # reactive twin fed the identical rate series sizes strictly lower
    state2 = {"arrival_rps": 0.0}
    cluster2 = make_cluster(replicas=1)
    rec2, clock2 = make_rec(cluster2, mutable_prom(state2))
    reports2 = drive(rec2, clock2, state2, RAMP)
    assert reports2[-1].decisions[0].rate_provenance == RATE_PROVENANCE_OBSERVED
    desired_reactive = desired_of(cluster2)
    assert desired_predictive > desired_reactive
    assert last.reason == REASON_FORECAST_BOUND
    assert last.replicas == desired_predictive


def test_predictive_is_noop_on_constant_rate():
    """The no-perturbation property end to end: constant traffic sizes
    identically with the feature on and off (zero trend, tight band),
    and the reason stays slo_bound — never forecast_bound."""
    outcomes = []
    for predictive in (True, False):
        state = {"arrival_rps": 0.0}
        cluster = make_cluster(replicas=1)
        rec, clock = make_rec(
            cluster, mutable_prom(state), predictive_scaling=predictive
        )
        reports = drive(rec, clock, state, [30.0] * 6)
        last = reports[-1].decisions[0]
        outcomes.append((desired_of(cluster), last.replicas))
        assert last.reason == REASON_SLO_BOUND
        if predictive:
            assert last.rate_provenance == RATE_PROVENANCE_OBSERVED
            assert last.sizing_rpm == pytest.approx(last.arrival_rpm)
            assert last.forecast_band_rpm == pytest.approx(0.0, abs=1e-6)
    assert outcomes[0] == outcomes[1]


def test_stabilization_gates_scale_down_and_releases():
    """The peak-over-window gate end to end: after a load drop the
    desired count holds the window peak with the stabilization_hold
    reason, then releases once the peak ages out — HPA scaleDown
    semantics at the reconciler."""
    state = {"arrival_rps": 0.0}
    cluster = make_cluster(replicas=1)
    rec, clock = make_rec(
        cluster,
        mutable_prom(state),
        predictive_scaling=False,  # isolate the stabilizer
        scale_down_stabilization_s=300.0,
    )
    drive(rec, clock, state, [50.0])
    high = desired_of(cluster)
    assert high > 1

    # load collapses; inside the window the peak holds
    (report,) = drive(rec, clock, state, [0.05])
    assert desired_of(cluster) == high
    dec = report.decisions[0]
    assert dec.reason == REASON_STABILIZATION_HOLD
    assert dec.replicas == high
    assert "stabilization window" in dec.detail

    # the deployment (direct_scale) also held the peak — the gate sits
    # before actuation, not just before status writes
    assert cluster.get_deployment(NS, VARIANT)["spec"]["replicas"] == high
    # windows are keyed per (variant, slice shape): a shape migration
    # must start a fresh window instead of comparing replica counts
    # across shapes
    assert rec.stabilizer.variants() == {f"{VARIANT}:{NS}@v5e-4"}

    # 300s later the peak has aged out: scale-down proceeds
    clock["t"] += 300.0
    (report,) = drive(rec, clock, state, [0.05])
    assert desired_of(cluster) == 1
    assert report.decisions[0].reason != REASON_STABILIZATION_HOLD


def test_forecast_gauges_emitted_and_pruned():
    """The forecast gauges carry (namespace, variant_name) labels and
    die with the variant, like every other per-variant series."""
    state = {"arrival_rps": 0.0}
    cluster = make_cluster(replicas=1)
    rec, clock = make_rec(cluster, mutable_prom(state), predictive_scaling=True)
    drive(rec, clock, state, [10.0, 20.0])
    labels = {LABEL_OUT_NAMESPACE: NS, LABEL_VARIANT: VARIANT}
    fi = rec.forecast_instruments
    assert fi.rate.get(labels) is not None
    assert fi.band.get(labels) is not None
    assert fi.error.get(labels) is not None
    assert rec.forecaster.variants() != set()

    # variant deleted: the next cycle prunes gauges and forecaster state
    cluster.delete_variant_autoscaling(NS, VARIANT)
    clock["t"] += 60.0
    rec.run_cycle()
    assert fi.rate.get(labels) is None
    assert fi.band.get(labels) is None
    assert fi.error.get(labels) is None
    assert rec.forecaster.variants() == set()


def test_predictive_off_by_default():
    """The conservative default: no forecaster, no stabilizer, observed
    provenance — the reactive deployments this repo's e2e suite asserts
    keep their exact semantics unless an operator opts in."""
    state = {"arrival_rps": 10.0}
    cluster = make_cluster(replicas=1)
    rec, clock = make_rec(cluster, mutable_prom(state))
    assert rec.forecaster is None
    assert rec.stabilizer is None
    (report,) = drive(rec, clock, state, [10.0])
    dec = report.decisions[0]
    assert dec.rate_provenance == RATE_PROVENANCE_OBSERVED
    assert dec.sizing_rpm == pytest.approx(dec.arrival_rpm)
    assert dec.forecast_upper_rpm == 0.0


def test_config_rejects_negative_stabilization():
    with pytest.raises(ValueError):
        ReconcilerConfig(scale_down_stabilization_s=-1.0)
