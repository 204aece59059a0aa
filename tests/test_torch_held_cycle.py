"""Holding the port's reconcile cycles to the reference's.

The carried controller tests (tests/test_torch_{reconciler_edges,obs,
inventory,predictive_reconciler,fleet_cycle}.py) build an in-memory
cluster and a FakeProm with the port's types and run the port's
`Reconciler` on backend "torch" on the CPU, with the reference's
expectations unchanged. `held_reconciler` adds the reference beside it:
before each of the port's cycles the cluster's state (its objects are
plain dicts) is copied into the reference's `InMemoryCluster`, and the
reference's `Reconciler` (backend "jax", the port's config otherwise)
runs one cycle over that copy and over the same Prometheus answers. The
two cycles' decision records are held to ROADMAP's rule: reason and
shape exactly, replicas exactly or ±1 where the chosen lane's rate
ceiling (`lambda_max_rpm`) agrees within 1e-4 relative (a ceil boundary
between f32 and XLA's f32).

Only clean cycles are held: a cycle in which the port reports an error is
a test's injected fault (a monkeypatched solver, a failing client), whose
expectations are the reference's own. A stand-in corrector that a test
sets on the port's reconciler is set on the reference's too. A cluster or Prometheus of another
type (a subclass that injects faults, a client over sockets) runs the
port alone. The reference's reconciler keeps its own state across cycles
(corrector, forecasters, sizing cache), as the port's does. The port's
corrector refits at the reference's dp (`at_reference_dp`): the
reference's refit spans its 8 virtual devices and rounds its batch to a
multiple of 8.

The cases at the end hold the rule itself.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math

import jax
import pytest

from inferno_tpu.controller import kube as r_kube
from inferno_tpu.controller import promclient as r_prom
from inferno_tpu.controller import reconciler as r_rec
from inferno_tpu_torch.controller import kube as p_kube
from inferno_tpu_torch.controller import promclient as p_prom
from inferno_tpu_torch.controller import reconciler as p_rec

# the CPU, asked for explicitly
PORT_CPU = {"compute_backend": "torch", "compute_device": "cpu"}
RTOL = 1e-4
# the reference's backend for each of the port's
REF_BACKEND = {"torch": "jax", "cuda": "jax", "scalar": "scalar", "native": "native"}
_CLUSTER_STATE = ("_vas", "_deployments", "_lws", "_configmaps", "_nodes", "_leases")
# attributes a test replaces on the port's reconciler that the reference's
# takes too (a stand-in corrector answers in either package's types)
_SHARED = ("corrector",)
# the reference's reconciler logs to a logger of its own, silenced: the
# port's "inferno.reconciler" logger is the one the tests read
_REF_LOG = logging.getLogger("test_torch_held_cycle.reference")
_REF_LOG.disabled = True


class _RefProm:
    """The port FakeProm's answers in the reference's types, without
    recording the reference's queries in the port's `queries` list."""

    def __init__(self, prom: p_prom.FakeProm):
        self.prom = prom

    def query(self, promql: str):
        prom = self.prom
        if promql in prom.errors:
            err = prom.errors[promql]
            raise r_prom.PromError(str(err)) if isinstance(err, p_prom.PromError) else err
        rows = prom.results.get(promql)
        if rows is None:
            rows = next((handler(promql) for match, handler in prom.handlers
                         if match(promql)), [])
        return [r_prom.Sample(labels=s.labels, value=s.value, timestamp=s.timestamp)
                for s in rows]

    def healthy(self) -> bool:
        return self.prom.is_healthy


def _ref_config(config: p_rec.ReconcilerConfig) -> r_rec.ReconcilerConfig:
    fields = {f.name for f in dataclasses.fields(r_rec.ReconcilerConfig)}
    kw = {k: v for k, v in dataclasses.asdict(config).items() if k in fields}
    kw["compute_backend"] = REF_BACKEND[config.compute_backend]
    return r_rec.ReconcilerConfig(**kw)


def _replicas_match(a, b) -> bool:
    if a.replicas == b.replicas:
        return True
    return abs(a.replicas - b.replicas) == 1 and math.isclose(
        a.lambda_max_rpm, b.lambda_max_rpm, rel_tol=RTOL)


def assert_decides_as_reference(port_report, ref_report) -> int:
    """ROADMAP's rule over one cycle's decision records; returns the
    number of ±1 boundary variants."""
    assert port_report.optimization_ok == ref_report.optimization_ok, ref_report.errors
    assert port_report.variants_prepared == ref_report.variants_prepared
    port, ref = port_report.decisions, ref_report.decisions
    assert [d.variant for d in port] == [d.variant for d in ref]
    boundary = 0
    for a, b in zip(port, ref):
        assert (a.reason, a.accelerator) == (b.reason, b.accelerator), (
            a.variant, a.reason, a.accelerator, b.reason, b.accelerator)
        assert _replicas_match(a, b), (a.variant, a.replicas, b.replicas)
        boundary += a.replicas != b.replicas
    return boundary


class HeldReconciler:
    """The port's Reconciler (every attribute and method is the port's)
    whose `run_cycle` also runs the reference's over the same inputs and
    holds the decisions (see the module docstring)."""

    def __init__(self, port: p_rec.Reconciler, ref: r_rec.Reconciler | None):
        object.__setattr__(self, "_port", port)
        object.__setattr__(self, "_ref", ref)
        object.__setattr__(self, "held_cycles", 0)

    def __getattr__(self, name):
        return getattr(self._port, name)

    def __setattr__(self, name, value):
        setattr(self._port, name, value)
        if name in _SHARED and self._ref is not None:
            setattr(self._ref, name, value)

    def run_cycle(self):
        port, ref = self._port, self._ref
        # the class's method: a test may replace the instance's run_cycle
        # with a wrapper of this one, which the port's run_forever calls
        cycle = type(port).run_cycle
        if ref is None or type(port.kube) is not p_kube.InMemoryCluster \
                or type(port.prom) is not p_prom.FakeProm:
            return cycle(port)
        for name in _CLUSTER_STATE:
            setattr(ref.kube, name, copy.deepcopy(getattr(port.kube, name)))
        ref.prom = _RefProm(port.prom)
        ref.clock, ref.sleep = port.clock, port.sleep
        report = cycle(port)
        ref_report = ref.run_cycle()
        if not report.errors and report.optimization_ok:
            assert_decides_as_reference(report, ref_report)
            object.__setattr__(self, "held_cycles", self.held_cycles + 1)
        return report

    def close(self):
        self._port.close()
        if self._ref is not None:
            self._ref.close()


def reference_dp() -> int:
    """The dp of the reference's refit mesh, `train_mesh(tp=1)` over every
    local device (8 under tests/conftest.py)."""
    return len(jax.devices())


def at_reference_dp(corrector):
    """The port's corrector, set to round its refit batch to
    `reference_dp()`."""
    if corrector is not None:
        corrector.dp = reference_dp()
    return corrector


def held_reconciler(kube, prom, config: p_rec.ReconcilerConfig, **kw) -> HeldReconciler:
    """The port's `Reconciler(kube, prom, config, **kw)`, held to the
    reference's when `kube` is an InMemoryCluster and `prom` a FakeProm;
    then the port's corrector refits on the reference's dp."""
    port = p_rec.Reconciler(kube=kube, prom=prom, config=config, **kw)
    ref = None
    if type(kube) is p_kube.InMemoryCluster and type(prom) is p_prom.FakeProm:
        ref = r_rec.Reconciler(kube=r_kube.InMemoryCluster(), prom=r_prom.FakeProm(),
                               config=_ref_config(config))
        ref.log = _REF_LOG
        at_reference_dp(port.corrector)
    return HeldReconciler(port, ref)


# -- the rule itself ----------------------------------------------------------


def _cluster_and_prom(arrival_rps=50.0):
    from test_torch_apiserver import CFG_NS, make_cluster, make_prom

    return make_cluster(), make_prom(arrival_rps=arrival_rps), CFG_NS


def test_held_cycle_compares_every_clean_cycle():
    cluster, prom, cfg_ns = _cluster_and_prom()
    rec = held_reconciler(cluster, prom, p_rec.ReconcilerConfig(
        config_namespace=cfg_ns, **PORT_CPU))
    for _ in range(3):
        report = rec.run_cycle()
        assert report.errors == []
    assert rec.held_cycles == 3
    assert rec.config.compute_backend == "torch"
    assert rec._ref.config.compute_backend == "jax"
    rec.close()


def test_held_cycle_catches_a_different_decision(monkeypatch):
    """A reference that decides one replica more fails the hold."""
    cluster, prom, cfg_ns = _cluster_and_prom()
    rec = held_reconciler(cluster, prom, p_rec.ReconcilerConfig(
        config_namespace=cfg_ns, **PORT_CPU))
    real = r_rec.Reconciler.run_cycle

    def one_more(self):
        report = real(self)
        for d in report.decisions:
            d.replicas += 1
            d.lambda_max_rpm *= 1.5
        return report

    monkeypatch.setattr(r_rec.Reconciler, "run_cycle", one_more)
    with pytest.raises(AssertionError):
        rec.run_cycle()


def test_reference_sees_the_port_clusters_edits():
    """Edits between cycles reach the reference: a second variant's
    Deployment scaled to three replicas shows in both cycles' records."""
    cluster, prom, cfg_ns = _cluster_and_prom(arrival_rps=5.0)
    rec = held_reconciler(cluster, prom, p_rec.ReconcilerConfig(
        config_namespace=cfg_ns, **PORT_CPU))
    rec.run_cycle()
    ns, name = next(iter(cluster._deployments))
    cluster._deployments[(ns, name)]["spec"]["replicas"] = 3
    cluster._deployments[(ns, name)]["status"]["readyReplicas"] = 3
    report = rec.run_cycle()
    assert rec.held_cycles == 2
    assert [d.prev_replicas for d in report.decisions] == [3]
    rec.close()


def test_other_clusters_run_the_port_alone():
    cluster, prom, cfg_ns = _cluster_and_prom()

    class Failing(p_kube.InMemoryCluster):
        pass

    failing = Failing()
    failing.__dict__.update(cluster.__dict__)
    rec = held_reconciler(failing, prom, p_rec.ReconcilerConfig(
        config_namespace=cfg_ns, **PORT_CPU))
    rec.run_cycle()
    assert rec._ref is None and rec.held_cycles == 0
