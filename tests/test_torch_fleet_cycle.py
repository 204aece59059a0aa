"""Fleet-scale reconcile pipeline: coalesced Prometheus
collection with per-variant fallback, the bounded-concurrency
collect/apply pipeline with error isolation and deterministic ordering,
the input-signature sizing cache, and the query-count regression guard.

Port of tests/test_fleet_cycle.py on the port's modules, the expectations
unchanged, apart from its two MiniProm-over-HTTP cases, which
tests/test_torch_e2e_http.py carries. Every reconciler sizes on backend
"torch" on the CPU, asked for explicitly (`PORT_CPU`), and every clean
cycle over an in-memory cluster is held to the reference's decisions on
the same inputs (`test_torch_held_cycle.held_reconciler`).
"""

import dataclasses

import pytest

from inferno_tpu_torch.controller.crd import (
    TYPE_METRICS_AVAILABLE,
    TYPE_OPTIMIZATION_READY,
)
from inferno_tpu_torch.controller.promclient import FakeProm, PromError
from inferno_tpu_torch.controller.reconciler import ReconcilerConfig
from inferno_tpu_torch.obs import (
    SIZING_PROVENANCE_CACHED,
    SIZING_PROVENANCE_SOLVED,
)
from inferno_tpu_torch.testing.fleet import (
    CONFIG_NS,
    FLEET_NS,
    fleet_cluster,
    fleet_fake_prom,
    fleet_model,
    fleet_variant,
)

from test_torch_held_cycle import PORT_CPU, held_reconciler

N = 6


def rows(n=N, arrival_rps=5.0, **overrides):
    out = {}
    for i in range(n):
        out[(fleet_model(i), FLEET_NS)] = {
            "running": 3.0, "arrival_rps": arrival_rps, "in_tokens": 128.0,
            "out_tokens": 128.0, "ttft_s": 0.05, "itl_s": 0.02,
            "max_batch": 64.0, **overrides,
        }
    return out


def reconciler(cluster, prom, **kw):
    cfg = ReconcilerConfig(config_namespace=CONFIG_NS, **PORT_CPU, **kw)
    return held_reconciler(cluster, prom, cfg)


def snapshot(cluster, report, n=N):
    """Everything a cycle decides, as comparable data: decision records
    (timings excluded — they are wall-clock), CR statuses, and desired
    allocations."""
    decisions = [r.to_dict() for r in report.decisions]
    statuses = []
    for i in range(n):
        va = cluster.get_variant_autoscaling(FLEET_NS, fleet_variant(i))
        statuses.append((
            va.status.desired_optimized_alloc.num_replicas,
            va.status.desired_optimized_alloc.accelerator,
            va.status.current_alloc.to_dict(),
            va.status.condition(TYPE_METRICS_AVAILABLE).status,
            va.status.condition(TYPE_OPTIMIZATION_READY).status,
        ))
    return decisions, statuses


# -- coalesced collection ----------------------------------------------------


def test_grouped_cycle_issues_q_not_qxv_queries():
    cluster = fleet_cluster(N)
    prom = fleet_fake_prom(rows())
    rec = reconciler(cluster, prom)
    report = rec.run_cycle()
    assert report.errors == []
    assert report.variants_prepared == report.variants_applied == N
    # ~Q queries for the whole fleet (7 grouped), not Q x V (~36)
    assert report.prom_queries == 7
    # and the counter instrument carries the same number
    assert rec.instruments.prom_queries.get({}) == 7.0


def test_grouped_and_per_variant_cycles_are_bit_identical():
    """Parity: the same canned telemetry through the coalesced path and
    the per-variant path produces identical decisions and statuses."""
    a_cluster, b_cluster = fleet_cluster(N), fleet_cluster(N)
    a = reconciler(a_cluster, fleet_fake_prom(rows()), grouped_collection=True)
    b = reconciler(b_cluster, fleet_fake_prom(rows()), grouped_collection=False)
    ra, rb = a.run_cycle(), b.run_cycle()
    assert snapshot(a_cluster, ra) == snapshot(b_cluster, rb)
    # the whole point of coalescing, made visible
    assert ra.prom_queries == 7
    assert rb.prom_queries == N * 7  # probe + 5 collect + max-batch each


def test_grouped_response_missing_variant_falls_back_to_single_queries():
    """A variant absent from the grouped vectors (here: the last one)
    rides its per-variant queries and still produces the same decision
    as its fleet-covered peers."""
    table = rows()
    missing = (fleet_model(N - 1), FLEET_NS)
    grouped_table = {k: v for k, v in table.items() if k != missing}
    prom = fleet_fake_prom(table)
    # drop the last variant's samples from every grouped vector (the
    # query strings still cover the full fleet selector)
    for q, samples in list(prom.results.items()):
        prom.results[q] = [
            smp for smp in samples if smp.labels.get("model_name") != missing[0]
        ]
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, prom)
    report = rec.run_cycle()
    assert report.errors == []
    assert report.variants_applied == N
    # 7 grouped + the missing variant's own queries (1 probe + 5 collect
    # + 1 max-batch)
    assert report.prom_queries == 7 + 7
    # same telemetry either way: the fallback variant's decision matches
    decisions = {r.variant: r for r in report.decisions}
    fb = decisions[f"{fleet_variant(N - 1)}:{FLEET_NS}"]
    peer = decisions[f"{fleet_variant(0)}:{FLEET_NS}"]
    assert fb.replicas == peer.replicas
    assert fb.arrival_rpm == pytest.approx(peer.arrival_rpm)


def test_grouped_prom_outage_degrades_to_per_variant_path():
    """Every grouped query failing (Prometheus outage mid-cycle) must not
    error the cycle shape: collection falls back per variant, where the
    existing per-variant skip/error isolation applies."""
    prom = fleet_fake_prom(rows(), grouped=False)  # grouped: empty vectors

    # empty grouped vectors -> no variant in the fleet probe -> fallback
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, prom)
    report = rec.run_cycle()
    assert report.errors == []
    assert report.variants_applied == N
    assert report.prom_queries == 7 + N * 7


def test_stale_grouped_samples_set_stale_condition():
    """Staleness survives coalescing: aged grouped samples mark the
    variant MetricsStale exactly like the per-variant path."""
    cluster = fleet_cluster(N)
    prom = fleet_fake_prom(rows(), age_seconds=600.0)
    rec = reconciler(cluster, prom)
    report = rec.run_cycle()
    assert report.variants_prepared == 0
    va = cluster.get_variant_autoscaling(FLEET_NS, fleet_variant(0))
    assert va.status.condition(TYPE_METRICS_AVAILABLE).reason == "MetricsStale"


def test_group_selector_escapes_promql_string_layer():
    """Real model ids contain `-` and `.`; re.escape turns them into
    `\\-`/`\\.`, which are INVALID escapes in a PromQL (Go) string
    literal — real Prometheus rejects the query. The selector must
    double its backslashes for the string layer, and MiniProm must
    unescape that layer (like Prometheus) before compiling the regex."""
    import re as _re
    import time as _time

    from inferno_tpu_torch.controller.collector import _group_selector, grouped_queries
    from inferno_tpu_torch.controller.engines import engine_for
    from inferno_tpu_torch.emulator.miniprom import MiniProm, _unquote

    model = "meta-llama/Llama-3.1-8B"
    engine = engine_for("vllm-tpu")
    sel = _group_selector(engine, {(model, "prod")})
    # every backslash inside the string literals must itself be escaped
    for literal in _re.findall(r'"([^"]*)"', sel):
        i = 0
        while i < len(literal):
            if literal[i] == "\\":
                assert i + 1 < len(literal) and literal[i + 1] in '\\"nt', (
                    f"invalid Go string escape in selector: {literal!r}")
                i += 2
            else:
                i += 1
    # string-layer unescape recovers exactly the intended regex
    models_literal = _re.search(r'=~"([^"]*)"', sel).group(1)
    assert _unquote(models_literal) == _re.escape(model)

    # and the whole path works: MiniProm answers the grouped query for
    # the dotted/hyphenated id
    def render() -> str:
        return f'vllm:num_requests_running{{model_name="{model}"}} 3\n'

    render.__name__ = f"{model}/0"
    prom = MiniProm([(render, {"namespace": "prod"})],
                    scrape_interval=60.0, window_seconds=60.0)
    prom.scrape_once()
    _time.sleep(0.01)
    prom.scrape_once()
    q = grouped_queries(engine, {(model, "prod")})["running"]
    samples = prom.client().query(q)
    assert [(s.labels["model_name"], s.value) for s in samples] \
        == [(model, 3.0)]


# -- bounded-concurrency pipeline --------------------------------------------


def test_serial_and_concurrent_cycles_are_bit_identical():
    """The acceptance parity check: RECONCILE_CONCURRENCY at the default
    (serial) and at 8 produce identical decisions, statuses, and record
    ORDER (variant-list order, not completion order)."""
    a_cluster, b_cluster = fleet_cluster(N), fleet_cluster(N)
    a = reconciler(a_cluster, fleet_fake_prom(rows()))
    b = reconciler(b_cluster, fleet_fake_prom(rows()), reconcile_concurrency=8)
    ra, rb = a.run_cycle(), b.run_cycle()
    assert snapshot(a_cluster, ra) == snapshot(b_cluster, rb)
    assert [r.variant for r in rb.decisions] == [
        f"{fleet_variant(i)}:{FLEET_NS}" for i in range(N)
    ]


def test_pooled_prom_error_isolated_to_one_variant():
    """One variant's queries raising PromError inside the pool skips THAT
    variant (error condition + error record) and never aborts the cycle
    or corrupts another variant's record."""
    table = rows()
    poisoned = fleet_model(2)
    prom = fleet_fake_prom(table, grouped=False)

    def poison(q):
        raise PromError("socket torn down")

    # poison the poisoned variant's COLLECT queries (validation passes,
    # then the arrival-rate query blows up mid-pool); the handler must
    # OUTRANK the table's catch-all handler
    prom.handlers.insert(
        0, (lambda q: f'"{poisoned}"' in q and "success" in q, poison)
    )
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, prom, grouped_collection=False,
                     reconcile_concurrency=4)
    report = rec.run_cycle()
    assert report.variants_seen == N
    assert report.variants_prepared == report.variants_applied == N - 1
    assert any("socket torn down" in e for e in report.errors)
    by_variant = {r.variant: r for r in report.decisions}
    assert by_variant[f"{fleet_variant(2)}:{FLEET_NS}"].reason == "error"
    assert "socket torn down" in by_variant[f"{fleet_variant(2)}:{FLEET_NS}"].detail
    for i in (0, 1, 3, 4, 5):
        assert by_variant[f"{fleet_variant(i)}:{FLEET_NS}"].reason != "error"


def test_pooled_worker_crash_isolated_to_one_variant():
    """A non-Prom exception escaping one collect worker (simulated via a
    broken handler raising RuntimeError) degrades to that variant's
    error record, never the cycle."""
    table = rows()
    poisoned = fleet_model(1)
    prom = fleet_fake_prom({k: v for k, v in table.items()
                            if k[0] != poisoned}, grouped=False)

    def crash(q):
        raise RuntimeError("emulated worker crash")

    prom.handlers.insert(0, (lambda q: f'"{poisoned}"' in q, crash))
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, prom, grouped_collection=False,
                     reconcile_concurrency=4)
    report = rec.run_cycle()
    assert report.variants_applied == N - 1
    assert any("emulated worker crash" in e for e in report.errors)
    by_variant = {r.variant: r for r in report.decisions}
    assert by_variant[f"{fleet_variant(1)}:{FLEET_NS}"].reason == "error"


def test_worker_pool_persists_across_cycles():
    """The collect/apply pool is owned by the Reconciler and survives
    cycles — per-thread keep-alive Prometheus connections only amortize
    if their threads do. close() releases it; a serial reconciler never
    creates one."""
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, fleet_fake_prom(rows()), reconcile_concurrency=8)
    try:
        rec.run_cycle()
        pool = rec._pool
        assert pool is not None
        rec.run_cycle()
        assert rec._pool is pool
    finally:
        rec.close()
    assert rec._pool is None
    serial = reconciler(fleet_cluster(N), fleet_fake_prom(rows()))
    serial.run_cycle()
    assert serial._pool is None
    serial.close()  # no-op on a never-pooled reconciler


def test_concurrency_config_validated():
    with pytest.raises(ValueError, match="reconcile_concurrency"):
        ReconcilerConfig(reconcile_concurrency=0)
    with pytest.raises(ValueError, match="sizing_cache_tolerance"):
        ReconcilerConfig(sizing_cache_tolerance=-0.1)


# -- input-signature sizing cache --------------------------------------------


def test_sizing_cache_replays_unchanged_variants():
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, fleet_fake_prom(rows()), sizing_cache=True,
                     sizing_cache_tolerance=0.05)
    first = rec.run_cycle()
    assert first.sizing_cache_hits == 0
    assert first.sizing_cache_misses == N
    assert all(r.sizing_provenance == SIZING_PROVENANCE_SOLVED
               for r in first.decisions)
    second = rec.run_cycle()
    assert second.sizing_cache_hits == N
    assert second.sizing_cache_misses == 0
    assert all(r.sizing_provenance == SIZING_PROVENANCE_CACHED
               for r in second.decisions)
    # identical decisions either way (replay, not re-derivation)
    assert [(r.variant, r.accelerator, r.replicas) for r in first.decisions] \
        == [(r.variant, r.accelerator, r.replicas) for r in second.decisions]
    # the per-cycle gauges track the outcome
    assert rec.instruments.cache_lookups.get({"result": "hit"}) == float(N)
    assert rec.instruments.cache_lookups.get({"result": "miss"}) == 0.0


def test_sizing_cache_tolerance_gates_rate_wiggle():
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, fleet_fake_prom(rows(arrival_rps=10.0)),
                     sizing_cache=True, sizing_cache_tolerance=0.02)
    rec.run_cycle()
    # +1% λ: inside the 2% band -> replayed
    rec.prom = fleet_fake_prom(rows(arrival_rps=10.1))
    r2 = rec.run_cycle()
    assert r2.sizing_cache_hits == N
    # +10% λ: outside the band -> re-solved (and re-cached at the new λ)
    rec.prom = fleet_fake_prom(rows(arrival_rps=11.0))
    r3 = rec.run_cycle()
    assert r3.sizing_cache_misses == N
    assert all(r.sizing_provenance == SIZING_PROVENANCE_SOLVED
               for r in r3.decisions)


def test_sizing_cache_invalidated_by_slo_change():
    """A structural input change (SLO tightened via the service-class
    ConfigMap) must miss for every variant — λ tolerance never papers
    over a changed target."""
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, fleet_fake_prom(rows()), sizing_cache=True,
                     sizing_cache_tolerance=0.5)
    rec.run_cycle()
    tightened = fleet_cluster(N, slo_itl=19.0)
    cluster.set_configmap(
        CONFIG_NS, "service-classes-config",
        tightened.get_configmap(CONFIG_NS, "service-classes-config"),
    )
    r2 = rec.run_cycle()
    assert r2.sizing_cache_hits == 0
    assert r2.sizing_cache_misses == N


def test_sizing_cache_disabled_by_default():
    cluster = fleet_cluster(2)
    rec = reconciler(cluster, fleet_fake_prom(rows(2)))
    assert rec.sizing_cache is None
    report = rec.run_cycle()
    report2 = rec.run_cycle()
    assert report.sizing_cache_hits == report2.sizing_cache_hits == 0
    assert all(r.sizing_provenance == SIZING_PROVENANCE_SOLVED
               for r in report2.decisions)


def test_sizing_cache_max_age_bounds_replay():
    """A persistent sub-tolerance λ drift must not be replayed forever:
    after max_age_cycles consecutive hits the entry re-solves, and the
    re-store re-anchors the λ reference (fresh entry, fresh budget)."""
    from inferno_tpu_torch.core.allocation import Allocation
    from inferno_tpu_torch.controller.sizing_cache import SizingCache

    cache = SizingCache(rel_tolerance=0.10, max_age_cycles=3)
    cur = Allocation(accelerator="v5e-8", num_replicas=2,
                     batch_size=16, cost=10.0)
    sig = ("sig",)
    cache.store("m0", sig, 10.0, {"v5e-8": cur.clone()})
    for _ in range(3):
        assert cache.lookup("m0", sig, 10.9, cur) is not None
    # 4th consecutive replay is refused even though λ is in-band
    assert cache.lookup("m0", sig, 10.9, cur) is None
    # the post-miss solve re-stores: budget and λ anchor start over
    cache.store("m0", sig, 10.9, {"v5e-8": cur.clone()})
    assert cache.lookup("m0", sig, 10.9, cur) is not None


def test_sizing_cache_pruned_with_deleted_variant():
    cluster = fleet_cluster(N)
    rec = reconciler(cluster, fleet_fake_prom(rows()), sizing_cache=True)
    rec.run_cycle()
    assert len(rec.sizing_cache) == N
    cluster.delete_variant_autoscaling(FLEET_NS, fleet_variant(0))
    rec.prom = fleet_fake_prom(
        {k: v for k, v in rows().items() if k[0] != fleet_model(0)}
    )
    rec.run_cycle()
    assert len(rec.sizing_cache) == N - 1


# -- query-count regression guard (CI satellite) -----------------------------
