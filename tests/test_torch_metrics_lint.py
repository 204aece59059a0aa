"""Port of tests/test_metrics_lint.py, on the port's imports: the cases
that tests/test_torch_lint.py does not carry under their own names (the
series-in-catalog cases, the instruments' observations, every production
histogram's buckets, and each lint rule's own case).

The expectations are the reference's. Each catalog case also holds the
port's entries (help text and kind) to the reference's catalog, and each
rule case builds the same registry in both packages and holds the port's
violations to the reference's, string for string.
"""

from inferno_tpu.controller import metrics as r_metrics
from inferno_tpu.obs import lint as r_lint
from inferno_tpu_torch.controller.metrics import Registry
from inferno_tpu_torch.obs.lint import build_controller_registry, lint_registry


def _catalog(registry) -> dict:
    return {name: (help_, kind) for name, help_, kind in registry.catalog()}


def _assert_in_catalog(expected: dict) -> None:
    """Each name in the port's catalog with its kind and help text, and
    as in the reference's catalog."""
    catalog = _catalog(build_controller_registry())
    reference = _catalog(r_lint.build_controller_registry())
    for name, kind in expected.items():
        assert name in catalog, name
        help_, got_kind = catalog[name]
        assert got_kind == kind
        assert help_.strip()
        assert name.startswith("inferno_")
        assert catalog[name] == reference[name], name


def _violations(build) -> list[str]:
    """The lint's findings on `build(Registry())`, which must equal the
    reference's on `build` of its own Registry."""
    registry = Registry()
    build(registry)
    ref = r_metrics.Registry()
    build(ref)
    violations = lint_registry(registry)
    assert violations == r_lint.lint_registry(ref)
    return violations


def test_fleet_cycle_series_in_catalog():
    """The fleet-scale cycle instruments ride the same prefix + help
    enforcement and register unconditionally with CycleInstruments."""
    _assert_in_catalog({
        "inferno_cycle_prom_queries_total": "counter",
        "inferno_sizing_cache_lookups": "gauge",
        "inferno_collect_concurrency": "histogram",
    })


def test_forecast_series_in_catalog():
    """The forecast series ride the same prefix + help enforcement as
    the rest of the catalog, and register UNCONDITIONALLY (the catalog
    must not depend on whether PREDICTIVE_SCALING is enabled)."""
    _assert_in_catalog({name: "gauge" for name in (
        "inferno_forecast_arrival_rpm", "inferno_forecast_band_rpm",
        "inferno_forecast_abs_error_rpm")})


def test_event_series_in_catalog():
    """The event-driven reconcile series register unconditionally
    (whether or not the controller runs event-driven or sharded) and ride
    the same prefix + help enforcement."""
    _assert_in_catalog({name: "gauge" for name in (
        "inferno_event_queue_depth", "inferno_shard_owned_servers")})


def test_event_instruments_observe():
    """observe_drain/observe_shard publish through the registry with the
    shard label carrying the member name."""
    from inferno_tpu_torch.controller.metrics import EventInstruments

    inst = EventInstruments(Registry())
    inst.observe_drain(7)
    assert inst.queue_depth.get({}) == 7.0
    inst.observe_shard("ctrl-0", 512)
    inst.observe_shard("ctrl-1", 488)
    assert inst.shard_owned.get({"shard": "ctrl-0"}) == 512.0
    assert inst.shard_owned.get({"shard": "ctrl-1"}) == 488.0


def test_incremental_dirty_series_in_catalog():
    """The dirty-set series register unconditionally (whether or not
    INCREMENTAL_CYCLE is enabled), carry unit suffixes, and the
    per-variant marker gauge prunes with deleted variants."""
    from inferno_tpu_torch.controller.metrics import CycleInstruments

    _assert_in_catalog({
        "inferno_cycle_dirty_lanes_total": "counter",
        "inferno_cycle_skipped_servers_total": "counter",
        "inferno_cycle_dirty_ratio": "gauge",
    })
    # prune contract: a deleted variant's dirty marker must not survive
    inst = CycleInstruments(Registry())
    inst.set_dirty_outcome(3, 7, [("ns", "a", True), ("ns", "b", False)])
    assert inst.dirty_ratio.get({"namespace": "ns", "variant_name": "a"}) == 1.0
    inst.prune_variants({("ns", "b")})
    assert inst.dirty_ratio.get({"namespace": "ns", "variant_name": "a"}) is None
    assert inst.dirty_ratio.get({"namespace": "ns", "variant_name": "b"}) == 0.0


def test_twin_series_in_catalog():
    """The fleet-twin progress series register unconditionally (the
    catalog must not depend on whether a twin run is hosted), carry unit
    suffixes, and the counters track a plant's cumulative totals
    monotonically across repeated observations."""
    from inferno_tpu_torch.controller.metrics import TwinInstruments

    _assert_in_catalog({
        "inferno_twin_events_total": "counter",
        "inferno_twin_advance_ms": "counter",
        "inferno_twin_engines_replicas": "gauge",
    })

    class PlantStub:
        engines = 8
        events_total = 100
        now_ms = 2000.0

    inst = TwinInstruments(Registry())
    inst.observe_plant(PlantStub(), policy="reactive")
    labels = {"policy": "reactive"}
    assert inst.events.get(labels) == 100.0
    assert inst.advance_ms.get(labels) == 2000.0
    assert inst.engines.get(labels) == 8.0
    # re-observing the same cumulative state must not double-count
    inst.observe_plant(PlantStub(), policy="reactive")
    assert inst.events.get(labels) == 100.0
    stub = PlantStub()
    stub.events_total, stub.now_ms = 150, 3000.0
    inst.observe_plant(stub, policy="reactive")
    assert inst.events.get(labels) == 150.0
    assert inst.advance_ms.get(labels) == 3000.0


def test_lint_flags_missing_prefix_and_help():
    def build(registry):
        registry.gauge("inferno_good_ratio", "has help")
        registry.gauge("rogue_series_total", "has help")  # wrong prefix
        registry.histogram("inferno_silent_seconds", "")  # empty help

    violations = _violations(build)
    assert len(violations) == 2
    assert any("rogue_series" in v and "prefix" in v for v in violations)
    assert any("inferno_silent_seconds" in v and "help" in v for v in violations)


def test_attainment_and_recorder_series_in_catalog():
    """The scoreboard gauges and the recorder drop counter ride the same
    enforcement and register unconditionally (the catalog must not depend
    on whether FLIGHT_RECORDER_DIR is set)."""
    _assert_in_catalog({
        "inferno_model_error_ttft_ms": "gauge",
        "inferno_model_error_itl_ms": "gauge",
        "inferno_slo_attainment_ratio": "gauge",
        "inferno_error_budget_burn_ratio": "gauge",
        "inferno_recorder_dropped_total": "counter",
    })


def test_lint_enforces_unit_suffix_with_allowlist():
    """Every series name must end in a unit suffix
    (_seconds/_ms/_total/_ratio/_rpm) unless grandfathered."""
    from inferno_tpu_torch.obs.lint import UNIT_SUFFIX_ALLOWLIST

    def build(registry):
        registry.gauge("inferno_mystery_value", "has help")  # no unit suffix
        registry.gauge("inferno_latency_ms", "has help")  # suffixed: clean
        registry.gauge("inferno_collect_concurrency", "has help")  # grandfathered

    violations = _violations(build)
    assert len(violations) == 1
    assert "inferno_mystery_value" in violations[0]
    assert "unit suffix" in violations[0]
    # the allowlist is a closed, known set — additions need a
    # contract-level reason, so pin its membership here
    # (inferno_event_queue_depth: the event reconcile, named after
    # controller-runtime's conventional workqueue_depth)
    assert UNIT_SUFFIX_ALLOWLIST == {
        "inferno_desired_replicas", "inferno_current_replicas",
        "inferno_sizing_cache_lookups", "inferno_collect_concurrency",
        "inferno_event_queue_depth",
    }


def test_profiler_series_in_catalog():
    """The cycle-profiler series ride the same prefix + help enforcement
    and register unconditionally (the catalog must not depend on whether
    CYCLE_PROFILER is on)."""
    _assert_in_catalog({
        "inferno_profile_phase_seconds": "histogram",
        "inferno_profile_phase_cpu_seconds": "histogram",
        "inferno_profile_budget_burn_ratio": "gauge",
        "inferno_profile_events_total": "counter",
        "inferno_profile_counter_ms": "counter",
        "inferno_profile_mem_peak_bytes": "gauge",
    })


def test_lint_flags_bad_histogram_buckets():
    """Bucket boundaries must be strictly increasing and finite. The
    registry constructor only rejects unsorted tuples — duplicates and
    infinities pass it and silently corrupt the rendered cumulative
    counts, which is exactly what the lint exists to catch."""
    def build(registry):
        registry.histogram("inferno_dup_seconds", "help", buckets=(0.1, 0.1, 1.0))
        registry.histogram(
            "inferno_inf_seconds", "help", buckets=(0.1, 1.0, float("inf"))
        )
        registry.histogram("inferno_ok_seconds", "help", buckets=(0.1, 1.0))

    violations = _violations(build)
    assert len(violations) == 2
    assert any(
        "inferno_dup_seconds" in v and "strictly increasing" in v for v in violations
    )
    assert any("inferno_inf_seconds" in v and "non-finite" in v for v in violations)
    assert not any("inferno_ok_seconds" in v for v in violations)


def test_every_production_histogram_has_sane_buckets():
    """The bucket rule runs over EVERY histogram the controller
    registers — the registry exposes them via `histograms()`, so a new
    instrument with a silently unsorted bucket list fails here and in
    the lint's CLI."""
    registry = build_controller_registry()
    hists = dict(registry.histograms())
    assert "inferno_profile_phase_seconds" in hists
    assert "inferno_cycle_duration_seconds" in hists
    for name, buckets in hists.items():
        assert buckets, name
        assert all(b2 > b1 for b1, b2 in zip(buckets, buckets[1:])), name
    assert lint_registry(registry) == []
    assert hists == dict(r_lint.build_controller_registry().histograms())


def test_lint_flags_help_restating_name():
    """Help text that merely repeats the metric name (any casing or
    punctuation, with or without the inferno_ prefix) documents nothing
    and fails the lint."""
    def build(registry):
        registry.gauge("inferno_queue_depth_ratio", "inferno_queue_depth_ratio")
        registry.counter("inferno_evictions_total", "Evictions, total.")
        registry.gauge("inferno_good_ms", "Wall time of the solve phase")

    violations = _violations(build)
    assert len(violations) == 2
    assert any("inferno_queue_depth_ratio" in v and "restates" in v for v in violations)
    assert any("inferno_evictions_total" in v and "restates" in v for v in violations)
    assert not any("inferno_good_ms" in v for v in violations)


def test_lint_flags_non_snake_case_labels():
    """Label names on live samples must be lower_snake_case (the `le`
    histogram label is synthesized and exempt). The rule reads
    Registry.labelsets(), so it sees exactly what /metrics would render."""
    gauges = []

    def build(registry):
        g = registry.gauge("inferno_styled_ratio", "per-variant style check")
        g.set({"variant_name": "a", "modelLabel": "m"}, 1.0)
        g.set({"variant_name": "b"}, 2.0)
        h = registry.histogram("inferno_lat_seconds", "latency", buckets=(0.1, 1.0))
        h.observe({"Phase": "solve"}, 0.2)
        gauges.append((registry, g))

    violations = _violations(build)
    assert len(violations) == 2
    assert any("inferno_styled_ratio" in v and "'modelLabel'" in v for v in violations)
    assert any("inferno_lat_seconds" in v and "'Phase'" in v for v in violations)
    # repeated samples with the same bad label stay ONE violation
    (port, g), (ref, r_g) = gauges
    g.set({"variant_name": "c", "modelLabel": "m2"}, 3.0)
    r_g.set({"variant_name": "c", "modelLabel": "m2"}, 3.0)
    assert len(lint_registry(port)) == 2
    assert lint_registry(port) == r_lint.lint_registry(ref)
