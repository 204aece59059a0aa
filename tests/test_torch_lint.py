"""The metric-catalog lint of the port (inferno_tpu_torch.obs.lint) over the
port's own registry (`inferno_tpu_torch.controller.metrics`): the catalog
is clean, and it is the reference's catalog, series for series (name,
help text and kind), with the lint's rules flagging the same faults.
"""

import pytest

from inferno_tpu.obs.lint import build_controller_registry as ref_build_registry
from inferno_tpu_torch.controller.metrics import MetricsEmitter, Registry
from inferno_tpu_torch.obs.lint import (
    UNIT_SUFFIX_ALLOWLIST,
    build_controller_registry,
    lint_registry,
    main,
)


def test_production_catalog_is_clean_and_matches_reference():
    registry = build_controller_registry()
    names = {name for name, _, _ in registry.catalog()}
    assert len(names) == 36
    assert {"inferno_desired_replicas", "inferno_cycle_duration_seconds",
            "inferno_recorder_dropped_total", "inferno_profile_phase_seconds",
            "inferno_event_queue_depth"} <= names
    assert lint_registry(registry) == []
    assert sorted(registry.catalog()) == sorted(ref_build_registry().catalog())
    assert dict(registry.histograms()) == dict(ref_build_registry().histograms())


@pytest.mark.parametrize("case", ["prefix_and_help", "unit_suffix", "buckets",
                                  "restated_help", "labels"])
def test_lint_rules_flag_faults(case):
    registry = Registry()
    if case == "prefix_and_help":
        registry.gauge("inferno_good_ratio", "has help")
        registry.gauge("rogue_series_total", "has help")
        registry.histogram("inferno_silent_seconds", "")
        want = [("rogue_series", "prefix"), ("inferno_silent_seconds", "help")]
    elif case == "unit_suffix":
        registry.gauge("inferno_mystery_value", "has help")
        registry.gauge("inferno_latency_ms", "has help")
        registry.gauge("inferno_collect_concurrency", "has help")
        want = [("inferno_mystery_value", "unit suffix")]
    elif case == "buckets":
        registry.histogram("inferno_dup_seconds", "help", buckets=(0.1, 0.1, 1.0))
        registry.histogram("inferno_inf_seconds", "help",
                           buckets=(0.1, 1.0, float("inf")))
        registry.histogram("inferno_ok_seconds", "help", buckets=(0.1, 1.0))
        want = [("inferno_dup_seconds", "strictly increasing"),
                ("inferno_inf_seconds", "non-finite")]
    elif case == "restated_help":
        registry.gauge("inferno_queue_depth_ratio", "inferno_queue_depth_ratio")
        registry.counter("inferno_evictions_total", "Evictions, total.")
        registry.gauge("inferno_good_ms", "Wall time of the solve phase")
        want = [("inferno_queue_depth_ratio", "restates"),
                ("inferno_evictions_total", "restates")]
    else:
        g = registry.gauge("inferno_styled_ratio", "per-variant style check")
        g.set({"variant_name": "a", "modelLabel": "m"}, 1.0)
        h = registry.histogram("inferno_lat_seconds", "latency", buckets=(0.1, 1.0))
        h.observe({"Phase": "solve"}, 0.2)
        want = [("inferno_styled_ratio", "'modelLabel'"),
                ("inferno_lat_seconds", "'Phase'")]
    violations = lint_registry(registry)
    assert len(violations) == len(want), violations
    for name, what in want:
        assert any(name in v and what in v for v in violations), (name, violations)


def test_unit_suffix_allowlist_is_the_reference_set():
    from inferno_tpu.obs.lint import UNIT_SUFFIX_ALLOWLIST as REF_ALLOWLIST

    assert UNIT_SUFFIX_ALLOWLIST == REF_ALLOWLIST


def test_production_samples_pass_label_lint():
    registry = Registry()
    MetricsEmitter(registry).emit_replica_metrics(
        namespace="ns", variant="v", accelerator="v5e-4", current=2, desired=3)
    assert lint_registry(registry) == []


def test_lint_cli_exit_code(capsys):
    assert main() == 0
    assert "36 series clean" in capsys.readouterr().out
