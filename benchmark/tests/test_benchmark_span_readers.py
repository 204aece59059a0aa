"""The readers of the program's span counters (`inferno_tpu_torch/obs/
profiler.py::span`): each on a hand-made context, each with nothing to read
(a program without the span, as before the spans existed), and the cells'
traced runs on the CPU reporting them."""

from __future__ import annotations

import pytest

from benchmark import common
from benchmark.tests import _support

LIVE = "llama_v5e10k.live"
FLASH = "llama_v5e10k.flash_crowd"
# reader -> (the counter it divides by the window's steps)
PER_STEP = {
    "sizing_self_ms": "calculate_fleet_self_ms",
    "dispatch_host_ms": "dispatch_ms",
    "solver_assign_ms": "solver_assign_ms",
    "solver_diff_ms": "solver_diff_ms",
    "solver_pools_ms": "solver_pools_ms",
    "solver_solution_ms": "solver_solution_ms",
    "plan_fold_ms": "plan_fold_ms",
    "plan_feed_ms": "plan_feed_ms",
}
READERS = sorted(PER_STEP)


def _ctx(counters, steps=4):
    return {"counters": counters, "step_ms": [100.0] * steps}


@pytest.mark.parametrize("name", sorted(PER_STEP))
def test_reader_divides_its_counter_by_the_steps(name):
    reader = common.load_reader(name)
    assert reader.read(_ctx({PER_STEP[name]: 30.0, "other_ms": 7.0})) == pytest.approx(7.5)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_its_counter(name):
    """The parent's program has none of these spans, the old dispatch
    counters (`jit_*`) are not read, and nor is `calculate_fleet`'s whole
    time in place of its own."""
    reader = common.load_reader(name)
    parent = {"snapshot_update_ms": 5.0, "incremental_writeback_ms": 3.0,
              "jit_execute_ms": 2.0, "jit_dispatches": 1}
    assert reader.read(_ctx(parent)) is None
    # the sizing's whole time is not its own time
    parent["calculate_fleet_ms"] = 9.0
    assert reader.read(_ctx(parent)) is None
    assert reader.read(_ctx({})) is None
    assert reader.read({"counters": {c: 1.0 for c in PER_STEP.values()},
                        "step_ms": []}) is None


def test_each_reader_is_declared_for_the_cell_that_has_its_span():
    doc = common.benchmark_doc()
    declared = {m["name"]: m for m in doc["per_layer"]}
    for name in READERS:
        m = declared[name]
        assert m["source"] == "program_counter"
        want = FLASH if name.startswith("plan_") else LIVE
        assert m["workloads"] == [want], name


@pytest.mark.parametrize("cell,names", [
    (LIVE, ["sizing_self_ms", "dispatch_host_ms", "solver_assign_ms", "solver_diff_ms",
            "solver_pools_ms", "solver_solution_ms"]),
    (FLASH, ["plan_fold_ms", "plan_feed_ms"]),
])
def test_traced_run_reports_the_span_metrics(cell, names, tmp_path):
    """A traced run of the cell on the CPU (the program's plain torch path,
    a 60-variant fleet) reports each of its span metrics, and the sizing's
    own work is not negative."""
    root = _support.small_root(tmp_path)
    result = _support.run_small(root, cell, seconds=1.0, trace=1)
    assert result["correct"], result["checks"]
    for name in names:
        assert name in result["metrics"], (name, sorted(result["metrics"]))
        assert result["metrics"][name]["value"] >= 0.0, name
    assert "dispatch_ms" not in result["metrics"]  # the jit_* counters are gone
