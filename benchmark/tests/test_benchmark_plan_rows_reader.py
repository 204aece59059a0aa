"""The reader of the share of the planner's rows solved on the card
(`plan_rows_on_card_pct`): on hand-made counters, with nothing to read (a
program without the row counters), and declared for the planner's cell."""

from __future__ import annotations

import pytest

from benchmark import common

NAME = "plan_rows_on_card_pct"


@pytest.mark.parametrize("counters,want", [
    ({"plan_card_rows": 2688}, 100.0),
    ({"plan_card_rows": 30, "plan_host_rows": 10}, 75.0),
    ({"plan_host_rows": 168, "plan_fold_ms": 9.0}, 0.0),
])
def test_reads_the_card_share_of_the_rows(counters, want):
    reader = common.load_reader(NAME)
    assert reader.read({"counters": counters, "step_ms": [1.0]}) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{}, {"plan_fold_ms": 5.0, "plan_feed_ms": 1.0}])
def test_finds_nothing_without_the_row_counters(counters):
    assert common.load_reader(NAME).read({"counters": counters, "step_ms": [1.0]}) is None


def test_is_declared_for_the_planner_cell_only():
    m = {m["name"]: m for m in common.benchmark_doc()["per_layer"]}[NAME]
    assert m["workloads"] == ["llama_v5e10k.flash_crowd"]
    assert (m["layer"], m["moves"], m["source"]) == (
        "planner rows", "plan_seeds_per_s", "program_counter")
