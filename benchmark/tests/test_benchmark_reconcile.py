"""The reconcile cell (`entries/reconcile.py`, `reference/reconcile.py`,
`configs/cluster5k.json`): its configuration is the repository's
deployment, each way the written cycle can go wrong reads as the number
that names it (a broken sizing underneath: `test_benchmark_entry_faults.py`),
and its readers read the program's spans or find nothing. On the CPU (the
program's plain torch path, a 30-variant cluster)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark import common
from benchmark.entries import reconcile
from benchmark.tests import _support
from inferno_tpu_torch.controller import metrics
from inferno_tpu_torch.controller.reconciler import Reconciler

CELL = "cluster5k.prom_live"
SAME_AS_LIVE = ("shapes", "models", "service_class", "idle_every", "load", "current_replicas")
VARIANTS = 30
REAL_APPLY = Reconciler._apply_one
REAL_EMIT = metrics.MetricsEmitter.emit_replica_metrics
BROKEN = reconcile.variant_name(3)  # a loaded variant (every 7th is idle)


def _config(name):
    return common.load_json(os.path.join(common.BENCH, "configs", name + ".json"))


def test_configuration_is_the_live_fleet_under_the_shipped_configmaps():
    """cluster5k's profiles, shapes, class and loads are llama_v5e10k's,
    and its ConfigMaps are the ones `deploy/manifests/configmaps.yaml`
    ships."""
    import yaml

    cfg, live = _config("cluster5k"), _config("llama_v5e10k")
    for key in SAME_AS_LIVE:
        assert cfg[key] == live[key], key
    assert (cfg["variants"], cfg["reduced"], cfg["precision"]) == (5000, [], "float32")
    with open(os.path.join(common.ROOT, "deploy", "manifests", "configmaps.yaml")) as f:
        shipped = {d["metadata"]["name"]: d["data"] for d in yaml.safe_load_all(f)}
    assert cfg["configmaps"] == shipped
    assert cfg["config_namespace"] == "inferno-system"
    controller = cfg["controller"]
    assert controller["KEEP_ACCELERATOR"] == "true" and controller["COMPUTE_BACKEND"] == "auto"
    assert (controller["DECISION_TRACE_BUFFER"], controller["LOG_LEVEL"]) == ("4", "warn")
    entry = next(c for c in common.benchmark_doc()["configs"] if c["name"] == "cluster5k")
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]


def test_every_variant_is_served_by_its_class_and_pinned_to_its_shape():
    """The cluster lists each variant's model in the Premium class at its
    SLOs, each VariantAutoscaling carries every shape its model has a
    profile for and is labelled with its current shape."""
    import yaml

    cfg = {**_config("cluster5k"), "variants": VARIANTS}
    fleet = common.load_generator(cfg["generator"]).make(cfg, 2**31 + 5)
    cluster = reconcile.build_cluster(cfg, fleet)
    classes = cluster.get_configmap("inferno-system", "service-classes-config")
    premium = yaml.safe_load(classes["premium.yaml"])
    listed = {e["model"]: (e["slo-ttft"], e["slo-tpot"]) for e in premium["data"]}
    vas = cluster.list_variant_autoscalings()
    assert len(vas) == VARIANTS
    for i, va in enumerate(vas):
        assert listed[va.spec.model_id] == (500.0, 24.0)
        offered = [fleet["shape_names"][s] for s in np.flatnonzero(fleet["offered"][i])]
        assert [p.acc for p in va.spec.accelerators] == offered
        assert va.labels["inference.optimization/acceleratorName"] == (
            fleet["shape_names"][fleet["cur_rank"][i]])
        assert cluster.get_deployment("fleet", va.name)["spec"]["replicas"] == fleet["cur_reps"][i]


def test_the_table_lies_on_the_profiles_and_is_drawn_from_the_seed():
    cfg = {**_config("cluster5k"), "variants": VARIANTS}
    mix = common.mix("prom_live")
    fleet = common.load_generator(cfg["generator"]).make(cfg, 11)
    state = {k: fleet[k] for k in ("lam", "in_tok", "out_tok")}
    reps = np.array(fleet["cur_reps"])
    a = reconcile.scrape(fleet, state, reps, mix["scrape"], 11, 4)
    b = reconcile.scrape(fleet, state, reps, mix["scrape"], 11, 4)
    c = reconcile.scrape(fleet, state, reps, mix["scrape"], 11, 5)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["running"], c["running"])
    i, s = np.arange(VARIANTS), fleet["cur_rank"]
    loaded = fleet["lam"] > 0
    conc = a["running"] / reps
    line = fleet["alpha"][i, s] + fleet["beta"][i, s] * conc
    ratio = a["itl_s"][loaded] * 1e3 / line[loaded]
    assert np.all((ratio >= 0.95) & (ratio <= 1.05))
    occupancy = a["running"] / reconcile.decode_batch(fleet, state["out_tok"])
    assert np.all((occupancy[loaded] >= 0.2) & (occupancy[loaded] <= 0.8))
    for k in ("rps", "running", "in_tok", "out_tok", "ttft_s", "itl_s"):
        assert np.all(a[k][~loaded] == 0.0), k


def _skip_one_write(self, va, rec, alloc, now, system):
    """The status write (and the gauge) of one variant left out."""
    if va.name == BROKEN:
        return [], False, False
    return REAL_APPLY(self, va, rec, alloc, now, system)


def _change_one_gauge(self, namespace, variant, accelerator, current, desired):
    """One variant's desired-replicas gauge one above its status."""
    return REAL_EMIT(self, namespace, variant, accelerator, current,
                     desired + (variant == BROKEN))


@pytest.mark.parametrize("owner,name,fault,number,want", [
    (Reconciler, "_apply_one", _skip_one_write, "unwritten", 1),
    (metrics.MetricsEmitter, "emit_replica_metrics", _change_one_gauge, "gauges_off", 1),
], ids=["skipped_status_write", "changed_gauge"])
def test_a_broken_cycle_reads_as_its_number(owner, name, fault, number, want, tmp_path,
                                            monkeypatch):
    root = _support.small_root(tmp_path, variants=VARIANTS)
    clean = _support.run_small(root, CELL, seconds=0.5)
    assert clean["correct"], clean["checks"]
    monkeypatch.setattr(owner, name, fault)
    broken = _support.run_small(root, CELL, seconds=0.5)
    assert not broken["correct"], broken["checks"]
    assert broken["checks"][number]["value"] == want, broken["checks"]


# reader -> where its number lives: the cycles' own profiles ("entry"),
# summed by the entry, or the window's profiler ("window")
READERS = {
    "reconcile_collect_ms": ("entry", "reconcile_collect_ms"),
    "reconcile_analyze_ms": ("entry", "reconcile_analyze_ms"),
    "reconcile_solve_ms": ("entry", "reconcile_solve_ms"),
    "reconcile_actuate_ms": ("entry", "reconcile_actuate_ms"),
    "reconcile_prom_queries": ("entry", "prom_queries"),
    "reconcile_finish_ms": ("window", "reconcile_finish_ms"),
}


def _ctx(where, counter, value, steps=4):
    cycles = {counter: value} if where == "entry" else {}
    window = {counter: value} if where == "window" else {}
    return {"counters": window, "step_ms": [100.0] * steps, "trace": None,
            "entry": {"cycle_counters": cycles}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_divides_its_counter_by_the_cycles(name):
    where, counter = READERS[name]
    assert common.load_reader(name).read(_ctx(where, counter, 30.0)) == pytest.approx(7.5)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_finds_nothing_where_the_program_has_no_span(name):
    """A program without the reconcile spans (the parent) has neither the
    cycles' phase counters nor the window's finish; the readers return
    None and do not raise, nor read the other place."""
    reader = common.load_reader(name)
    where, counter = READERS[name]
    other = "window" if where == "entry" else "entry"
    assert reader.read(_ctx(other, counter, 30.0)) is None
    assert reader.read(_ctx(where, "calculate_fleet_ms", 30.0)) is None
    assert reader.read({"counters": {}, "step_ms": [], "trace": None, "entry": {}}) is None


SHARED = ("sizing_roofline_pct", "stats_kernel_launches", "bisect_kernel_launches")


def test_each_metric_is_declared_for_the_reconcile_cell():
    doc = common.benchmark_doc()
    declared = {m["name"]: m for m in doc["per_layer"]}
    for name in [*READERS, "device_idle_pct.reconcile"]:
        m = declared[name]
        assert m["workloads"] == [CELL] and m["moves"] == "cycle_ms", name
    for name in SHARED:  # the live cell's kernel metrics, the cell appended
        assert declared[name]["workloads"] == ["llama_v5e10k.live", CELL], name
    cycle_ms = next(m for m in doc["end_to_end"] if m["name"] == "cycle_ms")
    assert cycle_ms["workloads"][-1] == CELL
    reader = common.load_reader("device_idle_pct.reconcile")
    assert reader.read({"trace": {"busy_s": 1.0, "window_s": 4.0}}) == pytest.approx(75.0)
    assert reader.read({"trace": None}) is None


def test_traced_run_reports_the_reconcile_metrics(tmp_path):
    """A traced run on the CPU reports every reconcile metric but the
    device's idle share, the grouped collection's 7 queries a cycle, and
    phases that account for the cycle."""
    root = _support.small_root(tmp_path, variants=VARIANTS)
    result = _support.run_small(root, CELL, seconds=1.0, trace=1)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) == set(READERS), sorted(got)
    assert got["reconcile_prom_queries"] == 7.0
    assert all(v > 0.0 for v in got.values()), got
    json.dumps(result)


def test_the_entry_gives_the_kernel_readers_their_numbers():
    """Traced, the entry gives `sizing_roofline_pct` the least device
    seconds of the window's cycles over the pinned lanes (positive, every
    loaded lane's tokens move each cycle, and one cycle's share of two);
    the launch counters only on the card. Untraced, neither."""
    import torch

    cfg = {**_config("cluster5k"), "variants": VARIANTS}
    bench = reconcile.Bench(cfg, common.mix("prom_live"), 2**31 + 9, torch.device("cpu"),
                            "torch", common.Spans(traced=False))
    bench.warm()
    for _ in range(2):
        bench.step()
    bench.finish()
    assert "sizing_bound_s" not in bench.layer_context(False)
    ctx = bench.layer_context(True)
    first = bench.warm_cycles + 1
    assert ctx["sizing_bound_s"] > 0.0
    assert ctx["sizing_bound_s"] == pytest.approx(
        bench.bound_s(first, first) + bench.bound_s(first + 1, first + 1))
    assert "stats_kernel_launches" not in ctx and "bisect_kernel_launches" not in ctx
    assert ctx["cycle_counters"]["reconcile_solve_ms"] > 0.0
    share = common.load_reader("sizing_roofline_pct").read(
        {"trace": {"busy_s": 2.0 * ctx["sizing_bound_s"]}, "entry": ctx})
    assert share == pytest.approx(50.0)
