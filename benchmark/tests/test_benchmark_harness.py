"""The harness on the CPU: deterministic traffic, the reference against
the program's plain torch path, the result line's keys, and a cell added
by files alone."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.entries import cycle
from benchmark.inputs import traffic
from benchmark.tests import _support

CONFIG = "llama_v5e10k"
LIVE = CONFIG + ".live"
CYCLE_MIXES = sorted(
    name[:-5] for name in os.listdir(os.path.join(common.BENCH, "traffic"))
    if name.endswith(".json")
    and common.mix(name[:-5]).get("entry") == "cycle"
)


@pytest.mark.parametrize("mix_name", CYCLE_MIXES)
def test_mix_is_deterministic_in_the_seed(mix_name):
    cfg = common.load_json(os.path.join(common.BENCH, "configs", CONFIG + ".json"))
    cfg["variants"] = 200
    mix = common.mix(mix_name)["cycle"]
    fleet = common.load_generator(cfg["generator"]).make(cfg, 2**31 + 11)
    again = common.load_generator(cfg["generator"]).make(cfg, 2**31 + 11)
    for key in ("lam", "alpha", "max_batch", "slo_itl"):
        assert np.array_equal(fleet[key], again[key], equal_nan=True)
    a = traffic.state_at(fleet, mix, 2**31 + 11, 5)
    b = traffic.state_at(fleet, mix, 2**31 + 11, 5)
    c = traffic.state_at(fleet, mix, 2**31 + 12, 5)
    for key in traffic.STATE_KEYS:
        assert np.array_equal(a[key], b[key]), key
    assert any(not np.array_equal(a[k], c[k]) for k in traffic.STATE_KEYS)
    # a cycle's moves depend on the seed and its index alone
    s1, s2 = traffic.initial(fleet), traffic.initial(fleet)
    m1 = traffic.step(fleet, s1, mix, 9, 3)
    m2 = traffic.step(fleet, s2, mix, 9, 3)
    assert m1.keys() == m2.keys() and all(np.array_equal(m1[k], m2[k]) for k in m1)


def test_configuration_is_the_committed_deployment():
    """Every profile number of the configuration is the repository's
    measured profile of that model on that shape, the shapes and their
    price are the shipped accelerator-cost ConfigMap's, and the service
    class is its Premium class."""
    import yaml

    cfg = common.load_json(os.path.join(common.BENCH, "configs", CONFIG + ".json"))
    for model in cfg["models"]:
        for acc, prof in model["profiles"].items():
            with open(os.path.join(common.ROOT, "profiles", f"{model['name']}_{acc}.json")) as f:
                measured = json.load(f)
            assert measured["slicesPerReplica"] == 1
            assert prof == {
                "maxBatchSize": measured["maxBatchSize"], "atTokens": measured["atTokens"],
                **measured["decodeParms"], **measured["prefillParms"]}
    with open(os.path.join(common.ROOT, "deploy", "manifests", "configmaps.yaml")) as f:
        maps = {d["metadata"]["name"]: d["data"] for d in yaml.safe_load_all(f)}
    costs = maps["accelerator-unit-costs"]
    for name, cents, chips in cfg["shapes"]:
        assert json.loads(costs[name])["cost"] == cents
        assert int(name.rsplit("-", 1)[1]) == chips
    premium = yaml.safe_load(maps["service-classes-config"]["premium.yaml"])
    sc = cfg["service_class"]
    assert (sc["name"], sc["priority"]) == (premium["name"], premium["priority"])
    assert (sc["slo_ttft_ms"], sc["slo_tpot_ms"]) == (
        premium["data"][0]["slo-ttft"], premium["data"][0]["slo-tpot"])
    # every variant is sized on each shape its model has a profile for
    fleet = common.load_generator(cfg["generator"]).make({**cfg, "variants": 40}, 3)
    spec = cycle.build_spec(fleet)
    offered = {(m.name, m.acc) for m in spec.models}
    for i, server in enumerate(spec.servers):
        base = next(m for m in cfg["models"] if server.model.startswith(m["name"] + "-ft"))
        assert {a for n, a in offered if n == server.model} == set(base["profiles"])
        assert server.current_alloc.accelerator in base["profiles"]


def test_roofline_counts_match_hand_counts():
    """The work counts at two chain lengths, 128 and 2,048 head states,
    against counts made by hand."""
    from benchmark import roofline

    # f32 halvings of [1, 2]: towards 1, hi reaches the float after 1 in
    # 23 steps and the 24th leaves the interval as it was; towards 2, the
    # 24th step's mid rounds up to 2 itself and the 25th changes nothing
    assert roofline.f32_steps([1.0, 1.0, 1.0], [2.0, 2.0, 2.0], [1.0, 2.0, 1.5],
                              [False, False, True]).tolist() == [23, 24, 0]
    lanes = {"batch": np.array([128.0, 2048.0, 2048.0]), "zero": np.array([False, False, True])}
    sized = {"lam_min": np.ones(3), "lam_max": np.full(3, 2.0), "lam_ttft": np.ones(3),
             "fixed_ttft": np.array([False, True, True]), "lam_itl": np.full(3, 2.0),
             "fixed_itl": np.array([False, True, True])}
    full = np.array([True, False, True])  # the third lane carries no load
    refold = np.array([False, True, False])
    # lane 0: 128 states x (two ends, throughput, operating point + 23 + 24
    # bisection steps); lane 1: one evaluation of 2,048 states
    elements = 128 * (4 + 23 + 24) + 2048
    want = elements * 11 / 67e12
    assert want > 2 * (12 * 4 + 8 * 4) / 3.35e12  # the operations bind, not the bytes
    assert roofline.cycle_bound_s(lanes, sized, full, refold) == pytest.approx(want, rel=1e-12)
    # a cycle that changes nothing needs nothing
    assert roofline.cycle_bound_s(lanes, None, np.zeros(3, bool), np.zeros(3, bool)) == 0.0


@pytest.mark.parametrize("cell", _support.cells())
def test_reference_agrees_with_the_program(cell, tmp_path):
    """At a 60-variant fleet the reference agrees with the program's plain
    torch path on the CPU within the cell's limits."""
    root = _support.small_root(tmp_path)
    result = _support.run_small(root, cell, seconds=1.0)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1


def test_last_line_has_the_result_keys(tmp_path):
    root = _support.small_root(tmp_path)
    result = _support.run_small(root, LIVE, seconds=0.5)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    doc = common.benchmark_doc(root)
    want = {m["name"] for m in common.metrics_for(doc, LIVE, "end_to_end")}
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and limits added
    as new files, and entries added to BENCHMARK.json, are all the harness
    needs to plan and run the new cell."""
    root = _support.small_root(tmp_path, variants=30)
    bench = os.path.join(root, "benchmark")
    cfg = common.load_json(os.path.join(bench, "configs", CONFIG + ".json"))
    cfg["variants"] = 25
    with open(os.path.join(bench, "configs", "throwaway.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "half_rates.json"), "w") as f:
        json.dump({"entry": "cycle", "warm_cycles": 1, "sample_within": 2,
                   "cycle": {"rate": {"fraction": 0.5, "scale": [0.5, 1.5]}}}, f)
    with open(os.path.join(bench, "metrics", "throwaway_ms.py"), "w") as f:
        f.write("def read(ctx):\n    return sum(ctx['step_ms'])\n")
    with open(os.path.join(bench, "limits", "throwaway.half_rates.json"), "w") as f:
        json.dump(common.load_json(os.path.join(bench, "limits", LIVE + ".json")), f)
    doc = common.benchmark_doc(root)
    doc["configs"].append({**doc["configs"][0], "name": "throwaway",
                           "file": "benchmark/configs/throwaway.json"})
    doc["workloads"].append({"name": "throwaway.half_rates", "config": "throwaway",
                             "traffic": "half_rates", "chips": 1, "why": "a test"})
    doc["per_layer"].append({"name": "throwaway_ms", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "test", "moves": "cycle_ms",
                             "workloads": ["throwaway.half_rates"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    assert [m["name"] for m in common.metrics_for(doc, "throwaway.half_rates", "per_layer")] == [
        "throwaway_ms"]
    result = _support.run_small(root, "throwaway.half_rates", seconds=0.5, trace=1)
    assert result["correct"], result["checks"]
    assert "throwaway_ms" in result["metrics"]


@pytest.mark.cuda
def test_card_smoke_runs_one_cell():
    """One cell for 10 s through the command, on the card."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")
    out = subprocess.run(
        [sys.executable, os.path.join(common.BENCH, "run.py"), "--workload", _support.cells()[0],
         "--seed", str(2**31 + 3), "--seconds", "10", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=600, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
