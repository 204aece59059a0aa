"""Shared helpers of the benchmark's tests: a small copy of the benchmark
(its BENCHMARK.json and data files, with the fleet cut to a size the
CPU holds) in a temporary checkout, run on the CPU with the program's
plain torch path."""

from __future__ import annotations

import json
import os
import shutil
import time

import torch

from benchmark import common
from benchmark.run import run_cell

SMALL_VARIANTS = 60


def small_root(tmp_path, variants: int = SMALL_VARIANTS) -> str:
    """A checkout holding BENCHMARK.json and the benchmark's files, with
    every configuration cut to `variants` variants."""
    root = str(tmp_path / "checkout")
    shutil.copytree(common.BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), root)
    for name in os.listdir(os.path.join(root, "benchmark", "configs")):
        path = os.path.join(root, "benchmark", "configs", name)
        cfg = common.load_json(path)
        cfg["variants"] = variants
        with open(path, "w") as f:
            json.dump(cfg, f)
    return root


def run_small(root: str, cell: str, seed: int = 2**31 + 7, seconds: float = 1.0, trace: int = 0):
    doc = common.benchmark_doc(root)
    return run_cell(doc, cell, seed, seconds, trace, torch.device("cpu"), "torch",
                    time.perf_counter(), root=root)


def cells(root: str = common.ROOT) -> list[str]:
    return [w["name"] for w in common.benchmark_doc(root)["workloads"]]
