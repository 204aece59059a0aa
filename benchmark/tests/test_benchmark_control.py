"""The control comes out not correct: the reference put in the program's
place at bfloat16, the precision below the configuration's float32, on
three seeds, at a size the CPU holds. (`benchmark/readings.py` reads the
same at each cell's own size on the card; the limits files give those
readings.)"""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import common
from benchmark.tests import _support


@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 2**31 + 23])
@pytest.mark.parametrize("cell", _support.cells())
def test_control_fails_and_the_program_passes(cell, seed, tmp_path):
    root = _support.small_root(tmp_path)
    doc = common.benchmark_doc(root)
    w = common.cell(doc, cell)
    bench_dir = os.path.join(root, "benchmark")
    config = common.config_of(doc, w, root)
    mix = common.mix(w["traffic"], bench_dir)
    limits = common.limits(cell, bench_dir)
    assert config["precision"] == "float32"
    bench = common.load_entry(mix["entry"]).Bench(config, mix, seed, torch.device("cpu"), "torch",
                                                  common.Spans())
    bench.warm()
    for _ in range(4):
        bench.step()
    bench.finish()
    program = bench.check(limits)
    control = bench.check(limits, program=torch.bfloat16)
    assert all(v <= lim for _, v, lim in program), program
    assert any(not v <= lim for _, v, lim in control), control
