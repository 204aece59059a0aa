"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds <n> --first-seed <s> \
        --cycles <c> --control-seeds <k>

For each of `--seeds` seeds the cell's entry is set up, warmed and run
for `--cycles` timed cycles at the cell's own load and size (enough to
reach the cycle drawn for the check), then the numbers `correct` is
decided by are read for the program (the lower readings) and, on the
first `--control-seeds` seeds, for the control: the reference put in the
program's place at bfloat16, the precision below the configuration's
float32 (the upper readings). One JSON line a seed; the limits files'
readings come from these lines. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROL = "bfloat16"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2**31 + 100)
    p.add_argument("--cycles", type=int, default=6)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    from benchmark import common
    from benchmark.run import _cache_dirs

    _cache_dirs()
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    doc = common.benchmark_doc()
    w = common.cell(doc, args.workload)
    config = common.config_of(doc, w)
    mix = common.mix(w["traffic"])
    limits = common.limits(args.workload)
    entry = common.load_entry(mix["entry"])
    for k in range(args.seeds):
        seed = args.first_seed + k
        t0 = time.perf_counter()
        bench = entry.Bench(config, mix, seed, device, "cuda", common.Spans())
        bench.warm()
        for _ in range(args.cycles):
            bench.step()
        bench.finish()
        line = {"workload": args.workload, "seed": seed,
                "program": {n: v for n, v, _ in bench.check(limits)}}
        if k < args.control_seeds:
            line["control"] = {n: v for n, v, _ in bench.check(limits, program=getattr(torch, CONTROL))}
        line["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
