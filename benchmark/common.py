"""What the harness finds by name: the cell in BENCHMARK.json, its
configuration file, its traffic mix, its limits, the entry that drives
it, and the readers of its metrics. Each lives in a file of its own, so
a cell, a mix, a configuration or a metric is added by adding files."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_doc(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(doc: dict, name: str) -> dict:
    for w in doc["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(doc: dict, w: dict, root: str = ROOT) -> dict:
    """The cell's configuration file, with its BENCHMARK.json entry."""
    entry = next(c for c in doc["configs"] if c["name"] == w["config"])
    return load_json(os.path.join(root, entry["file"]))


def mix(name: str, bench: str = BENCH) -> dict:
    return load_json(os.path.join(bench, "traffic", f"{name}.json"))


def limits(cell_name: str, bench: str = BENCH) -> dict:
    return load_json(os.path.join(bench, "limits", f"{cell_name}.json"))["limits"]


def load_generator(name: str):
    return importlib.import_module(f"benchmark.inputs.{name}")


def load_entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def load_reader(metric: str, bench: str = BENCH):
    """`metrics/<metric>.py`, loaded by path (a metric's name may hold a
    dot); its `read(ctx)` returns the number or None."""
    path = os.path.join(bench, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(doc: dict, cell_name: str, kind: str) -> list[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list it, and those without a list (a per-layer metric without
    one goes with every cell that reports the metric it moves)."""
    e2e = [m for m in doc["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in doc["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def rss_hwm_mib() -> float:
    """The process's peak resident set so far (getrusage's ru_maxrss, kB
    on Linux), MiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class Spans:
    """Host-clock spans taken from the benchmark's side around calls into
    the program: name -> list of ms. With `traced` each span is also a
    named range in the profiler's trace (`bench.<name>`)."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.ms: dict[str, list[float]] = {}

    def clear(self) -> None:
        self.ms = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rng = contextlib.nullcontext()
        if self.traced:
            import torch

            rng = torch.profiler.record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rng:
            yield
        self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1000.0)
