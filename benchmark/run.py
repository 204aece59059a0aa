"""Run one cell of the benchmark of `inferno_tpu_torch` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix (found by name, see
README.md), sets up and warms the program, drives it back to back for
`--seconds`, checks what the window produced against the plain
reference, and prints one JSON line: the cell's end-to-end metrics
(`--trace 0`) or its per-layer metrics from a profiled window
(`--trace 1`). Exits non-zero, printing no result, without a CUDA card
or with a module of JAX or of the JAX package loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "inferno_tpu")


def forbidden_modules() -> list[str]:
    """Modules of JAX or the JAX package in this process, by whole
    top-level name (`inferno_tpu_torch` is not `inferno_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def run_cell(doc, cell_name, seed, seconds, trace, device, backend, t_start, root=ROOT):
    """One run of a cell on `device` with the program's `backend`; the
    result line as a dict. `root` is the checkout whose BENCHMARK.json
    `doc` is."""
    import torch

    from benchmark import common
    from benchmark import trace as tracing
    from inferno_tpu_torch.obs.profiler import CycleProfiler

    w = common.cell(doc, cell_name)
    bench_dir = os.path.join(root, "benchmark")
    config = common.config_of(doc, w, root)
    mix = common.mix(w["traffic"], bench_dir)
    limits = common.limits(cell_name, bench_dir)
    entry = common.load_entry(mix["entry"])
    spans = common.Spans(traced=bool(trace))
    bench = entry.Bench(config, mix, seed, device, backend, spans)
    bench.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    spans.clear()
    counters = CycleProfiler() if trace else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        counters.activate()
    step_ms, units = [], 0
    with (torch.profiler.record_function(tracing.WINDOW) if trace else contextlib.nullcontext()):
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            ms, done = bench.step()
            step_ms.append(ms)
            units += done
        window_s = time.perf_counter() - w0
    t_closed = time.perf_counter()
    if trace:
        counters.deactivate()
        t_stop = time.perf_counter()
        prof.__exit__(None, None, None)
        print(f"benchmark: the profiler took {time.perf_counter() - t_stop:.2f} s to stop",
              file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rss_mib = common.rss_hwm_mib()
    bench.finish()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = bench.check(limits)
    failed = sum(1 for _, value, limit in checks if not value <= limit)
    t_check = time.perf_counter() - t_check

    t_read = time.perf_counter()
    ctx = {
        "setup_s": setup_s, "window_s": window_s, "step_ms": step_ms, "units": units,
        "rss_mib": rss_mib, "spans": spans.ms,
        "counters": counters.counters if counters else {},
        "trace": tracing.summarize(prof) if trace and device.type == "cuda" else None,
    }
    t_entry = time.perf_counter()
    ctx["entry"] = bench.layer_context(bool(trace))
    if trace:
        print(f"benchmark: reading the trace {t_entry - t_read:.2f} s, the entry's "
              f"readings {time.perf_counter() - t_entry:.2f} s", file=sys.stderr)
    print(f"benchmark: {cell_name} seed {seed}: set-up {setup_s:.2f} s, {len(step_ms)} steps "
          f"in {window_s:.2f} s, check {t_check:.2f} s, {time.perf_counter() - t_closed:.2f} s "
          f"from the window's close", file=sys.stderr)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in common.metrics_for(doc, cell_name, kind):
        value = common.load_reader(m["name"], bench_dir).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": w["chips"],
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": failed == 0, "attempted": len(step_ms), "failed": failed,
              "metrics": metrics, "device": dev}
    if ctx["trace"] is not None:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"],
                               "idle_gaps": ctx["trace"]["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    from benchmark import common

    doc = common.benchmark_doc()
    w = common.cell(doc, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"benchmark: {w['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(doc, args.workload, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
