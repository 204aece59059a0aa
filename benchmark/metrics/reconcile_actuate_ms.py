"""reconcile_actuate_ms: the reconcile cycle's actuate phase
(`controller/reconciler.py::Reconciler._cycle_inner`), its span
`reconcile_actuate` on each cycle's own profiler, summed over the window's
cycles by the entry, ms a cycle. None where the program has no such span."""


def read(ctx):
    c = (ctx.get("entry") or {}).get("cycle_counters", {})
    n = len(ctx["step_ms"])
    return c["reconcile_actuate_ms"] / n if n and "reconcile_actuate_ms" in c else None
