"""reconcile_finish_ms: the reconcile cycle's finish after its profile is
sealed (`controller/reconciler.py::Reconciler._finish_cycle`: attainment
scoring, the decision log, the trace ring), its span `reconcile_finish`
charged to the window's profiler, ms a cycle. None where the program has
no such span."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["reconcile_finish_ms"] / n if n and "reconcile_finish_ms" in c else None
