"""plan_fold_ms: the planner's per-row fold and argmin on the host
(parallel/fleet.py::FleetBatchPrep._solve_chunk), the program's
`plan_fold_ms` counter, ms a call over the traced window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["plan_fold_ms"] / n if n and "plan_fold_ms" in c else None
