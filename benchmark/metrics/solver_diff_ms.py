"""solver_diff_ms: the per-server diffs (solver/solver.py::Solver.solve),
the program's `solver_diff_ms` counter, ms a cycle over the traced
window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["solver_diff_ms"] / n if n and "solver_diff_ms" in c else None
