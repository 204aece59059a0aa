"""solver_assign_ms: the assignment (solver/solver.py: `solve_unlimited` or
the greedy), the program's `solver_assign_ms` counter, ms a cycle over the
traced window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["solver_assign_ms"] / n if n and "solver_assign_ms" in c else None
