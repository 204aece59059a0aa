"""solver_solution_ms: the solution (core/system.py::generate_solution),
the program's `solver_solution_ms` counter, ms a cycle over the traced
window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["solver_solution_ms"] / n if n and "solver_solution_ms" in c else None
