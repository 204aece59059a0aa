"""solver_pools_ms: the pool usage (core/system.py::allocate_by_pool), the
program's `solver_pools_ms` counter, ms a cycle over the traced window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["solver_pools_ms"] / n if n and "solver_pools_ms" in c else None
