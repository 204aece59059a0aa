"""dispatch_host_ms: the gathered solve (parallel/fleet.py::solve_slots: the
buckets' launches, their kernels and the copy back), the program's
`dispatch_ms` counter, ms a cycle over the traced window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["dispatch_ms"] / n if n and "dispatch_ms" in c else None
