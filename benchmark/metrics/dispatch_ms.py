"""dispatch_ms: the gathered solve (parallel/fleet.py::solve_slots, its
kernels and the copy back), the program's `jit_execute_ms` plus
`jit_compile_ms` counters (names kept from the JAX package; on the port
they time the dispatch), ms a cycle over the traced window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    keys = [k for k in ("jit_execute_ms", "jit_compile_ms") if k in c]
    return sum(c[k] for k in keys) / n if n and keys else None
