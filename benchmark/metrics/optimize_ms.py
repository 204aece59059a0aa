"""optimize_ms: the solver (solver/), the benchmark's own host-clock span
around `Optimizer(spec).optimize(system, calculate=False)`, ms a cycle."""


def read(ctx):
    ms = ctx["spans"].get("optimize")
    return sum(ms) / len(ms) if ms else None
