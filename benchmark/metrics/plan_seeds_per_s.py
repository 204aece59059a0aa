"""plan_seeds_per_s: a capacity planner's throughput, every ensemble
member completed in the window over the window's seconds."""


def read(ctx):
    return ctx["units"] / ctx["window_s"] if ctx["units"] else None
