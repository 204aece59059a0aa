"""plan_rows_ms: the planner's rows (planner/montecarlo.py: generating each
member's rows, the per-row fold and argmin on the host, the aggregate),
the rest of the program's own profile, ms a call over the window."""


def read(ctx):
    return ctx["entry"].get("plan_rows_ms")
