"""plan_feed_ms: the planner's envelope accumulator folding each slab of rows
(planner/montecarlo.py::_EnvelopeAccumulator.feed), the program's
`plan_feed_ms` counter, ms a call over the traced window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["plan_feed_ms"] / n if n and "plan_feed_ms" in c else None
