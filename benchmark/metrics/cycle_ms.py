"""cycle_ms: an operator's wait each interval, the summed host time of
every cycle in the window over their count (a cycle ends when its
decisions are on the host)."""


def read(ctx):
    ms = ctx["step_ms"]
    return sum(ms) / len(ms) if ms else None
