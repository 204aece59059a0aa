"""writeback_ms: the incremental writeback (parallel/incremental.py), the
program's `incremental_writeback_ms` counter, ms a cycle over the traced
window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["incremental_writeback_ms"] / n if n and "incremental_writeback_ms" in c else None
