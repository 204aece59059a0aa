"""snapshot_ms: the snapshot update and dirty scan (parallel/snapshot.py,
parallel/incremental.py), the program's `snapshot_update_ms` counter, ms
a cycle over the traced window."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    return c["snapshot_update_ms"] / n if n and "snapshot_update_ms" in c else None
