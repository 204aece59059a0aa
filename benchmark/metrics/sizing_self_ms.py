"""sizing_self_ms: fleet sizing's own work, `calculate_fleet`'s gather,
pack and unpack around its layers: the program's `calculate_fleet_self_ms`
counter (the `calculate_fleet` span's time less that of the spans that
closed directly inside it), ms a cycle over the traced window. Nothing
where the program has no such counter."""


def read(ctx):
    c, n = ctx["counters"], len(ctx["step_ms"])
    if not n or "calculate_fleet_self_ms" not in c:
        return None
    return c["calculate_fleet_self_ms"] / n
