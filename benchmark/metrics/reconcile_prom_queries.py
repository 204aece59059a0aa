"""reconcile_prom_queries: Prometheus queries a reconcile cycle issues
(the cycle profile's `prom_queries`, summed over the window's cycles by
the entry): about 7 with grouped collection, one set a variant if it falls
back."""


def read(ctx):
    c = (ctx.get("entry") or {}).get("cycle_counters", {})
    n = len(ctx["step_ms"])
    return c["prom_queries"] / n if n and "prom_queries" in c else None
