"""device_idle_pct.reconcile: the share of the traced window of the
reconcile cell in which no operation ran on the card."""


def read(ctx):
    trace = ctx["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
