"""sizing_roofline_pct: the least time the card could take for the sizing
work the window's changed inputs need (benchmark/roofline.py), over the
device's busy time in the traced window (every kernel, copy and set, not
chosen by name). Nothing when the window changed nothing or the card was
never busy."""


def read(ctx):
    trace = ctx["trace"]
    bound = ctx["entry"].get("sizing_bound_s")
    if not trace or not bound or trace["busy_s"] <= 0:
        return None
    return 100.0 * bound / trace["busy_s"]
