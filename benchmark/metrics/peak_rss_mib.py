"""peak_rss_mib: the memory the controller pod's manifest must grant, the
process's peak resident set (ru_maxrss) when the window closes."""


def read(ctx):
    return ctx["rss_mib"]
