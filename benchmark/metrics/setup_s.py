"""setup_s: seconds from the start of the process to the first timed step
(imports, the card's context, building the inputs, every kernel build
and cold pass, the warm steps)."""


def read(ctx):
    return ctx["setup_s"]
