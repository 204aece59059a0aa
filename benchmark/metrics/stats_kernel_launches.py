"""stats_kernel_launches: launches of the program's hand-written `stats_kernel`
(`ops/csrc/stats_kernel.cu`) a cycle over the window, from the program's own
launch counter (`ops/cuda_queueing.py`); nothing off the card."""


def read(ctx):
    return ctx["entry"].get("stats_kernel_launches")
