"""bisect_kernel_launches: launches of the program's hand-written `bisect_kernel`
(`ops/csrc/bisect_kernel.cu`) a cycle over the window, from the program's own
launch counter (`ops/cuda_queueing.py`); nothing off the card."""


def read(ctx):
    return ctx["entry"].get("bisect_kernel_launches")
