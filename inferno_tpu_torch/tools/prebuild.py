"""Build the port's two libraries inside its source tree, for a wheel that
ships them.

    python -m inferno_tpu_torch.tools.prebuild

Run from the root of a source tree (the directory that holds
`pyproject.toml`). It compiles the CUDA kernel library
(`ops.cuda_queueing.build()`: nvcc for sm_90a, into `ops/_build/`) and the
native solver (`native`, g++, beside `queueing.cc`), then raises unless
both files exist. A wheel built from that tree afterwards ships both
libraries under their content-addressed names (the package data lists
them), and an installed copy loads them as they are: no nvcc, no g++ and
no writable site-packages at run time. The image's build stage runs this
(`Dockerfile.torch`), as the reference's image builds its native library
before packaging.

nvcc compiles for a named architecture, so no CUDA device is needed:
nothing here calls into `torch.cuda`, and the command raises if CUDA was
initialised all the same. Prints one line per library: its path relative
to the tree, its size in bytes, and the seconds this command spent on it
(next to nothing where the tree already held it).
"""

from __future__ import annotations

import os
import sys
import time


def main() -> int:
    import torch

    from inferno_tpu_torch import native
    from inferno_tpu_torch.ops import cuda_queueing

    def build_native() -> str:
        native._load()
        return native._lib_path()

    root = os.getcwd()
    built = []
    for build in (cuda_queueing.build, build_native):
        t0 = time.perf_counter()  # noqa: INF005 (the build's own duration, printed)
        path = build()
        built.append((path, time.perf_counter() - t0))  # noqa: INF005 (as above)
    for path, seconds in built:
        if not os.path.isfile(path):
            raise RuntimeError(f"prebuild: {path} was not built")
        print(f"{os.path.relpath(path, root)} {os.path.getsize(path)} bytes {seconds:.1f} s")
    if torch.cuda.is_initialized():
        raise RuntimeError("prebuild: CUDA was initialised; the build must not need a card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
