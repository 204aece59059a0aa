"""Run one function on n `torch.distributed` ranks, one subprocess each.

The port's counterpart of the reference's multi-device programs
(`__graft_entry__.py` re-executes itself in a subprocess pinned to n
virtual CPU devices): torch runs one rank a process. `run_ranks` starts
n interpreters, each `python -m inferno_tpu_torch.parallel.ranks`, with
`MASTER_ADDR=127.0.0.1`, a free port, its rank and the world size; each
joins the process group (NCCL on n cards, one card a rank, when the
caller asks for the card; gloo on the CPU only when the caller asks for
`device="cpu"`), calls `module:function(**kwargs)` and pickles its return
value for the parent. A rank that exits non-zero, or a call that outlives
its timeout, stops every rank and raises with the failed ranks' output
tails. Nothing falls back from NCCL to gloo.

This module has no reference counterpart: it is how the port's
`graft_entry.dryrun_multichip` and the multi-rank tests start ranks.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_FAIL_GRACE_S = 2.0  # how long the other ranks get to exit after one fails


def rank_backend(n: int, device) -> str:
    """"nccl" for `device=None` or a CUDA device (n visible cards needed,
    else it raises), "gloo" for `device="cpu"`."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"ranks run on CUDA (NCCL) or the CPU (gloo), not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for NCCL ranks: pass device='cpu' to run the ranks "
            "on the CPU with gloo"
        )
    count = torch.cuda.device_count()
    if count < n:
        raise RuntimeError(f"{n} NCCL ranks need {n} CUDA devices, {count} visible")
    return "nccl"


def rank_device(backend: str, rank: int) -> torch.device:
    """The device a rank computes on: its own card under NCCL, the CPU
    under gloo."""
    return torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run_ranks(
    target: str, n: int, device=None, kwargs: dict | None = None,
    timeout: float = 900.0, path: tuple[str, ...] = (),
) -> list:
    """Call `target` ("module:function") on n ranks and return each rank's
    result, in rank order. `device` picks the backend (`rank_backend`);
    `path` adds import roots (the repo root is always first)."""
    backend = rank_backend(n, device)
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="inferno-ranks-") as tmp:
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(kwargs or {}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO_ROOT, *path, *filter(None, [env.get("PYTHONPATH")])]
        )
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n))
        procs, logs = [], []
        try:
            for rank in range(n):
                log = os.path.join(tmp, f"rank{rank}.log")
                logs.append(log)
                with open(log, "w") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "inferno_tpu_torch.parallel.ranks",
                         target, backend, tmp],
                        cwd=_REPO_ROOT, env={**env, "RANK": str(rank)},
                        stdout=out, stderr=subprocess.STDOUT,
                    ))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    # the others usually fail in a collective right after:
                    # give them a moment, then report every failed rank
                    grace = time.monotonic() + _FAIL_GRACE_S
                    while any(p.poll() is None for p in procs) and time.monotonic() < grace:
                        time.sleep(0.02)
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{n} {backend} ranks running {target} timed out after "
                        f"{timeout:.0f} s; rank 0:\n{_tail(logs[0])}"
                    )
                time.sleep(0.02)
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"rank {', '.join(map(str, failed))} of {n} ({backend}) failed running "
                    f"{target}:\n" + "\n".join(
                        f"--- rank {r} (rc={procs[r].returncode}) ---\n{_tail(logs[r])}"
                        for r in failed)
                )
            results = []
            for rank in range(n):
                with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _main(target: str, backend: str, tmp: str) -> None:
    import importlib

    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world,
        **({"device_id": torch.device("cuda", rank)} if backend == "nccl" else {}),
    )
    try:
        module, name = target.split(":")
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            kwargs = pickle.load(f)
        result = getattr(importlib.import_module(module), name)(**kwargs)
        with open(os.path.join(tmp, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(tmp, f"rank{rank}.pkl.tmp"),
                   os.path.join(tmp, f"rank{rank}.pkl"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:4])
