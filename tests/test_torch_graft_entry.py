"""The port's graft entry (inferno_tpu_torch.graft_entry) on the CPU:
`entry(device="cpu")` against the reference's `entry()` under the
round's port-vs-reference rule (the ±1 replica rule of
__graft_entry__.py:334-376, floats within the tolerances of
test_torch_queueing.py), `dryrun_multichip(n, device="cpu")` on gloo ranks,
and the refusals: no card for `device=None`, fewer cards than ranks, a
rank that fails or outlives its timeout.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

from inferno_tpu_torch import graft_entry
from inferno_tpu_torch.parallel.ranks import run_ranks

TESTS = str(pathlib.Path(__file__).resolve().parent)


def test_entry_matches_reference_entry():
    import jax

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import __graft_entry__ as ref_graft

    from test_torch_queueing import _assert_results_match

    ref_fn, ref_args = ref_graft.entry()
    ref = jax.jit(ref_fn)(*ref_args)
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    assert got.num_replicas.shape == (64,)
    assert bool(torch.all(got.num_replicas >= 1))
    assert bool(torch.all(torch.isfinite(got.cost)))
    _assert_results_match(ref, got)


def test_example_lanes_are_the_reference_lanes():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import __graft_entry__ as ref_graft

    for got, want in zip(graft_entry._example_fleet_params(40),
                         ref_graft._example_fleet_params(40)):
        np.testing.assert_array_equal(got, want)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu(n):
    report = graft_entry.dryrun_multichip(n, device="cpu", timeout=120)
    assert report["backend"] == "gloo"
    assert (report["dp"], report["tp"]) == (n // 2, 2)
    assert report["losses"][-1] < report["losses"][0] * 0.9
    assert report["fleet_lanes"] == report["tandem_lanes"] == 16
    assert report["decode"]["acc"] == pytest.approx(report["decode"]["acc_single"], rel=2e-4)


def test_dryrun_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device for NCCL ranks"):
        graft_entry.dryrun_multichip(2)


def test_dryrun_on_more_cards_than_visible_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 CUDA devices, 1 visible"):
        graft_entry.dryrun_multichip(2)


def _fail_on_rank_one() -> None:
    """Rank 1 raises; rank 0 waits in a barrier that never completes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one gives up")
    dist.barrier()


def _sleep(seconds: float) -> None:
    import time

    time.sleep(seconds)


def test_a_failed_rank_fails_the_call():
    failed = r"(?s)of 2 \(gloo\) failed.*--- rank 1 \(rc=1\) ---.*rank one gives up"
    with pytest.raises(RuntimeError, match=failed):
        run_ranks("test_torch_graft_entry:_fail_on_rank_one", 2, "cpu",
                  timeout=120, path=(TESTS,))


def test_ranks_that_outlive_the_timeout_fail_the_call():
    with pytest.raises(RuntimeError, match="timed out after 4 s"):
        run_ranks("test_torch_graft_entry:_sleep", 2, "cpu", {"seconds": 120},
                  timeout=4, path=(TESTS,))


def test_version_is_the_reference_version():
    import inferno_tpu
    import inferno_tpu_torch

    assert inferno_tpu_torch.__version__ == inferno_tpu.__version__
