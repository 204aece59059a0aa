"""The harness sees `correct` come out false when the timed path is
broken underneath, for every entry the benchmark's cells use: a step that
leaves its state unchanged, half of the batch left out, and one answer
altered where it is produced. `test_benchmark_faults.py` holds these
faults for the entries it names and stops at collection for a cell whose
entry it lacks (the reconcile entry); this file holds them for every
entry, with its own guard that each entry brings its faults. The
reconcile entry's own ways to go wrong (a status left unwritten, a gauge
changed) are in `test_benchmark_reconcile.py`. The run skips the look
for a card and drives the rest of a run on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

import inferno_tpu_torch.parallel as parallel
import inferno_tpu_torch.planner.montecarlo as montecarlo
from benchmark import common
from benchmark.tests import _support

REAL_SIZE = parallel.calculate_fleet
REAL_REPLAY = montecarlo.replay_montecarlo


def _size_unchanged(system, **kw):
    """The window's cycles return the state as it was."""
    if getattr(system, "_bench_sized", False):
        return 0
    system._bench_sized = True
    return REAL_SIZE(system, **kw)


def _size_half(system, **kw):
    """Half of the fleet sized; the other half keeps what it had (a
    `System` built afresh each cycle, as the controller's, has nothing)."""
    names = list(system.servers)
    return REAL_SIZE(system, **{**kw, "only": set(names[: len(names) // 2])})


def _size_altered(system, **kw):
    """One loaded variant's answer altered where it is produced: its
    candidates carry one replica more."""
    n = REAL_SIZE(system, **kw)
    for server in system.servers.values():
        if server.load.arrival_rate > 0 and len(server.all_allocations):
            for alloc in server.all_allocations.values():
                alloc.num_replicas += 1
            break
    return n


_first_report = {}


def _plan_unchanged(system, *args, **kw):
    """Every call returns the first call's report."""
    if id(system) not in _first_report:
        _first_report[id(system)] = REAL_REPLAY(system, *args, **kw)
    return _first_report[id(system)]


def _plan_half(system, scenario, steps, step_seconds, seeds, **kw):
    """Half of the members replayed, standing in for the rest."""
    half = max(seeds // 2, 1)
    report = REAL_REPLAY(system, scenario, steps, step_seconds, half,
                         keep_seeds=(0,), **{k: v for k, v in kw.items() if k != "keep_seeds"})
    costs = report["per_seed"]["cost_total_usd"]
    report["per_seed"]["cost_total_usd"] = [costs[k % half] for k in range(seeds)]
    report["_kept"] = {k: report["_kept"][0] for k in kw.get("keep_seeds", ())}
    return report


def _plan_altered(system, *args, **kw):
    """One kept cell's replicas altered where it is produced."""
    report = REAL_REPLAY(system, *args, **kw)
    kept = report["_kept"][0]
    loaded = np.flatnonzero(kept["choice"][0] >= 0)
    kept["replicas"][0, loaded[0]] += 1
    return report


# entry -> (the module, the function the fault replaces, the faults). The
# reconcile entry's controller builds its System afresh every cycle, so it
# has no state a step could leave unchanged: it takes the other two.
FAULTS = {
    "cycle": (parallel, "calculate_fleet", [_size_unchanged, _size_half, _size_altered]),
    "plan": (montecarlo, "replay_montecarlo", [_plan_unchanged, _plan_half, _plan_altered]),
    "reconcile": (parallel, "calculate_fleet", [_size_half, _size_altered]),
}


def _entry(cell: str) -> str:
    return common.mix(common.cell(common.benchmark_doc(), cell)["traffic"])["entry"]


def _cases():
    for cell in _support.cells():
        module, name, faults = FAULTS.get(_entry(cell), (None, None, []))
        for fault in faults:
            yield pytest.param(cell, module, name, fault, id=f"{cell}-{fault.__name__}")


@pytest.mark.parametrize("cell,module,name,fault", list(_cases()))
def test_a_broken_path_of_any_entry_is_not_correct(cell, module, name, fault, tmp_path,
                                                   monkeypatch):
    root = _support.small_root(tmp_path)
    clean = _support.run_small(root, cell, seconds=0.5)
    assert clean["correct"], clean["checks"]
    monkeypatch.setattr(module, name, fault)
    broken = _support.run_small(root, cell, seconds=0.5)
    assert not broken["correct"], broken["checks"]


def test_every_entry_of_a_cell_has_its_faults():
    for cell in _support.cells():
        assert _entry(cell) in FAULTS, cell
