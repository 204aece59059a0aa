"""Allocation assignment solver.

Capability parity with upstream pkg/solver/solver.go:13-93: snapshot
current allocations, dispatch to unlimited or greedy mode, compute
per-server orchestration diffs. Takes the `System` explicitly (no
singletons).

Port copy of `inferno_tpu/solver/solver.py`, verbatim apart from its
imports and the cycle profiler's spans (`obs/profiler.py`): `solver_assign`
around the assignment, `solver_diff` around the diffs.
"""

from __future__ import annotations

from inferno_tpu_torch.config.types import OptimizerSpec
from inferno_tpu_torch.core.allocation import Allocation, AllocationDiff, allocation_diff
from inferno_tpu_torch.core.system import System

# cycle-profiler hooks (obs/profiler.py): thread-local no-ops unless a
# profiler is active; observation only
from inferno_tpu_torch.obs import profiler as _prof
from inferno_tpu_torch.solver.greedy import solve_greedy
from inferno_tpu_torch.solver.greedy_vec import solve_greedy_fleet


def solve_unlimited(system: System) -> None:
    """Unlimited chip capacity: each server independently takes its
    minimum-value (cheapest after transition penalty) candidate
    (reference SolveUnlimited: pkg/solver/solver.go:63-79).

    Ties break deterministically by (value, cost, accelerator name) —
    NOT dict insertion order — so the pick is bit-reproducible against
    the vectorized per-server argmin `parallel.fleet.calculate_fleet`
    precomputes. Candidates sized by the fleet path arrive as
    `LaneAllocations` whose `best()` IS that argmin: consuming it keeps
    the solve O(servers) with one materialized Allocation per server
    instead of a Python scan over every lane.

    Systems sized by the incremental fleet cycle
    (parallel/incremental.py) additionally replay clean servers'
    standing allocations: on a persistent System only dirty servers'
    picks are re-applied — bit-identical to the full loop, since a clean
    server's best() is the exact object it already holds."""
    if getattr(system, "fleet_dirty", None) is not None:
        from inferno_tpu_torch.parallel.incremental import (
            record_unlimited,
            try_unlimited_replay,
        )

        if try_unlimited_replay(system):
            return
        _solve_unlimited_full(system)
        record_unlimited(system)
        return
    _solve_unlimited_full(system)


def _solve_unlimited_full(system: System) -> None:
    for server in system.servers.values():
        server.remove_allocation()
        allocs = server.all_allocations
        picker = getattr(allocs, "best", None)
        if picker is not None:
            best = picker()
        else:
            best: Allocation | None = None
            for alloc in allocs.values():
                if best is None or (alloc.value, alloc.cost, alloc.accelerator) < (
                    best.value, best.cost, best.accelerator
                ):
                    best = alloc
        if best is not None:
            server.set_allocation(best)


class Solver:
    """(reference: pkg/solver/solver.go:13-59)"""

    def __init__(self, optimizer_spec: OptimizerSpec):
        self.optimizer_spec = optimizer_spec
        self.current_allocation: dict[str, Allocation] = {}
        self.diff_allocation: dict[str, AllocationDiff] = {}

    def solve(self, system: System) -> None:
        # cur_allocation is always a value (an empty accelerator means "no
        # allocation"); allocation_diff normalizes that to "none"
        self.current_allocation = {
            name: server.cur_allocation for name, server in system.servers.items()
        }

        with _prof.span("solver_assign"):
            if self.optimizer_spec.unlimited:
                system.degradations = {}
                solve_unlimited(system)
            else:
                # limited mode: the vectorized solver consumes the columnar
                # candidate table when batched sizing attached one
                # (system.fleet_candidates); systems sized scalar fall back
                # to the scalar greedy inside — results are bit-identical
                solve_greedy_fleet(system, self.optimizer_spec)

        self.diff_allocation = {}
        with _prof.span("solver_diff"):
            for name, server in system.servers.items():
                diff = allocation_diff(self.current_allocation.get(name), server.allocation)
                if diff is not None:
                    self.diff_allocation[name] = diff
