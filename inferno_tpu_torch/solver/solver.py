"""Allocation assignment solver.

Capability parity with upstream pkg/solver/solver.go:13-93: snapshot
current allocations, dispatch to unlimited or greedy mode, compute
per-server orchestration diffs. Takes the `System` explicitly (no
singletons).

Port copy of `inferno_tpu/solver/solver.py`. Unlimited mode only: the
incremental-cycle replay hooks and the capacity-limited greedy solvers
(`greedy.py`, `greedy_vec.py`) are later slices of the port, and limited
mode raises until they land.
"""

from __future__ import annotations

from inferno_tpu_torch.config.types import OptimizerSpec
from inferno_tpu_torch.core.allocation import Allocation, AllocationDiff, allocation_diff
from inferno_tpu_torch.core.system import System


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
    instead of a Python scan over every lane."""
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
        if not self.optimizer_spec.unlimited:
            raise NotImplementedError(
                "capacity-limited mode is not ported yet (the reference's "
                "solver/greedy.py and solver/greedy_vec.py are a later slice)"
            )
        # cur_allocation is always a value (an empty accelerator means "no
        # allocation"); allocation_diff normalizes that to "none"
        self.current_allocation = {
            name: server.cur_allocation for name, server in system.servers.items()
        }

        system.degradations = {}
        solve_unlimited(system)

        self.diff_allocation = {}
        for name, server in system.servers.items():
            diff = allocation_diff(self.current_allocation.get(name), server.allocation)
            if diff is not None:
                self.diff_allocation[name] = diff
