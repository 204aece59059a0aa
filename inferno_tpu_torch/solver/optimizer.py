"""Optimizer: the one-call entry point for an optimization cycle.

Combines the reference's optimizer wrapper (wall-clock measurement,
upstream pkg/solver/optimizer.go:24-48) and manager
(upstream pkg/manager/manager.go:13-27) — without the manager's
singleton assignment: callers pass the `System` in and get a solution out.

Port copy of `inferno_tpu/solver/optimizer.py`, verbatim apart from its
imports and the cycle profiler's spans (`obs/profiler.py`): `solver_pools`
around `allocate_by_pool`, `solver_solution` around `generate_solution`.
Callers size candidates with `parallel.calculate_fleet` first and pass
`calculate=False`.
"""

from __future__ import annotations

import dataclasses
import time

from inferno_tpu_torch.config.types import AllocationData, OptimizerSpec
from inferno_tpu_torch.core.allocation import AllocationDiff
from inferno_tpu_torch.core.system import PoolUsage, System

# cycle-profiler hooks (obs/profiler.py): thread-local no-ops unless a
# profiler is active; observation only
from inferno_tpu_torch.obs import profiler as _prof
from inferno_tpu_torch.solver.solver import Solver


@dataclasses.dataclass
class OptimizationResult:
    solution: dict[str, AllocationData]
    diffs: dict[str, AllocationDiff]
    pool_usage: dict[str, PoolUsage]
    solution_time_msec: float  # solver wall-clock (the BASELINE metric)
    analysis_time_msec: float  # candidate-sizing wall-clock
    # capacity degradations the limited-mode solve recorded (server ->
    # solver.greedy.DegradationEvent); empty in unlimited mode
    degradations: dict = dataclasses.field(default_factory=dict)


class Optimizer:
    """(reference: pkg/solver/optimizer.go:13-48)"""

    def __init__(self, spec: OptimizerSpec | None = None):
        self.spec = spec or OptimizerSpec()
        self.solver = Solver(self.spec)
        self.solution_time_msec = 0.0

    def optimize(
        self, system: System, calculate: bool | None = None
    ) -> OptimizationResult:
        """Run (optionally) candidate sizing and the assignment solve.

        calculate=None (default) sizes candidates only if no server has
        any yet — so a system prepared by `calculate_fleet` (the TPU
        path) is not silently re-sized by the scalar path. True forces a
        re-size; False skips it.
        """
        t0 = time.perf_counter()
        if calculate or (calculate is None and not system.candidates_calculated):
            # auto (None): size only if nobody has sized this system yet, so
            # a system prepared by calculate_fleet (the TPU path) is not
            # silently re-sized by the scalar loop — including servers the
            # fleet path found infeasible. A System is a per-cycle value
            # (the controller rebuilds it each reconcile, like the
            # reference); mutating loads between optimize() calls requires
            # calculate=True.
            system.calculate_all()
        t1 = time.perf_counter()
        self.solver.solve(system)
        self.solution_time_msec = (time.perf_counter() - t1) * 1000.0
        with _prof.span("solver_pools"):
            usage = system.allocate_by_pool()
        with _prof.span("solver_solution"):
            solution = system.generate_solution()
        return OptimizationResult(
            solution=solution,
            diffs=self.solver.diff_allocation,
            pool_usage=usage,
            solution_time_msec=self.solution_time_msec,
            analysis_time_msec=(t1 - t0) * 1000.0,
            degradations=dict(getattr(system, "degradations", {}) or {}),
        )


def optimize(system: System, spec: OptimizerSpec | None = None) -> OptimizationResult:
    """Convenience one-shot optimization."""
    return Optimizer(spec).optimize(system)
