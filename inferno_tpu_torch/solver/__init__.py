"""Port copy of `inferno_tpu/solver/__init__.py`, verbatim apart from its imports."""

from inferno_tpu_torch.solver.greedy import (
    DegradationEvent,
    solve_greedy,
)
from inferno_tpu_torch.solver.greedy_vec import solve_greedy_fleet
from inferno_tpu_torch.solver.solver import Solver, solve_unlimited
from inferno_tpu_torch.solver.optimizer import Optimizer, optimize

__all__ = [
    "Solver",
    "solve_unlimited",
    "solve_greedy",
    "solve_greedy_fleet",
    "DegradationEvent",
    "Optimizer",
    "optimize",
]
