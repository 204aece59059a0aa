from inferno_tpu_torch.solver.solver import Solver, solve_unlimited

__all__ = ["Solver", "solve_unlimited"]
