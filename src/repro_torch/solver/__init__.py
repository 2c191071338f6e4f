"""Executors over compiled plans (the plain PyTorch one, for now)."""
from repro_torch.solver.executor import (
    PlanArrays,
    make_solver,
    plan_arrays,
    solve_with_plan,
)

__all__ = ["PlanArrays", "make_solver", "plan_arrays", "solve_with_plan"]
