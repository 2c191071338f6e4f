"""Executors over compiled plans (the plain PyTorch ones, bulk and
elastic)."""
from repro_torch.solver.executor import (
    ElasticArrays,
    PlanArrays,
    elastic_plan_arrays,
    make_solver,
    plan_arrays,
    solve_with_elastic,
    solve_with_plan,
)

__all__ = [
    "ElasticArrays",
    "PlanArrays",
    "elastic_plan_arrays",
    "make_solver",
    "plan_arrays",
    "solve_with_elastic",
    "solve_with_plan",
]
