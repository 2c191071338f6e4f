"""Solvers: the plain PyTorch executors over compiled plans (bulk and
elastic, untimed and timed; grouped, banked and resident-slot solves of
one width class), the serial reference solvers, and
(preconditioned) conjugate gradient, the end-to-end consumer."""
from repro_torch.solver.executor import (
    BankTensors,
    ElasticArrays,
    PlanArrays,
    blank_rhs,
    elastic_plan_arrays,
    extract_lane,
    insert_lane,
    make_solver,
    plan_arrays,
    solve_resident,
    solve_with_bank,
    solve_with_elastic,
    solve_with_elastic_timed,
    solve_with_plan,
    solve_with_plan_group,
    solve_with_plan_timed,
    stack_plan_bank,
)
from repro_torch.solver.reference import forward_substitution, solve_lower_scipy


def __getattr__(name):
    # ``cg`` imports the pipeline, whose backends import this package's
    # executor: load it on first use, not with the package
    if name in ("cg_solve", "pcg_ichol"):
        from repro_torch.solver import cg

        return getattr(cg, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BankTensors",
    "ElasticArrays",
    "PlanArrays",
    "blank_rhs",
    "cg_solve",
    "elastic_plan_arrays",
    "extract_lane",
    "forward_substitution",
    "insert_lane",
    "make_solver",
    "pcg_ichol",
    "plan_arrays",
    "solve_lower_scipy",
    "solve_resident",
    "solve_with_bank",
    "solve_with_elastic",
    "solve_with_elastic_timed",
    "solve_with_plan",
    "solve_with_plan_group",
    "solve_with_plan_timed",
    "stack_plan_bank",
]
