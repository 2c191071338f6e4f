"""The front door for every triangular solve of the port:

    from repro_torch.pipeline import TriangularSolver, PlanCache, factor_pair

    cache = PlanCache()
    solver = TriangularSolver.plan(L, k=8, cache=cache)   # on the card
    x = solver.solve(b)           # b: f[n] or batched f[n, m]

    fwd, bwd = factor_pair(Lf)    # L y = b, then L^T x = y (PCG's M^{-1})

``strategy="auto"`` hands the choice to the autotuner
(``repro_torch.autotune``: DAG features -> rule shortlist -> §2.2 cost
model; ``tune=True`` adds measured trials); the outcome is memoized in the
``PlanCache``.

Module map:

  * ``registry``  — named scheduling strategies behind one signature
  * ``solver``    — ``TriangularSolver`` / ``factor_pair`` (plan + bind),
                    ``grouped_solve`` / ``GroupBank`` (one width class)
  * ``cache``     — sparsity-pattern-keyed plan cache with hit/miss stats
"""
from repro_torch.pipeline.cache import CacheStats, PlanCache
from repro_torch.pipeline.registry import (
    ScheduleOptions,
    available_strategies,
    get_scheduler,
    register_scheduler,
    schedule,
)
from repro_torch.pipeline.solver import (
    GroupBank,
    TriangularSolver,
    factor_pair,
    grouped_solve,
)
from repro_torch.sparse.csr import pattern_fingerprint

__all__ = [
    "CacheStats",
    "PlanCache",
    "pattern_fingerprint",
    "ScheduleOptions",
    "available_strategies",
    "get_scheduler",
    "register_scheduler",
    "schedule",
    "GroupBank",
    "TriangularSolver",
    "factor_pair",
    "grouped_solve",
]
