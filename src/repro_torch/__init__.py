"""``repro_torch`` — the sparse triangular solver in PyTorch, for one
NVIDIA H100.

A port of the JAX package ``repro`` (which stays the reference): the
numpy inspector (DAG, GrowLocal schedule, §5 reorder, plan compiler) is
copied, the executors are PyTorch, and the kernels — bulk and elastic
SpTRSV, and SpMV on a sliced layout — are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use. It imports nothing of
``repro`` and nothing of JAX.

    from repro_torch import TriangularSolver, factor_pair

    solver = TriangularSolver.plan(L)      # growlocal, k=8, kernel, cuda
    x = solver.solve(b)                    # b: f[n] or f[n, m]
    solver.numeric_update(L_new_values)    # same pattern, new values
    TriangularSolver.plan(L, mode="elastic")  # fewer barriers, same bits

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from repro_torch.pipeline import (
    CacheStats,
    PlanCache,
    ScheduleOptions,
    TriangularSolver,
    factor_pair,
    pattern_fingerprint,
)

__all__ = [
    "CacheStats",
    "PlanCache",
    "ScheduleOptions",
    "TriangularSolver",
    "factor_pair",
    "pattern_fingerprint",
]
