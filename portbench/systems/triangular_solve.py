"""Plan once, solve many: ``TriangularSolver.plan(L)`` in set-up, then
``solver.solve(b)`` a call, b f[n] or f[n, m] in the caller's row order."""
from __future__ import annotations

import torch

from portbench.reference.matrices import Csr


class System:
    def __init__(self, matrix: Csr, config: dict, device: torch.device):
        from repro_torch.pipeline import TriangularSolver
        from repro_torch.sparse.csr import CSRMatrix

        L = CSRMatrix(matrix.n, matrix.n, matrix.indptr.copy(), matrix.indices.copy(),
                      matrix.data.copy())
        self.solver = TriangularSolver.plan(
            L, device=device, dtype=getattr(torch, config["dtype"]), **config.get("plan", {}))

    def warmup(self, rhs: torch.Tensor) -> None:
        self.solver.solve(rhs)

    def call(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.solver.solve(rhs)

    def counters(self) -> dict:
        return {"plan_s": self.solver.inspector_seconds,
                "levels": self.solver.bound.describe()["n_levels"],
                "supersteps": self.solver.n_supersteps}

    def close(self) -> None:
        del self.solver
