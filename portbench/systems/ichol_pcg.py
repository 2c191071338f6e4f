"""IC(0)-preconditioned CG: in set-up the program's ``ichol0`` and
``factor_pair`` (forward and backward factor solvers), then
``cg_solve(A, b, precond=bwd∘fwd)`` a call, to the configuration's
tolerance. The iterations and the final relative residual that each call
reports are kept for the checks and the metrics."""
from __future__ import annotations

import torch

from portbench.reference.matrices import Csr


class System:
    def __init__(self, matrix: Csr, config: dict, device: torch.device):
        from repro_torch.pipeline import factor_pair
        from repro_torch.solver.cg import cg_solve
        from repro_torch.sparse.csr import CSRMatrix
        from repro_torch.sparse.ichol import ichol0

        self._cg = cg_solve
        self.A = CSRMatrix(matrix.n, matrix.n, matrix.indptr.copy(), matrix.indices.copy(),
                           matrix.data.copy())
        self.dtype = getattr(torch, config["dtype"])
        self.device = device
        self.tol, self.maxiter = config["cg"]["tol"], config["cg"]["maxiter"]
        self.fwd, self.bwd = factor_pair(ichol0(self.A), device=device, dtype=self.dtype,
                                         **config.get("plan", {}))
        self.iters, self.relres = [], []  # as each timed call reports them

    def _solve(self, rhs, maxiter):
        return self._cg(self.A, rhs, precond=lambda r: self.bwd(self.fwd(r)), tol=self.tol,
                        maxiter=maxiter, dtype=self.dtype, device=self.device)

    def warmup(self, rhs: torch.Tensor) -> None:
        # every shape of a call: the matvec, both factor solves, the dots
        self._solve(rhs, 1)

    def call(self, rhs: torch.Tensor) -> torch.Tensor:
        x, iters, relres = self._solve(rhs, self.maxiter)
        self.iters.append(iters)
        self.relres.append(relres)
        return x

    def counters(self) -> dict:
        return {"plan_s": self.fwd.inspector_seconds + self.bwd.inspector_seconds,
                "levels": (self.fwd.bound.describe()["n_levels"]
                           + self.bwd.bound.describe()["n_levels"]),
                "iters": list(self.iters), "relres": list(self.relres),
                "maxiter": self.maxiter}

    def close(self) -> None:
        del self.fwd, self.bwd, self.A
