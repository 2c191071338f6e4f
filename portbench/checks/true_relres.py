"""A linear solve A x = b by its true residual: ‖b - A x‖₂ / ‖b‖₂ with the
product in float64 from the benchmark's own A, for each compared call.
The control runs the reference's own IC(0) and PCG."""
from __future__ import annotations

import torch

from portbench.checks import PRECISION_BELOW
from portbench.reference.matrices import ichol0
from portbench.reference.solve import Pcg, Spmv


def compare(run) -> dict:
    matvec = Spmv(run.matrix, dtype=torch.float64, device=run.device)
    values = {}
    for i, b, x in run.kept:
        b = b.to(device=run.device, dtype=torch.float64)
        res = float(torch.linalg.norm(b - matvec(x)) / torch.linalg.norm(b))
        values[i] = res if res == res else float("inf")
    return values


def control(matrix, rhs, config, device) -> list:
    low = PRECISION_BELOW[config["dtype"]]
    solve = Pcg(matrix, ichol0(matrix), dtype=low, device=device)
    cg = config["cg"]
    return [solve(b, tol=cg["tol"], maxiter=cg["maxiter"])[0].float() for b in rhs]
