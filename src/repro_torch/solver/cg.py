"""(Preconditioned) conjugate gradient — the end-to-end consumer of SpTRSV.

This is the application the paper motivates (§1: iterative methods reuse one
sparsity pattern across many solves — IC(0)-preconditioned CG does two
triangular solves per iteration). A port of the JAX package's
``solver/cg.py``: ``pcg_ichol`` is a thin client of the
``repro_torch.pipeline`` front door — IC(0), then ``factor_pair`` plans the
scheduled (L, L^T) solver pair, whose ``bwd(fwd(r))`` is the
preconditioner. CG's matvec is the SpMV kernel, A bound once in its sliced
layout (``kernels.spmv.EllOperator``), one launch a matvec: deterministic,
each row one fused multiply-add chain per W entries and a sum of the
chains in order, where an ``index_add_`` segment sum would change its
order, and with it the iteration count, from run to run on CUDA.

Everything runs on ``device`` (``None``: the card, raising without CUDA).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.spmv import EllOperator
from repro_torch.pipeline import PlanCache, factor_pair
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.ichol import ichol0


def _csr_matvec_fn(a: CSRMatrix, dtype=torch.float32, device=None) -> EllOperator:
    """``a`` bound once on ``device``: ``matvec(p)`` is one launch of the
    SpMV kernel (its plain version on the CPU), with no host work."""
    return EllOperator(a, dtype=dtype, device=device)


def cg_solve(
    a: CSRMatrix,
    b,
    *,
    precond: Optional[Callable] = None,
    tol: float = 1e-6,
    maxiter: int = 1000,
    dtype=torch.float32,
    device=None,
):
    """CG on SPD ``a``; ``precond(r) -> z`` approximates A^-1 r. Returns
    (x, n_iters, final relative residual norm), x a tensor on ``device``.

    The JAX body, formula for formula and in the same order; the inner
    products are reductions outside the bitwise contract (torch's on the
    CPU, cuBLAS's on the card), so the iterates agree with the JAX ones to
    a tolerance, not bit for bit. The JAX ``while_loop`` becomes a Python
    loop that reads its condition ``‖r‖/‖b‖ > tol`` back to the host once
    per iteration: one device-to-host synchronisation per iteration;
    ``alpha`` and ``beta`` stay 0-d tensors on the device."""
    device = resolve_device(device)
    matvec = _csr_matvec_fn(a, dtype, device)
    b_t = torch.as_tensor(b).to(device=device, dtype=dtype)
    bnorm = torch.linalg.norm(b_t) + 1e-30

    M = precond if precond is not None else (lambda r: r)

    x = torch.zeros_like(b_t)
    r = b_t
    z = M(b_t)
    p = z
    it = 0
    while it < maxiter and bool(torch.linalg.norm(r) / bnorm > tol):
        ap = matvec(p)
        # repro: blessed-reduction — CG inner products: the iteration is
        # convergence-bounded, not bitwise-specified (only the triangular
        # solves inside the preconditioner carry the bitwise contract)
        rz = torch.dot(r, z)
        alpha = rz / (torch.dot(p, ap) + 1e-30)  # repro: blessed-reduction
        x = x + alpha * p
        r2 = r - alpha * ap
        z2 = M(r2)
        beta = torch.dot(r2, z2) / (rz + 1e-30)  # repro: blessed-reduction
        p = z2 + beta * p
        r, z = r2, z2
        it += 1
    return x, it, float(torch.linalg.norm(r) / bnorm)


def pcg_ichol(
    a: CSRMatrix,
    b,
    *,
    k: int = 8,
    strategy: str = "auto",
    tol: float = 1e-6,
    maxiter: int = 1000,
    dtype=torch.float32,
    cache: Optional[PlanCache] = None,
    device=None,
    backend: str = "kernel",
):
    """End to end: IC(0) + scheduled triangular solves as the CG
    preconditioner. Returns (x, iters, relres, info-dict). Pass a
    ``PlanCache`` to reuse plans across calls on one sparsity pattern.

    ``strategy`` defaults to ``"auto"``, as in the JAX package: the
    autotuner picks each factor's schedule (``repro_torch.autotune``).
    ``backend`` is ``"kernel"`` (the CUDA kernels) or ``"scan"`` (the plain
    executor)."""
    device = resolve_device(device)
    Lf = ichol0(a)
    fwd, bwd = factor_pair(
        Lf, strategy=strategy, k=k, dtype=dtype, cache=cache, device=device,
        backend=backend,
    )

    def precond(res):  # z = (L L^T)^{-1} res
        return bwd(fwd(res))

    x, iters, relres = cg_solve(
        a, b, precond=precond, tol=tol, maxiter=maxiter, dtype=dtype, device=device
    )
    info = {
        "fwd_supersteps": fwd.n_supersteps,
        "bwd_supersteps": bwd.n_supersteps,
        "fwd_strategy": fwd.strategy,
        "bwd_strategy": bwd.strategy,
        "fwd_plan": fwd.exec_plan.stats(),
        "bwd_plan": bwd.exec_plan.stats(),
    }
    if cache is not None:
        info["cache"] = cache.stats.as_dict()
    return x, iters, relres, info

