"""Public wrappers around the SpTRSV kernels.

``sptrsv_kernel_solve(plan, b)`` is the counterpart of
``solver.executor.solve_with_plan`` backed by the CUDA kernels (the plain
version for CPU tensors). The kernels walk the plan in place, so unlike the
TPU tiling no step padding is needed.

This module is the device half of the ``kernel`` entry in
``repro_torch.backends`` — bind through the registry
(``get_backend("kernel").bind(plan)``) unless you need the raw pieces.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plan import ExecPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.sptrsv import sptrsv_cuda
from repro_torch.solver.executor import PlanArrays, pad_rhs, plan_arrays


def check_plan_indices(plan: ExecPlan) -> None:
    """Raise unless every index the kernels dereference is in range: rows
    and gather columns in [0, n] (n is the scratch slot) and step bounds
    monotone from 0 to T. The kernels read these without bounds checks."""
    n, T = plan.n, plan.n_steps
    for name in ("row_ids", "col_idx"):
        a = getattr(plan, name)
        if a.size and (int(a.min()) < 0 or int(a.max()) > n):
            raise ValueError(f"plan.{name} holds indices outside [0, {n}]")
    sb = np.asarray(plan.step_bounds)
    if sb.ndim != 1 or sb.size < 1 or sb[0] != 0 or sb[-1] != T or (np.diff(sb) < 0).any():
        raise ValueError(f"plan.step_bounds must rise monotonically from 0 to T={T}")


def kernel_plan_arrays(
    plan: ExecPlan, *, dtype=torch.float32, device=None
) -> PlanArrays:
    """The plan tensors on ``device`` (``None``: the card, raising without
    CUDA), index contents checked."""
    check_plan_indices(plan)
    return plan_arrays(plan, dtype=dtype, device=device)


def solve_with_kernel_arrays(pa: PlanArrays, b: torch.Tensor) -> torch.Tensor:
    """The kernel-calling convention in one place: cast ``b``, append the
    scratch row, run ``sptrsv_cuda``, drop the scratch row. Shared by
    ``bind_kernel_solver`` and the ``kernel`` backend."""
    b_pad = pad_rhs(b.to(pa.vals.dtype))
    x = sptrsv_cuda(
        pa.row_ids, pa.col_idx, pa.vals, pa.diag, pa.accum, pa.step_bounds, b_pad
    )
    return x[: pa.n]


def bind_kernel_solver(plan: ExecPlan, *, dtype=torch.float32, device=None):
    """Bind the plan tensors once on ``device`` (``None``: the card);
    returns ``solve(b) -> x`` where ``b`` is f[n] or f[n, m] (batched
    multi-RHS)."""
    device = resolve_device(device)
    pa = kernel_plan_arrays(plan, dtype=dtype, device=device)

    def solve(b):
        return solve_with_kernel_arrays(
            pa, torch.as_tensor(b, dtype=dtype, device=device)
        )

    return solve


def sptrsv_kernel_solve(plan: ExecPlan, b, *, dtype=torch.float32, device=None):
    """Solve L x = b with the kernels. ``b``: f[n] (returns x f[n]) or
    f[n, m] for a batched multi-RHS solve (returns x f[n, m])."""
    return bind_kernel_solver(plan, dtype=dtype, device=device)(b)
