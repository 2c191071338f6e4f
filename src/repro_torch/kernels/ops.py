"""Public wrappers around the SpTRSV kernels.

``sptrsv_kernel_solve(plan, b)`` is the counterpart of
``solver.executor.solve_with_plan`` backed by the CUDA kernels (the plain
version for CPU tensors). Every kernel reads the plan's real lane-steps in
level order (layout in ``kernels.levels``), not the padded plan: the bulk
kernels (one right-hand side, and m a block per column) take the bulk order,
a run per superstep (``level_plan_arrays``, ``solve_with_kernel_arrays``);
the elastic kernels take the order over runs of the certificate's
``slack`` supersteps (``elastic_kernel_arrays``,
``solve_with_elastic_kernel_arrays``). Each solve is one launch with one
block barrier per level.

This module is the device half of the ``kernel`` entry in
``repro_torch.backends`` — bind through the registry
(``get_backend("kernel").bind(plan)``) unless you need the raw pieces.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.plan import ExecPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.levels import LevelOrder, level_order
from repro_torch.kernels.sptrsv import sptrsv_elastic_cuda, sptrsv_level_cuda
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
    """The padded plan tensors on ``device`` (``None``: the card, raising
    without CUDA), index contents checked: no kernel reads them; the
    ``kernel`` backend keeps them as the source of its value refresh."""
    check_plan_indices(plan)
    return plan_arrays(plan, dtype=dtype, device=device)


class LevelArrays(NamedTuple):
    """The plan's real lane-steps in level order on the solver's device:
    the single-RHS kernel's tensors (``kernels.levels``)."""

    row_ids: torch.Tensor  # int32[P]
    col_idx: torch.Tensor  # int32[P, W]
    vals: torch.Tensor  # f[P, W]
    diag: torch.Tensor  # f[P]
    accum: torch.Tensor  # bool[P]
    vert_ptr: torch.Tensor  # int32[V+1]
    level_ptr: torch.Tensor  # int32[L+1]
    perm: torch.Tensor  # int64[P]: each lane-step's flat (step * k + lane) plan index
    n: int


def level_plan_arrays(
    plan: ExecPlan, *, dtype=torch.float32, device=None, order: LevelOrder | None = None
) -> LevelArrays:
    """The plan tensors gathered into level order on ``device`` (``None``:
    the card, raising without CUDA), index contents checked. ``order`` is
    ``plan``'s level order where the caller has it already."""
    check_plan_indices(plan)
    device = resolve_device(device)
    if order is None:
        order = level_order(plan)
    perm = order.perm
    W = plan.W

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return LevelArrays(
        row_ids=put(plan.row_ids.reshape(-1)[perm], torch.int32),
        col_idx=put(plan.col_idx.reshape(-1, W)[perm], torch.int32),
        vals=put(plan.vals.reshape(-1, W)[perm], dtype),
        diag=put(plan.diag.reshape(-1)[perm], dtype),
        accum=put(plan.accum.reshape(-1)[perm], torch.bool),
        vert_ptr=put(order.vert_ptr, torch.int32),
        level_ptr=put(order.level_ptr, torch.int32),
        perm=put(perm, torch.int64),
        n=plan.n,
    )


def solve_with_kernel_arrays(la: LevelArrays, b: torch.Tensor) -> torch.Tensor:
    """The kernel-calling convention in one place: cast ``b``, append the
    scratch row, run ``sptrsv_level_cuda`` over ``la`` in the bulk level
    order (b f[n] or f[n, m]), drop the scratch row. Shared by
    ``bind_kernel_solver`` and the ``kernel`` backend."""
    b_pad = pad_rhs(b.to(la.vals.dtype))
    return sptrsv_level_cuda(*la[:7], b_pad)[: la.n]


def check_elastic_certificate(plan: ExecPlan) -> None:
    """Raise unless ``plan.elastic`` is a certificate that fits this plan:
    its step and superstep counts are the plan's and its slack is at
    least 1. The elastic kernels read only its slack."""
    ep = plan.elastic
    if ep is None:
        raise ValueError("plan has no elastic certificate attached (plan.elastic)")
    if ep.n_steps != plan.n_steps or ep.n_supersteps != plan.n_supersteps or ep.slack < 1:
        raise ValueError(
            f"plan.elastic does not fit the plan: T={plan.n_steps}, "
            f"supersteps={plan.n_supersteps}; certificate T={ep.n_steps}, "
            f"supersteps={ep.n_supersteps}, slack={ep.slack}"
        )


def elastic_kernel_arrays(plan: ExecPlan, *, dtype=torch.float32, device=None) -> LevelArrays:
    """The elastic kernels' tensors on ``device`` (``None``: the card,
    raising without CUDA): the plan's real lane-steps in the level order
    over runs of ``plan.elastic.slack`` supersteps (``kernels.levels``).
    Index contents and the certificate are checked."""
    check_elastic_certificate(plan)
    check_plan_indices(plan)
    device = resolve_device(device)
    order = level_order(plan, slack=plan.elastic.slack)
    return level_plan_arrays(plan, dtype=dtype, device=device, order=order)


def solve_with_elastic_kernel_arrays(la: LevelArrays, b: torch.Tensor) -> torch.Tensor:
    """Elastic twin of ``solve_with_kernel_arrays``: cast ``b``, append the
    scratch row, run ``sptrsv_elastic_cuda`` (b f[n] or f[n, m]), drop the
    scratch row."""
    b_pad = pad_rhs(b.to(la.vals.dtype))
    x = sptrsv_elastic_cuda(*la[:7], b_pad)
    return x[: la.n]


def bind_kernel_solver(plan: ExecPlan, *, dtype=torch.float32, device=None):
    """Bind the plan's level tensors once on ``device`` (``None``: the
    card); returns ``solve(b) -> x`` where ``b`` is f[n] or f[n, m]
    (batched multi-RHS)."""
    device = resolve_device(device)
    la = level_plan_arrays(plan, dtype=dtype, device=device)

    def solve(b):
        return solve_with_kernel_arrays(la, torch.as_tensor(b, dtype=dtype, device=device))

    return solve


def sptrsv_kernel_solve(plan: ExecPlan, b, *, dtype=torch.float32, device=None):
    """Solve L x = b with the kernels. ``b``: f[n] (returns x f[n]) or
    f[n, m] for a batched multi-RHS solve (returns x f[n, m])."""
    return bind_kernel_solver(plan, dtype=dtype, device=device)(b)
