"""Public wrappers around the SpTRSV kernels.

``sptrsv_kernel_solve(plan, b)`` is the counterpart of
``solver.executor.solve_with_plan`` backed by the CUDA kernels (the plain
version for CPU tensors). The bulk kernels walk the plan in place, so unlike
the TPU tiling no step padding is needed; the elastic kernels
(``elastic_kernel_arrays`` / ``solve_with_elastic_kernel_arrays``) read the
plan padded to whole slack windows, as the certificate's tiles are.

This module is the device half of the ``kernel`` entry in
``repro_torch.backends`` — bind through the registry
(``get_backend("kernel").bind(plan)``) unless you need the raw pieces.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.plan import ExecPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.sptrsv import sptrsv_cuda, sptrsv_elastic_cuda
from repro_torch.solver.executor import (
    ElasticArrays,
    PlanArrays,
    elastic_plan_arrays,
    pad_rhs,
    plan_arrays,
)


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


def check_elastic_certificate(plan: ExecPlan) -> None:
    """Raise unless ``plan.elastic`` is a certificate for this plan whose
    wave ids the elastic kernels can walk: [M, slack] with M =
    ceil(T / slack), each tile's ids rising by at most one from 0, and
    ``n_waves`` the tile's last id + 1."""
    ep = plan.elastic
    if ep is None:
        raise ValueError("plan has no elastic certificate attached (plan.elastic)")
    M = max(1, -(-plan.n_steps // ep.slack))
    wave = np.asarray(ep.wave_id)
    nw = np.asarray(ep.n_waves)
    if ep.n_steps != plan.n_steps or wave.shape != (M, ep.slack) or nw.shape != (M,):
        raise ValueError(
            f"plan.elastic does not fit the plan: T={plan.n_steps}, "
            f"slack={ep.slack}, wave_id {wave.shape}, n_waves {nw.shape}"
        )
    steps = np.diff(wave, axis=1)
    if (wave[:, 0] != 0).any() or ((steps != 0) & (steps != 1)).any() or (
        nw != wave[:, -1] + 1
    ).any():
        raise ValueError("plan.elastic wave ids must rise by 0 or 1 from 0 in each tile")


def elastic_kernel_arrays(
    plan: ExecPlan, *, dtype=torch.float32, device=None
) -> Tuple[ElasticArrays, torch.Tensor, torch.Tensor]:
    """``(ea, wave_id, n_waves)`` for the elastic kernels on ``device``
    (``None``: the card, raising without CUDA): the plan in macro-step
    layout, window-padded to ``M * slack`` steps, and the wave tensors of
    the certificate attached to the plan (``plan.elastic``, from
    ``core.elastic.elastic_transform``), whose slack is the tile size.
    Index contents and the certificate are checked."""
    check_plan_indices(plan)
    check_elastic_certificate(plan)
    device = resolve_device(device)
    ep = plan.elastic
    ea = elastic_plan_arrays(plan, slack=ep.slack, dtype=dtype, device=device)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32).reshape(-1)).to(device)

    return ea, put(ep.wave_id), put(ep.n_waves)


def elastic_kernel_args(ea: ElasticArrays, wave_id: torch.Tensor, n_waves: torch.Tensor):
    """The arguments of ``sptrsv_elastic_cuda`` before ``b_pad``: the wave
    tensors and the macro-step tensors flattened to [M * slack, ...]
    (views, no copy)."""
    M, S, k = ea.row_ids.shape
    T = M * S
    return (
        wave_id, n_waves, ea.row_ids.view(T, k), ea.col_idx.view(T, k, -1),
        ea.vals.view(T, k, -1), ea.diag.view(T, k), ea.accum.view(T, k),
    )


def solve_with_elastic_kernel_arrays(
    ea: ElasticArrays, wave_id: torch.Tensor, n_waves: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Elastic twin of ``solve_with_kernel_arrays``: cast ``b``, append the
    scratch row, run ``sptrsv_elastic_cuda``, drop the scratch row."""
    b_pad = pad_rhs(b.to(ea.vals.dtype))
    x = sptrsv_elastic_cuda(*elastic_kernel_args(ea, wave_id, n_waves), b_pad)
    return x[: ea.n]


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
