"""The plain PyTorch executor over an ExecPlan (bulk-synchronous part).

This module holds the plain step bodies ``_step_single`` / ``_step_mrhs``:
the one definition of what a solve computes, bit for bit. They are the
PyTorch spelling of the JAX package's ``solver/executor.py`` step bodies:

  * the W-reduction is a left-to-right chain of ``torch.addcmul`` — one
    fused multiply-add per entry, which is what XLA emits for the
    reference's ``acc + v * x[col]``; a plain ``acc + v * x`` rounds twice
    and breaks bitwise parity with the reference;
  * the finish is a correctly rounded ``(b[row] - acc) / d``;
  * non-accum lanes scatter into x and reset their accumulator.

``kernels.ref.sptrsv_ref`` loops over these bodies; it is the plain version
of the CUDA kernels and what the ``scan`` backend runs. The CUDA kernels
(``kernels/sptrsv.py``) reproduce the same bits.

Padding protocol (see ``core.plan``): row id n = scratch row, gather index
n = scratch slot, so padded lanes are harmless; the scratch slot stays 0.
``accum`` rows carry partial sums for rows wider than W.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.plan import ExecPlan
from repro_torch.device import resolve_device


class PlanArrays(NamedTuple):
    """Plan tensors on the solver's device (see ExecPlan for shapes)."""

    row_ids: torch.Tensor  # int32[T, k]
    col_idx: torch.Tensor  # int32[T, k, W]
    vals: torch.Tensor  # f[T, k, W]
    diag: torch.Tensor  # f[T, k]
    accum: torch.Tensor  # bool[T, k]
    step_bounds: torch.Tensor  # int32[S+1]; the CUDA kernels' barriers
    n: int


def plan_arrays(plan: ExecPlan, dtype=torch.float32, device=None) -> PlanArrays:
    """The plan's tensors on ``device`` (``None``: the card, raising
    without CUDA)."""
    device = resolve_device(device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return PlanArrays(
        row_ids=put(plan.row_ids, torch.int32),
        col_idx=put(plan.col_idx, torch.int32),
        vals=put(plan.vals, dtype),
        diag=put(plan.diag, dtype),
        accum=put(plan.accum, torch.bool),
        step_bounds=put(plan.step_bounds, torch.int32),
        n=plan.n,
    )


def _step_single(x, acc, rows, cols, v, d, a, b_pad):
    """One plan step on x f[n+1] (updated in place): gather, fused
    multiply-add chain over w, divide, scatter. Returns ``(x, acc)``."""
    for w in range(v.shape[1]):
        acc = torch.addcmul(acc, v[:, w], x[cols[:, w]])
    xv = (b_pad[rows] - acc) / d
    # finishing lanes write x and reset their accumulator; padded lanes
    # share the scratch row n and all write the same 0 there
    x[rows] = torch.where(a, x[rows], xv)
    acc = torch.where(a, acc, 0.0)
    return x, acc


def _step_mrhs(x, acc, rows, cols, v, d, a, b_pad):
    """Multi-RHS twin of ``_step_single``: x f[n+1, m], acc f[k, m]; one
    index gather feeds all m columns, and a column's bits are independent
    of both the lane count k and the batch width m."""
    for w in range(v.shape[1]):
        acc = torch.addcmul(acc, v[:, w, None], x[cols[:, w]])
    xv = (b_pad[rows] - acc) / d[:, None]
    x[rows] = torch.where(a[:, None], x[rows], xv)
    acc = torch.where(a[:, None], acc, 0.0)
    return x, acc


def pad_rhs(b: torch.Tensor) -> torch.Tensor:
    """``b`` f[n] or f[n, m] with the zero scratch row n appended."""
    return torch.cat([b, b.new_zeros((1, *b.shape[1:]))])


def solve_with_plan(pa: PlanArrays, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b with the plain step bodies. ``b``: f[n] or f[n, m]
    (multi-RHS — solved in one traversal), on the plan's device."""
    from repro_torch.kernels.ref import sptrsv_ref

    b_pad = pad_rhs(b.to(pa.vals.dtype))
    x = sptrsv_ref(pa.row_ids, pa.col_idx, pa.vals, pa.diag, pa.accum, b_pad)
    return x[: pa.n]


def make_solver(plan: ExecPlan, dtype=torch.float32, device=None):
    """Bind a plan on ``device`` (``None``: the card, raising without
    CUDA); returns ``solve(b) -> x`` for ``b`` f[n] or f[n, m]."""
    device = resolve_device(device)
    pa = plan_arrays(plan, dtype=dtype, device=device)

    def solve(b):
        return solve_with_plan(pa, torch.as_tensor(b, dtype=dtype, device=device))

    return solve
