"""The plain PyTorch executor over an ExecPlan: bulk-synchronous, and the
elastic macro-step loop of ``mode="elastic"``.

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
    step_bounds: torch.Tensor  # int32[S+1]: superstep s is steps [sb[s], sb[s+1])
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


# --------------------------------------------------------------- elastic
class ElasticArrays(NamedTuple):
    """Plan tensors in macro-step layout: the T plan steps, padded up to
    ``M * slack`` with scratch steps, reshaped to a leading [M, slack]
    grid. The plain executor loops over the M macro-steps and replays each
    window's steps in order. The elastic kernels do not read them: they
    read the plan in level order (``kernels.ops.elastic_kernel_arrays``),
    and the kernel backend keeps these tensors as its value refresh's
    source."""

    row_ids: torch.Tensor  # int32[M, S, k]
    col_idx: torch.Tensor  # int32[M, S, k, W]
    vals: torch.Tensor  # f[M, S, k, W]
    diag: torch.Tensor  # f[M, S, k]
    accum: torch.Tensor  # bool[M, S, k]
    n: int
    slack: int
    n_steps: int  # original (pre-padding) plan step count T


def _pad_to_window(a: np.ndarray, pad: int, fill) -> np.ndarray:
    if pad == 0:
        return a
    tail = np.full((pad, *a.shape[1:]), fill, dtype=a.dtype)
    return np.concatenate([a, tail], axis=0)


def elastic_plan_arrays(
    plan: ExecPlan, *, slack: int, dtype=torch.float32, device=None
) -> ElasticArrays:
    """Lay the plan out for the elastic executor on ``device`` (``None``:
    the card, raising without CUDA). Padding steps are the usual scratch
    protocol (row n, gather n, val 0, diag 1, no accum): they write the
    scratch slot's 0 and cannot perturb x[:n]. The accumulator enters the
    padding as zero — a plan's last real step never carries ``accum``
    (every virtual-row chain ends with its finishing row)."""
    device = resolve_device(device)
    T = plan.n_steps
    M = max(1, -(-T // slack))
    pad = M * slack - T
    n, k, W = plan.n, plan.k, plan.W

    def put(a, fill, dt, *tail):
        a = np.ascontiguousarray(_pad_to_window(a, pad, fill).reshape(M, slack, *tail))
        return torch.as_tensor(a).to(device=device, dtype=dt)

    return ElasticArrays(
        row_ids=put(plan.row_ids, n, torch.int32, k),
        col_idx=put(plan.col_idx, n, torch.int32, k, W),
        vals=put(plan.vals, 0, dtype, k, W),
        diag=put(plan.diag, 1, dtype, k),
        accum=put(plan.accum, False, torch.bool, k),
        n=n,
        slack=int(slack),
        n_steps=T,
    )


def _elastic_loop(row_ids, col_idx, vals, diag, accum, b_pad):
    """Elastic loop: ``ceil(T / slack)`` macro-steps, each replaying its
    window's ``slack`` plan steps in order through ``_step_single`` (or
    ``_step_mrhs`` for b_pad f[n+1, m]) — the same steps in the same order
    as the bulk loop, so the same bits."""
    step = _step_single if b_pad.dim() == 1 else _step_mrhs
    x = torch.zeros_like(b_pad)
    acc = b_pad.new_zeros((row_ids.shape[2], *b_pad.shape[1:]))
    for rows, cols, v, d, a in zip(row_ids, col_idx, vals, diag, accum):
        for j in range(rows.shape[0]):
            x, acc = step(x, acc, rows[j], cols[j], v[j], d[j], a[j], b_pad)
    return x


def solve_with_elastic(ea: ElasticArrays, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b through the elastic macro-step loop. ``b``: f[n] or
    f[n, m]; bitwise-identical to ``solve_with_plan`` on the same plan."""
    b_pad = pad_rhs(b.to(ea.vals.dtype))
    x = _elastic_loop(ea.row_ids, ea.col_idx, ea.vals, ea.diag, ea.accum, b_pad)
    return x[: ea.n]
