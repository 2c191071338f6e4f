"""Plain PyTorch versions of the kernels in this package.

``sptrsv_ref`` is the plain scheduled solve in the plan's own step order:
the scan executor's step bodies run as a loop of eager PyTorch operations
(it is not a second implementation), and the function every SpTRSV kernel
computes bit for bit. ``sptrsv_level_ref`` is the plain version of the
level-ordered kernels (the bulk and the elastic ones, one and m right-hand
sides) and ``spmv_ell_ref`` that of the SpMV kernel. The CPU tests use
them, the ``scan`` backend runs ``sptrsv_ref``, the kernel wrappers run
them for CPU tensors, and ``chip_smoke.py`` holds the kernels against them.
"""
from __future__ import annotations

import torch

from repro_torch.solver.executor import _solve_segment, _zero_carry


def sptrsv_ref(row_ids, col_idx, vals, diag, accum, b_pad):
    """Plain scheduled SpTRSV.

    Shapes: row_ids int32[T,k]; col_idx int32[T,k,W]; vals f[T,k,W];
    diag f[T,k]; accum bool[T,k]; b_pad f[n+1] or f[n+1, m]. Returns x
    shaped like ``b_pad`` (the last row is scratch). Sequential over T,
    vectorized over the k lanes (and the m columns).
    """
    x, acc = _zero_carry(b_pad, row_ids.shape[1])
    return _solve_segment(row_ids, col_idx, vals, diag, accum, b_pad, x, acc)[0]


def sptrsv_level_ref(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad):
    """Plain level-ordered SpTRSV, one or m right-hand sides.

    Shapes: the plan's real lane-steps in level order (``kernels.levels``,
    the bulk order or the elastic one): row_ids int32[P]; col_idx
    int32[P,W]; vals f[P,W]; diag f[P]; accum bool[P]; vert_ptr
    int32[V+1]; level_ptr int32[L+1]; b_pad f[n+1] or f[n+1, m]. Returns x
    shaped like ``b_pad`` (the last row is scratch and stays 0). Level by
    level; within a level, vectorized over its vertices (and the m
    columns) and, for the g-th lane-step of every vertex that has one,
    chaining ``torch.addcmul`` over w from the vertex's carried
    accumulator, as the bulk step does; a finishing step writes x.
    Bitwise-equal to ``sptrsv_ref`` on the plan.
    """
    cols = b_pad.shape[1:]
    lift = (lambda t: t) if not cols else (lambda t: t[..., None])  # noqa: E731
    x = torch.zeros_like(b_pad)
    vert_ptr = vert_ptr.long()
    levels = level_ptr.tolist()
    for v0, v1 in zip(levels[:-1], levels[1:]):
        start = vert_ptr[v0:v1]
        length = vert_ptr[v0 + 1 : v1 + 1] - start
        acc = b_pad.new_zeros((v1 - v0, *cols))
        for g in range(int(length.max())):
            live = torch.nonzero(length > g).squeeze(1)
            p = start[live] + g
            a = acc[live]
            for w in range(col_idx.shape[1]):
                a = torch.addcmul(a, lift(vals[p, w]), x[col_idx[p, w]])
            acc[live] = a
            fin = ~accum[p]
            rows = row_ids[p][fin]
            x[rows] = (b_pad[rows] - a[fin]) / lift(diag[p][fin])
    return x


def spmv_ell_ref(col_idx, vals, x_pad):
    """Plain padded-ELL SpMV: ``y[r] = sum_w vals[r, w] * x_pad[col_idx[r, w]]``
    as a left-to-right ``torch.addcmul`` chain over w from 0 — the CUDA
    kernel's fused multiply-adds in the same order. Shapes: col_idx
    int32[R, W]; vals f[R, W]; x_pad f[n+1] (slot n is scratch, 0).
    Returns y f[R]."""
    y = x_pad.new_zeros(col_idx.shape[0])
    for w in range(col_idx.shape[1]):
        y = torch.addcmul(y, vals[:, w], x_pad[col_idx[:, w]])
    return y
