"""Plain PyTorch versions of the kernels in this package.

``sptrsv_ref`` is the plain scheduled solve in the plan's own step order:
the scan executor's step bodies run as a loop of eager PyTorch operations
(it is not a second implementation), and the function every SpTRSV kernel
computes bit for bit. ``sptrsv_level_ref`` is the plain version of the
level-ordered kernels (the bulk and the elastic ones, one and m right-hand
sides), ``sptrsv_ordered_ref`` that of the ordered solve (b and x in the
caller's row order), ``sptrsv_level_range_ref`` that of a launch over a range of levels
(the distributed backend's rounds), ``sptrsv_level_bank_ref`` that of the banked one (each column on
its own plan of a bank), and ``spmv_sliced_ref`` that of the SpMV kernel, y = A x on the
sliced layout. ``spmv_ell_ref`` is the plain version of the JAX package's
per-ELL-row TPU kernel, and ``spmv_ell_rows_ref`` adds the split rows to
it: the definition ``spmv_sliced_ref`` keeps bit for bit. The CPU tests use
them, the ``scan`` backend runs ``sptrsv_ref``, the kernel wrappers run
them for CPU tensors, and ``chip_smoke.py`` holds the kernels against them.
"""
from __future__ import annotations

import torch

from repro_torch.solver.executor import _solve_segment, _zero_carry

SLICE_ROWS = 32  # rows of a slice of the SpMV layout: one warp of the kernel


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
    x = torch.zeros_like(b_pad)
    _walk_levels(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr.tolist(), b_pad, x)
    return x


def sptrsv_ordered_ref(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, perm, b):
    """Plain version of the ordered solve (``kernels.sptrsv.sptrsv_ordered_cuda``):
    b f[n] or f[n, m] in the caller's row order, ``perm`` int[n] the
    caller's row of each plan row; returns x in the caller's row order. b
    gathered into plan row order (the scratch row +0), solved by
    ``sptrsv_level_ref``, x scattered back."""
    perm = perm.long()
    b_pad = b.new_zeros((b.shape[0] + 1, *b.shape[1:]))
    b_pad[:-1] = b[perm]
    x = sptrsv_level_ref(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad)
    out = torch.empty_like(b)
    out[perm] = x[:-1]
    return out


def sptrsv_level_range_ref(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, lo, hi,
                           b, x):
    """Plain version of ``kernels.sptrsv.sptrsv_level_range_cuda``: walks
    levels ``[lo, hi)`` of the level tensors into ``x`` in place, which
    keeps whatever earlier ranges (or exchanges) wrote. ``b`` and ``x`` are
    f[rows] or column-major f[m, rows] (a column's rows contiguous).
    Returns ``x``. A walk of ranges that partition ``[0, L)``, in order, is
    bitwise ``sptrsv_level_ref``."""
    view = (lambda t: t) if b.dim() == 1 else (lambda t: t.T)  # noqa: E731
    _walk_levels(row_ids, col_idx, vals, diag, accum, vert_ptr,
                 level_ptr[lo : hi + 1].tolist(), view(b), view(x))
    return x


def _walk_levels(row_ids, col_idx, vals, diag, accum, vert_ptr, levels, b_pad, x):
    """The walk of ``sptrsv_level_ref`` over the levels whose vertex bounds
    are ``levels`` (a list of L'+1 absolute bounds) into ``x`` (f[rows] or
    a [rows, m] view), in place."""
    cols = b_pad.shape[1:]
    lift = (lambda t: t) if not cols else (lambda t: t[..., None])  # noqa: E731
    vert_ptr = vert_ptr.long()
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


def bank_lane(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, level_off, n_levels,
              lane):
    """Lane ``lane`` of a bank of level tensors (``kernels.ops.LevelBank``)
    as the level tensors of its plan alone: its slice of the concatenation,
    ``vert_ptr`` and ``level_ptr`` shifted back to start at 0."""
    l0 = int(level_off[lane])
    lp = level_ptr[l0 : l0 + int(n_levels[lane]) + 1]
    v0, v1 = int(lp[0]), int(lp[-1])
    vp = vert_ptr[v0 : v1 + 1]
    p0, p1 = int(vp[0]), int(vp[-1])
    return (row_ids[p0:p1], col_idx[p0:p1], vals[p0:p1], diag[p0:p1], accum[p0:p1],
            vp - p0, lp - v0)


def sptrsv_level_bank_ref(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr,
                          level_off, n_levels, lane_idx, b_col):
    """Plain banked level-ordered SpTRSV: column j of ``b_col`` f[m, n+1]
    (column-major, the scratch entry last) solved on bank lane
    ``lane_idx[j]`` — ``sptrsv_level_ref`` on that lane's level tensors
    (``bank_lane``), the columns of one lane together (a column's bits do
    not depend on its neighbours). Shapes: the bank's concatenated level
    tensors (``kernels.ops.LevelBank``), level_off and n_levels int32[lanes],
    lane_idx int[m]. Returns x f[m, n+1], the layout of ``b_col``."""
    bank = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, level_off, n_levels)
    lanes = torch.as_tensor(lane_idx).long()
    x = torch.zeros_like(b_col)
    for lane in torch.unique(lanes).tolist():
        cols = torch.nonzero(lanes == lane).squeeze(1).to(b_col.device)
        x[cols] = sptrsv_level_ref(*bank_lane(*bank, lane), b_col[cols].T).T
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


def spmv_ell_rows_ref(col_idx, vals, row_map, x):
    """y = A x from A's padded ELL (``kernels.spmv.ell_from_csr``):
    ``spmv_ell_ref`` on x padded with the scratch slot, then each row's
    pieces added in piece order to 0, y[i] = ((0 + c0) + c1) + ... (the
    JAX package's ``spmv`` sums them with ``segment_sum`` instead). Shapes:
    col_idx int32[R, W]; vals f[R, W]; row_map int32[R], sorted, every row
    present; x f[n_cols]. Returns y f[n_rows]."""
    y_ell = spmv_ell_ref(col_idx, vals, torch.cat([x, x.new_zeros(1)]))
    row_map = torch.as_tensor(row_map, device=x.device).long()
    n_rows = int(row_map[-1]) + 1 if row_map.numel() else 0
    piece = torch.arange(row_map.numel(), device=x.device) - torch.searchsorted(row_map, row_map)
    y = x.new_zeros(n_rows)
    for p in range(int(piece.max()) + 1 if piece.numel() else 0):
        sel = piece == p
        y[row_map[sel]] = y[row_map[sel]] + y_ell[sel]
    return y


def spmv_sliced_ref(col, val, slice_ptr, row_len, width, x):
    """Plain SpMV on the sliced layout (``kernels.spmv.SlicedEll``): slot
    k of row i at ``slice_ptr[i // 32] + 32 k + i % 32``, k < row_len[i].
    Row i is a left-to-right ``torch.addcmul`` chain over its entries from
    0, restarted every ``width`` entries, each finished chain added to the
    row's sum from 0: the CUDA kernel's operations in its order.
    Vectorized over the rows, slot by slot. Shapes: col int32[S]; val
    f[S]; slice_ptr int64[ceil(n/32)+1]; row_len int32[n]; x f[n_cols].
    Returns y f[n]: bitwise ``spmv_ell_rows_ref`` on the padded ELL of the
    same matrix and W (see ``kernels.spmv``)."""
    n = row_len.shape[0]
    y = x.new_zeros(n)
    acc = x.new_zeros(n)
    length = row_len.long()
    rows = torch.arange(n, device=x.device)
    base = slice_ptr[rows // SLICE_ROWS] + rows % SLICE_ROWS
    for k in range(int(length.max()) if n else 0):
        live = torch.nonzero(length > k).squeeze(1)
        idx = base[live] + SLICE_ROWS * k
        a = torch.addcmul(acc[live], val[idx], x[col[idx]])
        fold = (length[live] == k + 1) | ((k + 1) % width == 0)
        acc[live] = torch.where(fold, 0.0, a)
        y[live[fold]] = y[live[fold]] + a[fold]
    return y
