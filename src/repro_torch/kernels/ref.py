"""Plain PyTorch versions of the kernels in this package.

``sptrsv_ref`` is the plain version of the bulk CUDA SpTRSV kernels: the
same function, run as a loop of eager PyTorch operations over the
executor's step bodies (it is not a second implementation).
``sptrsv_elastic_ref`` is the plain version of the elastic kernels and
``spmv_ell_ref`` that of the SpMV kernel. The CPU tests use them, the
``scan`` backend runs ``sptrsv_ref``, the kernel wrappers run them for CPU
tensors, and ``chip_smoke.py`` holds the kernels against them.
"""
from __future__ import annotations

import torch

from repro_torch.solver.executor import _step_mrhs, _step_single


def sptrsv_ref(row_ids, col_idx, vals, diag, accum, b_pad):
    """Plain scheduled SpTRSV.

    Shapes: row_ids int32[T,k]; col_idx int32[T,k,W]; vals f[T,k,W];
    diag f[T,k]; accum bool[T,k]; b_pad f[n+1] or f[n+1, m]. Returns x
    shaped like ``b_pad`` (the last row is scratch). Sequential over T,
    vectorized over the k lanes (and the m columns).
    """
    step = _step_single if b_pad.dim() == 1 else _step_mrhs
    x = torch.zeros_like(b_pad)
    acc = b_pad.new_zeros((row_ids.shape[1], *b_pad.shape[1:]))
    for t in range(row_ids.shape[0]):
        x, acc = step(
            x, acc, row_ids[t], col_idx[t], vals[t], diag[t], accum[t], b_pad
        )
    return x


def sptrsv_elastic_ref(wave_id, n_waves, row_ids, col_idx, vals, diag, accum, b_pad):
    """Plain elastic SpTRSV: tile by tile, readiness wave by wave.

    Shapes as ``sptrsv_ref`` with T = M * S window-padded steps, plus
    wave_id int32[T] (each step's wave inside its S-step tile) and n_waves
    int32[M]. A wave's steps are mutually independent (the certificate of
    ``core.elastic``), so they run together: each (step, lane) chain starts
    from the *selected* accumulator — ``tot[t-1]`` iff step t-1 accumulates
    in that lane (for the tile's first step that is the carry across the
    tile boundary), else 0 — and chains ``torch.addcmul`` over w, left to
    right, exactly as the bulk step does; only the wave's non-accum rows
    are finished. Bitwise-equal to ``sptrsv_ref`` on the same plan.
    """
    T, k = row_ids.shape
    M = n_waves.shape[0]
    S = T // M
    cols = b_pad.shape[1:]
    lift = (lambda t: t) if not cols else (lambda t: t[..., None])  # noqa: E731
    waves, counts = wave_id.tolist(), n_waves.tolist()
    x = torch.zeros_like(b_pad)
    tot = b_pad.new_zeros((T + 1, k, *cols))  # tot[t + 1] = step t's total
    carry = torch.cat([accum.new_zeros((1, k)), accum])  # carry[t] = accum[t-1]
    for i in range(M):
        s0, end = i * S, (i + 1) * S
        for r in range(counts[i]):
            s1 = s0 + 1
            while s1 < end and waves[s1] == r:
                s1 += 1
            acc = torch.where(lift(carry[s0:s1]), tot[s0:s1], 0.0)
            for w in range(col_idx.shape[2]):
                acc = torch.addcmul(acc, lift(vals[s0:s1, :, w]), x[col_idx[s0:s1, :, w]])
            tot[s0 + 1 : s1 + 1] = acc
            live = ~accum[s0:s1]
            rows = row_ids[s0:s1][live]
            x[rows] = (b_pad[rows] - acc[live]) / lift(diag[s0:s1][live])
            s0 = s1
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
