"""Plain PyTorch versions of the kernels in this package.

``sptrsv_ref`` is the plain version of the CUDA SpTRSV kernels: the same
function, run as a loop of eager PyTorch operations over the executor's
step bodies (it is not a second implementation). The CPU tests use it, the
``scan`` backend runs it, the ``kernel`` backend runs it for CPU tensors,
and ``chip_smoke.py`` holds the kernels against it.
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
