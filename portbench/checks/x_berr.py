"""A triangular solve by its componentwise backward error: for each
right-hand side, max over rows of |b - L x|_i / (|L| |x| + |b|)_i, in
float64 from the benchmark's own L; a call reads its worst column. Each row
is held to its own scale, so a wrong answer in a row whose |x| is far below
the largest (on ER, max / median |x| is 1e4-1e5) shows as plainly as one in
the largest. A row whose scale is 0 (b_i = 0, and x = 0 wherever the row
reads it: N(0, 1) draws of float32 do give exact zeros) reads 0, as its
residual is 0 too; NaN anywhere reads as infinity."""
from __future__ import annotations

import numpy as np
import torch

from portbench.checks import columns, per_call
from portbench.reference.matrices import Csr
from portbench.reference.solve import Spmv


def compare(run) -> dict:
    m = run.matrix
    L = Spmv(m, dtype=torch.float64, device=run.device)
    absL = Spmv(Csr(m.n, m.indptr, m.indices, np.abs(m.data)), dtype=torch.float64,
                device=run.device)
    B = columns([b for _, b, _ in run.kept]).to(device=run.device, dtype=torch.float64)
    X = columns([x for _, _, x in run.kept]).to(device=run.device, dtype=torch.float64)
    errs = []
    for j in range(0, B.shape[1], 64):  # blocks of columns, so that it fits
        b, x = B[:, j:j + 64], X[:, j:j + 64]
        num, den = (b - L(x)).abs(), absL(x.abs()) + b.abs()
        errs.append(torch.where(den == 0, num, num / den).amax(dim=0))
    return per_call(run, torch.cat(errs))
