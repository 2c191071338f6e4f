"""A triangular solve against the reference's float64 level solve: for
each right-hand side, max |x - x_ref| / max |x_ref|; a call reads its
worst column. The reference works out its own levels from the matrix."""
from __future__ import annotations

import torch

from portbench.checks import PRECISION_BELOW, columns, per_call
from portbench.reference.solve import LevelSolve


def compare(run) -> dict:
    ref = LevelSolve(run.matrix, dtype=torch.float64, device=run.device)
    B = columns([b for _, b, _ in run.kept]).to(device=run.device, dtype=torch.float64)
    X = columns([x for _, _, x in run.kept]).to(device=run.device, dtype=torch.float64)
    gaps = []
    for j in range(0, B.shape[1], 64):  # blocks of columns, so that it fits
        Xr = ref(B[:, j:j + 64])
        gaps.append((X[:, j:j + 64] - Xr).abs().amax(dim=0) / Xr.abs().amax(dim=0))
    return per_call(run, torch.cat(gaps))


def control(matrix, rhs, config, device) -> list:
    low = PRECISION_BELOW[config["dtype"]]
    ref = LevelSolve(matrix, dtype=low, device=device)
    return [ref(b.to(device=device, dtype=low)).float() for b in rhs]
