"""The plain solves: levels, a level-by-level triangular solve, SpMV and
PCG, in plain PyTorch on any device and in any floating type.

Nothing here is scheduled, tiled or fused: the levels are the wavefronts
of the matrix's own dependency graph (a row's level is one more than the
highest level among the rows it reads), and each level is one vectorised
step over its rows, each row padded to the level's widest row.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.matrices import Csr, csr_from_coo, transpose


def levels(m: Csr) -> np.ndarray:
    """int64[n]: the wavefront of each row of lower-triangular ``m``
    (Kahn's algorithm one wavefront at a time)."""
    rows = m.row_of_entry()
    off = m.indices < rows
    if bool(np.any(m.indices > rows)):
        raise ValueError("levels: the matrix is not lower triangular")
    src, dst = m.indices[off], rows[off]  # row dst reads row src
    indeg = np.bincount(dst, minlength=m.n)
    order = np.argsort(src, kind="stable")
    succ = dst[order]
    succ_ptr = np.zeros(m.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=m.n), out=succ_ptr[1:])
    level = np.full(m.n, -1, dtype=np.int64)
    front = np.nonzero(indeg == 0)[0]
    depth = 0
    while len(front):
        level[front] = depth
        starts, ends = succ_ptr[front], succ_ptr[front + 1]
        lens = ends - starts
        if not lens.sum():
            break
        # every successor entry of the front, without a Python loop
        idx = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(lens.sum())
        touched, dec = np.unique(succ[idx], return_counts=True)
        indeg[touched] -= dec
        front = touched[indeg[touched] == 0]
        depth += 1
    if bool(np.any(level < 0)):
        raise ValueError("levels: the dependency graph has a cycle")
    return level


class LevelSolve:
    """``L x = b`` for lower-triangular ``L`` (or upper with ``upper=True``,
    solved as the reversed lower system), level by level, in ``dtype`` on
    ``device``. Inputs and outputs are in the caller's row order."""

    def __init__(self, m: Csr, *, dtype=torch.float64, device="cpu", upper=False):
        if upper:  # reverse rows and columns: an upper matrix becomes lower
            rev = m.n - 1
            m = _relabel(m, rev)
        self.n, self.dtype, self.device, self.upper = m.n, dtype, torch.device(device), upper
        lvl = levels(m)
        self.n_levels = int(lvl.max()) + 1 if m.n else 0
        rows = m.row_of_entry()
        is_diag = m.indices == rows
        if int(is_diag.sum()) != m.n:
            raise ValueError("LevelSolve needs a full diagonal")
        diag = np.zeros(m.n)
        diag[rows[is_diag]] = m.data[is_diag]
        if not np.all(diag != 0.0):
            raise ValueError("LevelSolve: a zero on the diagonal")
        off = ~is_diag
        r_off, c_off, v_off = rows[off], m.indices[off], m.data[off]
        row_len = np.bincount(r_off, minlength=m.n)
        starts = np.zeros(m.n + 1, dtype=np.int64)
        np.cumsum(row_len, out=starts[1:])
        by_level = np.argsort(lvl, kind="stable")
        bounds = np.searchsorted(lvl[by_level], np.arange(self.n_levels + 1))
        self.steps = []
        for k in range(self.n_levels):
            R = by_level[bounds[k]:bounds[k + 1]]
            w = int(row_len[R].max()) if len(R) else 0
            cols = np.zeros((len(R), w), dtype=np.int64)
            vals = np.zeros((len(R), w))
            if w:
                slot = np.arange(w)
                mask = slot[None, :] < row_len[R][:, None]
                src = (starts[R][:, None] + slot[None, :])[mask]
                cols[mask] = c_off[src]
                vals[mask] = v_off[src]
            t = dict(dtype=dtype, device=self.device)
            self.steps.append((
                torch.as_tensor(R, device=self.device),
                torch.as_tensor(cols, device=self.device),
                torch.as_tensor(vals, **t),
                torch.as_tensor(diag[R], **t),
            ))

    def __call__(self, b: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
        """x for ``b`` f[n] or f[n, m]; the columns in blocks of ``chunk``."""
        b = torch.as_tensor(b).to(device=self.device, dtype=self.dtype)
        vec = b.dim() == 1
        B = b[:, None] if vec else b
        if self.upper:
            B = B.flip(0)
        X = torch.empty_like(B)
        for j in range(0, B.shape[1], chunk):
            X[:, j:j + chunk] = self._solve(B[:, j:j + chunk])
        if self.upper:
            X = X.flip(0)
        return X[:, 0] if vec else X

    def _solve(self, B: torch.Tensor) -> torch.Tensor:
        # padding slots read row 0 with weight 0; every row is written once
        X = torch.zeros_like(B)
        for R, cols, vals, diag in self.steps:
            acc = B[R]
            if cols.shape[1]:
                acc = acc - (vals[:, :, None] * X[cols]).sum(dim=1)
            X[R] = acc / diag[:, None]
        return X


def _relabel(m: Csr, rev: int) -> Csr:
    return csr_from_coo(m.n, rev - m.row_of_entry(), rev - m.indices, m.data)


class Spmv:
    """y = A x in ``dtype`` on ``device``: products and a segment sum."""

    def __init__(self, a: Csr, *, dtype=torch.float64, device="cpu"):
        dev = torch.device(device)
        self.n, self.dtype, self.device = a.n, dtype, dev
        self.rows = torch.as_tensor(a.row_of_entry(), device=dev)
        self.cols = torch.as_tensor(a.indices, device=dev)
        self.vals = torch.as_tensor(a.data, dtype=dtype, device=dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        prod = self.vals.reshape(-1, *([1] * (x.dim() - 1))) * x[self.cols]
        return torch.zeros_like(x).index_add_(0, self.rows, prod)


class Pcg:
    """IC(0)-preconditioned CG in ``dtype``: the textbook iteration with
    ``z = (L Lᵀ)⁻¹ r`` by two level solves; a call stops when ‖r‖/‖b‖ <=
    tol or after ``maxiter`` iterations and returns (x, iterations)."""

    def __init__(self, a: Csr, lf: Csr, *, dtype, device):
        self.fwd = LevelSolve(lf, dtype=dtype, device=device)
        self.bwd = LevelSolve(transpose(lf), dtype=dtype, device=device, upper=True)
        self.matvec = Spmv(a, dtype=dtype, device=device)
        self.dtype, self.device = dtype, device

    def __call__(self, b, *, tol: float, maxiter: int):
        b = torch.as_tensor(b).to(device=self.device, dtype=self.dtype)
        bnorm = torch.linalg.norm(b.double())
        x = torch.zeros_like(b)
        r = b.clone()
        z = self.bwd(self.fwd(r))
        p = z.clone()
        rz = torch.dot(r, z)
        it = 0
        while it < maxiter and float(torch.linalg.norm(r.double()) / bnorm) > tol:
            ap = self.matvec(p)
            alpha = rz / torch.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = self.bwd(self.fwd(r))
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        return x, it
