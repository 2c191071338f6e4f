"""Frozen copies of the matrices the configurations name, in plain NumPy.

``erdos_renyi_lower`` (arXiv:2503.05408 §6.2.4), ``poisson2d_matrix`` (the
FEM stand-in of §6.2.1) and ``ichol0`` (zero-fill incomplete Cholesky) are
copied from the port's ``sparse/`` modules, draw for draw and operation for
operation, so that equal seeds give equal matrices. The program may change
its own copies later; these stay as the yardstick.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the generators here that a configuration may name; further ones are files
# of reference/generators/ (inputs.generator)
GENERATORS = ("erdos_renyi_lower", "poisson2d_matrix")


@dataclasses.dataclass(frozen=True)
class Csr:
    """A square CSR matrix: ``indptr`` int64[n + 1], ``indices`` int64[nnz],
    ``data`` float64[nnz], columns sorted within each row."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row_of_entry(self) -> np.ndarray:
        return np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))


def csr_from_coo(n: int, rows, cols, vals) -> Csr:
    """CSR from COO triplets, sorted by (row, column); duplicates summed."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        new_run = np.ones(len(rows), dtype=bool)
        new_run[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        run_id = np.cumsum(new_run) - 1
        merged = np.zeros(int(run_id[-1]) + 1, dtype=np.float64)
        np.add.at(merged, run_id, vals)
        rows, cols, vals = rows[new_run], cols[new_run], merged
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return Csr(n, np.cumsum(indptr), cols, vals)


def transpose(m: Csr) -> Csr:
    return csr_from_coo(m.n, m.indices, m.row_of_entry(), m.data)


def paper_values(rng: np.random.Generator, n_off: int, n_diag: int):
    """§6.2: off-diagonal values U[-2, 2]; |diagonal| LogUniform[1/2, 2]
    with a random sign."""
    off = rng.uniform(-2.0, 2.0, size=n_off)
    mag = np.exp(rng.uniform(np.log(0.5), np.log(2.0), size=n_diag))
    sign = rng.choice([-1.0, 1.0], size=n_diag)
    return off, mag * sign


def erdos_renyi_lower(n: int, p: float, *, seed: int = 0) -> Csr:
    """§6.2.4: entry (i, j), i > j, present with probability p, and a full
    diagonal; the paper's value distributions."""
    rng = np.random.default_rng(seed)
    rows_list, cols_list = [], []
    counts = rng.binomial(np.arange(n), p)
    for i in np.nonzero(counts)[0]:
        c = rng.choice(i, size=counts[i], replace=False)
        rows_list.append(np.full(len(c), i, dtype=np.int64))
        cols_list.append(c.astype(np.int64))
    rows = np.concatenate(rows_list) if rows_list else np.empty(0, dtype=np.int64)
    cols = np.concatenate(cols_list) if cols_list else np.empty(0, dtype=np.int64)
    off, diag = paper_values(rng, len(rows), n)
    return csr_from_coo(
        n,
        np.concatenate([rows, np.arange(n, dtype=np.int64)]),
        np.concatenate([cols, np.arange(n, dtype=np.int64)]),
        np.concatenate([off, diag]),
    )


def poisson2d_matrix(nx: int) -> Csr:
    """The SPD 5-point Laplacian on an nx × nx grid (4 on the diagonal, -1
    to each grid neighbour)."""
    n = nx * nx
    idx = np.arange(n, dtype=np.int64).reshape(nx, nx)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 4.0)]
    for a, b in [(idx[:, 1:].ravel(), idx[:, :-1].ravel()),
                 (idx[1:, :].ravel(), idx[:-1, :].ravel())]:
        rows.extend([a, b])
        cols.extend([b, a])
        vals.extend([np.full(len(a), -1.0)] * 2)
    return csr_from_coo(n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals))


def lower_triangle(m: Csr) -> Csr:
    rows = m.row_of_entry()
    keep = m.indices <= rows
    return csr_from_coo(m.n, rows[keep], m.indices[keep], m.data[keep])


def ichol0(a: Csr) -> Csr:
    """IC(0): L on tril(A)'s pattern with A ≈ L Lᵀ, up-looking, row by row.
    A pivot that is not positive retries with the diagonal scaled by
    (1 + shift), the shift doubling from 1e-3."""
    tril = lower_triangle(a)
    base_diag = tril.data[tril.indices == tril.row_of_entry()].copy()
    shift = 0.0
    for _ in range(12):
        L = _ichol0_once(tril, base_diag, shift)
        if L is not None:
            return L
        shift = max(shift * 2.0, 1e-3)
    raise np.linalg.LinAlgError("IC(0) failed even with a diagonal shift")


def _ichol0_once(tril: Csr, base_diag: np.ndarray, shift: float):
    n, indptr, indices = tril.n, tril.indptr, tril.indices
    vals = tril.data.copy()
    rows = tril.row_of_entry()
    diag_mask = indices == rows
    if shift:
        vals[diag_mask] = base_diag * (1.0 + shift)
    diag_pos = np.nonzero(diag_mask)[0]
    if len(diag_pos) != n:
        raise ValueError("IC(0) needs a structurally full diagonal")
    for i in range(n):
        lo = int(indptr[i])
        ti = int(diag_pos[i])
        for t in range(lo, ti):
            j = int(indices[t])
            s = vals[t]
            pi, pj = lo, int(indptr[j])
            tj = int(diag_pos[j])
            while pi < t and pj < tj:
                ci, cj = indices[pi], indices[pj]
                if ci == cj:
                    s -= vals[pi] * vals[pj]
                    pi += 1
                    pj += 1
                elif ci < cj:
                    pi += 1
                else:
                    pj += 1
            vals[t] = s / vals[tj]
        s = vals[ti] - float(np.sum(vals[lo:ti] ** 2))
        if s <= 0.0:
            return None
        vals[ti] = np.sqrt(s)
    return Csr(n, indptr.copy(), indices.copy(), vals)
