"""Compressed-sparse-row matrices (host/inspector side, numpy only).

The paper stores the triangular matrix in CSR (§6.1, [TW67]); every scheduler
and the plan compiler consume this representation. We keep an explicit,
dependency-light CSR rather than scipy.sparse so the inspector is trivially
portable; conversion helpers to/from scipy exist for testing. All operations
here are vectorized — they run on matrices with 10^5..10^6 rows inside the
benchmark harness.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """A CSR matrix. ``indptr`` has length n+1, ``indices``/``data`` length nnz."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray  # int64[n_rows+1]
    indices: np.ndarray  # int64[nnz]
    data: np.ndarray  # float64[nnz]

    def __post_init__(self):
        assert self.indptr.shape == (self.n_rows + 1,)
        assert self.indices.shape == self.data.shape
        assert int(self.indptr[-1]) == len(self.indices)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row_of_entry(self) -> np.ndarray:
        """int64[nnz]: the row index of every stored entry."""
        return np.repeat(np.arange(self.n_rows, dtype=np.int64), self.row_nnz())

    def is_lower_triangular(self) -> bool:
        return bool(np.all(self.indices <= self.row_of_entry()))

    def diagonal(self) -> np.ndarray:
        n = min(self.n_rows, self.n_cols)
        d = np.zeros(n, dtype=self.data.dtype)
        rows = self.row_of_entry()
        mask = (self.indices == rows) & (rows < n)
        d[rows[mask]] = self.data[mask]
        return d

    def has_full_diagonal(self) -> bool:
        n = min(self.n_rows, self.n_cols)
        rows = self.row_of_entry()
        mask = (self.indices == rows) & (rows < n)
        present = np.zeros(n, dtype=bool)
        present[rows[mask]] = self.data[mask] != 0.0
        return bool(present.all())

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=(self.n_rows, self.n_cols)
        )

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = m.tocsr()
        m.sum_duplicates()
        m.sort_indices()
        return CSRMatrix(
            n_rows=m.shape[0],
            n_cols=m.shape[1],
            indptr=np.asarray(m.indptr, dtype=np.int64),
            indices=np.asarray(m.indices, dtype=np.int64),
            data=np.asarray(m.data, dtype=np.float64),
        )


def pattern_fingerprint(m: CSRMatrix) -> str:
    """Stable hash of the *sparsity pattern* (shape + indptr + indices).

    Deliberately ignores ``data``: two factors with identical structure but
    different values share schedules and plan tensors' shapes, which is what
    the pipeline plan cache keys on (values refresh via ``numeric_update``).
    """
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64([m.n_rows, m.n_cols]).tobytes())
    h.update(np.ascontiguousarray(m.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(m.indices, dtype=np.int64).tobytes())
    return h.hexdigest()


def csr_from_coo(
    n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
) -> CSRMatrix:
    """Build CSR from COO triplets; duplicate entries are summed. Vectorized."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        # Merge duplicate (row, col) runs with a segmented sum.
        new_run = np.ones(len(rows), dtype=bool)
        new_run[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        run_id = np.cumsum(new_run) - 1
        n_runs = int(run_id[-1]) + 1
        merged = np.zeros(n_runs, dtype=np.float64)
        np.add.at(merged, run_id, vals)
        rows, cols, vals = rows[new_run], cols[new_run], merged
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(n_rows, n_cols, indptr, cols, vals)


def csr_from_dense(a: np.ndarray) -> CSRMatrix:
    rows, cols = np.nonzero(a)
    return csr_from_coo(a.shape[0], a.shape[1], rows, cols, a[rows, cols])


def csr_to_dense(m: CSRMatrix) -> np.ndarray:
    out = np.zeros((m.n_rows, m.n_cols), dtype=np.float64)
    out[m.row_of_entry(), m.indices] = m.data
    return out


def lower_triangle_of(m: CSRMatrix, *, unit_diagonal_fill: bool = False) -> CSRMatrix:
    """Extract the lower triangle (incl. diagonal). Optionally force a unit
    diagonal where the diagonal entry is missing (keeps the solve well-posed)."""
    rows = m.row_of_entry()
    keep = m.indices <= rows
    rows, cols, vals = rows[keep], m.indices[keep], m.data[keep]
    if unit_diagonal_fill:
        has_diag = np.zeros(m.n_rows, dtype=bool)
        has_diag[rows[cols == rows]] = True
        missing = np.nonzero(~has_diag)[0]
        rows = np.concatenate([rows, missing])
        cols = np.concatenate([cols, missing])
        vals = np.concatenate([vals, np.ones(len(missing))])
    return csr_from_coo(m.n_rows, m.n_cols, rows, cols, vals)


def transpose_csr(m: CSRMatrix) -> CSRMatrix:
    return csr_from_coo(m.n_cols, m.n_rows, m.indices, m.row_of_entry(), m.data)


def permute_symmetric(m: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Symmetric permutation: ``B = P A P^T`` where ``perm[new] = old``.

    Row ``perm[i]`` of A becomes row ``i`` of B; columns are relabeled the same
    way. This is the §5 reordering primitive: if ``perm`` lists vertices in
    (superstep, core, original-id) order — a topological order — B is still
    lower triangular.
    """
    perm = np.asarray(perm, dtype=np.int64)
    assert perm.shape == (m.n_rows,)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m.n_rows, dtype=np.int64)
    return csr_from_coo(
        m.n_rows, m.n_cols, inv[m.row_of_entry()], inv[m.indices], m.data
    )
