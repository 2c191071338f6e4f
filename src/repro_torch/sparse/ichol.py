"""Zero-fill incomplete Cholesky — IC(0).

Produces the iChol data set of the paper (§6.2.3) from SPD matrices and the
preconditioner for preconditioned CG. Standard up-looking IC(0) on the
lower-triangular pattern of A; the inspector runs once per sparsity pattern,
so the per-row python loop is acceptable at benchmark sizes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, lower_triangle_of


def ichol0(a: CSRMatrix, *, shift: float = 0.0) -> CSRMatrix:
    """IC(0) factor L with A ≈ L Lᵀ, L restricted to tril(A)'s pattern.

    ``shift`` scales the diagonal by (1 + shift) before factorization
    (standard remedy when a pivot goes non-positive; we retry internally
    with growing shift)."""
    tril = lower_triangle_of(a)
    base_diag = tril.diagonal().copy()

    attempt_shift = shift
    for _ in range(12):
        ok, L = _ichol0_once(tril, base_diag, attempt_shift)
        if ok:
            return L
        attempt_shift = max(attempt_shift * 2.0, 1e-3)
    raise np.linalg.LinAlgError("IC(0) failed even with diagonal shift")


def _ichol0_once(tril: CSRMatrix, base_diag: np.ndarray, shift: float):
    n = tril.n_rows
    indptr, indices = tril.indptr, tril.indices
    vals = tril.data.copy()
    rows = tril.row_of_entry()
    diag_mask = indices == rows
    if shift:
        vals[diag_mask] = base_diag * (1.0 + shift)

    diag_pos = np.nonzero(diag_mask)[0]
    assert len(diag_pos) == n, "IC(0) requires a structurally full diagonal"

    for i in range(n):
        lo = int(indptr[i])
        ti = int(diag_pos[i])
        for t in range(lo, ti):
            j = int(indices[t])
            # L[i,j] = (A[i,j] - sum_{k<j} L[i,k] L[j,k]) / L[j,j]
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
        # diagonal: L[i,i] = sqrt(A[i,i] - sum_k L[i,k]^2)
        s = vals[ti] - float(np.sum(vals[lo:ti] ** 2))
        if s <= 0.0:
            return False, None
        vals[ti] = np.sqrt(s)
    L = CSRMatrix(n, tril.n_cols, indptr.copy(), indices.copy(), vals)
    return True, L
