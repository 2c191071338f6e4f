"""Serial reference solvers — the oracle every executor is tested against.
A copy of the JAX package's ``solver/reference.py`` (NumPy and SciPy,
on the host)."""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSRMatrix


def forward_substitution(L: CSRMatrix, b: np.ndarray) -> np.ndarray:
    """Eq. (2.1): x_i = (b_i - sum_{j<i} A_ij x_j) / A_ii. Serial CSR sweep —
    the 'Serial' baseline of the paper's tables."""
    n = L.n_rows
    x = np.zeros(n, dtype=np.float64)
    indptr, indices, data = L.indptr, L.indices, L.data
    for i in range(n):
        acc = 0.0
        diag = None
        for t in range(int(indptr[i]), int(indptr[i + 1])):
            j = int(indices[t])
            if j == i:
                diag = data[t]
            else:
                acc += data[t] * x[j]
        x[i] = (b[i] - acc) / diag
    return x


def solve_lower_scipy(L: CSRMatrix, b: np.ndarray) -> np.ndarray:
    from scipy.sparse.linalg import spsolve_triangular

    return spsolve_triangular(L.to_scipy().tocsr(), b, lower=True)
