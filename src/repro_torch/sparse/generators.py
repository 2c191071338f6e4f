"""Matrix generators reproducing the paper's synthetic data sets (§6.2.4,
§6.2.5) plus FEM-style substitutes for SuiteSparse (§6.2.1: Poisson FEM
matrices whose solve-DAG statistics sit in the same regime). Copied from
the JAX package so that equal seeds give equal matrices in both.

Entry-value distributions follow the paper exactly:
  * off-diagonal non-zeros ~ U[-2, 2] i.i.d.,
  * |diagonal| ~ LogUniform[2^-1, 2], sign ± uniform (footnote 5: avoids
    divisions by ~0).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, csr_from_coo


def _paper_values(rng: np.random.Generator, n_off: int, n_diag: int):
    off = rng.uniform(-2.0, 2.0, size=n_off)
    mag = np.exp(rng.uniform(np.log(0.5), np.log(2.0), size=n_diag))
    sign = rng.choice([-1.0, 1.0], size=n_diag)
    return off, mag * sign


def erdos_renyi_lower(
    n: int, p: float, *, seed: int = 0
) -> CSRMatrix:
    """§6.2.4: lower-triangular ER matrix — entry (i, j), i > j, non-zero with
    probability p; full non-zero diagonal with the paper's value distributions."""
    rng = np.random.default_rng(seed)
    # Sample the number of non-zeros per row i from Binomial(i, p), then choose
    # columns without replacement. Vectorized in expectation-sized batches.
    rows_list = []
    cols_list = []
    counts = rng.binomial(np.arange(n), p)
    total = int(counts.sum())
    # Sample columns via sorting a uniform draw per entry: for row i we need
    # `counts[i]` distinct columns in [0, i). Use floyd-like sampling per row
    # only for tiny counts; otherwise random choice with dedup via unique.
    for i in np.nonzero(counts)[0]:
        c = rng.choice(i, size=counts[i], replace=False)
        rows_list.append(np.full(len(c), i, dtype=np.int64))
        cols_list.append(c.astype(np.int64))
    if rows_list:
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
    else:
        rows = np.empty(0, dtype=np.int64)
        cols = np.empty(0, dtype=np.int64)
    off, diag = _paper_values(rng, len(rows), n)
    all_rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    all_cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    all_vals = np.concatenate([off, diag])
    del total
    return csr_from_coo(n, n, all_rows, all_cols, all_vals)


def narrow_band_lower(
    n: int, p: float, band: float, *, seed: int = 0, max_width_sigma: float = 12.0
) -> CSRMatrix:
    """§6.2.5: entry (i, j), i > j, non-zero with probability
    ``p * exp((1 + j - i) / B)`` — mass concentrated near the diagonal.
    Hard to parallelize by design, but good locality.

    We truncate the band at width ``max_width_sigma * B`` where the inclusion
    probability has decayed below p * e^-12 ~ 6e-6 p: negligible mass,
    keeps generation O(n * B)."""
    rng = np.random.default_rng(seed)
    width = int(min(n - 1, np.ceil(band * max_width_sigma)))
    offsets = np.arange(1, width + 1)  # i - j
    probs = p * np.exp((1 - offsets) / band)
    probs = np.clip(probs, 0.0, 1.0)
    rows_list, cols_list = [], []
    for off_k, pk in zip(offsets, probs):
        if pk <= 0:
            continue
        i = np.arange(off_k, n, dtype=np.int64)
        mask = rng.random(len(i)) < pk
        ii = i[mask]
        rows_list.append(ii)
        cols_list.append(ii - off_k)
    rows = np.concatenate(rows_list) if rows_list else np.empty(0, dtype=np.int64)
    cols = np.concatenate(cols_list) if cols_list else np.empty(0, dtype=np.int64)
    off, diag = _paper_values(rng, len(rows), n)
    all_rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    all_cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    all_vals = np.concatenate([off, diag])
    return csr_from_coo(n, n, all_rows, all_cols, all_vals)


def poisson2d_matrix(nx: int, ny: int | None = None) -> CSRMatrix:
    """SPD 5-point Laplacian on an nx × ny grid — the canonical FEM-ish
    SuiteSparse stand-in (apache2/ecology2/thermal2 are of this flavor)."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64).reshape(nx, ny)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 4.0)]
    # left/right/up/down couplings
    for (a, b) in [
        (idx[:, 1:].ravel(), idx[:, :-1].ravel()),
        (idx[1:, :].ravel(), idx[:-1, :].ravel()),
    ]:
        rows.extend([a, b])
        cols.extend([b, a])
        vals.extend([np.full(len(a), -1.0)] * 2)
    return csr_from_coo(
        n, n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    )


def poisson3d_matrix(nx: int, ny: int | None = None, nz: int | None = None) -> CSRMatrix:
    """SPD 7-point Laplacian on an nx × ny × nz grid (audikw_1/bone010-flavor
    connectivity after ordering)."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64).reshape(nx, ny, nz)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for (a, b) in [
        (idx[:, :, 1:].ravel(), idx[:, :, :-1].ravel()),
        (idx[:, 1:, :].ravel(), idx[:, :-1, :].ravel()),
        (idx[1:, :, :].ravel(), idx[:-1, :, :].ravel()),
    ]:
        rows.extend([a, b])
        cols.extend([b, a])
        vals.extend([np.full(len(a), -1.0)] * 2)
    return csr_from_coo(
        n, n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    )


def shifted_coupling_lower(
    n: int, shift: int, *, stride: int = 8, seed: int = 0
) -> CSRMatrix:
    """A family of structurally DISTINCT lower-triangular matrices that
    compile to identically-shaped ``ExecPlan`` tensors — one *width
    class* (``TriangularSolver.width_class``), the serve layer's
    cross-pattern batching unit.

    Full non-zero diagonal plus one off-diagonal entry per ``stride``-th
    row ``i``, at column ``i - 1 - shift``. Varying ``shift`` in
    ``[0, stride - 2]`` moves every coupling to a different column
    (distinct sparsity fingerprints) while preserving the DAG's level
    profile exactly: couplings never target another coupled row, so
    every variant is "n - n/stride roots, n/stride depth-1 rows" with
    the same row-nnz histogram — level schedulers (``wavefront``,
    ``hdagg``) and the plan compiler see the same shapes for all shifts.
    Values follow the paper's distributions (off ~ U[-2,2],
    |diag| ~ LogU[1/2, 2])."""
    if not 0 <= shift <= stride - 2:
        raise ValueError(
            f"shift must be in [0, {stride - 2}] so couplings stay "
            "clear of the coupled rows (shift == stride - 1 would chain "
            "them, changing the DAG depth and thus the width class)"
        )
    rng = np.random.default_rng(seed)
    rr = np.arange(stride, n, stride, dtype=np.int64)
    cc = rr - 1 - shift
    off, diag = _paper_values(rng, len(rr), n)
    all_rows = np.concatenate([rr, np.arange(n, dtype=np.int64)])
    all_cols = np.concatenate([cc, np.arange(n, dtype=np.int64)])
    all_vals = np.concatenate([off, diag])
    return csr_from_coo(n, n, all_rows, all_cols, all_vals)


def random_spd_band(n: int, bandwidth: int, density: float, *, seed: int = 0) -> CSRMatrix:
    """Random symmetric positive-definite banded matrix (diagonally dominant),
    used by the IC(0) data-set generator."""
    rng = np.random.default_rng(seed)
    rows_list, cols_list, vals_list = [], [], []
    for off in range(1, bandwidth + 1):
        i = np.arange(off, n, dtype=np.int64)
        mask = rng.random(len(i)) < density
        ii = i[mask]
        v = rng.uniform(-1.0, 1.0, size=len(ii))
        rows_list.extend([ii, ii - off])
        cols_list.extend([ii - off, ii])
        vals_list.extend([v, v])
    rows = np.concatenate(rows_list) if rows_list else np.empty(0, dtype=np.int64)
    cols = np.concatenate(cols_list) if cols_list else np.empty(0, dtype=np.int64)
    vals = np.concatenate(vals_list) if vals_list else np.empty(0, dtype=np.float64)
    # diagonal dominance => SPD
    abssum = np.zeros(n)
    np.add.at(abssum, rows, np.abs(vals))
    diag = abssum + 1.0
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    vals = np.concatenate([vals, diag])
    return csr_from_coo(n, n, rows, cols, vals)
