"""Matrix-Market IO (coordinate real/integer/pattern, general/symmetric),
dependency-light.

Lets users drop in actual SuiteSparse ``.mtx`` / ``.mtx.gz`` files when
they have them; the generators stand in where they do not.
Reading and writing round-trip each other for every supported
(field, symmetry) combination, gzip included. A copy of the JAX
package's ``sparse/io.py``: the same matrix writes the same bytes.
"""
from __future__ import annotations

import gzip
import io
from pathlib import Path

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, csr_from_coo, transpose_csr

_FIELDS = ("real", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric")


def _parse_header(header: str) -> tuple:
    """-> (field, symmetry); raises on anything we cannot faithfully
    represent (complex values, skew/hermitian symmetry, array format)."""
    tokens = header.split()
    # %%MatrixMarket object format field symmetry
    if len(tokens) < 5 or tokens[0] != "%%matrixmarket":
        raise ValueError(f"unsupported MatrixMarket header: {header}")
    _, obj, fmt, field, symmetry = tokens[:5]
    if obj != "matrix" or fmt != "coordinate":
        raise ValueError(
            f"only 'matrix coordinate' files are supported, got "
            f"{obj!r} {fmt!r}"
        )
    if field not in _FIELDS:
        raise ValueError(
            f"unsupported field {field!r}; supported: {_FIELDS}"
        )
    if symmetry not in _SYMMETRIES:
        raise ValueError(
            f"unsupported symmetry {symmetry!r}; supported: {_SYMMETRIES}"
        )
    return field, symmetry


def _opener(path: Path):
    return gzip.open if path.suffix == ".gz" else open


def read_matrix_market(path: str | Path) -> CSRMatrix:
    path = Path(path)
    with _opener(path)(path, "rt") as fh:
        header = fh.readline().strip().lower()
        field, symmetry = _parse_header(header)
        pattern = field == "pattern"
        symmetric = symmetry == "symmetric"
        line = fh.readline()
        while line.startswith("%"):
            line = fh.readline()
        n_rows, n_cols, nnz = (int(t) for t in line.split())
        data = np.loadtxt(io.StringIO(fh.read()), ndmin=2)
    if data.shape[0] != nnz:
        raise ValueError(
            f"entry count mismatch: header says {nnz}, file has "
            f"{data.shape[0]}"
        )
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = np.ones(len(rows)) if pattern else data[:, 2].astype(np.float64)
    if symmetric:
        if not bool(np.all(rows >= cols)):
            raise ValueError(
                "symmetric MatrixMarket files must store the lower triangle"
            )
        off = rows != cols
        rows_all = np.concatenate([rows, cols[off]])
        cols_all = np.concatenate([cols, rows[off]])
        vals = np.concatenate([vals, vals[off]])
        rows, cols = rows_all, cols_all
    assert len(rows) >= nnz  # symmetric expansion can only grow
    return csr_from_coo(n_rows, n_cols, rows, cols, vals)


def write_matrix_market(
    path: str | Path,
    m: CSRMatrix,
    *,
    field: str = "real",
    symmetry: str = "general",
) -> None:
    """Write ``m`` as ``coordinate <field> <symmetry>``; gzip-compressed
    when ``path`` ends in ``.gz``.

    * ``field="integer"`` requires integral values (formatted as ints);
      ``field="pattern"`` stores structure only (values read back as 1.0).
    * ``symmetry="symmetric"`` requires a structurally and numerically
      symmetric ``m`` and stores only its lower triangle (the standard
      MatrixMarket convention ``read_matrix_market`` expands).
    """
    if field not in _FIELDS:
        raise ValueError(f"field must be one of {_FIELDS}, got {field!r}")
    if symmetry not in _SYMMETRIES:
        raise ValueError(
            f"symmetry must be one of {_SYMMETRIES}, got {symmetry!r}"
        )
    path = Path(path)
    rows = m.row_of_entry()
    cols = m.indices
    vals = m.data
    if field == "integer" and not np.all(vals == np.round(vals)):
        raise ValueError("field='integer' requires integral values")
    if symmetry == "symmetric":
        t = transpose_csr(m)
        # pattern files never store values, so only structural symmetry
        # is required for a faithful round-trip
        if (
            m.n_rows != m.n_cols
            or not np.array_equal(m.indptr, t.indptr)
            or not np.array_equal(m.indices, t.indices)
            or (field != "pattern" and not np.array_equal(m.data, t.data))
        ):
            raise ValueError(
                "symmetry='symmetric' requires a symmetric matrix"
            )
        keep = rows >= cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    with _opener(path)(path, "wt") as fh:
        fh.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        fh.write(f"{m.n_rows} {m.n_cols} {len(rows)}\n")
        if field == "pattern":
            for r, c in zip(rows, cols):
                fh.write(f"{r + 1} {c + 1}\n")
        elif field == "integer":
            for r, c, v in zip(rows, cols, vals):
                fh.write(f"{r + 1} {c + 1} {int(round(v))}\n")
        else:
            for r, c, v in zip(rows, cols, vals):
                fh.write(f"{r + 1} {c + 1} {v:.17g}\n")
