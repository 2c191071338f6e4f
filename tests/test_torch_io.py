"""The port's Matrix-Market IO (``repro_torch.sparse.io``): the eight
cases of tests/test_io.py on the port's reader and writer (read <-> write
round-trips over real/integer/pattern x general/symmetric, plain and
gzip, header checks), and against the JAX package: a file the port
writes holds the bytes the JAX writer writes for the same matrix (gzip:
the same decompressed bytes; the gzip header carries a time stamp), and
both readers read every such file into equal arrays."""
import dataclasses
import gzip

import numpy as np
import pytest

import repro.sparse as jsparse
from repro.sparse.io import read_matrix_market as jread
from repro.sparse.io import write_matrix_market as jwrite
from repro_torch.sparse import (
    CSRMatrix,
    csr_from_coo,
    erdos_renyi_lower,
    read_matrix_market,
    transpose_csr,
    write_matrix_market,
)


def _lower(seed=5, n=60):
    return erdos_renyi_lower(n, 0.06, seed=seed)


def _symmetric(seed=6, n=50):
    """L + L^T with a heavy diagonal — numerically symmetric by build."""
    L = erdos_renyi_lower(n, 0.06, seed=seed)
    rows = np.concatenate([L.row_of_entry(), L.indices])
    cols = np.concatenate([L.indices, L.row_of_entry()])
    vals = np.concatenate([L.data, L.data])
    return csr_from_coo(n, n, rows, cols, vals)


def _assert_same(a: CSRMatrix, b: CSRMatrix, values=True):
    assert (a.n_rows, a.n_cols, a.nnz) == (b.n_rows, b.n_cols, b.nnz)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    if values:
        assert np.allclose(a.data, b.data, rtol=0, atol=0)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
def test_roundtrip_general(tmp_path, field, gz):
    m = _lower()
    if field == "integer":
        m = dataclasses.replace(
            m, data=np.round(m.data * 10).astype(np.float64)
        )
    path = tmp_path / ("m.mtx" + (".gz" if gz else ""))
    write_matrix_market(path, m, field=field)
    back = read_matrix_market(path)
    if field == "pattern":
        _assert_same(m, back, values=False)
        assert np.all(back.data == 1.0)
    else:
        _assert_same(m, back)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
def test_roundtrip_symmetric(tmp_path, field, gz):
    m = _symmetric()
    if field == "integer":
        m = dataclasses.replace(
            m, data=np.round(m.data * 10).astype(np.float64)
        )
    path = tmp_path / ("s.mtx" + (".gz" if gz else ""))
    write_matrix_market(path, m, field=field, symmetry="symmetric")
    # symmetric storage really stores only the lower triangle
    opener = gzip.open if gz else open
    with opener(path, "rt") as fh:
        header = fh.readline()
        n, nc, nnz_stored = (int(t) for t in fh.readline().split())
    assert "symmetric" in header and field in header
    assert nnz_stored < m.nnz
    back = read_matrix_market(path)
    if field == "pattern":
        _assert_same(m, back, values=False)
    else:
        _assert_same(m, back)


def test_integer_header_is_accepted(tmp_path):
    """`coordinate integer` files (SuiteSparse has many) parse fine."""
    path = tmp_path / "int.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate integer general\n"
        "% a comment line\n"
        "2 2 3\n"
        "1 1 5\n"
        "2 1 -3\n"
        "2 2 7\n"
    )
    m = read_matrix_market(path)
    assert (m.n_rows, m.n_cols, m.nnz) == (2, 2, 3)
    assert np.array_equal(m.data, [5.0, -3.0, 7.0])


def test_symmetric_pattern_read(tmp_path):
    path = tmp_path / "sp.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate pattern symmetric\n"
        "3 3 3\n"
        "1 1\n"
        "3 1\n"
        "3 3\n"
    )
    m = read_matrix_market(path)
    assert m.nnz == 4  # (3,1) expands to (1,3)
    assert np.all(m.data == 1.0)
    t = transpose_csr(m)
    assert np.array_equal(m.indptr, t.indptr)
    assert np.array_equal(m.indices, t.indices)


def test_rejects_unsupported_headers(tmp_path):
    cases = [
        ("%%MatrixMarket matrix array real general\n2 2\n1\n0\n0\n1\n",
         "coordinate"),
        ("%%MatrixMarket matrix coordinate complex general\n1 1 1\n"
         "1 1 2.0 0.0\n", "field"),
        ("%%MatrixMarket matrix coordinate real hermitian\n1 1 1\n"
         "1 1 2.0\n", "symmetry"),
        ("garbage first line\n1 1 1\n1 1 2.0\n", "header"),
    ]
    for text, match in cases:
        path = tmp_path / "bad.mtx"
        path.write_text(text)
        with pytest.raises(ValueError, match=match):
            read_matrix_market(path)


def test_rejects_bad_write_args(tmp_path):
    m = _lower()
    with pytest.raises(ValueError, match="field"):
        write_matrix_market(tmp_path / "x.mtx", m, field="complex")
    with pytest.raises(ValueError, match="symmetry"):
        write_matrix_market(tmp_path / "x.mtx", m, symmetry="hermitian")
    with pytest.raises(ValueError, match="symmetric"):
        # a lower-triangular matrix is not symmetric
        write_matrix_market(tmp_path / "x.mtx", m, symmetry="symmetric")
    with pytest.raises(ValueError, match="integral"):
        write_matrix_market(tmp_path / "x.mtx", m, field="integer")


def test_pattern_symmetric_write_needs_only_structural_symmetry(tmp_path):
    """Values are never written for field='pattern', so a structurally
    symmetric matrix with asymmetric values must still round-trip."""
    m = _symmetric()
    rng = np.random.default_rng(7)
    m = dataclasses.replace(m, data=rng.standard_normal(m.nnz))
    path = tmp_path / "sp.mtx"
    write_matrix_market(path, m, field="pattern", symmetry="symmetric")
    back = read_matrix_market(path)
    _assert_same(m, back, values=False)
    with pytest.raises(ValueError, match="symmetric"):
        # ... while a value-carrying field still demands numeric symmetry
        write_matrix_market(path, m, field="real", symmetry="symmetric")


def test_entry_count_mismatch_rejected(tmp_path):
    path = tmp_path / "short.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "2 2 3\n"
        "1 1 1.0\n"
    )
    with pytest.raises(ValueError, match="entry count"):
        read_matrix_market(path)


# ------------------------------------------------------- against JAX
def _jax(m):
    return jsparse.CSRMatrix(m.n_rows, m.n_cols, m.indptr, m.indices, m.data)


def _read_bytes(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("symmetry", ["general", "symmetric"])
@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
def test_written_bytes_and_reads_match_jax(tmp_path, field, symmetry, gz):
    m = _symmetric() if symmetry == "symmetric" else _lower()
    if field == "integer":
        m = dataclasses.replace(m, data=np.round(m.data * 10).astype(np.float64))
    suffix = ".mtx.gz" if gz else ".mtx"
    ours, theirs = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    write_matrix_market(ours, m, field=field, symmetry=symmetry)
    jwrite(theirs, _jax(m), field=field, symmetry=symmetry)
    assert _read_bytes(ours) == _read_bytes(theirs)
    for path in (ours, theirs):
        t, j = read_matrix_market(path), jread(path)
        assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
        for f in ("indptr", "indices", "data"):
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_reads_hand_written_files_like_jax(tmp_path):
    # comments, an integer field and a symmetric pattern file, each as the
    # JAX reader reads it
    texts = [
        "%%MatrixMarket matrix coordinate integer general\n% c\n2 2 3\n1 1 5\n2 1 -3\n2 2 7\n",
        "%%MatrixMarket matrix coordinate pattern symmetric\n3 3 3\n1 1\n3 1\n3 3\n",
        "%%MatrixMarket matrix coordinate real general\n3 4 2\n3 4 1.5e-3\n1 2 -2\n",
    ]
    for i, text in enumerate(texts):
        path = tmp_path / f"h{i}.mtx"
        path.write_text(text)
        t, j = read_matrix_market(path), jread(path)
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(t, f), getattr(j, f)), (i, f)
