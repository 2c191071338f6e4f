"""The port's SpMV against the JAX package (CPU).

  * ``ell_from_csr`` array-equal (value and dtype) to the JAX package's;
  * ``kernels.ref.spmv_ell_ref`` within rtol=atol=1e-5 of
    ``spmv_pallas(interpret=True)`` and of ``spmv_block_ref``, and the
    entry point ``spmv`` within 1e-5 of the JAX ``spmv`` and 2e-4 of
    scipy — the tolerances of tests/test_spmv_kernel.py: SpMV is outside
    the bitwise contract (the reference tree-sums over W);
  * the kernel's sliced layout (``sliced_from_csr``): every CSR entry once,
    slot-major in slices of 32 rows, ``row_len`` the row lengths, and its
    lane-idle share;
  * the kernel's plain version ``spmv_sliced_ref`` bitwise the padded-ELL
    product with the split rows summed in piece order
    (``spmv_ell_rows_ref``, the definition it keeps), at widths None, 2
    and 3, in float32 and float64, also on rows whose chains cancel to an
    exact zero or reach -0;
  * the wrapper's input checks and its plain path;
  * the bound operator ``EllOperator`` (CG's matvec): bitwise ``spmv()``
    and the definition, with no host work in a call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as jsparse
from repro.kernels.ref import spmv_block_ref
from repro.kernels.spmv import ell_from_csr as jell_from_csr
from repro.kernels.spmv import spmv as jspmv
from repro.kernels.spmv import spmv_pallas
from repro_torch.backends.base import numpy_dtype
from repro_torch.convert import csr_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import spmv as tspmv
from repro_torch.kernels.ref import (
    SLICE_ROWS,
    spmv_ell_ref,
    spmv_ell_rows_ref,
    spmv_sliced_ref,
)

def _arrow():
    """ER with three dense rows: the default width (the 95th percentile of
    the row lengths) splits those rows into many ELL rows."""
    m = jsparse.erdos_renyi_lower(300, 0.02, seed=300)
    long_rows = [np.full(i, i) for i in (100, 200, 299)]
    long_cols = [np.arange(i) for i in (100, 200, 299)]
    rng = np.random.default_rng(8)
    return jsparse.csr_from_coo(
        300, 300, np.concatenate([m.row_of_entry(), *long_rows]),
        np.concatenate([m.indices, *long_cols]),
        np.concatenate([m.data, rng.uniform(-1, 1, 599)]))


_MATS = {
    "er": lambda: jsparse.erdos_renyi_lower(300, 0.02, seed=300),
    "arrow": _arrow,
    "nb": lambda: jsparse.narrow_band_lower(257, 0.2, 6.0, seed=5),
    "ichol": lambda: jsparse.ichol0(jsparse.poisson2d_matrix(12)),
    "upper": lambda: jsparse.transpose_csr(jsparse.erdos_renyi_lower(200, 0.05, seed=2)),
}


def _port(m):
    return csr_from_numpy(m.n_rows, m.n_cols, m.indptr, m.indices, m.data)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _tensors(layout):
    """A numpy ``SlicedEll``'s four arrays as tensors, then its width."""
    return (*(torch.from_numpy(a) for a in layout[:4]), layout.width)


def _definition(m, x, width=None):
    """y by the definition the sliced walk keeps: the padded ELL at
    ``width``, chained over every slot, the split rows summed in order."""
    dtype = numpy_dtype(x.dtype)
    col_idx, vals, row_map = tspmv.ell_from_csr(m, width=width, dtype=dtype)
    return spmv_ell_rows_ref(torch.from_numpy(col_idx), torch.from_numpy(vals),
                             torch.from_numpy(row_map), x)


def _signed_zeros(dtype, n=97, seed=11):
    """(m, x): rows of 0 to 8 entries drawn from five kinds, so that chains
    cancel to an exact zero or reach -0 mid-row and at a row's end:
    a negative value times x = +0 (a -0 product, which fma adds to +0 as
    +0); -tiny times tiny, which underflows to -0 and keeps a chain at -0
    through the -0 products after it; +tiny times tiny (+0); a value and
    its negation at two columns of equal x (an exact zero); and ordinary
    entries. Some rows are empty."""
    tiny = 1e-30 if dtype == np.float32 else 1e-200
    x = np.random.default_rng(seed).uniform(-2, 2, 30)
    x[:10], x[10:20], x[21] = 0.0, tiny, x[20]
    rng = np.random.default_rng(seed + 1)
    indptr, cols, vals = [0], [], []
    for _ in range(n):
        for kind in rng.integers(0, 5, rng.integers(0, 5)):
            if kind == 0:
                cols.append(int(rng.integers(0, 10)))
                vals.append(-rng.uniform(0.5, 2))
            elif kind in (1, 2):
                cols.append(int(rng.integers(10, 20)))
                vals.append(-tiny if kind == 1 else tiny)
            elif kind == 3:
                a = rng.uniform(0.5, 2)
                cols += [20, 21]
                vals += [a, -a]
            else:
                cols.append(int(rng.integers(22, 30)))
                vals.append(rng.uniform(-2, 2))
        indptr.append(len(cols))
    m = csr_from_numpy(n, 30, np.array(indptr), np.array(cols), np.array(vals))
    return m, x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("name", ["er", "nb", "ichol", "upper"])
def test_ell_from_csr_matches_jax(name, width, dtype):
    m = _MATS[name]()
    for a, b in zip(jell_from_csr(m, width=width, dtype=dtype),
                    tspmv.ell_from_csr(_port(m), width=width, dtype=dtype)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# the cases of tests/test_spmv_kernel.py::test_spmv_kernel_matches_oracle
@pytest.mark.parametrize("n,density,tile", [(300, 0.02, 64), (512, 0.05, 128)])
def test_spmv_ell_ref_matches_pallas_and_oracle(n, density, tile):
    m = jsparse.erdos_renyi_lower(n, density, seed=n)
    col_idx, vals, _ = jell_from_csr(m, dtype=np.float32)
    pad = (-col_idx.shape[0]) % tile
    col_idx = np.concatenate([col_idx, np.full((pad, col_idx.shape[1]), n, np.int32)])
    vals = np.concatenate([vals, np.zeros((pad, vals.shape[1]), np.float32)])
    x = np.random.default_rng(1).standard_normal(n)
    x_pad = jnp.concatenate([jnp.asarray(x, jnp.float32), jnp.zeros(1, jnp.float32)])
    y_pallas = np.asarray(spmv_pallas(
        jnp.asarray(col_idx), jnp.asarray(vals), x_pad, rows_per_tile=tile, interpret=True
    ))
    y_oracle = np.asarray(spmv_block_ref(x_pad, jnp.asarray(col_idx), jnp.asarray(vals)))
    y = spmv_ell_ref(
        torch.from_numpy(col_idx), torch.from_numpy(vals), torch.from_numpy(np.array(x_pad))
    ).numpy()
    np.testing.assert_allclose(y, y_pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, y_oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_spmv_matches_jax_and_scipy(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 200))
    m = jsparse.narrow_band_lower(n, 0.2, 6.0, seed=seed)
    x = rng.standard_normal(n)
    y = tspmv.spmv(_port(m), x, device="cpu")
    assert y.dtype == torch.float32 and y.shape == (n,) and y.device.type == "cpu"
    y_jax = np.asarray(jspmv(m, x, rows_per_tile=32, interpret=True))
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), m.to_scipy() @ x, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["er", "ichol", "upper"])
def test_spmv_f64_and_torch_input(name):
    m = _MATS[name]()
    x = np.random.default_rng(3).standard_normal(m.n_cols)
    y = tspmv.spmv(_port(m), torch.from_numpy(x), dtype=torch.float64, device="cpu")
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), m.to_scipy() @ x, rtol=1e-12, atol=1e-12)


def test_split_rows_sum_in_piece_order():
    # the dense rows split into many ELL rows; piece p of every row is
    # added in turn, so y equals the rows' left-to-right piece sums
    m = _port(_MATS["arrow"]())
    col_idx, vals, row_map = tspmv.ell_from_csr(m, dtype=np.float64)
    assert np.bincount(row_map).max() > 2 and (np.diff(row_map) >= 0).all()
    x = np.random.default_rng(4).standard_normal(m.n_cols)
    x_pad = torch.from_numpy(np.append(x, 0.0))
    y_ell = spmv_ell_ref(torch.from_numpy(col_idx), torch.from_numpy(vals), x_pad)
    op = tspmv.EllOperator(m, dtype=torch.float64, device="cpu")
    y = op(torch.from_numpy(x)).numpy()
    expect = np.zeros(m.n_rows)
    for r, v in zip(row_map, y_ell.numpy()):
        expect[r] = expect[r] + v
    assert np.array_equal(y, expect)
    assert np.array_equal(_definition(m, torch.from_numpy(x)).numpy(), expect)
    np.testing.assert_allclose(y, m.to_scipy() @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("width", [None, 2, 3])
@pytest.mark.parametrize("name", sorted(_MATS))
def test_sliced_layout_holds_every_entry_once(name, width):
    m = _port(_MATS[name]())
    lay = tspmv.sliced_from_csr(m, width=width, dtype=np.float64)
    n = m.n_rows
    assert lay.width == (width or tspmv.ell_from_csr(m)[0].shape[1]) == tspmv.ell_width(m, width)
    assert lay.n_cols == m.n_cols and lay.col.dtype == np.int32 and lay.val.dtype == np.float64
    assert lay.slice_ptr.dtype == np.int64 and lay.row_len.dtype == np.int32
    assert np.array_equal(lay.row_len, np.diff(m.indptr))
    # slice s holds 32 slots for each slot of its longest row
    lens = np.zeros(-(-n // SLICE_ROWS) * SLICE_ROWS, dtype=np.int64)
    lens[:n] = lay.row_len
    assert np.array_equal(np.diff(lay.slice_ptr),
                          SLICE_ROWS * lens.reshape(-1, SLICE_ROWS).max(axis=1))
    assert lay.slice_ptr[0] == 0 and lay.slice_ptr[-1] == len(lay.col) == len(lay.val)
    # slot k of row i, slot-major: every CSR entry, in order, exactly once
    seen = np.zeros(len(lay.col), dtype=bool)
    for i in range(n):
        k = np.arange(lay.row_len[i])
        slots = lay.slice_ptr[i // SLICE_ROWS] + SLICE_ROWS * k + i % SLICE_ROWS
        lo, hi = m.indptr[i], m.indptr[i + 1]
        assert np.array_equal(lay.col[slots], m.indices[lo:hi])
        assert np.array_equal(lay.val[slots], m.data[lo:hi])
        assert not seen[slots].any()
        seen[slots] = True
    assert seen.sum() == m.nnz
    # the rest is padding, (0, 0), stored and never read
    assert not lay.col[~seen].any() and not lay.val[~seen].any()
    assert lay.lane_idle_share() == pytest.approx(1 - m.nnz / len(lay.col))


@pytest.mark.parametrize("width", [None, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(_MATS))
def test_sliced_ref_bitwise_ell_definition(name, dtype, width):
    # the plain version of the kernel is the padded-ELL chains (padding
    # included) with the split rows summed in piece order, to the bit;
    # every third x is 0, so padding-like +0 products occur in real rows
    m = _port(_MATS[name]())
    lay = tspmv.sliced_from_csr(m, width=width, dtype=numpy_dtype(dtype))
    x = np.random.default_rng(5).standard_normal(m.n_cols)
    x[::3] = 0.0
    x = torch.as_tensor(x, dtype=dtype)
    y = spmv_sliced_ref(*_tensors(lay), x)
    assert y.dtype == dtype and y.shape == (m.n_rows,)
    assert torch.equal(_bits(y), _bits(_definition(m, x, width)))


@pytest.mark.parametrize("width", [None, 1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sliced_ref_signed_zeros_bitwise(dtype, width):
    # chains that cancel to +0, or end at -0 where the padded ELL's
    # padding slot would turn them to +0: the row sum's +0 start does
    # the same, so the bits agree
    m, x = _signed_zeros(dtype)
    xt = torch.as_tensor(x, dtype=torch.float32 if dtype == np.float32 else torch.float64)
    col_idx, vals, _ = tspmv.ell_from_csr(m, width=1, dtype=dtype)
    y_piece = spmv_ell_ref(torch.from_numpy(col_idx), torch.from_numpy(vals),
                           torch.cat([xt, xt.new_zeros(1)]))
    assert bool(((y_piece == 0) & torch.signbit(y_piece)).any())  # -0 chains exist
    lay = tspmv.sliced_from_csr(m, width=width, dtype=dtype)
    y = spmv_sliced_ref(*_tensors(lay), xt)
    expect = _definition(m, xt, width)
    assert bool((expect == 0).sum() > m.n_rows // 4)
    assert torch.equal(_bits(y), _bits(expect))
    assert torch.equal(_bits(tspmv.EllOperator(m, dtype=xt.dtype, device="cpu")(xt)),
                       _bits(_definition(m, xt)))


@pytest.mark.parametrize("name", sorted(_MATS))
def test_ell_operator_matches_jax_spmv(name):
    # the whole product: within 1e-5 of the JAX spmv (Pallas interpret,
    # tree sums, segment_sum) and 2e-4 of scipy, as tests/test_spmv_kernel.py
    m = _MATS[name]()
    x = np.random.default_rng(6).standard_normal(m.n_cols)
    y = tspmv.EllOperator(_port(m), device="cpu")(x).numpy()
    y_jax = np.asarray(jspmv(m, x, rows_per_tile=32, interpret=True))
    np.testing.assert_allclose(y, y_jax, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, m.to_scipy() @ x, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["er", "arrow", "nb", "ichol", "upper"])
def test_ell_operator_bitwise_vs_spmv_and_ell_ref(name, dtype):
    # bound once: the same bits as spmv() (bind, then call), as the plain
    # version on the bound layout and as the padded-ELL definition, call
    # after call
    m = _port(_MATS[name]())
    op = tspmv.EllOperator(m, dtype=dtype, device="cpu")
    lay = tspmv.sliced_from_csr(m, dtype=numpy_dtype(dtype))
    for a, b in zip(op.layout[:4], lay[:4]):
        assert np.array_equal(a.numpy(), b) and a.numpy().dtype == b.dtype
    assert op.layout[4:] == lay[4:]
    assert op.lane_idle_share == lay.lane_idle_share()
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = torch.as_tensor(rng.standard_normal(m.n_cols), dtype=dtype)
        y = op(x)
        assert y.dtype == dtype and y.shape == (m.n_rows,)
        assert torch.equal(y, tspmv.spmv(m, x, dtype=dtype, device="cpu"))
        assert torch.equal(y, spmv_sliced_ref(*op.layout[:5], x))
        assert torch.equal(_bits(y), _bits(_definition(m, x)))


def test_ell_operator_call_does_no_host_conversion(monkeypatch):
    # after binding, a call builds no layout: the layout lives on the
    # operator's device, and a call is the wrapper on it
    m = _port(_MATS["arrow"]())
    op = tspmv.EllOperator(m, device="cpu")
    assert all(t.device.type == "cpu" for t in op.layout[:4])
    assert int(op.layout.row_len.max()) > op.layout.width  # split rows, summed in the call
    x = np.random.default_rng(2).standard_normal(m.n_cols)
    y0 = op(x)

    def refuse(*a, **k):
        raise AssertionError("host work inside a call")

    for name in ("ell_from_csr", "ell_width", "sliced_from_csr"):
        monkeypatch.setattr(tspmv, name, refuse)
    calls = []
    plain = tspmv.spmv_sliced_ref
    monkeypatch.setattr(tspmv, "spmv_sliced_ref", lambda *a: calls.append(a) or plain(*a))
    tspmv.reset_launches()
    assert torch.equal(op(x), y0)
    assert len(calls) == 1 and all(a is b for a, b in zip(calls[0][:4], op.layout[:4]))
    assert tspmv.launches == {"spmv": 0}  # the plain version, on the CPU
    with pytest.raises(ValueError, match="x must be"):
        op(np.ones(m.n_cols + 1))


def test_spmv_cuda_input_checks_and_plain_path():
    # the wrapper spmv_sliced_cuda: types, shapes, layout and device
    # checked before anything runs; CPU tensors take the plain version
    m = _port(_MATS["nb"]())
    c, v, sp, rl, w = _tensors(tspmv.sliced_from_csr(m))
    x = torch.zeros(m.n_cols)
    for args, err in [
        ((c.long(), v, sp, rl, w, x), TypeError),
        ((c, v.double(), sp, rl, w, x), TypeError),
        ((c, v, sp, rl, w, x.double()), TypeError),
        ((c, v, sp.int(), rl, w, x), TypeError),
        ((c, v, sp, rl.long(), w, x), TypeError),
        ((c, v.numpy(), sp, rl, w, x), TypeError),
        ((c, v[:-1], sp, rl, w, x), ValueError),
        ((c, v, sp[:-1], rl, w, x), ValueError),
        ((c, v, sp, rl[:-1], w, x), ValueError),
        ((c[::2], v[::2], sp, rl, w, x), ValueError),  # not contiguous
        ((c, v, sp, rl, w, x[None]), ValueError),
        ((c, v, sp, rl, 0, x), ValueError),
        ((c, v, sp, rl, float(w), x), ValueError),
        ((c, v, sp, rl, w, x.to("meta")), TypeError),
        ((c, v, sp, rl, w, x.numpy()), TypeError),
    ]:
        with pytest.raises(err):
            tspmv.spmv_sliced_cuda(*args)
    tspmv.reset_launches()
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(m.n_cols), dtype=torch.float32)
    y = tspmv.spmv_sliced_cuda(c, v, sp, rl, w, x)
    assert torch.equal(y, spmv_sliced_ref(c, v, sp, rl, w, x))
    assert tspmv.launches == {"spmv": 0}
    assert "spmv" not in build._LIBS
    with pytest.raises(ValueError, match="x must be"):
        tspmv.spmv(m, np.ones(m.n_cols + 1), device="cpu")
    bad = csr_from_numpy(m.n_rows, m.n_cols, m.indptr, m.indices + 1, m.data)
    with pytest.raises(ValueError, match="column indices"):
        tspmv.spmv(bad, np.ones(m.n_cols), device="cpu")


def test_spmv_rows_without_entries():
    # rows without entries store no slot and give +0
    m = csr_from_numpy(5, 4, np.zeros(6, np.int64), np.zeros(0, np.int64), np.zeros(0))
    lay = tspmv.sliced_from_csr(m)
    assert len(lay.col) == 0 and lay.lane_idle_share() == 0.0
    y = tspmv.spmv(m, np.ones(4), device="cpu")
    assert y.shape == (5,) and not bool(torch.signbit(y).any()) and not y.any()
