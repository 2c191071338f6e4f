"""The port's padded-ELL SpMV against the JAX package (CPU).

  * ``ell_from_csr`` array-equal (value and dtype) to the JAX package's;
  * ``kernels.ref.spmv_ell_ref`` within rtol=atol=1e-5 of
    ``spmv_pallas(interpret=True)`` and of ``spmv_block_ref``, and the
    entry point ``spmv`` within 1e-5 of the JAX ``spmv`` and 2e-4 of
    scipy — the tolerances of tests/test_spmv_kernel.py: SpMV is outside
    the bitwise contract (the reference tree-sums over W);
  * the sum of split rows, the wrapper's input checks and its plain path;
  * the bound operator ``EllOperator`` (CG's matvec): bitwise ``spmv()``
    and the plain version's piece sums, with no host work in a call.
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
from repro_torch.kernels.ref import spmv_ell_ref

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
    np.testing.assert_allclose(y, m.to_scipy() @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["er", "arrow", "nb", "ichol", "upper"])
def test_ell_operator_bitwise_vs_spmv_and_ell_ref(name, dtype):
    # bound once: the same bits as spmv() (bind, then call) and as the
    # kernel's plain version on the bound ELL arrays, call after call
    m = _port(_MATS[name]())
    op = tspmv.EllOperator(m, dtype=dtype, device="cpu")
    col_idx, vals, row_map = tspmv.ell_from_csr(m, dtype=numpy_dtype(dtype))
    assert np.array_equal(op.col_idx.numpy(), col_idx) and np.array_equal(op.vals.numpy(), vals)
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = torch.as_tensor(rng.standard_normal(m.n_cols), dtype=dtype)
        y = op(x)
        assert y.dtype == dtype and y.shape == (m.n_rows,)
        assert torch.equal(y, tspmv.spmv(m, x, dtype=dtype, device="cpu"))
        y_ell = spmv_ell_ref(op.col_idx, op.vals, torch.cat([x, x.new_zeros(1)]))
        expect = torch.zeros(m.n_rows, dtype=dtype)
        for r, v in zip(row_map, y_ell):
            expect[r] = expect[r] + v
        assert torch.equal(y, expect)


def test_ell_operator_call_does_no_host_conversion(monkeypatch):
    # after binding, a call neither converts to ELL nor builds piece
    # indices: both live on the operator's device
    m = _port(_MATS["arrow"]())
    op = tspmv.EllOperator(m, device="cpu")
    assert op._rest and all(s.device.type == d.device.type == "cpu" for s, d in op._rest)
    x = np.random.default_rng(2).standard_normal(m.n_cols)
    y0 = op(x)

    def refuse(*a, **k):
        raise AssertionError("host work inside a call")

    monkeypatch.setattr(tspmv, "ell_from_csr", refuse)
    monkeypatch.setattr(tspmv, "_piece_indices", refuse)
    tspmv.reset_launches()
    assert torch.equal(op(x), y0)
    assert tspmv.launches == {"spmv": 0}  # the plain version, on the CPU
    with pytest.raises(ValueError, match="x must be"):
        op(np.ones(m.n_cols + 1))


def test_spmv_cuda_input_checks_and_plain_path():
    m = _port(_MATS["nb"]())
    col_idx, vals, _ = tspmv.ell_from_csr(m)
    c, v = torch.from_numpy(col_idx), torch.from_numpy(vals)
    x_pad = torch.zeros(m.n_cols + 1)
    for args, err in [
        ((c.long(), v, x_pad), TypeError),
        ((c, v.double(), x_pad), TypeError),
        ((c, v[:, :1].contiguous(), x_pad), ValueError),
        ((c.t(), v.t(), x_pad), ValueError),  # not contiguous
        ((c, v, x_pad[None]), ValueError),
    ]:
        with pytest.raises(err):
            tspmv.spmv_cuda(*args)
    tspmv.reset_launches()
    y = tspmv.spmv_cuda(c, v, x_pad)
    assert torch.equal(y, spmv_ell_ref(c, v, x_pad))
    assert tspmv.launches == {"spmv": 0}
    assert "spmv" not in build._LIBS
    with pytest.raises(ValueError, match="x must be"):
        tspmv.spmv(m, np.ones(m.n_cols + 1), device="cpu")
    bad = csr_from_numpy(m.n_rows, m.n_cols, m.indptr, m.indices + 1, m.data)
    with pytest.raises(ValueError, match="column indices"):
        tspmv.spmv(bad, np.ones(m.n_cols), device="cpu")
