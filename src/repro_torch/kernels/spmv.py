"""Padded-ELL SpMV on the card: wrapper over ``csrc/spmv.cu``.

The off-diagonal-block operator of the paper's block decomposition (§1.1.4:
the triangular matrix splits into diagonal SpTRSV blocks and off-diagonal
SpMV blocks; the SpMV part is embarrassingly parallel and feeds the next
diagonal block's right-hand side). The counterpart of the JAX package's
``kernels/spmv.py``:

  * ``ell_from_csr`` — a NumPy copy (vectorized, array-equal to the
    original): rows padded to W slots (columns with the scratch slot n,
    values with 0); rows wider than W split into several ELL rows, and
    ``row_map`` gives each ELL row's target row;
  * ``spmv_cuda`` — the kernel wrapper (replaces ``spmv_pallas``, the TPU
    kernel ``_spmv_kernel``): tensors on the CPU take the plain version
    (``kernels.ref.spmv_ell_ref``), and only because they lie on the CPU;
    tensors on a CUDA device launch the kernel or raise;
  * ``EllOperator(m)`` — the matrix bound once on a device: the ELL
    conversion on the host, the ELL tensors and the indices of the sum of
    split rows put on the device once; ``op(x)`` launches the kernel and
    sums the pieces with no host work and no host-to-device copy (CG's
    matvec, ``solver.cg``);
  * ``spmv(m, x)`` — the entry point: bind, then call.

SpMV is outside the solver's bitwise contract (the reference tree-sums
over W): the JAX package is held to it within a tolerance. The kernel's
per-ELL-row result is bitwise-equal to ``spmv_ell_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.backends.base import numpy_dtype
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.ref import spmv_ell_ref
from repro_torch.sparse.csr import CSRMatrix

launches = {"spmv": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches["spmv"] = 0


def ell_from_csr(m: CSRMatrix, *, width: int | None = None, dtype=np.float32):
    """(col_idx int32[R, W], vals f[R, W], row_map int32[R]) with
    self-padding to slot ``m.n_cols``. ``width`` defaults to the 95th
    percentile of the row lengths (at least 1); row i takes
    ``max(1, ceil(nnz_i / W))`` consecutive ELL rows, its entries in
    order. Array-equal to the JAX package's ``ell_from_csr``."""
    W = width or max(int(np.percentile(m.row_nnz(), 95)), 1)
    nnz_row = m.row_nnz()
    pieces = np.maximum(1, -(-nnz_row // W))
    first = np.cumsum(pieces) - pieces  # first ELL row of each row
    R = int(pieces.sum())
    pos = np.arange(m.nnz, dtype=np.int64) - np.repeat(m.indptr[:-1], nnz_row)
    dest = (np.repeat(first, nnz_row) + pos // W) * W + pos % W
    col_idx = np.full(R * W, m.n_cols, dtype=np.int32)
    col_idx[dest] = m.indices
    vals = np.zeros(R * W, dtype=dtype)
    vals[dest] = m.data
    row_map = np.repeat(np.arange(m.n_rows, dtype=np.int32), pieces)
    return col_idx.reshape(R, W), vals.reshape(R, W), row_map


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed once per process."""
    fn = getattr(build.load("spmv"), f"spmv_ell_{_SUFFIX[dtype]}")
    fn.argtypes = [_P, _P, _I, _I, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(col_idx, vals, x_pad):
    for name, t in (("col_idx", col_idx), ("vals", vals), ("x_pad", x_pad)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x_pad.device:
            raise ValueError(f"{name} is on {t.device}, x_pad on {x_pad.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if col_idx.dtype != torch.int32:
        raise TypeError(f"col_idx must be int32, got {col_idx.dtype}")
    if vals.dtype not in _SUFFIX or x_pad.dtype != vals.dtype:
        raise TypeError(
            f"vals and x_pad must share float32 or float64; got {vals.dtype}, {x_pad.dtype}"
        )
    if col_idx.dim() != 2 or vals.shape != col_idx.shape:
        raise ValueError(
            f"col_idx and vals must both be [R, W]; got {tuple(col_idx.shape)}, "
            f"{tuple(vals.shape)}"
        )
    if x_pad.dim() != 1 or x_pad.shape[0] < 1:
        raise ValueError(f"x_pad must be [n+1]; got {tuple(x_pad.shape)}")


def spmv_cuda(col_idx, vals, x_pad):
    """y f[R] = the padded-ELL product of (col_idx, vals) with x_pad f[n+1]
    (slot n scratch, 0); see the module docstring. Column contents (in
    [0, n]) are ``ell_from_csr``'s guarantee; ``spmv`` checks the matrix's."""
    _check(col_idx, vals, x_pad)
    device = x_pad.device
    if device.type == "cpu":
        return spmv_ell_ref(col_idx, vals, x_pad)
    if device.type != "cuda":
        raise ValueError(f"spmv_cuda runs on CUDA or CPU tensors, not {device}")
    R, W = col_idx.shape
    y = torch.empty(R, dtype=vals.dtype, device=device)
    if R == 0:
        return y
    fn = _entry(vals.dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(col_idx.data_ptr(), vals.data_ptr(), R, W, x_pad.data_ptr(),
                 y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"spmv_ell launch failed: CUDA error {err}")
    launches["spmv"] += 1
    return y


def _piece_indices(row_map: np.ndarray):
    """``(first, rest)`` for the sum of split rows: ``first`` int64[n_rows]
    is the first ELL row of each row (``row_map`` is sorted and every row
    has one), and ``rest`` lists, for piece p = 1, 2, ..., the ELL rows
    that are some row's piece p and the rows they belong to."""
    row_map = np.asarray(row_map, dtype=np.int64)
    run_start = np.ones(len(row_map), dtype=bool)
    run_start[1:] = row_map[1:] != row_map[:-1]
    first = np.flatnonzero(run_start)
    piece = np.arange(len(row_map)) - np.repeat(first, np.diff(np.append(first, len(row_map))))
    rest = []
    for p in range(1, int(piece.max()) + 1 if len(piece) else 0):
        sel = np.flatnonzero(piece == p)
        rest.append((sel, row_map[sel]))
    return first, rest


class EllOperator:
    """``m`` bound once as padded ELL on ``device`` (``None``: the card,
    raising without CUDA): ``op(x)`` is y = m @ x through the kernel.

    Binding converts to ELL on the host (``ell_from_csr``), puts
    ``col_idx`` and ``vals`` on the device and precomputes the
    gather and scatter indices of the sum of split rows as device tensors.
    A call pads x with the scratch slot, launches ``spmv_cuda`` and sums
    the pieces deterministically: piece p of every row is added in turn,
    p = 0, 1, ..., one gather-add per piece with unique targets (no
    ``index_add_``, whose order on CUDA changes from run to run)."""

    def __init__(self, m: CSRMatrix, *, dtype=torch.float32, device=None):
        device = resolve_device(device)
        if m.nnz and (int(m.indices.min()) < 0 or int(m.indices.max()) >= m.n_cols):
            raise ValueError(f"matrix column indices must lie in [0, {m.n_cols})")
        col_idx, vals, row_map = ell_from_csr(m, dtype=numpy_dtype(dtype))
        first, rest = _piece_indices(row_map)

        def put(a):
            return torch.as_tensor(a).to(device)

        self.n_rows, self.n_cols = m.n_rows, m.n_cols
        self.dtype, self.device = dtype, device
        self.col_idx, self.vals = put(col_idx), put(vals)
        self._first = put(first)
        self._rest = [(put(src), put(dst)) for src, dst in rest]

    def __call__(self, x) -> torch.Tensor:
        """y f[n_rows] = m @ x for ``x`` f[n_cols] (numpy or torch; a tensor
        of the bound dtype on the bound device is used as it is)."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        if x.shape != (self.n_cols,):
            raise ValueError(f"x must be [{self.n_cols}]; got {tuple(x.shape)}")
        y_ell = spmv_cuda(self.col_idx, self.vals, torch.cat([x, x.new_zeros(1)]))
        y = y_ell.new_zeros(self.n_rows) + y_ell[self._first]
        for src, dst in self._rest:
            y[dst] = y[dst] + y_ell[src]
        return y


def spmv(m: CSRMatrix, x, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """y = m @ x through the kernel on ``device`` (``None``: the card,
    raising without CUDA): ``EllOperator(m)(x)``. ``x`` f[n_cols], numpy
    or torch; returns y f[n_rows] on ``device``. The CUDA kernel does not
    tile, so the TPU's row-tile padding is gone."""
    return EllOperator(m, dtype=dtype, device=device)(x)
