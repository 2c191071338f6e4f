"""SpMV on the card, y = A x in one launch: wrapper over ``csrc/spmv.cu``.

The off-diagonal-block operator of the paper's block decomposition (§1.1.4:
the triangular matrix splits into diagonal SpTRSV blocks and off-diagonal
SpMV blocks; the SpMV part is embarrassingly parallel and feeds the next
diagonal block's right-hand side), and CG's matvec. The counterpart of the
JAX package's ``kernels/spmv.py::spmv``: the padded-ELL TPU kernel
``_spmv_kernel`` followed by the segment sum of split rows.

  * ``ell_from_csr`` — a NumPy copy of the JAX package's padded ELL
    (array-equal to it): rows padded to W slots, rows wider than W split
    into several ELL rows, ``row_map`` giving each ELL row's target row.
    It is the definition the sliced layout keeps: W comes from its rule
    (``ell_width``), and its pieces of W entries are the chains below;
  * ``sliced_from_csr`` — the layout the kernel reads (``SlicedEll``):
    rows in slices of 32 consecutive rows, one slice per warp, each slice's
    entries slot-major up to its longest row, so that a warp's 32 lanes
    read 32 neighbouring slots; each row's length beside it, so that
    padding is stored but never read;
  * ``spmv_sliced_cuda`` — the kernel wrapper (replaces ``spmv_pallas``,
    the TPU kernel ``_spmv_kernel``, and the segment sum after it): tensors
    on the CPU take the plain version (``kernels.ref.spmv_sliced_ref``),
    and only because they lie on the CPU; tensors on a CUDA device launch
    the kernel or raise;
  * ``EllOperator(m)`` — the matrix bound once on a device: the layout
    built on the host and put on the device once; ``op(x)`` is one launch,
    with no host work, no host-to-device copy and no other device
    operation (CG's matvec, ``solver.cg``);
  * ``spmv(m, x)`` — the entry point: bind, then call.

The arithmetic. Row i is one left-to-right fused multiply-add chain over
its real entries from +0, restarted every W entries, each finished chain
added to the row's sum, which starts at +0: y[i] = ((+0 + c0) + c1) + ...
That is bit for bit the padded-ELL product (``spmv_ell_ref``: piece p's
chain ``c_p`` over its W slots, padding included) followed by the piece
sums in piece order (``spmv_ell_rows_ref``). A padding slot adds
fma(+0, +0, acc), which is acc unless acc is -0, and the sum's +0 start
turns a chain's -0 into +0 just as that slot would. SpMV is outside the
solver's bitwise contract (the reference tree-sums over W): the JAX
package is held to it within a tolerance.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.backends.base import numpy_dtype
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.ref import SLICE_ROWS, spmv_sliced_ref
from repro_torch.sparse.csr import CSRMatrix

launches = {"spmv": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches["spmv"] = 0


def ell_width(m: CSRMatrix, width: int | None = None) -> int:
    """W: ``width``, else the 95th percentile of the row lengths (at
    least 1)."""
    return width or max(int(np.percentile(m.row_nnz(), 95)), 1)


def ell_from_csr(m: CSRMatrix, *, width: int | None = None, dtype=np.float32):
    """(col_idx int32[R, W], vals f[R, W], row_map int32[R]) with
    self-padding to slot ``m.n_cols``. ``width`` defaults to
    ``ell_width``; row i takes ``max(1, ceil(nnz_i / W))`` consecutive ELL
    rows, its entries in order. Array-equal to the JAX package's
    ``ell_from_csr``."""
    W = ell_width(m, width)
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


class SlicedEll(NamedTuple):
    """A matrix as the SpMV kernel reads it (numpy arrays from
    ``sliced_from_csr``, tensors once bound). Slot k of row i lies at
    ``slice_ptr[i // 32] + 32 k + i % 32`` for k < ``row_len[i]``; the
    slots past a row's length, up to its slice's longest row, are stored
    (column 0, value 0) and never read."""

    col: object  # int32[S]
    val: object  # f[S]
    slice_ptr: object  # int64[ceil(n_rows / 32) + 1]
    row_len: object  # int32[n_rows]
    width: int  # W: a row's chain restarts every W entries
    n_cols: int

    def lane_idle_share(self) -> float:
        """Stored slots that are not entries, over all stored slots: the
        share of a warp's lanes idle at a slot (they load nothing)."""
        total = int(self.slice_ptr[-1])
        return 1.0 - int(self.row_len.sum()) / total if total else 0.0


def sliced_from_csr(m: CSRMatrix, *, width: int | None = None, dtype=np.float32) -> SlicedEll:
    """``m`` in the kernel's layout (``SlicedEll``), numpy arrays: rows in
    slices of 32 in their own order, entries in CSR order within a row,
    W from ``ell_width``."""
    n = m.n_rows
    row_len = m.row_nnz().astype(np.int32)
    n_slices = -(-n // SLICE_ROWS)
    lens = np.zeros(n_slices * SLICE_ROWS, dtype=np.int64)
    lens[:n] = row_len
    slice_ptr = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(SLICE_ROWS * lens.reshape(n_slices, SLICE_ROWS).max(axis=1, initial=0),
              out=slice_ptr[1:])
    rows = m.row_of_entry()
    pos = np.arange(m.nnz, dtype=np.int64) - np.repeat(m.indptr[:-1], row_len)
    dest = slice_ptr[rows // SLICE_ROWS] + SLICE_ROWS * pos + rows % SLICE_ROWS
    col = np.zeros(int(slice_ptr[-1]), dtype=np.int32)
    col[dest] = m.indices
    val = np.zeros(int(slice_ptr[-1]), dtype=dtype)
    val[dest] = m.data
    return SlicedEll(col, val, slice_ptr, row_len, ell_width(m, width), m.n_cols)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed once per process."""
    fn = getattr(build.load("spmv"), f"spmv_sliced_{_SUFFIX[dtype]}")
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(col, val, slice_ptr, row_len, width, x):
    if not isinstance(x, torch.Tensor) or x.device.type not in ("cuda", "cpu"):
        raise TypeError(f"x must be a torch.Tensor on a CUDA or CPU device; got {x!r:.80}")
    tensors = dict(col=col, val=val, slice_ptr=slice_ptr, row_len=row_len, x=x)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, want in (("col", torch.int32), ("slice_ptr", torch.int64),
                       ("row_len", torch.int32)):
        if tensors[name].dtype != want:
            raise TypeError(f"{name} must be {want}, got {tensors[name].dtype}")
    if val.dtype not in _SUFFIX or x.dtype != val.dtype:
        raise TypeError(f"val and x must share float32 or float64; got {val.dtype}, {x.dtype}")
    if val.shape != col.shape:
        raise ValueError(f"col and val differ in shape: {tuple(col.shape)}, {tuple(val.shape)}")
    n_slices = -(-row_len.shape[0] // SLICE_ROWS)
    if slice_ptr.shape[0] != n_slices + 1:
        raise ValueError(f"slice_ptr must have {n_slices + 1} entries for "
                         f"{row_len.shape[0]} rows; got {slice_ptr.shape[0]}")
    if not isinstance(width, int) or width < 1:
        raise ValueError(f"width must be a positive int; got {width!r}")


def spmv_sliced_cuda(col, val, slice_ptr, row_len, width, x):
    """y f[n_rows] = A x for A in the sliced layout (``SlicedEll``'s
    tensors, then its width) and x f[n_cols]; see the module docstring.
    The slot contents (columns in [0, n_cols), slots in the slices) are
    ``sliced_from_csr``'s guarantee; ``EllOperator`` checks the matrix's
    columns and x's length."""
    _check(col, val, slice_ptr, row_len, width, x)
    return _run(col, val, slice_ptr, row_len, width, x)


def _run(col, val, slice_ptr, row_len, width, x):
    """The plain version for CPU tensors, else one launch on x's device
    and current stream (the guard makes that device current for the call):
    the checks are the caller's."""
    device = x.device
    if device.type == "cpu":
        return spmv_sliced_ref(col, val, slice_ptr, row_len, width, x)
    n = row_len.shape[0]
    y = torch.empty(n, dtype=val.dtype, device=device)
    if n == 0:
        return y
    fn = _entry(val.dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(col.data_ptr(), val.data_ptr(), slice_ptr.data_ptr(), row_len.data_ptr(),
                 n, width, x.data_ptr(), y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"spmv_sliced launch failed: CUDA error {err}")
    launches["spmv"] += 1
    return y


class EllOperator:
    """``m`` bound once in the sliced layout on ``device`` (``None``: the
    card, raising without CUDA): ``op(x)`` is y = m @ x, one launch of the
    kernel (its plain version on the CPU).

    Binding builds the layout on the host (``sliced_from_csr``), puts its
    four arrays on the device (``layout``) and checks them as
    ``spmv_sliced_cuda`` does; a call checks x alone and launches the
    kernel on them: no pad of x, no split-row sums outside the kernel."""

    def __init__(self, m: CSRMatrix, *, dtype=torch.float32, device=None):
        device = resolve_device(device)
        if m.nnz and (int(m.indices.min()) < 0 or int(m.indices.max()) >= m.n_cols):
            raise ValueError(f"matrix column indices must lie in [0, {m.n_cols})")
        host = sliced_from_csr(m, dtype=numpy_dtype(dtype))
        self.layout = SlicedEll(*(torch.as_tensor(a).to(device) for a in host[:4]),
                                host.width, host.n_cols)
        self.n_rows, self.n_cols = m.n_rows, m.n_cols
        self.dtype, self.device = dtype, device
        self.lane_idle_share = host.lane_idle_share()
        _check(*self.layout[:5], torch.empty(m.n_cols, dtype=dtype, device=device))

    def __call__(self, x) -> torch.Tensor:
        """y f[n_rows] = m @ x for ``x`` f[n_cols] (numpy or torch; a
        contiguous tensor of the bound dtype on the bound device is used as
        it is)."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        if x.shape != (self.n_cols,):
            raise ValueError(f"x must be [{self.n_cols}]; got {tuple(x.shape)}")
        return _run(*self.layout[:5], x.contiguous())


def spmv(m: CSRMatrix, x, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """y = m @ x through the kernel on ``device`` (``None``: the card,
    raising without CUDA): ``EllOperator(m)(x)``. ``x`` f[n_cols], numpy
    or torch; returns y f[n_rows] on ``device``. The CUDA kernel does not
    tile, so the TPU's row-tile padding is gone."""
    return EllOperator(m, dtype=dtype, device=device)(x)
