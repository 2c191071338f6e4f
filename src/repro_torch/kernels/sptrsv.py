"""The SpTRSV kernels on the card: wrappers over ``csrc/sptrsv.cu`` (bulk)
and ``csrc/sptrsv_elastic.cu`` (``mode="elastic"``). Every kernel is a
level walk of ``csrc/level.cuh`` over the plan in level order
(``kernels.levels``).

``sptrsv_level_cuda`` (one or m right-hand sides, the bulk level order)
replaces the JAX package's ``sptrsv_pallas`` (the TPU kernels
``_sptrsv_kernel`` and ``_sptrsv_mrhs_kernel``); ``sptrsv_elastic_cuda``
(one or m right-hand sides, the level order over runs of ``slack``
supersteps) replaces ``sptrsv_pallas_elastic`` (the TPU kernels
``_sptrsv_elastic_kernel`` and ``_sptrsv_elastic_mrhs_kernel``). Each
launches one block for b f[n+1] and, for b f[n+1, m], a block per column
of a column-major copy of b. Each takes the level tensors and the
right-hand side padded with the scratch row, and returns x shaped like
``b_pad`` (the last row is scratch):

  * tensors on the CPU take the plain version (``kernels.ref``), and only
    because they lie on the CPU;
  * tensors on a CUDA device launch the kernel or raise — a missing
    ``nvcc``, a failed build and a refused launch all raise.

``launches`` counts the kernel launches per entry point, so a run can show
that its solves went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import sptrsv_level_ref

launches = {"single": 0, "mrhs": 0, "elastic_single": 0, "elastic_mrhs": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SINGLE = [_P] * 7 + [_I, _I, _P, _P, _P]
_COLS = [_P] * 7 + [_I, _I, _I, _I64, _P, _P, _P]
_ARGTYPES = {"single": _SINGLE, "mrhs": _COLS, "elastic_single": _SINGLE, "elastic_mrhs": _COLS}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """The C entry point of ``kind`` for ``dtype``, typed once per process."""
    lib = build.load("sptrsv_elastic" if kind.startswith("elastic") else "sptrsv")
    fn = getattr(lib, f"sptrsv_{kind}_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES[kind]
    fn.restype = ctypes.c_int
    return fn


def _launch(kind, vals, b, *args):
    """Launch ``kind`` on ``b``'s device and current stream; the guard
    makes that device current for the call and restores the caller's."""
    device = b.device
    if device.type != "cuda":
        raise ValueError(f"the SpTRSV kernels run on CUDA or CPU tensors, not {device}")
    entry = _entry(kind, vals.dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"sptrsv_{kind} launch failed: CUDA error {err}")
    launches[kind] += 1


def _check_level(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b):
    """The level tensors' device, layout, types and shapes, and those of
    the right-hand side ``b`` (f[n+1] or f[n+1, m]); index contents are
    checked at bind time by ``kernels.ops.level_plan_arrays``."""
    tensors = dict(
        row_ids=row_ids, col_idx=col_idx, vals=vals, diag=diag, accum=accum,
        vert_ptr=vert_ptr, level_ptr=level_ptr, b=b,
    )
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("row_ids", "col_idx", "vert_ptr", "level_ptr"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if accum.dtype != torch.bool:
        raise TypeError(f"accum must be bool, got {accum.dtype}")
    if vals.dtype not in _SUFFIX:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    for name in ("diag", "b"):
        if tensors[name].dtype != vals.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, vals is {vals.dtype}")
    for name in ("row_ids", "diag", "accum", "vert_ptr", "level_ptr"):
        if tensors[name].dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(tensors[name].shape)}")
    P = row_ids.shape[0]
    if col_idx.dim() != 2 or col_idx.shape[0] != P or vals.shape != col_idx.shape:
        raise ValueError(
            f"col_idx {tuple(col_idx.shape)} and vals {tuple(vals.shape)} must be [P={P}, W]"
        )
    if diag.shape != (P,) or accum.shape != (P,):
        raise ValueError(f"diag and accum must be [P={P}]")
    if vert_ptr.shape[0] < 1 or level_ptr.shape[0] < 1:
        raise ValueError("vert_ptr and level_ptr must not be empty")
    if b.dim() not in (1, 2) or b.shape[0] < 1:
        raise ValueError(f"b must be [n+1] or [n+1, m]; got {tuple(b.shape)}")


def _level_args(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr):
    """The level tensors' pointers, the level count and W: the leading
    arguments of every level entry point."""
    ptrs = [t.data_ptr() for t in (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)]
    return (*ptrs, level_ptr.shape[0] - 1, col_idx.shape[1])


def _launch_level(single, mrhs, level, b_pad):
    """Entry ``single`` on b_pad f[n+1] (checked, on the card), or entry
    ``mrhs`` on b_pad f[n+1, m]: a block per column of the column-major
    copy (a column's rows 1 apart, columns n+1 apart, so each block reads
    and writes one contiguous column), x returned as a view of the
    column-major result."""
    vals = level[2]
    if b_pad.numel() == 0:
        return torch.zeros_like(b_pad)
    if b_pad.dim() == 1:
        x = torch.zeros_like(b_pad)
        _launch(single, vals, b_pad, *_level_args(*level), b_pad.data_ptr(), x.data_ptr())
        return x
    m = b_pad.shape[1]
    b_col = b_pad.T.contiguous()
    x = torch.zeros_like(b_col)
    _launch(mrhs, vals, b_col, *_level_args(*level), m, b_col.shape[1], b_col.data_ptr(),
            x.data_ptr())
    return x.T


def sptrsv_level_cuda(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad):
    """Scheduled SpTRSV over the plan's real lane-steps in the bulk level
    order (``kernels.levels``): row_ids int32[P], col_idx int32[P, W],
    vals f[P, W], diag f[P], accum bool[P], vert_ptr int32[V+1],
    level_ptr int32[L+1], b_pad f[n+1] (one block) or f[n+1, m] (a block
    per column of a column-major copy; x is returned as a view of the
    column-major result). Bitwise-equal to ``kernels.ref.sptrsv_ref`` on
    the plan."""
    level = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)
    _check_level(*level, b_pad)
    if b_pad.device.type == "cpu":
        return sptrsv_level_ref(*level, b_pad)
    return _launch_level("single", "mrhs", level, b_pad)


def sptrsv_elastic_cuda(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad):
    """Scheduled SpTRSV in ``mode="elastic"``: the level tensors of
    ``sptrsv_level_cuda`` in the level order over runs of the certificate's
    ``slack`` supersteps (``kernels.ops.elastic_kernel_arrays``), b_pad
    f[n+1] or f[n+1, m], launched as ``sptrsv_level_cuda`` launches.
    Bitwise-equal to ``kernels.ref.sptrsv_ref`` on the plan."""
    level = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)
    _check_level(*level, b_pad)
    if b_pad.device.type == "cpu":
        return sptrsv_level_ref(*level, b_pad)
    return _launch_level("elastic_single", "elastic_mrhs", level, b_pad)
