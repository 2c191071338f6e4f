"""The SpTRSV kernels on the card: wrappers over ``csrc/sptrsv.cu`` (bulk)
and ``csrc/sptrsv_elastic.cu`` (``mode="elastic"``). The single-RHS bulk
kernel and both elastic kernels are the level walk of ``csrc/level.cuh``
over the plan in level order (``kernels.levels``).

``sptrsv_level_cuda`` (one right-hand side, the bulk level order) and
``sptrsv_cuda`` (m right-hand sides) replace the JAX package's
``sptrsv_pallas`` (the TPU kernels ``_sptrsv_kernel`` and
``_sptrsv_mrhs_kernel``); ``sptrsv_elastic_cuda`` (one or m right-hand
sides, the level order over runs of ``slack`` supersteps) replaces
``sptrsv_pallas_elastic`` (the TPU kernels ``_sptrsv_elastic_kernel`` and
``_sptrsv_elastic_mrhs_kernel``). Each takes the plan tensors and the
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
from repro_torch.kernels.ref import sptrsv_level_ref, sptrsv_ref

launches = {"single": 0, "mrhs": 0, "elastic_single": 0, "elastic_mrhs": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_ARGTYPES = {
    "single": [_P] * 7 + [_I, _I, _P, _P, _P],
    "mrhs": [_P] * 6 + [_I, _I, _I, _I, _P, _P, _P],
    "elastic_single": [_P] * 7 + [_I, _I, _P, _P, _P],
    "elastic_mrhs": [_P] * 7 + [_I, _I, _I, _I64, _I64, _P, _P, _P],
}


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


def _check_tensors(tensors, int_names, vals, accum, b_pad):
    """Device, layout and types of an entry point's tensors: ``tensors``
    by name, ``int_names`` those that are int32 indices."""
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != b_pad.device:
            raise ValueError(
                f"{name} is on {t.device}, b_pad on {b_pad.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in int_names:
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if accum.dtype != torch.bool:
        raise TypeError(f"accum must be bool, got {accum.dtype}")
    if vals.dtype not in _SUFFIX:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    for name in ("diag", "b_pad"):
        if tensors[name].dtype != vals.dtype:
            raise TypeError(
                f"{name} is {tensors[name].dtype}, vals is {vals.dtype}"
            )


def _check_vectors(vectors):
    for name, t in vectors.items():
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")


def _check(row_ids, col_idx, vals, diag, accum, b_pad, **vectors):
    """The plan tensors' device, layout, types and shapes; ``vectors`` are
    the 1-D int32 index tensors of the entry point (the step bounds)."""
    tensors = dict(
        row_ids=row_ids, col_idx=col_idx, vals=vals, diag=diag,
        accum=accum, b_pad=b_pad, **vectors,
    )
    _check_tensors(tensors, ("row_ids", "col_idx", *vectors), vals, accum, b_pad)
    if row_ids.dim() != 2 or col_idx.dim() != 3:
        raise ValueError("expected row_ids [T, k] and col_idx [T, k, W]")
    _check_vectors(vectors)
    T, k = row_ids.shape
    if col_idx.shape[:2] != (T, k) or vals.shape != col_idx.shape:
        raise ValueError(
            f"col_idx {tuple(col_idx.shape)} and vals {tuple(vals.shape)} "
            f"must be [T={T}, k={k}, W]"
        )
    if diag.shape != (T, k) or accum.shape != (T, k):
        raise ValueError(f"diag and accum must be [T={T}, k={k}]")
    if b_pad.dim() not in (1, 2) or b_pad.shape[0] < 1:
        raise ValueError(f"b_pad must be [n+1] or [n+1, m]; got {tuple(b_pad.shape)}")


def _launch(kind, vals, b_pad, *args):
    """Launch ``kind`` on ``b_pad``'s device and current stream; the guard
    makes that device current for the call and restores the caller's."""
    device = b_pad.device
    if device.type != "cuda":
        raise ValueError(f"the SpTRSV kernels run on CUDA or CPU tensors, not {device}")
    entry = _entry(kind, vals.dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"sptrsv_{kind} launch failed: CUDA error {err}")
    launches[kind] += 1


def sptrsv_cuda(row_ids, col_idx, vals, diag, accum, step_bounds, b_pad):
    """Scheduled bulk SpTRSV; see the module docstring. On the card it
    runs m right-hand sides (``b_pad`` f[n+1, m]) and raises for one:
    that is ``sptrsv_level_cuda``'s. Index contents (rows and columns in
    [0, n], monotone step bounds ending at T) are the plan compiler's
    guarantee and are checked at bind time by
    ``kernels.ops.kernel_plan_arrays``."""
    _check(row_ids, col_idx, vals, diag, accum, b_pad, step_bounds=step_bounds)
    if b_pad.device.type == "cpu":
        return sptrsv_ref(row_ids, col_idx, vals, diag, accum, b_pad)
    if b_pad.dim() == 1:
        raise ValueError(
            "sptrsv_cuda runs m right-hand sides on the card; one right-hand "
            "side is sptrsv_level_cuda's (kernels.ops.level_plan_arrays)"
        )
    k, W = col_idx.shape[1:]
    x = torch.zeros_like(b_pad)
    if b_pad.numel() == 0:
        return x
    ptrs = [t.data_ptr() for t in (row_ids, col_idx, vals, diag, accum, step_bounds)]
    S = step_bounds.shape[0] - 1
    _launch("mrhs", vals, b_pad, *ptrs, S, k, W, b_pad.shape[1], b_pad.data_ptr(),
            x.data_ptr())
    return x


def _check_level(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad):
    """The level tensors' device, layout, types and shapes (b_pad f[n+1]
    or f[n+1, m]); index contents are checked at bind time by
    ``kernels.ops.level_plan_arrays``."""
    tensors = dict(
        row_ids=row_ids, col_idx=col_idx, vals=vals, diag=diag, accum=accum,
        vert_ptr=vert_ptr, level_ptr=level_ptr, b_pad=b_pad,
    )
    _check_tensors(tensors, ("row_ids", "col_idx", "vert_ptr", "level_ptr"),
                   vals, accum, b_pad)
    _check_vectors(dict(row_ids=row_ids, diag=diag, accum=accum, vert_ptr=vert_ptr,
                        level_ptr=level_ptr))
    P = row_ids.shape[0]
    if col_idx.dim() != 2 or col_idx.shape[0] != P or vals.shape != col_idx.shape:
        raise ValueError(
            f"col_idx {tuple(col_idx.shape)} and vals {tuple(vals.shape)} must be [P={P}, W]"
        )
    if diag.shape != (P,) or accum.shape != (P,):
        raise ValueError(f"diag and accum must be [P={P}]")
    if vert_ptr.shape[0] < 1 or level_ptr.shape[0] < 1:
        raise ValueError("vert_ptr and level_ptr must not be empty")
    if b_pad.dim() not in (1, 2) or b_pad.shape[0] < 1:
        raise ValueError(f"b_pad must be [n+1] or [n+1, m]; got {tuple(b_pad.shape)}")


def sptrsv_level_cuda(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad):
    """Scheduled SpTRSV of one right-hand side over the plan's real
    lane-steps in level order (``kernels.levels``): row_ids int32[P],
    col_idx int32[P, W], vals f[P, W], diag f[P], accum bool[P], vert_ptr
    int32[V+1], level_ptr int32[L+1], b_pad f[n+1]. Bitwise-equal to
    ``sptrsv_cuda`` on the plan."""
    _check_level(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad)
    if b_pad.dim() != 1:
        raise ValueError(f"b_pad must be 1-D, got {tuple(b_pad.shape)}")
    if b_pad.device.type == "cpu":
        return sptrsv_level_ref(row_ids, col_idx, vals, diag, accum, vert_ptr,
                                level_ptr, b_pad)
    x = torch.zeros_like(b_pad)
    ptrs = [t.data_ptr() for t in (row_ids, col_idx, vals, diag, accum, vert_ptr,
                                   level_ptr)]
    _launch("single", vals, b_pad, *ptrs, level_ptr.shape[0] - 1, col_idx.shape[1],
            b_pad.data_ptr(), x.data_ptr())
    return x


def sptrsv_elastic_cuda(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad):
    """Scheduled SpTRSV in ``mode="elastic"``: the level tensors of
    ``sptrsv_level_cuda`` in the level order over runs of the certificate's
    ``slack`` supersteps (``kernels.ops.elastic_kernel_arrays``), b_pad
    f[n+1] (one block) or f[n+1, m] (a block per column, on a column-major
    copy of b_pad; x is returned as the transposed view of its
    column-major result). Bitwise-equal to ``sptrsv_cuda`` on the plan."""
    _check_level(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad)
    if b_pad.device.type == "cpu":
        return sptrsv_level_ref(row_ids, col_idx, vals, diag, accum, vert_ptr,
                                level_ptr, b_pad)
    if b_pad.numel() == 0:
        return torch.zeros_like(b_pad)
    ptrs = [t.data_ptr() for t in (row_ids, col_idx, vals, diag, accum, vert_ptr,
                                   level_ptr)]
    shape = (level_ptr.shape[0] - 1, col_idx.shape[1])
    if b_pad.dim() == 1:
        x = torch.zeros_like(b_pad)
        _launch("elastic_single", vals, b_pad, *ptrs, *shape, b_pad.data_ptr(),
                x.data_ptr())
        return x
    # a column's rows 1 apart, columns n+1 apart: each block reads and
    # writes one contiguous column (faster than row-major x, copies
    # included: kernels/level_sweep.py)
    b_col = b_pad.T.contiguous()
    x = torch.zeros_like(b_col)
    _launch("elastic_mrhs", vals, b_pad, *ptrs, *shape, b_col.shape[0], 1, b_col.shape[1],
            b_col.data_ptr(), x.data_ptr())
    return x.T
