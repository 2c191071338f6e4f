"""The SpTRSV kernels on the card: wrappers over ``csrc/sptrsv.cu`` (bulk)
and ``csrc/sptrsv_elastic.cu`` (readiness waves, ``mode="elastic"``).

``sptrsv_cuda`` replaces the JAX package's ``sptrsv_pallas`` (the TPU
kernels ``_sptrsv_kernel`` and ``_sptrsv_mrhs_kernel``);
``sptrsv_elastic_cuda`` replaces ``sptrsv_pallas_elastic`` (the TPU kernels
``_sptrsv_elastic_kernel`` and ``_sptrsv_elastic_mrhs_kernel``). Each takes
the plan tensors and the right-hand side padded with the scratch row, and
returns x shaped like ``b_pad`` (the last row is scratch):

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
from repro_torch.kernels.ref import sptrsv_elastic_ref, sptrsv_ref

launches = {"single": 0, "mrhs": 0, "elastic_single": 0, "elastic_mrhs": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "single": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "mrhs": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "elastic_single": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "elastic_mrhs": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
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


def _check(row_ids, col_idx, vals, diag, accum, b_pad, **vectors):
    """The plan tensors' device, layout, types and shapes; ``vectors`` are
    the 1-D int32 index tensors of the entry point (step bounds, or wave
    ids and wave counts)."""
    tensors = dict(
        row_ids=row_ids, col_idx=col_idx, vals=vals, diag=diag,
        accum=accum, b_pad=b_pad, **vectors,
    )
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != b_pad.device:
            raise ValueError(
                f"{name} is on {t.device}, b_pad on {b_pad.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("row_ids", "col_idx", *vectors):
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
    if row_ids.dim() != 2 or col_idx.dim() != 3:
        raise ValueError("expected row_ids [T, k] and col_idx [T, k, W]")
    for name, t in vectors.items():
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
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
    """Scheduled bulk SpTRSV; see the module docstring. Index contents
    (rows and columns in [0, n], monotone step bounds ending at T) are
    the plan compiler's guarantee and are checked at bind time by
    ``kernels.ops.kernel_plan_arrays``."""
    _check(row_ids, col_idx, vals, diag, accum, b_pad, step_bounds=step_bounds)
    if b_pad.device.type == "cpu":
        return sptrsv_ref(row_ids, col_idx, vals, diag, accum, b_pad)
    T, k = row_ids.shape
    W = col_idx.shape[2]
    x = torch.zeros_like(b_pad)
    if b_pad.numel() == 0:
        return x
    ptrs = [t.data_ptr() for t in (row_ids, col_idx, vals, diag, accum, step_bounds)]
    S = step_bounds.shape[0] - 1
    kind = "single" if b_pad.dim() == 1 else "mrhs"
    shape = (S, k, W) if kind == "single" else (S, k, W, b_pad.shape[1])
    _launch(kind, vals, b_pad, *ptrs, *shape, b_pad.data_ptr(), x.data_ptr())
    return x


def sptrsv_elastic_cuda(wave_id, n_waves, row_ids, col_idx, vals, diag, accum, b_pad):
    """Scheduled SpTRSV in readiness waves; see the module docstring. The
    plan tensors are window-padded to T = M * S steps (S = slack), wave_id
    int32[T] and n_waves int32[M] are the certificate's
    (``core.elastic.elastic_transform``). Bitwise-equal to ``sptrsv_cuda``
    on the same plan. Index contents and the certificate's shape are
    checked at bind time by ``kernels.ops.elastic_kernel_arrays``."""
    _check(row_ids, col_idx, vals, diag, accum, b_pad,
           wave_id=wave_id, n_waves=n_waves)
    T, k = row_ids.shape
    M = n_waves.shape[0]
    if wave_id.shape[0] != T or M < 1 or T % M:
        raise ValueError(
            f"wave_id must be [T={T}] and n_waves [M] with T a multiple of M; "
            f"got {tuple(wave_id.shape)} and {tuple(n_waves.shape)}"
        )
    if b_pad.device.type == "cpu":
        return sptrsv_elastic_ref(
            wave_id, n_waves, row_ids, col_idx, vals, diag, accum, b_pad
        )
    W = col_idx.shape[2]
    x = torch.zeros_like(b_pad)
    if b_pad.numel() == 0:
        return x
    # tot[t, l] holds step t's running total where step t accumulates; it
    # is read only behind that flag, so it needs no initialisation
    tot = torch.empty((T, k, *b_pad.shape[1:]), dtype=b_pad.dtype, device=b_pad.device)
    ptrs = [t.data_ptr() for t in (wave_id, n_waves, row_ids, col_idx, vals, diag, accum)]
    kind = "elastic_single" if b_pad.dim() == 1 else "elastic_mrhs"
    shape = (M, T // M, k, W) + (() if b_pad.dim() == 1 else (b_pad.shape[1],))
    _launch(kind, vals, b_pad, *ptrs, *shape, b_pad.data_ptr(), x.data_ptr(),
            tot.data_ptr())
    return x
