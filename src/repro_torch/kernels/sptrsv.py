"""The bulk SpTRSV kernels on the card: wrapper over ``csrc/sptrsv.cu``.

``sptrsv_cuda`` replaces the JAX package's ``sptrsv_pallas`` (the TPU
kernels ``_sptrsv_kernel`` and ``_sptrsv_mrhs_kernel``). It takes the plan
tensors, the step bounds and the right-hand side padded with the scratch
row, and returns x shaped like ``b_pad`` (the last row is scratch):

  * tensors on the CPU take the plain version (``kernels.ref.sptrsv_ref``),
    and only because they lie on the CPU;
  * tensors on a CUDA device launch the kernel or raise — a missing
    ``nvcc``, a failed build and a refused launch all raise.

``launches`` counts the kernel launches per entry point, so a run can show
that its solves went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import sptrsv_ref

launches = {"single": 0, "mrhs": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "single": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "mrhs": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _entry(kind: str, dtype: torch.dtype):
    fn = getattr(build.load("sptrsv"), f"sptrsv_{kind}_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES[kind]
    fn.restype = ctypes.c_int
    return fn


def _check(row_ids, col_idx, vals, diag, accum, step_bounds, b_pad):
    tensors = dict(
        row_ids=row_ids, col_idx=col_idx, vals=vals, diag=diag,
        accum=accum, step_bounds=step_bounds, b_pad=b_pad,
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
    for name in ("row_ids", "col_idx", "step_bounds"):
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
    if row_ids.dim() != 2 or col_idx.dim() != 3 or step_bounds.dim() != 1:
        raise ValueError(
            "expected row_ids [T, k], col_idx [T, k, W], step_bounds [S+1]"
        )
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


def sptrsv_cuda(row_ids, col_idx, vals, diag, accum, step_bounds, b_pad):
    """Scheduled bulk SpTRSV; see the module docstring. Index contents
    (rows and columns in [0, n], monotone step bounds ending at T) are
    the plan compiler's guarantee and are checked at bind time by
    ``kernels.ops.kernel_plan_arrays``."""
    _check(row_ids, col_idx, vals, diag, accum, step_bounds, b_pad)
    device = b_pad.device
    if device.type == "cpu":
        return sptrsv_ref(row_ids, col_idx, vals, diag, accum, b_pad)
    if device.type != "cuda":
        raise ValueError(f"sptrsv_cuda runs on CUDA or CPU tensors, not {device}")
    T, k = row_ids.shape
    W = col_idx.shape[2]
    x = torch.zeros_like(b_pad)
    if b_pad.numel() == 0:
        return x
    ptrs = [t.data_ptr() for t in (row_ids, col_idx, vals, diag, accum, step_bounds)]
    S = step_bounds.shape[0] - 1
    kind = "single" if b_pad.dim() == 1 else "mrhs"
    shape = (S, k, W) if kind == "single" else (S, k, W, b_pad.shape[1])
    entry = _entry(kind, vals.dtype)
    # a launch must target the current device's stream; the guard makes
    # b_pad's device current for the call and restores the caller's after
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*ptrs, *shape, b_pad.data_ptr(), x.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sptrsv_{kind} launch failed: CUDA error {err}")
    launches[kind] += 1
    return x
