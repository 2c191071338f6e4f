"""The SpTRSV kernels on the card: wrappers over ``csrc/sptrsv.cu``, one
library for both level orders. Every kernel is a level walk of
``csrc/level.cuh`` over the plan in level order (``kernels.levels``); the
bulk and the elastic order differ only in the level tensors it is handed.

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

``sptrsv_level_bank_cuda`` launches the same column grid over a bank of
plans of one width class, each column on its own plan (the serve layer's
grouped and resident-slot solves; the JAX package vmaps its scan over the
lanes instead).

``sptrsv_level_range_cuda`` launches the bulk entries over a range of
levels, ``[lo, hi)``, of a bound level order into the caller's x, which
keeps what earlier ranges wrote: the distributed backend's rounds, one
launch per position and round, with an exchange between rounds. It needs
no kernel of its own: the level walk reads absolute chunk bounds from
``level_chunk[0]`` on and keeps no state across launches, so the range is
the walk started at ``level_chunk + lo`` with ``hi - lo`` levels.

``sptrsv_ordered_cuda`` is the front door's solve
(``pipeline.TriangularSolver.solve`` on the card): one cooperative launch
(``csrc/level.cuh``, ``sptrsv_level_ordered_kernel``) takes b and returns
x in the caller's row order, with no gather, padding or fill around it.
``bind_ordered_walk`` checks the level tensors, the chunk table and the
row permutation once, at bind, and fixes the launch's arguments; a solve
checks only b and allocates x and the scratch (``torch.empty``, no fill).
It takes CUDA tensors only: on the CPU the front door keeps the gathers
and the plain version (``kernels.ref.sptrsv_ordered_ref`` states it).

Every entry also takes the level order's chunk table and stage layout
(``kernels.levels.LevelChunks``, the kernel's stages in shared memory):
``chunks=`` the one bound with the level tensors (``LevelArrays.chunks``,
``LevelBank.chunks``), else the wrapper builds it from ``vert_ptr`` and
``level_ptr`` on the host, a copy from the device and one pass, per call.

``launches`` counts the kernel launches per entry point, under a lock (the
serve layer launches from several threads), so a run can show that its
solves went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import operator
import threading
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.levels import LevelChunks, level_chunks
from repro_torch.kernels.ref import (
    sptrsv_level_bank_ref,
    sptrsv_level_range_ref,
    sptrsv_level_ref,
)

launches = {"single": 0, "mrhs": 0, "elastic_single": 0, "elastic_mrhs": 0, "bank": 0,
            "range_single": 0, "range_mrhs": 0, "ordered_single": 0, "ordered_mrhs": 0,
            "elastic_ordered_single": 0, "elastic_ordered_mrhs": 0}
# the serve layer launches from worker threads and its slot dispatcher at
# once; a count is a read-modify-write, so it takes the lock
_COUNT_LOCK = threading.Lock()

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SINGLE = [_P] * 8 + [_I] * 4 + [_P] * 3
_COLS = [_P] * 8 + [_I] * 5 + [_I64] + [_P] * 3
_BANK = [_P] * 11 + [_I] * 4 + [_I64] + [_P] * 3
# the ordered solve: the level tensors but level_ptr and the chunk table;
# level count, W, stage layout, m, grid; n; perm, b, out, scratch, stream
_ORDERED = [_P] * 8 + [_I] * 6 + [_I64] + [_P] * 5
_ARGTYPES = {"single": _SINGLE, "mrhs": _COLS, "bank": _BANK, "ordered": _ORDERED}
# an elastic or a range launch runs the entry point of its layout, and an
# ordered solve of one or m columns, of the bulk or the elastic order, the
# one ordered entry; each is counted under its own kind
_ENTRY_OF = {"elastic_single": "single", "elastic_mrhs": "mrhs", "range_single": "single",
             "range_mrhs": "mrhs", "ordered_single": "ordered", "ordered_mrhs": "ordered",
             "elastic_ordered_single": "ordered", "elastic_ordered_mrhs": "ordered"}
# the fewest blocks of an ordered launch where the card holds them: they
# share its moves of b and x (a block walks each column). On an H100 the
# solve of one column took 1.5% over the walk alone at 32 blocks and 0.8%
# at 128, of 32 columns 23.6% and 9.0% (the paper's ER set, PERF.md)
ORDERED_SPREAD = 128


def reset_launches() -> None:
    with _COUNT_LOCK:
        for key in launches:
            launches[key] = 0


def _count(kind: str) -> None:
    """One launch of ``kind``: the only place a launch is counted."""
    with _COUNT_LOCK:
        launches[kind] += 1


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """The C entry point of ``kind`` for ``dtype``, typed once per process."""
    kind = _ENTRY_OF.get(kind, kind)
    fn = getattr(build.load("sptrsv"), f"sptrsv_{kind}_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES[kind]
    fn.restype = ctypes.c_int
    return fn


def _launch(kind, dtype, device, stage_bytes, *args):
    """Launch ``kind`` for ``dtype`` on ``device`` (a CUDA device) and its
    current stream; the guard makes that device current for the call and
    restores the caller's."""
    entry = _entry(kind, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with obs.span("kernel.launch", cat="kernel", kind=kind, stage_bytes=stage_bytes):
            err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"sptrsv_{kind} launch failed: CUDA error {err}")
    _count(kind)


def _check_placed(tensors: dict, device, where: str) -> None:
    """Each of ``tensors`` (name -> value) a contiguous tensor on
    ``device`` (``where`` names what sets the device)."""
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {where} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_level(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b):
    """The level tensors' device, layout, types and shapes, and those of
    the right-hand side ``b`` (f[n+1] or f[n+1, m]); index contents are
    checked at bind time by ``kernels.ops.level_plan_arrays``."""
    if not isinstance(b, torch.Tensor):
        raise TypeError("b must be a torch.Tensor")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    _check_level_tensors(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b.device, "b")
    if b.dtype != vals.dtype:
        raise TypeError(f"b is {b.dtype}, vals is {vals.dtype}")
    if b.dim() not in (1, 2) or b.shape[0] < 1:
        raise ValueError(f"b must be [n+1] or [n+1, m]; got {tuple(b.shape)}")


def _check_level_tensors(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, device,
                         where="vals"):
    """The level tensors' device (``device``, set by ``where``), layout,
    types and shapes."""
    tensors = dict(
        row_ids=row_ids, col_idx=col_idx, vals=vals, diag=diag, accum=accum,
        vert_ptr=vert_ptr, level_ptr=level_ptr,
    )
    _check_placed(tensors, device, where)
    for name in ("row_ids", "col_idx", "vert_ptr", "level_ptr"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if accum.dtype != torch.bool:
        raise TypeError(f"accum must be bool, got {accum.dtype}")
    if vals.dtype not in _SUFFIX:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    if diag.dtype != vals.dtype:
        raise TypeError(f"diag is {diag.dtype}, vals is {vals.dtype}")
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


def device_chunks(host: LevelChunks, device) -> LevelChunks:
    """``host`` (``kernels.levels.level_chunks``) with its chunk table on
    ``device``."""
    return host._replace(chunk_ptr=torch.as_tensor(host.chunk_ptr).to(device),
                         level_chunk=torch.as_tensor(host.level_chunk).to(device))


def _stage_chunks(level, chunks, device):
    """The chunk table the walk takes: ``chunks`` checked against the
    level tensors ``level`` and ``device``, or, where it is None, built
    from the level tensors on the host (``kernels.levels.level_chunks``)."""
    if device.type != "cuda":
        raise ValueError(f"the SpTRSV kernels run on CUDA or CPU tensors, not {device}")
    vals, vert_ptr, level_ptr = level[2], level[5], level[6]
    if chunks is None:
        chunks = device_chunks(level_chunks(vert_ptr.cpu().numpy(), level_ptr.cpu().numpy(),
                                            vals.shape[1], vals.element_size()), device)
    return _check_chunks(chunks, level_ptr, device)


def _check_chunks(chunks, level_ptr, device):
    """``chunks`` (a ``LevelChunks``) on ``device``, fitting ``level_ptr``."""
    if not isinstance(chunks, LevelChunks):
        raise TypeError("chunks must be a kernels.levels.LevelChunks")
    for name in ("chunk_ptr", "level_chunk"):
        t = getattr(chunks, name)
        if not isinstance(t, torch.Tensor) or t.device != device:
            raise ValueError(f"chunks.{name} must be a tensor on {device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"chunks.{name} must be contiguous int32")
    if chunks.chunk_ptr.dim() != 2 or chunks.chunk_ptr.shape[1] != 2:
        raise ValueError(f"chunks.chunk_ptr must be [C+1, 2]; got {tuple(chunks.chunk_ptr.shape)}")
    if chunks.level_chunk.shape != level_ptr.shape:
        raise ValueError(f"chunks.level_chunk must be [L+1={level_ptr.shape[0]}]; got "
                         f"{tuple(chunks.level_chunk.shape)}")
    return chunks


def _level_args(row_ids, col_idx, vals, diag, accum, vert_ptr, chunks, lo=0, hi=None):
    """The level tensors' and the chunk table's pointers, the level count
    (of levels ``[lo, hi)``, all by default), W and the stage layout: the
    leading arguments of every level entry point but the bank's."""
    ptrs = [t.data_ptr() for t in (row_ids, col_idx, vals, diag, accum, vert_ptr,
                                   chunks.chunk_ptr)]
    lc = chunks.level_chunk
    hi = lc.shape[0] - 1 if hi is None else hi
    return (*ptrs, lc.data_ptr() + lo * lc.element_size(), hi - lo, col_idx.shape[1],
            chunks.stage_bytes, chunks.n_stages)


def _launch_level(single, mrhs, level, b_pad, chunks):
    """Entry ``single`` on b_pad f[n+1] (checked, on the card), or entry
    ``mrhs`` on b_pad f[n+1, m]: a block per column of the column-major
    copy (a column's rows 1 apart, columns n+1 apart, so each block reads
    and writes one contiguous column), x returned as a view of the
    column-major result."""
    vals = level[2]
    if b_pad.numel() == 0:
        return torch.zeros_like(b_pad)
    chunks = _stage_chunks(level, chunks, b_pad.device)
    args = _level_args(*level[:6], chunks)
    if b_pad.dim() == 1:
        x = torch.zeros_like(b_pad)
        _launch(single, vals.dtype, b_pad.device, chunks.stage_bytes, *args, b_pad.data_ptr(),
                x.data_ptr())
        return x
    m = b_pad.shape[1]
    b_col = b_pad.T.contiguous()
    x = torch.zeros_like(b_col)
    _launch(mrhs, vals.dtype, b_col.device, chunks.stage_bytes, *args, m, b_col.shape[1],
            b_col.data_ptr(), x.data_ptr())
    return x.T


def sptrsv_level_cuda(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad, *,
                      chunks=None):
    """Scheduled SpTRSV over the plan's real lane-steps in the bulk level
    order (``kernels.levels``): row_ids int32[P], col_idx int32[P, W],
    vals f[P, W], diag f[P], accum bool[P], vert_ptr int32[V+1],
    level_ptr int32[L+1], b_pad f[n+1] (one block) or f[n+1, m] (a block
    per column of a column-major copy; x is returned as a view of the
    column-major result). ``chunks``: the order's ``LevelChunks`` on the
    device (see the module docstring). Bitwise-equal to
    ``kernels.ref.sptrsv_ref`` on the plan."""
    level = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)
    _check_level(*level, b_pad)
    if b_pad.device.type == "cpu":
        return sptrsv_level_ref(*level, b_pad)
    return _launch_level("single", "mrhs", level, b_pad, chunks)


def sptrsv_elastic_cuda(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_pad, *,
                        chunks=None):
    """Scheduled SpTRSV in ``mode="elastic"``: the level tensors of
    ``sptrsv_level_cuda`` in the level order over runs of the certificate's
    ``slack`` supersteps (``kernels.ops.elastic_kernel_arrays``), b_pad
    f[n+1] or f[n+1, m], launched as ``sptrsv_level_cuda`` launches.
    Bitwise-equal to ``kernels.ref.sptrsv_ref`` on the plan."""
    level = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)
    _check_level(*level, b_pad)
    if b_pad.device.type == "cpu":
        return sptrsv_level_ref(*level, b_pad)
    return _launch_level("elastic_single", "elastic_mrhs", level, b_pad, chunks)


def _check_range(level, lo, hi, b, x):
    """``_check_level``'s checks of the level tensors and of ``b`` (f[rows]
    or column-major f[m, rows]), plus ``0 <= lo <= hi <= L`` and ``x``
    shaped, typed, laid out and placed as ``b``."""
    _check_level(*level, b)
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    if x.device != b.device or x.dtype != b.dtype or x.shape != b.shape:
        raise ValueError(
            f"x must match b: got {x.dtype}{tuple(x.shape)} on {x.device}, "
            f"b {b.dtype}{tuple(b.shape)} on {b.device}"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (f[rows] or column-major f[m, rows])")
    L = level[6].shape[0] - 1
    lo, hi = operator.index(lo), operator.index(hi)
    if not 0 <= lo <= hi <= L:
        raise ValueError(f"level range [{lo}, {hi}) is not inside [0, {L}]")
    return lo, hi


def sptrsv_level_range_cuda(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, lo, hi,
                            b, x, *, chunks=None):
    """Walk levels ``[lo, hi)`` of a bound level order (the tensors of
    ``sptrsv_level_cuda``) into ``x``, in place: b and x f[rows] (one
    block, the ``single`` entry) or column-major f[m, rows] (a block per
    column, the ``mrhs`` entry), rows = n + 1 with the scratch row last.
    ``x`` keeps what earlier ranges and the caller wrote; a walk of ranges
    that partition ``[0, L)``, in order, is bitwise one full
    ``sptrsv_level_cuda``. An empty range launches nothing. Returns
    ``x``. CPU tensors take ``kernels.ref.sptrsv_level_range_ref``."""
    level = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)
    lo, hi = _check_range(level, lo, hi, b, x)
    if b.device.type == "cpu":
        return sptrsv_level_range_ref(*level, lo, hi, b, x)
    if hi == lo or b.numel() == 0:
        return x
    chunks = _stage_chunks(level, chunks, b.device)
    # the walk reads absolute chunk bounds from its level_chunk on
    args = _level_args(*level[:6], chunks, lo, hi)
    if b.dim() == 1:
        _launch("range_single", vals.dtype, b.device, chunks.stage_bytes, *args, b.data_ptr(),
                x.data_ptr())
    else:
        _launch("range_mrhs", vals.dtype, b.device, chunks.stage_bytes, *args, b.shape[0],
                b.shape[1], b.data_ptr(), x.data_ptr())
    return x


def _check_bank(level_off, n_levels, lane_idx, b_col, level):
    """The bank's lane tables and the host-side ``lane_idx`` (every entry a
    lane of the bank: the kernel reads them unchecked), on top of
    ``_check_level``'s checks of the concatenated level tensors and of the
    column-major right-hand side b_col f[m, n+1]."""
    _check_level(*level, b_col)
    for name, t in (("level_off", level_off), ("n_levels", n_levels)):
        if not isinstance(t, torch.Tensor) or t.device != b_col.device:
            raise ValueError(f"{name} must be a tensor on {b_col.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32[lanes]")
    lanes = level_off.shape[0]
    if n_levels.shape[0] != lanes or lanes < 1:
        raise ValueError(f"level_off and n_levels must be [lanes >= 1]; got {lanes}, "
                         f"{n_levels.shape[0]}")
    if not isinstance(lane_idx, torch.Tensor) or lane_idx.device.type != "cpu":
        raise TypeError("lane_idx must be a tensor on the host (it is checked there)")
    if lane_idx.dim() != 1 or lane_idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lane_idx must be int[m]; got {lane_idx.dtype}{tuple(lane_idx.shape)}")
    if b_col.dim() != 2 or b_col.shape[0] != lane_idx.shape[0]:
        raise ValueError(f"b_col must be [m={lane_idx.shape[0]}, n+1]; got {tuple(b_col.shape)}")
    if lane_idx.numel() and (int(lane_idx.min()) < 0 or int(lane_idx.max()) >= lanes):
        raise ValueError(f"lane_idx holds lanes outside [0, {lanes})")


def sptrsv_level_bank_cuda(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr,
                           level_off, n_levels, lane_idx, b_col, *, chunks=None):
    """Scheduled SpTRSV over a bank of plans of one width class
    (``kernels.ops.LevelBank``): the lanes' level tensors concatenated,
    level_off and n_levels int32[lanes] (lane l walks ``level_ptr[
    level_off[l] .. level_off[l] + n_levels[l]]``), lane_idx int[m] on the
    host, b_col f[m, n+1] column-major (a column's rows contiguous, the
    scratch entry last). Column j is solved on lane ``lane_idx[j]``, one
    block per column, in one launch; returns x f[m, n+1] in b_col's
    layout. ``chunks``: the bank's ``LevelChunks`` (``LevelBank.chunks``),
    whose ``level_chunk`` the lane tables index as they index
    ``level_ptr``. Bitwise ``sptrsv_level_cuda`` on each column's plan
    alone."""
    level = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)
    _check_bank(level_off, n_levels, lane_idx, b_col, level)
    if b_col.device.type == "cpu":
        return sptrsv_level_bank_ref(*level, level_off, n_levels, lane_idx, b_col)
    chunks = _stage_chunks(level, chunks, b_col.device)
    x = torch.zeros_like(b_col)
    m = b_col.shape[0]
    lanes = lane_idx.to(device=b_col.device, dtype=torch.int32)
    ptrs = [t.data_ptr() for t in (*level[:6], chunks.chunk_ptr, chunks.level_chunk, level_off,
                                   n_levels, lanes)]
    _launch("bank", vals.dtype, b_col.device, chunks.stage_bytes, *ptrs, col_idx.shape[1],
            chunks.stage_bytes, chunks.n_stages, m, b_col.shape[1], b_col.data_ptr(),
            x.data_ptr())
    return x



class OrderedWalk(NamedTuple):
    """A level order bound for the ordered solve (``bind_ordered_walk``):
    what a solve launches, checked once."""

    # the level tensors, the row permutation and the chunk table: alive while
    # ``args`` points at them
    tensors: tuple
    args: tuple  # the entry's leading arguments, up to the stage layout
    perm: int  # the row permutation's pointer
    # the launch kinds, one right-hand side and m: ordered_* for the bulk
    # order, elastic_ordered_* for the elastic one (one entry point)
    single: str
    mrhs: str
    n: int
    dtype: torch.dtype
    device: torch.device
    stage_bytes: int
    n_stages: int


def bind_ordered_walk(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, perm, n, *,
                      chunks, elastic=False) -> OrderedWalk:
    """Check the level tensors of ``sptrsv_level_cuda`` (of the elastic
    order where ``elastic``), their chunk table ``chunks`` and ``perm``
    int32[n] (plan row r is the caller's row ``perm[r]``;
    ``kernels.ops.ordered_walk`` checks that it is a permutation) once, and
    fix the launch's arguments but those of a solve."""
    device = vals.device
    level = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)
    _check_level_tensors(*level, device)
    chunks = _check_chunks(chunks, level_ptr, device)
    _check_placed({"perm": perm}, device, "vals")
    n = operator.index(n)
    if perm.dtype != torch.int32 or perm.shape != (n,) or n < 1:
        raise ValueError(f"perm must be int32[n={n}], n >= 1; got {perm.dtype}{tuple(perm.shape)}")
    ptrs = [t.data_ptr() for t in (*level[:6], chunks.chunk_ptr, chunks.level_chunk)]
    args = (*ptrs, level_ptr.shape[0] - 1, col_idx.shape[1], chunks.stage_bytes, chunks.n_stages)
    prefix = "elastic_" if elastic else ""
    return OrderedWalk(tensors=(*level, perm, chunks.chunk_ptr, chunks.level_chunk), args=args,
                       perm=perm.data_ptr(), single=f"{prefix}ordered_single",
                       mrhs=f"{prefix}ordered_mrhs", n=n,
                       dtype=vals.dtype, device=device, stage_bytes=chunks.stage_bytes,
                       n_stages=chunks.n_stages)


@functools.lru_cache(maxsize=None)
def _ordered_blocks(dtype, device, stage_bytes, n_stages) -> int:
    """The most blocks of the ordered entry resident at once on ``device``
    for the stage layout: what its cooperative launch may take."""
    fn = getattr(build.load("sptrsv"), f"sptrsv_ordered_blocks_{_SUFFIX[dtype]}")
    fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(_I)], ctypes.c_int
    blocks = _I(0)
    with torch.cuda.device(device):
        err = fn(stage_bytes, n_stages, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"sptrsv_ordered_blocks: CUDA error {err}")
    return blocks.value


def ordered_columns(walk: OrderedWalk) -> int:
    """The most right-hand sides one ordered launch takes: a block each,
    all resident at once."""
    return _ordered_blocks(walk.dtype, walk.device, walk.stage_bytes, walk.n_stages)


def sptrsv_ordered_cuda(walk: OrderedWalk, b):
    """Solve for ``b`` f[n] or f[n, m] in the caller's row order, one
    cooperative launch (``bind_ordered_walk``; m at most
    ``ordered_columns(walk)``); returns x, a new tensor shaped like ``b``,
    in the caller's row order. Bitwise ``sptrsv_level_cuda`` on ``b``
    gathered into plan row order, with its x gathered back
    (``kernels.ref.sptrsv_ordered_ref``). ``b`` must be a contiguous
    tensor of the walk's dtype on its device (CUDA)."""
    if not isinstance(b, torch.Tensor):
        raise TypeError("b must be a torch.Tensor")
    if b.device != walk.device or b.dtype != walk.dtype:
        raise ValueError(f"b must be {walk.dtype} on {walk.device}; got {b.dtype} on {b.device}")
    if b.dim() not in (1, 2) or b.shape[0] != walk.n or not b.is_contiguous():
        raise ValueError(f"b must be a contiguous [n] or [n, m] with n={walk.n}; got "
                         f"{tuple(b.shape)}")
    out = torch.empty_like(b)
    if b.numel() == 0:
        return out
    m = 1 if b.dim() == 1 else b.shape[1]
    blocks = ordered_columns(walk)
    if m > blocks:
        raise ValueError(f"an ordered launch takes at most {blocks} columns; got {m}")
    scratch = b.new_empty(2 * m * (walk.n + 1))  # b, then x, in plan row order
    _launch(walk.single if b.dim() == 1 else walk.mrhs, walk.dtype, walk.device,
            walk.stage_bytes, *walk.args, m, min(max(m, ORDERED_SPREAD), blocks), walk.n,
            walk.perm, b.data_ptr(), out.data_ptr(), scratch.data_ptr())
    return out
