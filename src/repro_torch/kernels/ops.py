"""Public wrappers around the SpTRSV kernels.

``sptrsv_kernel_solve(plan, b)`` is the counterpart of
``solver.executor.solve_with_plan`` backed by the CUDA kernels (the plain
version for CPU tensors). Every kernel reads the plan's real lane-steps in
level order (layout in ``kernels.levels``), not the padded plan: the bulk
kernels (one right-hand side, and m a block per column) take the bulk order,
a run per superstep (``level_plan_arrays``, ``solve_with_kernel_arrays``);
the elastic kernels take the order over runs of the certificate's
``slack`` supersteps (``elastic_kernel_arrays``,
``solve_with_elastic_kernel_arrays``). Each solve is one launch with one
block barrier per level. A bank of plans of one width class
(``LevelBank``, ``stack_level_bank``) takes the serve layer's grouped and
resident-slot solves, each column on its own plan, in one launch of the
banked kernel (``solve_with_level_bank``). The front door's solve on the
card takes b and returns x in the caller's row order: the level tensors
and the solver's row permutation bound once (``ordered_walk``), one
launch a solve (``solve_ordered``). A distributed solve binds each position's
plan (a lane of the plan, or a shard of its rows) in the bulk level order
with the level range of each exchange round (``round_level_arrays``), and
walks one range per round (``kernels.sptrsv.sptrsv_level_range_cuda``).
Every bound of level tensors refreshes its values on the device the same
way: new entry data gathered through the plan's value sources in the same
level order (``level_sources``, ``refresh_level_values``).

This module is the device half of the ``kernel`` entry in
``repro_torch.backends`` — bind through the registry
(``get_backend("kernel").bind(plan)``) unless you need the raw pieces.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends.base import masked_value_gather
from repro_torch.core.plan import ExecPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.levels import (
    LevelChunks,
    LevelOrder,
    level_chunks,
    level_order,
    round_ranges,
)
from repro_torch.kernels.sptrsv import (
    OrderedWalk,
    bind_ordered_walk,
    device_chunks,
    sptrsv_elastic_cuda,
    sptrsv_level_bank_cuda,
    sptrsv_level_cuda,
    sptrsv_ordered_cuda,
)
from repro_torch.solver.executor import pad_rhs, pow2_lanes


def check_plan_indices(plan: ExecPlan) -> None:
    """Raise unless every index the kernels dereference is in range: rows
    and gather columns in [0, n] (n is the scratch slot) and step bounds
    monotone from 0 to T. The kernels read these without bounds checks."""
    n, T = plan.n, plan.n_steps
    for name in ("row_ids", "col_idx"):
        a = getattr(plan, name)
        if a.size and (int(a.min()) < 0 or int(a.max()) > n):
            raise ValueError(f"plan.{name} holds indices outside [0, {n}]")
    sb = np.asarray(plan.step_bounds)
    if sb.ndim != 1 or sb.size < 1 or sb[0] != 0 or sb[-1] != T or (np.diff(sb) < 0).any():
        raise ValueError(f"plan.step_bounds must rise monotonically from 0 to T={T}")


class LevelArrays(NamedTuple):
    """The plan's real lane-steps in level order on the solver's device:
    the single-RHS kernel's tensors (``kernels.levels``)."""

    row_ids: torch.Tensor  # int32[P]
    col_idx: torch.Tensor  # int32[P, W]
    vals: torch.Tensor  # f[P, W]
    diag: torch.Tensor  # f[P]
    accum: torch.Tensor  # bool[P]
    vert_ptr: torch.Tensor  # int32[V+1]
    level_ptr: torch.Tensor  # int32[L+1]
    perm: torch.Tensor  # int64[P]: each lane-step's flat (step * k + lane) plan index
    n: int
    # the host level order these tensors were gathered by: what the
    # verifier (``analysis.level_check``) audits after a bind
    order: LevelOrder | None = None
    # the order's chunk table on the device and its stage layout
    # (``kernels.levels.level_chunks``): what the kernel stages
    chunks: LevelChunks | None = None


def level_plan_arrays(
    plan: ExecPlan, *, dtype=torch.float32, device=None, order: LevelOrder | None = None,
    cuts=(),
) -> LevelArrays:
    """The plan tensors gathered into level order on ``device`` (``None``:
    the card, raising without CUDA), index contents checked, with the
    order's chunk table for the kernel's stages (one pass over the level
    bounds; no chunk across a level of ``cuts``, where level ranges are
    launched on their own). ``order`` is ``plan``'s level order where the
    caller has it already."""
    check_plan_indices(plan)
    device = resolve_device(device)
    if order is None:
        order = level_order(plan)
    perm = order.perm
    W = plan.W

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return LevelArrays(
        row_ids=put(plan.row_ids.reshape(-1)[perm], torch.int32),
        col_idx=put(plan.col_idx.reshape(-1, W)[perm], torch.int32),
        vals=put(plan.vals.reshape(-1, W)[perm], dtype),
        diag=put(plan.diag.reshape(-1)[perm], dtype),
        accum=put(plan.accum.reshape(-1)[perm], torch.bool),
        vert_ptr=put(order.vert_ptr, torch.int32),
        level_ptr=put(order.level_ptr, torch.int32),
        perm=put(perm, torch.int64),
        n=plan.n,
        order=order,
        chunks=device_chunks(level_chunks(order.vert_ptr, order.level_ptr, W, dtype.itemsize,
                                          cuts), device),
    )


class RoundLevels(NamedTuple):
    """One position's share of a distributed solve: its plan in the bulk
    level order on the position's device, the level range of each exchange
    round (round r walks levels ``[ranges[r], ranges[r+1])``), and the
    plan's value sources gathered into the same order (int32, -1 marks
    padding), from which a value refresh gathers new entry data."""

    la: LevelArrays
    ranges: tuple  # F+1 ints
    val_src: torch.Tensor  # int32[P, W]
    diag_src: torch.Tensor  # int32[P]


def level_sources(plan: ExecPlan, order: LevelOrder, *, device=None):
    """``(val_src, diag_src)``: ``plan``'s value sources gathered into the
    level order ``order`` on ``device`` (``None``: the card, raising
    without CUDA), int32[P, W] and int32[P], -1 marking padding: what
    ``refresh_level_values`` gathers new entry data through."""
    device = resolve_device(device)

    def put(a, shape):
        return torch.as_tensor(np.ascontiguousarray(
            np.asarray(a, np.int32).reshape(shape)[order.perm])).to(device)

    return put(plan.val_src, (-1, plan.W)), put(plan.diag_src, (-1,))


def refresh_level_values(la: LevelArrays, val_src, diag_src, data) -> LevelArrays:
    """``la`` with its values gathered from ``data`` (the new matrix's
    entry values in the plan dtype, on ``la``'s device) through its
    level-ordered sources (``level_sources``), the old value kept at
    padding; new tensors, ``la`` untouched. The value refresh of every
    bound that holds level tensors."""
    vals, diag = masked_value_gather(data, val_src, la.vals, diag_src, la.diag)
    return la._replace(vals=vals, diag=diag)


def round_level_arrays(plan: ExecPlan, bounds, *, dtype=torch.float32,
                       device=None) -> RoundLevels:
    """``plan`` in the bulk level order on ``device`` (``None``: the card,
    raising without CUDA) with the level ranges of the exchange rounds cut
    at ``bounds`` (superstep indices, ``kernels.levels.round_ranges``), its
    chunk table cut there too (no levels packed across a round), and its
    level-ordered value sources."""
    order = level_order(plan)
    ranges = round_ranges(order, bounds)
    la = level_plan_arrays(plan, dtype=dtype, device=device, order=order, cuts=ranges)
    val_src, diag_src = level_sources(plan, order, device=la.vals.device)
    return RoundLevels(la=la, ranges=tuple(int(v) for v in ranges),
                       val_src=val_src, diag_src=diag_src)


def solve_with_kernel_arrays(la: LevelArrays, b: torch.Tensor) -> torch.Tensor:
    """The kernel-calling convention in one place: cast ``b``, append the
    scratch row, run ``sptrsv_level_cuda`` over ``la`` in the bulk level
    order (b f[n] or f[n, m]), drop the scratch row. Shared by
    ``bind_kernel_solver`` and the ``kernel`` backend."""
    with obs.span("kernel.solve", cat="kernel"):
        b_pad = pad_rhs(b.to(la.vals.dtype))
        return sptrsv_level_cuda(*la[:7], b_pad, chunks=la.chunks)[: la.n]


def ordered_walk(la: LevelArrays, perm, *, elastic: bool = False) -> OrderedWalk:
    """The ordered solve bound over ``la`` (of the elastic order where
    ``elastic``) under the row permutation ``perm`` (int[n]: plan row r is
    the caller's row ``perm[r]``), its tensors checked once
    (``kernels.sptrsv.bind_ordered_walk``). Raises unless ``perm`` is a
    permutation of the n rows, which the kernel indexes unchecked."""
    n = la.n
    perm = torch.as_tensor(perm).to(device=la.vals.device, dtype=torch.int64)
    if perm.shape != (n,) or (n and (int(perm.min()) < 0 or int(perm.max()) >= n)):
        raise ValueError(f"perm must hold the rows of [0, n={n}), n of them")
    if n and not bool((torch.bincount(perm, minlength=n) == 1).all()):
        raise ValueError("perm must be a permutation of the rows")
    return bind_ordered_walk(*la[:7], perm.to(torch.int32), n, chunks=la.chunks, elastic=elastic)


def solve_ordered(walk: OrderedWalk, b: torch.Tensor) -> torch.Tensor:
    """The front door's solve on the card: b f[n] or f[n, m] in the
    caller's row order (contiguous, the walk's dtype and device), one
    launch of the ordered solve; x a new tensor in the caller's row order."""
    with obs.span("kernel.solve", cat="kernel"):
        return sptrsv_ordered_cuda(walk, b)


class LevelBank(NamedTuple):
    """A width class's plans in level order, stacked once on the device:
    the banked kernel's tensors. Each lane's level tensors are concatenated
    (``vert_ptr`` shifted by the lane's lane-step offset, ``level_ptr`` by
    its vertex offset), so lane l walks ``level_ptr[level_off[l] ..
    level_off[l] + n_levels[l]]`` of the shared arrays; the chunk tables
    are concatenated the same way, so the lane tables index
    ``chunks.level_chunk`` as they index ``level_ptr``. The lane axis is
    padded up to a power of two by repeating lane 0
    (``solver.executor.pow2_lanes``), whose padded lanes point at lane 0's
    levels and copy no plan data."""

    row_ids: torch.Tensor  # int32[sum P]
    col_idx: torch.Tensor  # int32[sum P, W]
    vals: torch.Tensor  # f[sum P, W]
    diag: torch.Tensor  # f[sum P]
    accum: torch.Tensor  # bool[sum P]
    vert_ptr: torch.Tensor  # int32[sum V + 1]
    level_ptr: torch.Tensor  # int32[sum L + 1]
    level_off: torch.Tensor  # int32[lanes]: a lane's first entry of level_ptr
    n_levels: torch.Tensor  # int32[lanes]
    perm: torch.Tensor  # int64[lanes, n]: caller order -> plan row order
    inv: torch.Tensor  # int64[lanes, n]: plan row order -> caller order
    n: int
    chunks: LevelChunks | None = None  # the lanes' chunk tables concatenated, one stage layout


_INT32_MAX = 2**31 - 1


def _concat_levels(las, lanes):
    """The banked kernel's nine tensors for the level tensors ``las`` (one
    width class: the same n, W, dtype and device): each member's tensors
    concatenated, and the lane tables of ``lanes`` (member indices). Raises
    where a concatenated count passes int32, which the kernel indexes
    with."""
    n, W = las[0].n, las[0].col_idx.shape[1]
    if any(la.n != n or la.col_idx.shape[1] != W for la in las):
        raise ValueError("a level bank takes plans of one width class (the same n and W)")
    n_steps = [la.row_ids.shape[0] for la in las]
    n_verts = [la.vert_ptr.shape[0] - 1 for la in las]
    n_lvls = [la.level_ptr.shape[0] - 1 for la in las]
    totals = {"lane-steps": sum(n_steps), "vertices": sum(n_verts) + 1,
              "levels": sum(n_lvls) + 1}
    for what, total in totals.items():
        if total > _INT32_MAX:
            raise ValueError(f"the bank's {what} ({total}) pass int32")
    p_off = np.concatenate([[0], np.cumsum(n_steps)])
    v_off = np.concatenate([[0], np.cumsum(n_verts)])
    l_off = np.concatenate([[0], np.cumsum(n_lvls)])
    tail = las[0].vert_ptr.new_tensor
    vert_ptr = torch.cat([la.vert_ptr[:-1] + int(p) for la, p in zip(las, p_off)]
                         + [tail([int(p_off[-1])])])
    level_ptr = torch.cat([la.level_ptr[:-1] + int(v) for la, v in zip(las, v_off)]
                          + [tail([int(v_off[-1])])])

    def lane_table(values):
        return torch.as_tensor(np.asarray(values, np.int64)[lanes]).to(
            device=las[0].vals.device, dtype=torch.int32)

    return (*(torch.cat([getattr(la, f) for la in las]) for f in LevelArrays._fields[:5]),
            vert_ptr, level_ptr, lane_table(l_off[:-1]), lane_table(n_lvls))


def _concat_chunks(las) -> LevelChunks:
    """The members' chunk tables concatenated as ``_concat_levels``
    concatenates their levels: each chunk bound shifted by its member's
    vertex and lane-step offsets, each ``level_chunk`` by its chunk offset.
    One stage layout serves every lane: the largest stage and the fewest
    stages, which fit the block (each member's largest stage fits its own
    ring of at least two), so each member's chunks still fit."""
    chunks = [la.chunks for la in las]
    n_steps = [la.row_ids.shape[0] for la in las]
    n_verts = [la.vert_ptr.shape[0] - 1 for la in las]
    n_chunks = [c.chunk_ptr.shape[0] - 1 for c in chunks]
    offs = np.stack([np.concatenate([[0], np.cumsum(n_verts)]),
                     np.concatenate([[0], np.cumsum(n_steps)])], axis=1)
    c_off = np.concatenate([[0], np.cumsum(n_chunks)])
    tail = chunks[0].chunk_ptr.new_tensor
    chunk_ptr = torch.cat([c.chunk_ptr[:-1] + tail(o.tolist()) for c, o in zip(chunks, offs)]
                          + [tail([offs[-1].tolist()])])
    level_chunk = torch.cat([c.level_chunk[:-1] + int(o) for c, o in zip(chunks, c_off)]
                            + [tail([int(c_off[-1])])])
    return LevelChunks(
        chunk_ptr=chunk_ptr,
        level_chunk=level_chunk,
        n_stages=min(c.n_stages for c in chunks),
        stage_bytes=max(c.stage_bytes for c in chunks),
        staged=np.concatenate([c.staged for c in chunks]),
        cuttable=np.concatenate([c.cuttable[:-1] for c in chunks] + [[True]]),
    )


def stack_level_bank(las, perms, invs) -> LevelBank:
    """Stack one width class's level tensors ``las`` (``LevelArrays``) with
    their row permutations ``perms`` / ``invs`` (int64[n] each) into a
    ``LevelBank``, its lane axis padded up to a power of two."""
    lanes = pow2_lanes(len(las))
    return LevelBank(
        *_concat_levels(las, lanes),
        perm=torch.stack([perms[i] for i in lanes]),
        inv=torch.stack([invs[i] for i in lanes]),
        n=las[0].n,
        chunks=_concat_chunks(las),
    )


def solve_with_level_bank(bank: LevelBank, lane_idx, B) -> torch.Tensor:
    """The banked solve: column j of ``B`` f[n, m] (caller row order) on
    bank lane ``lane_idx[j]``. One ``torch.gather`` puts B's columns, each
    permuted by its lane's ``perm``, straight into the kernel's
    column-major buffer f[m, n+1] (the scratch entry 0), one launch of
    ``sptrsv_level_bank_cuda`` solves every column, and one gather by the
    lanes' ``inv`` returns x f[n, m] in caller order."""
    with obs.span("kernel.solve", cat="kernel"):
        lanes = torch.as_tensor(np.asarray(lane_idx, dtype=np.int64))
        B = torch.as_tensor(B).to(device=bank.vals.device, dtype=bank.vals.dtype)
        m, n = lanes.shape[0], bank.n
        b_col = B.new_zeros((m, n + 1))
        on_device = lanes.to(B.device)
        torch.gather(B.T, 1, bank.perm[on_device], out=b_col[:, :n])
        x_col = sptrsv_level_bank_cuda(*bank[:9], lanes, b_col, chunks=bank.chunks)
        return torch.gather(x_col[:, :n], 1, bank.inv[on_device]).T


def check_elastic_certificate(plan: ExecPlan) -> None:
    """Raise unless ``plan.elastic`` is a certificate that fits this plan:
    its step and superstep counts are the plan's and its slack is at
    least 1. The elastic kernels read only its slack."""
    ep = plan.elastic
    if ep is None:
        raise ValueError("plan has no elastic certificate attached (plan.elastic)")
    if ep.n_steps != plan.n_steps or ep.n_supersteps != plan.n_supersteps or ep.slack < 1:
        raise ValueError(
            f"plan.elastic does not fit the plan: T={plan.n_steps}, "
            f"supersteps={plan.n_supersteps}; certificate T={ep.n_steps}, "
            f"supersteps={ep.n_supersteps}, slack={ep.slack}"
        )


def elastic_kernel_arrays(plan: ExecPlan, *, dtype=torch.float32, device=None) -> LevelArrays:
    """The elastic kernels' tensors on ``device`` (``None``: the card,
    raising without CUDA): the plan's real lane-steps in the level order
    over runs of ``plan.elastic.slack`` supersteps (``kernels.levels``).
    Index contents and the certificate are checked."""
    check_elastic_certificate(plan)
    check_plan_indices(plan)
    device = resolve_device(device)
    order = level_order(plan, slack=plan.elastic.slack)
    return level_plan_arrays(plan, dtype=dtype, device=device, order=order)


def solve_with_elastic_kernel_arrays(la: LevelArrays, b: torch.Tensor) -> torch.Tensor:
    """Elastic twin of ``solve_with_kernel_arrays``: cast ``b``, append the
    scratch row, run ``sptrsv_elastic_cuda`` (b f[n] or f[n, m]), drop the
    scratch row."""
    with obs.span("kernel.solve", cat="kernel"):
        b_pad = pad_rhs(b.to(la.vals.dtype))
        return sptrsv_elastic_cuda(*la[:7], b_pad, chunks=la.chunks)[: la.n]


def bind_kernel_solver(plan: ExecPlan, *, dtype=torch.float32, device=None):
    """Bind the plan's level tensors once on ``device`` (``None``: the
    card); returns ``solve(b) -> x`` where ``b`` is f[n] or f[n, m]
    (batched multi-RHS)."""
    device = resolve_device(device)
    la = level_plan_arrays(plan, dtype=dtype, device=device)

    def solve(b):
        return solve_with_kernel_arrays(la, torch.as_tensor(b, dtype=dtype, device=device))

    return solve


def sptrsv_kernel_solve(plan: ExecPlan, b, *, dtype=torch.float32, device=None):
    """Solve L x = b with the kernels. ``b``: f[n] (returns x f[n]) or
    f[n, m] for a batched multi-RHS solve (returns x f[n, m])."""
    return bind_kernel_solver(plan, dtype=dtype, device=device)(b)
