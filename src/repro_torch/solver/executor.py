"""The plain PyTorch executor over an ExecPlan: bulk-synchronous, and the
elastic macro-step loop of ``mode="elastic"``.

This module holds the plain step bodies ``_step_single`` / ``_step_mrhs``:
the one definition of what a solve computes, bit for bit. They are the
PyTorch spelling of the JAX package's ``solver/executor.py`` step bodies:

  * the W-reduction is a left-to-right chain of ``torch.addcmul`` — one
    fused multiply-add per entry, which is what XLA emits for the
    reference's ``acc + v * x[col]``; a plain ``acc + v * x`` rounds twice
    and breaks bitwise parity with the reference;
  * the finish is a correctly rounded ``(b[row] - acc) / d``;
  * non-accum lanes scatter into x and reset their accumulator.

``kernels.ref.sptrsv_ref`` loops over these bodies; it is the plain version
of the CUDA kernels and what the ``scan`` backend runs. The CUDA kernels
(``kernels/sptrsv.py``) reproduce the same bits.

``solve_with_plan_timed`` / ``solve_with_elastic_timed`` are the opt-in
timed solves (``TriangularSolver.plan(..., timed=True)``): the same steps
in the same order, cut into one timed segment per superstep (bulk) or per
macro-step (elastic), so the same bits.

Padding protocol (see ``core.plan``): row id n = scratch row, gather index
n = scratch slot, so padded lanes are harmless; the scratch slot stays 0.
``accum`` rows carry partial sums for rows wider than W.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import ExecPlan
from repro_torch.device import resolve_device, timed_us


class PlanArrays(NamedTuple):
    """Plan tensors on the solver's device (see ExecPlan for shapes)."""

    row_ids: torch.Tensor  # int32[T, k]
    col_idx: torch.Tensor  # int32[T, k, W]
    vals: torch.Tensor  # f[T, k, W]
    diag: torch.Tensor  # f[T, k]
    accum: torch.Tensor  # bool[T, k]
    step_bounds: torch.Tensor  # int32[S+1]: superstep s is steps [sb[s], sb[s+1])
    n: int


def plan_arrays(plan: ExecPlan, dtype=torch.float32, device=None) -> PlanArrays:
    """The plan's tensors on ``device`` (``None``: the card, raising
    without CUDA)."""
    device = resolve_device(device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return PlanArrays(
        row_ids=put(plan.row_ids, torch.int32),
        col_idx=put(plan.col_idx, torch.int32),
        vals=put(plan.vals, dtype),
        diag=put(plan.diag, dtype),
        accum=put(plan.accum, torch.bool),
        step_bounds=put(plan.step_bounds, torch.int32),
        n=plan.n,
    )


def _step_single(x, acc, rows, cols, v, d, a, b_pad):
    """One plan step on x f[n+1] (updated in place): gather, fused
    multiply-add chain over w, divide, scatter. Returns ``(x, acc)``."""
    for w in range(v.shape[1]):
        acc = torch.addcmul(acc, v[:, w], x[cols[:, w]])
    xv = (b_pad[rows] - acc) / d
    # finishing lanes write x and reset their accumulator; padded lanes
    # share the scratch row n and all write the same 0 there
    x[rows] = torch.where(a, x[rows], xv)
    acc = torch.where(a, acc, 0.0)
    return x, acc


def _step_mrhs(x, acc, rows, cols, v, d, a, b_pad):
    """Multi-RHS twin of ``_step_single``: x f[n+1, m], acc f[k, m]; one
    index gather feeds all m columns, and a column's bits are independent
    of both the lane count k and the batch width m."""
    for w in range(v.shape[1]):
        acc = torch.addcmul(acc, v[:, w, None], x[cols[:, w]])
    xv = (b_pad[rows] - acc) / d[:, None]
    x[rows] = torch.where(a[:, None], x[rows], xv)
    acc = torch.where(a[:, None], acc, 0.0)
    return x, acc


def pad_rhs(b: torch.Tensor) -> torch.Tensor:
    """``b`` f[n] or f[n, m] with the zero scratch row n appended."""
    return torch.cat([b, b.new_zeros((1, *b.shape[1:]))])


def _zero_carry(b_pad: torch.Tensor, k: int):
    """The (x, acc) carry every loop over plan steps starts from: x shaped
    like ``b_pad`` and acc f[k] (f[k, m]), both zero."""
    return torch.zeros_like(b_pad), b_pad.new_zeros((k, *b_pad.shape[1:]))


def _solve_segment(rows, cols, v, d, a, b_pad, x, acc):
    """Run a contiguous run of plan steps, in order, on an (x, acc) carry
    (rows int32[t, k]): the whole plan (``kernels.ref.sptrsv_ref``), an
    elastic macro window, or a timed segment. Single- vs multi-RHS follows
    the carry's rank. Returns the carry."""
    step = _step_single if x.dim() == 1 else _step_mrhs
    for j in range(rows.shape[0]):
        x, acc = step(x, acc, rows[j], cols[j], v[j], d[j], a[j], b_pad)
    return x, acc


def solve_with_plan(pa: PlanArrays, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b with the plain step bodies. ``b``: f[n] or f[n, m]
    (multi-RHS — solved in one traversal), on the plan's device."""
    from repro_torch.kernels.ref import sptrsv_ref

    b_pad = pad_rhs(b.to(pa.vals.dtype))
    x = sptrsv_ref(pa.row_ids, pa.col_idx, pa.vals, pa.diag, pa.accum, b_pad)
    return x[: pa.n]


def make_solver(plan: ExecPlan, dtype=torch.float32, device=None):
    """Bind a plan on ``device`` (``None``: the card, raising without
    CUDA); returns ``solve(b) -> x`` for ``b`` f[n] or f[n, m]."""
    device = resolve_device(device)
    pa = plan_arrays(plan, dtype=dtype, device=device)

    def solve(b):
        return solve_with_plan(pa, torch.as_tensor(b, dtype=dtype, device=device))

    return solve


# ------------------------------------------------- width-class grouping
# The plain versions of the grouped, banked and resident solves (the
# ``scan`` backend runs them; the ``kernel`` backend launches its banked
# level walk instead). Lane j solves ITS OWN plan on its own right-hand
# side: the single-RHS step body run for every lane at once, gathers and
# scatters along the lane axis. The ops are elementwise, so a lane's bits
# are the single-RHS scan's on its plan, whatever its neighbours hold.


def _step_lanes(x, acc, rows, cols, v, d, a, b_pad):
    """``_step_single`` for g lanes at once: x f[g, n+1] (updated in
    place), acc f[g, k]; rows int64[g, k], cols int64[g, k, W] (as
    ``torch.gather`` takes them), v f[g, k, W], d f[g, k], a bool[g, k],
    b_pad f[g, n+1]. Lane i reads and writes row i of x only."""
    for w in range(v.shape[2]):
        acc = torch.addcmul(acc, v[:, :, w], torch.gather(x, 1, cols[:, :, w]))
    xv = (torch.gather(b_pad, 1, rows) - acc) / d
    # finishing lanes write x; padded lanes all write the scratch slot's 0
    x.scatter_(1, rows, torch.where(a, torch.gather(x, 1, rows), xv))
    acc = torch.where(a, acc, 0.0)
    return x, acc


def _scan_lanes(row_ids, col_idx, vals, diag, accum, b_pad):
    """The grouped scan: every tensor carries a leading lane axis g and
    lane i runs its own plan (``row_ids[i]``, ...) on ``b_pad[i]`` f[n+1].
    Returns x f[g, n+1] (the last column is scratch)."""
    x = torch.zeros_like(b_pad)
    acc = b_pad.new_zeros((row_ids.shape[0], row_ids.shape[2]))
    row_ids, col_idx = row_ids.long(), col_idx.long()
    for t in range(row_ids.shape[1]):
        x, acc = _step_lanes(x, acc, row_ids[:, t], col_idx[:, t], vals[:, t], diag[:, t],
                             accum[:, t], b_pad)
    return x


_PLAN_FIELDS = ("row_ids", "col_idx", "vals", "diag", "accum")


def solve_with_plan_group(pas, b_cols: torch.Tensor) -> torch.Tensor:
    """Solve lane j of ``b_cols`` f[g, n] (already in plan row order)
    against ``pas[j]``. All plans share one width class (equal tensor
    shapes); returns x f[g, n]. Stacks the plan tensors per call — the
    replay path; serving amortizes the stacking in a ``BankTensors``
    bank (``solve_with_bank``, the same bits)."""
    dtype = pas[0].vals.dtype
    b = b_cols.to(dtype)
    b_pad = torch.cat([b, b.new_zeros((b.shape[0], 1))], dim=1)
    stacked = [torch.stack([getattr(pa, f) for pa in pas]) for f in _PLAN_FIELDS]
    return _scan_lanes(*stacked, b_pad)[:, : pas[0].n]


class BankTensors(NamedTuple):
    """A width class's plan tensors stacked once on the device (lane axis
    P first) with each lane's row permutations: the serving path for
    cross-pattern grouped batches, restacked only when the class's
    membership changes."""

    row_ids: torch.Tensor  # int32[P, T, k]
    col_idx: torch.Tensor  # int32[P, T, k, W]
    vals: torch.Tensor  # f[P, T, k, W]
    diag: torch.Tensor  # f[P, T, k]
    accum: torch.Tensor  # bool[P, T, k]
    perm: torch.Tensor  # int64[P, n]  caller order -> plan row order
    inv: torch.Tensor  # int64[P, n]  plan row order -> caller order


def pow2_lanes(count: int) -> list:
    """The bank's lane list for ``count`` members: their indices, padded
    up to a power of two by repeating lane 0, so a bank takes at most
    log2 distinct lane counts as classes grow and shrink."""
    pad = (1 << max(count - 1, 0).bit_length()) - count if count > 1 else 0
    return list(range(count)) + [0] * pad


def stack_plan_bank(pas, perms, invs) -> BankTensors:
    """Stack one width class's plans into a ``BankTensors``, the lane axis
    padded up to a power of two (``pow2_lanes``)."""
    idx = pow2_lanes(len(pas))
    return BankTensors(
        *(torch.stack([getattr(pas[i], f) for i in idx]) for f in _PLAN_FIELDS),
        perm=torch.stack([perms[i] for i in idx]),
        inv=torch.stack([invs[i] for i in idx]),
    )


def _lane_tensor(lane_idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(lane_idx, dtype=np.int64)).to(device)


def solve_with_bank(bank: BankTensors, lane_idx, B) -> torch.Tensor:
    """Solve column j of ``B`` f[n, m] (caller row order) against bank lane
    ``lane_idx[j]`` — its plan tensors and its row permutation. Returns x
    f[n, m] in caller order, bitwise ``solve_with_plan_group`` on the same
    lanes (the gathers move bits unchanged)."""
    lanes = _lane_tensor(lane_idx, bank.vals.device)
    dtype = bank.vals.dtype
    B = torch.as_tensor(B).to(device=bank.vals.device, dtype=dtype)
    b = torch.gather(B.T, 1, bank.perm[lanes])
    b_pad = torch.cat([b, b.new_zeros((b.shape[0], 1))], dim=1)
    x = _scan_lanes(*(getattr(bank, f)[lanes] for f in _PLAN_FIELDS), b_pad)
    return torch.gather(x[:, :-1], 1, bank.inv[lanes]).T


# ------------------------------------------------- resident RHS slots
# The continuous-batching serve engine (``repro_torch.serve.slots``) keeps
# one resident right-hand-side bank B f[n, S] per width class on the
# device: admission inserts a request's b into a free slot, each dispatch
# pass solves a pow2 lane prefix of the bank, and completion extracts the
# finished slot's column. The bank is column-major (a slot's column is
# contiguous), which moves no bits.


def blank_rhs(n: int, slots: int, dtype, device) -> torch.Tensor:
    """A zeroed resident right-hand-side bank f[n, slots] on ``device``,
    each column contiguous."""
    return torch.zeros((slots, n), dtype=dtype, device=device).T


def insert_lane(B_res: torch.Tensor, lane: int, b) -> torch.Tensor:
    """A NEW resident bank with column ``lane`` replaced by ``b`` f[n];
    every other column's bits are untouched. Pure: the input bank is not
    mutated, so a pass holding the old bank keeps solving its snapshot."""
    out = B_res.clone()  # keeps the column-major strides
    out[:, lane] = torch.as_tensor(b).to(device=B_res.device, dtype=B_res.dtype)
    return out


def extract_lane(X: torch.Tensor, lane: int) -> torch.Tensor:
    """Column ``lane`` of ``X`` f[n, S] as f[n] (bits unchanged)."""
    return X[:, lane]


def solve_resident(bank: BankTensors, lane_idx, B_res: torch.Tensor) -> torch.Tensor:
    """One continuous-mode pass: ``solve_with_bank`` on the first
    ``len(lane_idx)`` columns of the resident bank (the engine's pow2
    occupied-lane prefix), bitwise the same call on those columns."""
    return solve_with_bank(bank, lane_idx, B_res[:, : len(lane_idx)])


# --------------------------------------------------------------- elastic
class ElasticArrays(NamedTuple):
    """Plan tensors in macro-step layout: the T plan steps, padded up to
    ``M * slack`` with scratch steps, reshaped to a leading [M, slack]
    grid. The plain executor loops over the M macro-steps and replays each
    window's steps in order. The elastic kernels do not read them: they
    read the plan in level order (``kernels.ops.elastic_kernel_arrays``),
    and the kernel backend keeps these tensors as its value refresh's
    source."""

    row_ids: torch.Tensor  # int32[M, S, k]
    col_idx: torch.Tensor  # int32[M, S, k, W]
    vals: torch.Tensor  # f[M, S, k, W]
    diag: torch.Tensor  # f[M, S, k]
    accum: torch.Tensor  # bool[M, S, k]
    n: int
    slack: int
    n_steps: int  # original (pre-padding) plan step count T


def _pad_to_window(a: np.ndarray, pad: int, fill) -> np.ndarray:
    if pad == 0:
        return a
    tail = np.full((pad, *a.shape[1:]), fill, dtype=a.dtype)
    return np.concatenate([a, tail], axis=0)


def elastic_plan_arrays(
    plan: ExecPlan, *, slack: int, dtype=torch.float32, device=None
) -> ElasticArrays:
    """Lay the plan out for the elastic executor on ``device`` (``None``:
    the card, raising without CUDA). Padding steps are the usual scratch
    protocol (row n, gather n, val 0, diag 1, no accum): they write the
    scratch slot's 0 and cannot perturb x[:n]. The accumulator enters the
    padding as zero — a plan's last real step never carries ``accum``
    (every virtual-row chain ends with its finishing row)."""
    device = resolve_device(device)
    T = plan.n_steps
    M = max(1, -(-T // slack))
    pad = M * slack - T
    n, k, W = plan.n, plan.k, plan.W

    def put(a, fill, dt, *tail):
        a = np.ascontiguousarray(_pad_to_window(a, pad, fill).reshape(M, slack, *tail))
        return torch.as_tensor(a).to(device=device, dtype=dt)

    return ElasticArrays(
        row_ids=put(plan.row_ids, n, torch.int32, k),
        col_idx=put(plan.col_idx, n, torch.int32, k, W),
        vals=put(plan.vals, 0, dtype, k, W),
        diag=put(plan.diag, 1, dtype, k),
        accum=put(plan.accum, False, torch.bool, k),
        n=n,
        slack=int(slack),
        n_steps=T,
    )


def _elastic_loop(row_ids, col_idx, vals, diag, accum, b_pad):
    """Elastic loop: ``ceil(T / slack)`` macro-steps, each replaying its
    window's ``slack`` plan steps in order (``_solve_segment``) — the same
    steps in the same order as the bulk loop, so the same bits."""
    x, acc = _zero_carry(b_pad, row_ids.shape[2])
    for window in zip(row_ids, col_idx, vals, diag, accum):
        x, acc = _solve_segment(*window, b_pad, x, acc)
    return x


def solve_with_elastic(ea: ElasticArrays, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b through the elastic macro-step loop. ``b``: f[n] or
    f[n, m]; bitwise-identical to ``solve_with_plan`` on the same plan."""
    b_pad = pad_rhs(b.to(ea.vals.dtype))
    x = _elastic_loop(ea.row_ids, ea.col_idx, ea.vals, ea.diag, ea.accum, b_pad)
    return x[: ea.n]


# ---------------------------------------------------------- timed solves
# Opt-in per-step device timing (``TriangularSolver.plan(..., timed=True)``
# / ``BoundSolve.solve_timed``): the plan traversal is cut at its natural
# boundaries (superstep bounds for the bulk loop, macro-step windows for
# elastic) and each segment is timed on its own (``device.timed_us``: CUDA
# events on the card, the host clock on the CPU). The segments run
# ``_solve_segment``, as the untimed loops do, in the same order on one
# (x, acc) carry, so x is bitwise the untimed solve's; only the
# granularity that can be observed changes.


def solve_with_plan_timed(pa: PlanArrays, b: torch.Tensor) -> Tuple[torch.Tensor, List[dict]]:
    """``solve_with_plan`` with per-superstep timing: one timed segment per
    non-empty superstep. Returns ``(x, steps)`` where each entry is
    ``{"superstep", "n_steps", "us"}``; an ``executor.superstep`` span
    lands in the active trace buffer per segment when tracing is on."""
    b_pad = pad_rhs(b.to(pa.vals.dtype))
    x, acc = _zero_carry(b_pad, pa.row_ids.shape[1])
    bounds = pa.step_bounds.tolist()
    steps: List[dict] = []
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        if hi == lo:
            continue
        with obs.span("executor.superstep", cat="executor", superstep=s, steps=hi - lo):
            (x, acc), us = timed_us(lambda: _solve_segment(
                pa.row_ids[lo:hi], pa.col_idx[lo:hi], pa.vals[lo:hi], pa.diag[lo:hi],
                pa.accum[lo:hi], b_pad, x, acc), b_pad.device)
        steps.append({"superstep": s, "n_steps": hi - lo, "us": us})
    return x[: pa.n], steps


def solve_with_elastic_timed(ea: ElasticArrays, b: torch.Tensor) -> Tuple[torch.Tensor, List[dict]]:
    """``solve_with_elastic`` with per-macro-step timing. Returns
    ``(x, steps)`` with one ``{"macro_step", "n_steps", "us"}`` entry (and
    one ``executor.macro_step`` span when tracing) per executed
    macro-step: the runtime side of the elastic barrier-fusion
    certificate."""
    b_pad = pad_rhs(b.to(ea.vals.dtype))
    x, acc = _zero_carry(b_pad, ea.row_ids.shape[2])
    steps: List[dict] = []
    for m in range(ea.row_ids.shape[0]):
        with obs.span("executor.macro_step", cat="executor", macro=m, slack=ea.slack):
            (x, acc), us = timed_us(lambda: _solve_segment(
                ea.row_ids[m], ea.col_idx[m], ea.vals[m], ea.diag[m], ea.accum[m],
                b_pad, x, acc), b_pad.device)
        steps.append({"macro_step": m, "n_steps": ea.slack, "us": us})
    return x[: ea.n], steps
