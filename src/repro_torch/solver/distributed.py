"""Distributed SpTRSV executor, ``shard="model"``: the BSP model on a mesh.

The port's counterpart of the JAX package's ``solver/distributed.py``. The
k schedule cores are the k positions of the mesh's ``model`` axis
(``mesh.make_mesh``); the right-hand sides split over its ``data`` axis.
Model position p holds a replicated x (f[n+1], or column-major f[m_local,
n+1] for its slice of the batch) and lane p of the plan as a one-lane plan
(``lane_plan``) in the bulk level order, bound on the position's device
(``kernels.ops.round_level_arrays``). A solve runs in exchange rounds, one
per superstep or per fused run of the elastic certificate:

  * every position walks its lane's levels of the round into its own x,
    one range launch of the level kernel
    (``kernels.sptrsv.sptrsv_level_range_cuda``; the plain version for a
    position on the CPU);
  * then the all-gather: every row a lane finished in the round is copied
    from its owner's x into every other position's x. The tables are
    static, the rows of each lane's finishing steps in the round (the
    ``safe_rows`` rule of the JAX executor: accumulating and padding steps
    move nothing).

A lane's vertex reads rows of its own lane, finished earlier in the round
at a lower level or in an earlier round, and rows of other lanes, finished
in an earlier round (BSP validity; within a fused run, the certificate)
and gathered since. Each row gets the plan's own chain of fused
multiply-adds, so the answer is bitwise the scan executor's. The JAX
executor's step is ``acc + gathered @ v[0]``, a dot product that XLA need
not contract into the scan's FMA chain, so against it the answer holds
within a tolerance, not bitwise.

A single right-hand side runs on the positions of data row 0 alone; m
right-hand sides are padded to a multiple of the ``data`` axis, and data
row d takes columns ``[d m_local, (d+1) m_local)``. Bind through the
registry (``get_backend("distributed").bind(plan, mesh=mesh)``) unless
you need the raw pieces. The JAX package's ``distributed_input_specs`` /
``lower_distributed_solve`` lower XLA for its dry run and have no
counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core.plan import ExecPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import round_level_arrays
from repro_torch.kernels.sptrsv import sptrsv_level_range_cuda


@dataclasses.dataclass(frozen=True)
class DistPlanSpec:
    """What the executor reads of a distributed solve, built once at bind."""

    step_bounds: tuple  # len S+1
    # superstep index of each exchange round's start, and S last (len F+1):
    # one round per superstep, or per fused run of the elastic certificate
    # (core.elastic): a fused run has no cross-core read of a value written
    # inside it, so one exchange at its end is as correct as one per
    # superstep. The level order's runs count supersteps, so the round
    # ranges are cut here.
    exchange_bounds: tuple

    @property
    def n_rounds(self) -> int:
        return len(self.exchange_bounds) - 1


def dist_plan_spec(plan: ExecPlan, exchange_bounds=None) -> DistPlanSpec:
    """The spec of ``plan`` on a mesh; ``exchange_bounds`` (superstep
    indices, e.g. the certificate's ``fused_bounds``; None: every
    superstep) fuses rounds."""
    if exchange_bounds is None:
        exchange_bounds = range(plan.n_supersteps + 1)
    return DistPlanSpec(
        step_bounds=tuple(int(t) for t in plan.step_bounds),
        exchange_bounds=tuple(int(s) for s in exchange_bounds),
    )


def lane_plan(plan: ExecPlan, p: int) -> ExecPlan:
    """Lane ``p`` of ``plan`` as a one-lane plan over the same rows: its
    ``[:, p]`` columns, the plan's step bounds. Its level order sees only
    the lane's own dependencies; rows of other lanes are never written in
    it, so they impose no order (they arrive by exchange)."""
    sl = slice(p, p + 1)
    return dataclasses.replace(
        plan,
        k=1,
        row_ids=np.ascontiguousarray(plan.row_ids[:, sl]),
        col_idx=np.ascontiguousarray(plan.col_idx[:, sl]),
        vals=np.ascontiguousarray(plan.vals[:, sl]),
        diag=np.ascontiguousarray(plan.diag[:, sl]),
        accum=np.ascontiguousarray(plan.accum[:, sl]),
        val_src=None if plan.val_src is None else np.ascontiguousarray(plan.val_src[:, sl]),
        diag_src=None if plan.diag_src is None else np.ascontiguousarray(plan.diag_src[:, sl]),
        elastic=None,
    )


def per_position(mesh, make) -> list:
    """``[data][model]`` values of ``make(device, j)``, made once per
    (device, model index): positions of one column that share a device
    share the value."""
    made = {}
    out = []
    for d in range(mesh.shape["data"]):
        row = []
        for j in range(mesh.shape["model"]):
            dev = mesh.device((d, j))
            key = (str(dev), j)
            if key not in made:
                made[key] = make(dev, j)
            row.append(made[key])
        out.append(row)
    return out


def dist_plan_args(plan: ExecPlan, mesh, bounds, dtype=torch.float32) -> List[list]:
    """``[data][model]`` ``RoundLevels``: model position p holds lane p of
    ``plan`` in the bulk level order on its device, with the round ranges
    cut at ``bounds`` (superstep indices)."""
    return per_position(mesh, lambda dev, p: round_level_arrays(
        lane_plan(plan, p), bounds, dtype=dtype, device=dev))


class GatherRound(NamedTuple):
    """One round's all-gather tables, ``[data][model]`` int64 tensors on the
    positions' devices: ``rows[d][p]`` the rows lane p finished in the
    round, ``all_rows[d][p]`` every lane's, concatenated in lane order (the
    order of the gathered values)."""

    rows: list
    all_rows: list
    n_values: int  # rows finished in the round, over all lanes


def lane_rows(plan: ExecPlan, bounds) -> list:
    """``[F][k]`` int64 host arrays: the rows each lane finishes in each
    round (its real, non-accum steps, in step order)."""
    sb = np.asarray(plan.step_bounds, np.int64)
    fin = (plan.row_ids != plan.n) & ~plan.accum
    out = []
    for r in range(len(bounds) - 1):
        lo, hi = sb[bounds[r]], sb[bounds[r + 1]]
        out.append([plan.row_ids[lo:hi, p][fin[lo:hi, p]].astype(np.int64)
                    for p in range(plan.k)])
    return out


def dist_exchange_args(plan: ExecPlan, mesh, bounds) -> List[GatherRound]:
    """The all-gather tables of every round (``GatherRound``)."""
    out = []
    for rows in lane_rows(plan, bounds):
        cat = np.concatenate(rows)
        out.append(GatherRound(
            rows=per_position(mesh, lambda dev, p, rows=rows: torch.as_tensor(rows[p]).to(dev)),
            all_rows=per_position(mesh, lambda dev, p, cat=cat: torch.as_tensor(cat).to(dev)),
            n_values=int(cat.size),
        ))
    return out


def positions(mesh, single: bool) -> list:
    """The positions that take part: data row 0 for one right-hand side,
    every position for m."""
    rows = 1 if single else mesh.shape["data"]
    return [(d, j) for d in range(rows) for j in range(mesh.shape["model"])]


def launch_round(mesh, plan_args, r, bs, xs, used) -> int:
    """Every position of ``used`` walks its levels of round ``r`` into its
    x on its own stream: one range launch where it has levels. Returns the
    number of positions that had work."""
    busy = 0
    for d, j in used:
        rl = plan_args[d][j]
        lo, hi = rl.ranges[r], rl.ranges[r + 1]
        if hi > lo:
            busy += 1
            with mesh.on((d, j)):
                sptrsv_level_range_cuda(*rl.la[:7], lo, hi, bs[d][j], xs[d][j])
    return busy


def _all_gather(mesh, d, xs_row, gr: GatherRound) -> None:
    """Round's all-gather along data row ``d``: the rows each lane finished
    gathered on its position's stream, concatenated on position (d, 0),
    and copied into every position's x (its own rows too, the same bits)."""
    k = len(xs_row)
    if gr.n_values == 0:
        return
    parts, evs = [], []
    for p in range(k):
        with mesh.on((d, p)):
            parts.append(xs_row[p].index_select(-1, gr.rows[d][p]))
        evs.append(mesh.mark((d, p)))
    home = (d, 0)
    mesh.wait(home, evs)
    with mesh.on(home):
        gathered = torch.cat([mesh.move(t, (d, p), home) for p, t in enumerate(parts)], dim=-1)
    ev = mesh.mark(home)
    for q in range(k):
        mesh.wait((d, q), [ev])
        with mesh.on((d, q)):
            xs_row[q].index_copy_(-1, gr.all_rows[d][q], mesh.move(gathered, home, (d, q)))


def place_rhs(mesh, b_pad, single: bool) -> tuple:
    """``(bs, xs)``: the right-hand side for each position of ``mesh``
    (``[data][model]``; None where a position takes no part) and a zeroed x
    beside it. ``b_pad`` f[n+1] goes to data row 0; f[B, n+1] (B a multiple
    of the data axis, each row one right-hand side: the column-major layout
    of the m-RHS kernel) splits its rows over the data axis."""
    D, K = mesh.shape["data"], mesh.shape["model"]
    bs = [[None] * K for _ in range(D)]
    xs = [[None] * K for _ in range(D)]
    ml = 0 if single else b_pad.shape[0] // D
    for d, j in positions(mesh, single):
        part = b_pad if single else b_pad[d * ml:(d + 1) * ml]
        bs[d][j] = part.to(mesh.device((d, j))).contiguous()
        xs[d][j] = torch.zeros_like(bs[d][j])
    return bs, xs


def run_round(mesh, plan_args, gather_args, r, bs, xs, single) -> int:
    """Round ``r``: the launches, then the all-gather of every data row."""
    used = positions(mesh, single)
    busy = launch_round(mesh, plan_args, r, bs, xs, used)
    for d in sorted({d for d, _ in used}):
        _all_gather(mesh, d, xs[d], gather_args[r])
    return busy


def collect(mesh, xs, single: bool, home) -> torch.Tensor:
    """x from model position 0 of each data row (every position holds the
    whole x after the last all-gather), on ``home``: f[n+1] or f[B, n+1]."""
    if single:
        return xs[0][0].to(home)
    return torch.cat([xs[d][0].to(home) for d in range(mesh.shape["data"])])


def build_distributed_solver(spec: DistPlanSpec, mesh):
    """Returns ``solve(plan_args, gather_args, b_pad) -> x``: b_pad f[n+1]
    (one right-hand side) or f[B, n+1] (B a multiple of the data axis) on
    the caller's device; x shaped like it, on that device. ``plan_args``
    from ``dist_plan_args``, ``gather_args`` from ``dist_exchange_args``."""

    def solve(plan_args, gather_args, b_pad):
        single = b_pad.dim() == 1
        home = b_pad.device
        bs, xs = place_rhs(mesh, b_pad, single)
        used = positions(mesh, single)
        mesh.fork(used)
        for r in range(spec.n_rounds):
            run_round(mesh, plan_args, gather_args, r, bs, xs, single)
        mesh.join(used)
        return collect(mesh, xs, single, home)

    return solve


def run_distributed_solve(plan: ExecPlan, b, mesh, dtype=torch.float32, device=None):
    """Solve on ``mesh``; b: [B, n] (one right-hand side per row, as the
    JAX package's ``run_distributed_solve``). Returns x f[B, n] on
    ``device`` (``None``: the mesh's first position's device). The plan's
    k must equal the model axis."""
    if plan.k != mesh.shape["model"]:
        raise ValueError(f"plan has k={plan.k}; the mesh's model axis is {mesh.shape['model']}")
    home = mesh.devices.flat[0] if device is None else resolve_device(device)
    b = torch.as_tensor(np.asarray(b)).to(device=home, dtype=dtype)
    D = mesh.shape["data"]
    B = b.shape[0]
    Bp = -(-B // D) * D
    b_pad = b.new_zeros((Bp, plan.n + 1))
    b_pad[:B, : plan.n] = b
    spec = dist_plan_spec(plan)
    solve = build_distributed_solver(spec, mesh)
    x = solve(dist_plan_args(plan, mesh, spec.exchange_bounds, dtype),
              dist_exchange_args(plan, mesh, spec.exchange_bounds), b_pad)
    return x[:B, : plan.n]
