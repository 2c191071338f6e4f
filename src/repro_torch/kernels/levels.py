"""Level order of a plan: the layout of the level-walk SpTRSV kernels.

A plan walks each core's chain of rows in order, one lock-step row per lane
(``core.plan``). Most of a chain's rows do not depend on each other, so the
level kernels do not walk chains: they solve the plan level by level, with
one block barrier per level, and this module computes that order on the
host, once per plan, at bind time.

  * The padding lane-steps (``row_ids == n``) are dropped: they only write
    the +0 that x already holds in the scratch slot n.
  * A *vertex* is a lane's run of ``accum`` steps plus the step that
    finishes it: consecutive steps of one lane in one superstep (an accum
    chain never crosses a superstep, ``core.plan``).
  * The supersteps are grouped into *runs* of ``slack`` consecutive
    supersteps. ``slack=1`` makes a run of each superstep: the bulk
    kernel's order. ``mode="elastic"`` passes its certificate's slack.
  * A vertex's *local level* is 0 if it reads no row finished in its own
    run, else 1 + the highest local level of such a row's vertex.
  * Vertices are ordered by (run, level, lane, step), each vertex's
    lane-steps contiguous and in plan order, so one level is a contiguous
    run of vertices whose rows are mutually independent.

Why one block barrier per level is enough. A vertex reads x rows of three
kinds:

  * rows of an earlier run, complete behind the barrier that ended that
    run's last level;
  * rows of its own run, finished at a lower level by the definition of
    the level, complete behind that level's barrier;
  * the scratch slot n, which holds +0 throughout.

It never reads a row of a later run, nor a later row of its own run: the
plan never reads a row before the step that finishes it. So a run of
supersteps needs no ordering but its levels, and the superstep boundaries
inside it add none. A block barrier orders every thread of the block, so
nothing needs the cross-core cut of ``core.elastic``'s fused superstep
runs either (it is there for executors with no barrier inside a run). The
run length ``slack`` keeps its meaning there, the staleness bound: the
number of supersteps whose levels share one numbering. A ``slack`` of at
least the superstep count gives the whole DAG's wavefront order, as many
levels as its longest path.

It has no counterpart in the JAX package: it is these kernels' layout, as
the step padding and the readiness waves were the TPU kernels'.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.plan import ExecPlan


class LevelOrder(NamedTuple):
    """The level order of one plan (host arrays)."""

    perm: np.ndarray  # int64[P]: flat (step * k + lane) index of each real lane-step
    vert_ptr: np.ndarray  # int32[V+1]: vertex v covers perm[vert_ptr[v]:vert_ptr[v+1]]
    level_ptr: np.ndarray  # int32[L+1]: level i covers vertices [level_ptr[i], level_ptr[i+1])
    level_run: np.ndarray  # int32[L]: the run (superstep // slack) of each level
    slack: int  # supersteps per run

    @property
    def n_levels(self) -> int:
        return len(self.level_ptr) - 1

    def stats(self) -> dict:
        """Level counts and widths (vertices per level)."""
        widths = np.diff(self.level_ptr)
        per_run = np.bincount(self.level_run) if self.n_levels else widths
        return {
            "lane_steps": int(self.perm.size),
            "vertices": len(self.vert_ptr) - 1,
            "slack": self.slack,
            "levels": self.n_levels,
            "levels_per_run": per_run.tolist(),
            "level_width_max": int(widths.max()) if widths.size else 0,
            "level_width_median": float(np.median(widths)) if widths.size else 0.0,
        }


def _local_levels(plan: ExecPlan, run: np.ndarray) -> np.ndarray:
    """int64[T, k]: for each lane-step, the local level of its vertex as
    known at that step (at the finishing step: the vertex's level), given
    each step's run. One pass over the T steps, vectorised over the k
    lanes.

    ``rank[r]`` encodes row r's run and level as ``s * span + level + 1``,
    so ``rank[c] - s * span`` is (level + 1) for a row of the current run s
    and negative for a row of an earlier one; rows not yet finished (the
    scratch slot n) read 0. Finishing padding lanes write a dump slot
    n + 1, which no gather reads."""
    n, T = plan.n, plan.n_steps
    span = T + 2  # more than any level + 1
    rank = np.zeros(n + 2, np.int64)
    real = plan.row_ids != n
    write = np.where(real & ~plan.accum, plan.row_ids, n + 1)
    levels = np.empty(plan.row_ids.shape, np.int64)
    acc = np.zeros(plan.k, np.int64)
    for t in range(T):
        base = run[t] * span
        acc = np.maximum(acc, rank[plan.col_idx[t]].max(axis=1) - base)
        levels[t] = acc
        rank[write[t]] = base + acc + 1
        acc = np.where(plan.accum[t], acc, 0)
    return levels


def level_order(plan: ExecPlan, slack: int = 1) -> LevelOrder:
    """The level order of ``plan`` over runs of ``slack`` supersteps (see
    the module docstring); ``slack=1`` is the bulk kernel's order."""
    if slack < 1:
        raise ValueError(f"slack must be >= 1, got {slack}")
    n, k = plan.n, plan.k
    bounds = np.asarray(plan.step_bounds, np.int64)
    run = np.repeat(np.arange(len(bounds) - 1, dtype=np.int64) // slack, np.diff(bounds))
    levels = _local_levels(plan, run)

    # real lane-steps, lane by lane in step order: a vertex is a run that
    # ends at a finishing (non-accum) step
    step, lane = np.nonzero((plan.row_ids != n).T)[::-1]
    flat = step * k + lane
    finishing = ~plan.accum.reshape(-1)[flat]
    starts = np.concatenate([[True], finishing[:-1]])[: finishing.size]
    vertex = np.cumsum(starts) - 1
    vertex_level = levels.reshape(-1)[flat[finishing]]
    lvl = vertex_level[vertex]
    rn = run[step]

    order = np.lexsort((step, lane, lvl, rn))
    perm = flat[order]
    first = _run_starts(vertex[order])  # first lane-step of each vertex
    rn_v, lvl_v = rn[order][first], lvl[order][first]
    level_first = _run_starts(rn_v * (plan.n_steps + 2) + lvl_v)  # first vertex of each level
    return LevelOrder(
        perm=perm,
        vert_ptr=np.append(first, perm.size).astype(np.int32),
        level_ptr=np.append(level_first, first.size).astype(np.int32),
        level_run=rn_v[level_first].astype(np.int32),
        slack=int(slack),
    )


def round_ranges(order: LevelOrder, bounds) -> np.ndarray:
    """int64[F+1]: the level range of each exchange round of a distributed
    solve. ``bounds`` (int[F+1], superstep indices rising from 0 to S) cut
    the supersteps into rounds; round r walks levels ``[out[r], out[r+1])``
    of ``order``, exactly the levels whose run lies in ``[bounds[r],
    bounds[r+1])``. The order must be the bulk one (``slack=1``, a run per
    superstep): its levels are sorted by run, so each round's levels are
    contiguous. That holds for the per-superstep bounds and for the elastic
    certificate's fused ones (``core.elastic``, ``fused_bounds``)."""
    if order.slack != 1:
        raise ValueError(f"round ranges need the bulk order (slack 1), got slack {order.slack}")
    return np.searchsorted(order.level_run, np.asarray(bounds, np.int64), side="left")


def _run_starts(a: np.ndarray) -> np.ndarray:
    """Indices where a run of equal values of ``a`` begins."""
    if a.size == 0:
        return np.zeros(0, np.int64)
    return np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
