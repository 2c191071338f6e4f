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

from typing import Any, NamedTuple

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


# The level walk's stages (csrc/level.cuh, which holds the same numbers):
SMEM_BYTES = 232_448  # dynamic shared memory one block may use on an H100 (227 KB)
STAGE_HEAD_BYTES = 256  # the stages' mbarriers and heads, ahead of the stages
# The stages take at most half of it: the rest of the SM's 256 KB of shared
# memory and L1 stays L1, where the x gathers hit. On ER (n = 100,000, W =
# 12), with a barrier a chunk, two stages of 116 KB made the single-RHS
# walk 16-21% slower than two of 60 KB.
MIN_STAGES, MAX_STAGES = 2, 4
# the block's consumer threads, a vertex each: 1,024 less the producer warp
CHUNK_VERTICES = 992


class LevelChunks(NamedTuple):
    """The level walk's chunk table and stage layout (``level_chunks``).
    A chunk is one stage load: a run of at most ``CHUNK_VERTICES`` vertices
    inside one level, or several consecutive whole levels of at most
    ``CHUNK_VERTICES`` vertices each. The kernel stages each chunk's slices
    of the level tensors, its level bounds included, in shared memory ahead
    of the barrier before it (csrc/level.cuh)."""

    chunk_ptr: Any  # int32[C+1, 2]: (first vertex, first lane-step) of each chunk, then the ends
    # int32[L+1]: the chunk that holds level i's first vertex, then C; level
    # i covers chunks [level_chunk[i], level_chunk[i+1]], the last of them
    # only where it is shared with level i+1
    level_chunk: Any
    n_stages: int  # stages in the ring, 2 to MAX_STAGES
    stage_bytes: int  # bytes a stage holds, a multiple of 16
    # bool[C] (host): the chunk fits a stage; else it is one vertex, read in place
    staged: np.ndarray
    # bool[L+1] (host): level i begins a chunk, so a level range may start
    # or end there (L: True)
    cuttable: np.ndarray

    def stats(self) -> dict:
        """The staging counter of ``describe()``: how often the stages
        engage, and ``packed_levels``, the levels that share their chunk
        with another level."""
        alone = self.cuttable[:-1] & self.cuttable[1:]
        return {"stages": self.n_stages, "stage_bytes": self.stage_bytes,
                "chunks": int(self.staged.size),
                "chunks_staged": int(np.count_nonzero(self.staged)),
                "levels": len(self.level_chunk) - 1,
                "packed_levels": int(alone.size - np.count_nonzero(alone))}


def stage_need(nv, np_, W: int, itemsize: int, nl=1):
    """Bytes a stage needs for a chunk of ``nv`` vertices, ``np_``
    lane-steps and ``nl`` levels (scalars or int64 arrays): its slices of
    vert_ptr (nv + 1), col_idx and vals (np_ * W), row_ids, diag and accum
    (np_), and, where it holds more than one level, of level_ptr (nl + 1),
    each rounded out to 16-byte bounds wherever it starts, as
    ``cp.async.bulk`` copies it. The kernel decides whether a chunk is
    staged by the same sum."""
    nv, np_, nl = (np.asarray(a, np.int64) for a in (nv, np_, nl))
    lens = (4 * (nv + 1), 4 * np_ * W, itemsize * np_ * W, 4 * np_, itemsize * np_, np_)
    levels = np.where(nl > 1, (4 * (nl + 1) + 30) // 16 * 16, 0)
    return sum((n + 30) // 16 * 16 for n in lens) + levels


def level_chunks(vert_ptr, level_ptr, W: int, itemsize: int, cuts=()) -> LevelChunks:
    """The chunk table of a level order (host arrays) for elements of
    ``itemsize`` bytes and plan width ``W``, and its stage layout.

    Each level is cut every ``CHUNK_VERTICES`` vertices. A stage holds the
    widest of those chunks (``stage_need``), at most half of the stages'
    room (half of ``SMEM_BYTES``), and the ring takes as many such stages
    as the room holds, 2 to ``MAX_STAGES``. A chunk that does not fit a
    stage is cut again, as many vertices at a time as fit; a vertex that
    alone does not fit is a chunk of its own, not staged (the kernel reads
    it in place). Then consecutive levels that are each one staged chunk
    are packed into one chunk, greedily, as many as fit a stage with their
    level bounds, so a stage load carries many narrow levels. No chunk
    spans a level of ``cuts`` (level indices: the level ranges that are
    launched on their own, ``kernels.sptrsv.sptrsv_level_range_cuda``),
    which begins a chunk. One pass over the levels; only chunks that do
    not fit are cut in a loop, and packing takes a step a chunk."""
    vp = np.asarray(vert_ptr, np.int64)
    lp = np.asarray(level_ptr, np.int64)
    widths = np.diff(lp)
    pieces = -(-widths // CHUNK_VERTICES)
    ends = np.cumsum(pieces)
    first = np.repeat(lp[:-1], pieces) + CHUNK_VERTICES * (
        np.arange(ends[-1] if ends.size else 0) - np.repeat(ends - pieces, pieces))
    last = np.minimum(first + CHUNK_VERTICES, np.repeat(lp[1:], pieces))
    need = stage_need(last - first, vp[last] - vp[first], W, itemsize)

    room = SMEM_BYTES // 2 - STAGE_HEAD_BYTES
    largest = room // MIN_STAGES // 16 * 16
    stage_bytes = min(-(-int(need.max(initial=16)) // 16) * 16, largest)
    n_stages = min(max(room // stage_bytes, MIN_STAGES), MAX_STAGES)

    starts = [first]
    for v, end in zip(first[need > stage_bytes], last[need > stage_bytes]):
        cuts_v = []
        while v < end:  # stage_need rises with the vertices taken
            fits = stage_need(np.arange(1, end - v + 1), vp[v + 1 : end + 1] - vp[v], W, itemsize)
            v += max(int(np.count_nonzero(fits <= stage_bytes)), 1)
            cuts_v.append(v)
        starts.append(np.asarray(cuts_v[:-1], np.int64))
    starts = np.unique(np.concatenate(starts)) if len(starts) > 1 else first
    starts = _pack_levels(starts, vp, lp, W, itemsize, stage_bytes, cuts)

    ends = np.append(starts[1:], lp[-1])
    bounds = np.append(starts, lp[-1])
    level_chunk = np.searchsorted(starts, lp, side="right") - 1
    level_chunk[-1] = starts.size
    levels_in = np.maximum(np.bincount(level_chunk[:-1], minlength=starts.size), 1)
    return LevelChunks(
        chunk_ptr=np.stack([bounds, vp[bounds]], axis=1).astype(np.int32),
        level_chunk=level_chunk.astype(np.int32),
        n_stages=int(n_stages),
        stage_bytes=int(stage_bytes),
        staged=stage_need(ends - starts, vp[ends] - vp[starts], W, itemsize,
                          levels_in) <= stage_bytes,
        cuttable=np.isin(lp, bounds),
    )


def _pack_levels(starts, vp, lp, W, itemsize, stage_bytes, cuts):
    """``starts`` (the chunk starts of each level cut on its own) with the
    starts of packed levels taken out: from each level that is one staged
    chunk, the longest run of such levels that follow it, none of them in
    ``cuts``, whose vertices, lane-steps and level bounds fit one stage
    (``stage_need`` rises with each level taken). The run is sought in a
    window of levels that doubles while the run fills it."""
    L = lp.size - 1
    lc = np.searchsorted(starts, lp)
    nv, np_ = np.diff(lp), vp[lp[1:]] - vp[lp[:-1]]
    one = (np.diff(lc) == 1) & (stage_need(nv, np_, W, itemsize) <= stage_bytes)
    opens = np.zeros(L + 1, bool)  # a level that must begin a chunk
    opens[np.asarray(cuts, np.int64)] = True
    keep = np.ones(starts.size, bool)
    i = 0
    while i < L:
        if not one[i]:
            i += 1
            continue
        window = 32
        while True:
            j = np.arange(i + 1, min(L, i + window) + 1)  # pack levels [i, j)
            ok = np.append(True, one[j[:-1]] & ~opens[j[:-1]])
            fits = stage_need(lp[j] - lp[i], vp[lp[j]] - vp[lp[i]], W, itemsize,
                              j - i) <= stage_bytes
            take = int(np.argmin(np.append(ok & fits, False)))  # the leading levels that fit
            if take < j.size or j[-1] == L:
                break
            window *= 2
        keep[lc[i + 1 : i + take]] = False
        i += take
    return starts[keep]


def _run_starts(a: np.ndarray) -> np.ndarray:
    """Indices where a run of equal values of ``a`` begins."""
    if a.size == 0:
        return np.zeros(0, np.int64)
    return np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
