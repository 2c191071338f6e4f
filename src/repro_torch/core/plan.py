"""ExecPlan — compile a BSP schedule into padded tensors for the executors.

The executor view of a schedule:

  * supersteps execute one after another (a barrier between them);
  * within a superstep, each of the k cores processes its chain of rows
    **sequentially** (same-core dependencies are legal — that is GrowLocal's
    main source of barrier savings);
  * the k cores advance in lock-step: sequential position t of every chain
    executes simultaneously (vector parallelism across cores).

The plan therefore pads every superstep to a rectangle:

    step t = 0..chain_len(s)-1 of superstep s processes rows
    row_ids[s_off + t, 0..k-1], each row with up to W off-diagonal entries
    col_idx[..., w] / vals[..., w] (padded with col -> self, val -> 0).

Rows are padded with a sentinel id pointing at a scratch slot (n), so padding
lanes write to scratch and never corrupt x. The off-diagonal width W is a
per-plan maximum; rows wider than W are split into multiple *virtual rows*
(partial-sum rows that accumulate into the same x slot — the last virtual row
finishes with the diagonal division). The plan compiler reports padding
efficiency; the §Perf loop iterates on it.

Compilation is the paper's *inspector* phase (§7.7 amortizes it over many
executes), so it must be O(nnz), not O(n) Python iterations:
``compile_plan`` is pure NumPy array passes — virtual-row expansion via
``repeat``/``cumsum`` segment arithmetic and one bulk scatter per plan
tensor. This is a copy of the JAX package's inspector;
``tests/test_torch_inspector.py`` holds the two bitwise-equal. The
original per-row compiler is kept as ``_reference_compile_plan``, the
oracle ``tests/test_torch_check.py`` holds the vectorized one to.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch import obs
from repro_torch.core.schedule import Schedule
from repro_torch.sparse.csr import CSRMatrix


@dataclasses.dataclass
class ExecPlan:
    """Padded execution plan. Shapes:
    row_ids   int32[T, k]      — target row of each (step, core); n = padding
    col_idx   int32[T, k, W]   — gather indices into x (self-padded)
    vals      float32/64[T,k,W]— off-diagonal values (0-padded)
    diag      float[T, k]      — diagonal value of the row (1 for padding)
    accum     bool[T, k]       — True: this step only accumulates partial
                                  sums (row split over multiple steps)
    step_bounds int32[S+1]     — superstep s covers steps
                                  [step_bounds[s], step_bounds[s+1])
    val_src   int32[T, k, W]   — index into L.data feeding vals (-1 padding)
    diag_src  int32[T, k]      — index into L.data feeding diag (-1 padding)

    ``val_src``/``diag_src`` let a caller refresh the numeric values for a
    new matrix with the *same* sparsity pattern without recompiling — the
    plan-cache ``numeric_update`` path (and, device-side, the
    ``repro_torch.backends`` ``BoundSolve.update_values`` gather).

    ``elastic`` (optional) attaches the bounded-slack certificate from
    ``core.elastic.elastic_transform`` when the plan was built for
    ``mode="elastic"`` — the executors' macro-step/wave geometry;
    ``stats()`` then reports barrier counts before/after fusion.
    """

    n: int
    k: int
    W: int
    row_ids: np.ndarray
    col_idx: np.ndarray
    vals: np.ndarray
    diag: np.ndarray
    accum: np.ndarray
    step_bounds: np.ndarray
    val_src: np.ndarray | None = None
    diag_src: np.ndarray | None = None
    elastic: "object | None" = None  # core.elastic.ElasticPlan when elastic

    def numeric_update(self, data: np.ndarray) -> None:
        """Overwrite ``vals``/``diag`` in place from ``data`` — the ``.data``
        of a matrix with the sparsity pattern this plan was compiled for
        (same entry order as the ``L`` passed to ``compile_plan``)."""
        assert self.val_src is not None and self.diag_src is not None
        data = np.asarray(data)
        vmask = self.val_src >= 0
        self.vals[vmask] = data[self.val_src[vmask]].astype(self.vals.dtype)
        dmask = self.diag_src >= 0
        self.diag[dmask] = data[self.diag_src[dmask]].astype(self.diag.dtype)

    @property
    def n_steps(self) -> int:
        return self.row_ids.shape[0]

    @property
    def n_supersteps(self) -> int:
        return len(self.step_bounds) - 1

    def stats(self) -> dict:
        real = self.row_ids != self.n
        nnz_slots = self.col_idx.shape[0] * self.k * self.W
        # count populated slots from the value-source map, not from
        # (vals != 0): a factor may legitimately store explicit zeros, and
        # a padding slot may transiently hold a zero from numeric_update —
        # val_src >= 0 is the structural truth
        if self.val_src is not None:
            real_nnz = int((self.val_src >= 0).sum())
        else:  # plans built without source maps fall back to the value test
            real_nnz = int((self.vals != 0).sum())
        out = {
            "n_steps": self.n_steps,
            "n_supersteps": self.n_supersteps,
            "k": self.k,
            "W": self.W,
            "row_slot_utilization": float(real.mean()),
            "nnz_slot_utilization": real_nnz / max(nnz_slots, 1),
            "bytes_streamed": int(
                self.col_idx.size * 4 + self.vals.size * self.vals.itemsize
                + self.row_ids.size * 4 + self.diag.size * self.diag.itemsize
            ),
        }
        if self.elastic is not None:
            # barrier accounting before/after bounded-slack fusion
            out["elastic"] = self.elastic.stats()
        return out


def _resolve_width(row_nnz_off: np.ndarray, n: int, width: int | None) -> int:
    """Default W: 95th percentile of off-diagonal row nnz, clipped to
    [4, 512] (wide rows are split, narrow rows padded; §Perf tunes this)."""
    if width is None:
        width = int(np.clip(np.percentile(row_nnz_off, 95) if n else 4, 4, 512))
        width = max(width, 1)
    return int(width)


def compile_plan(
    L: CSRMatrix,
    sched: Schedule,
    *,
    width: int | None = None,
    dtype=np.float32,
) -> ExecPlan:
    """Compile (matrix, schedule) into an ExecPlan — vectorized inspector.

    O(nnz) NumPy passes, no per-row Python: the schedule order comes from
    one lexsort, virtual rows from a ``repeat``/``cumsum`` expansion, and
    each plan tensor is filled by a single bulk scatter.

    ``width``: max off-diagonal entries per virtual row (W); see
    ``_resolve_width`` for the default.
    """
    n, k = L.n_rows, sched.k
    with obs.span(
        "inspector.compile_plan", cat="inspector", n=n, k=k
    ) as sp:
        row_nnz_off = L.row_nnz() - 1  # off-diag count (diag always present)
        assert (row_nnz_off >= 0).all(), "matrix must have a full diagonal"
        W = _resolve_width(row_nnz_off, n, width)
        S = sched.n_supersteps
        diag_vals = L.diagonal()

        # -- schedule order: vertices grouped by (superstep, core), chain
        # order (the stable lexsort Schedule.chains() uses, minus the dict)
        with obs.span("inspector.order", cat="inspector"):
            order = np.lexsort((sched.rank, sched.pi, sched.sigma))

        # -- virtual-row expansion: vertex v becomes ceil(off_nnz/W) rows --
        with obs.span("inspector.expand", cat="inspector"):
            segs = np.maximum(1, -(-row_nnz_off // W)).astype(np.int64)
            segs_o = segs[order]
            vr_v = np.repeat(order, segs_o)  # vertex of each virtual row
            starts = np.cumsum(segs_o) - segs_o  # first v-row per vertex
            vr_g = (
                np.arange(len(vr_v), dtype=np.int64)
                - np.repeat(starts, segs_o)
            )
            vr_last = vr_g == segs[vr_v] - 1

            # chain position of each virtual row within (superstep, core)
            key = sched.sigma[vr_v].astype(np.int64) * k + sched.pi[vr_v]
            group_len = np.bincount(key, minlength=S * k)  # sorted already
            group_start = np.cumsum(group_len) - group_len
            t_in_chain = (
                np.arange(len(vr_v), dtype=np.int64) - group_start[key]
            )

            # superstep step count = max chain length over its k cores
            chain_len = group_len.reshape(S, k)
            step_bounds = np.zeros(S + 1, dtype=np.int64)
            np.cumsum(chain_len.max(axis=1), out=step_bounds[1:])
            T = int(step_bounds[-1])

            # flat (step, core) slot of every virtual row
            slot = (
                step_bounds[sched.sigma[vr_v]] + t_in_chain
            ) * k + sched.pi[vr_v]

        # -- row-level tensors: one scatter each --------------------------
        with obs.span("inspector.row_scatter", cat="inspector"):
            row_ids = np.full(T * k, n, dtype=np.int32)
            row_ids[slot] = vr_v
            diag = np.ones(T * k, dtype=dtype)
            diag[slot] = diag_vals[vr_v]
            accum = np.zeros(T * k, dtype=bool)
            accum[slot] = ~vr_last

            # first diagonal entry id per row (reverse scatter keeps first)
            rows_of_entry = L.row_of_entry()
            off_mask = L.indices != rows_of_entry
            diag_entry = np.full(n, -1, dtype=np.int64)
            d_ids = np.nonzero(~off_mask)[0]
            diag_entry[rows_of_entry[d_ids[::-1]]] = d_ids[::-1]
            diag_src = np.full(T * k, -1, dtype=np.int32)
            diag_src[slot] = diag_entry[vr_v]

        # -- entry-level tensors: off-diagonal entries, row-major ---------
        with obs.span("inspector.entry_scatter", cat="inspector"):
            off_entries = np.nonzero(off_mask)[0]  # entry ids by row
            n_off = np.bincount(
                rows_of_entry[off_mask], minlength=n
            ).astype(np.int64)
            off_start = np.cumsum(n_off) - n_off  # row -> first off slot

            # virtual row (v, g) takes off slots [gW, min((g+1)W, n_off))
            cnt = np.clip(n_off[vr_v] - vr_g * W, 0, W)
            total = int(cnt.sum())
            e_start = np.cumsum(cnt) - cnt
            lane = (
                np.arange(total, dtype=np.int64) - np.repeat(e_start, cnt)
            )
            src = off_entries[
                off_start[np.repeat(vr_v, cnt)]
                + np.repeat(vr_g, cnt) * W
                + lane
            ]
            dest = np.repeat(slot, cnt) * W + lane

            # padding gathers read x[n] (scratch) -> harmless 0 contribution
            col_idx = np.full(T * k * W, n, dtype=np.int32)
            col_idx[dest] = L.indices[src]
            vals = np.zeros(T * k * W, dtype=dtype)
            vals[dest] = L.data[src]
            # int32 matches col_idx and halves the host-side footprint;
            # entry ids are bounded by nnz << 2^31
            val_src = np.full(T * k * W, -1, dtype=np.int32)
            val_src[dest] = src

        sp.set(T=T, W=W, supersteps=S)

    return ExecPlan(
        n=n,
        k=k,
        W=W,
        row_ids=row_ids.reshape(T, k),
        col_idx=col_idx.reshape(T, k, W),
        vals=vals.reshape(T, k, W),
        diag=diag.reshape(T, k),
        accum=accum.reshape(T, k),
        step_bounds=step_bounds.astype(np.int32),
        val_src=val_src.reshape(T, k, W),
        diag_src=diag_src.reshape(T, k),
    )


def _reference_compile_plan(
    L: CSRMatrix,
    sched: Schedule,
    *,
    width: int | None = None,
    dtype=np.float32,
) -> ExecPlan:
    """The original per-row plan compiler (superstep x core x virtual row
    Python loops). Kept solely as the equivalence oracle for the
    vectorized ``compile_plan`` — do not call it on large matrices."""
    n, k = L.n_rows, sched.k
    row_nnz_off = L.row_nnz() - 1  # off-diagonal count (diag always present)
    assert (row_nnz_off >= 0).all(), "matrix must have a full diagonal"
    W = _resolve_width(row_nnz_off, n, width)

    chains = sched.chains()
    diag_vals = L.diagonal()

    # per (superstep, core): expand each row into ceil(off_nnz / W) virtual
    # rows; chain length = sum of virtual rows; superstep step count = max
    # chain length over cores.
    step_bounds = [0]
    vrows: List[List[List[tuple]]] = []  # superstep -> core -> [(row, seg)]
    for s in range(sched.n_supersteps):
        per_core: List[List[tuple]] = []
        for p in range(k):
            chain = chains.get((s, p), np.empty(0, dtype=np.int64))
            vr: List[tuple] = []
            for v in chain:
                v = int(v)
                segs = max(1, -(-int(row_nnz_off[v]) // W))
                for g in range(segs):
                    vr.append((v, g, g == segs - 1))
            per_core.append(vr)
        vrows.append(per_core)
        step_bounds.append(step_bounds[-1] + max(len(c) for c in per_core))

    T = step_bounds[-1]
    row_ids = np.full((T, k), n, dtype=np.int32)
    col_idx = np.zeros((T, k, W), dtype=np.int32)
    vals = np.zeros((T, k, W), dtype=dtype)
    diag = np.ones((T, k), dtype=dtype)
    accum = np.zeros((T, k), dtype=bool)
    val_src = np.full((T, k, W), -1, dtype=np.int32)
    diag_src = np.full((T, k), -1, dtype=np.int32)
    col_idx[:] = n

    for s in range(sched.n_supersteps):
        base = step_bounds[s]
        for p in range(k):
            for t, (v, g, last) in enumerate(vrows[s][p]):
                cols, values = L.row(v)
                e0 = int(L.indptr[v])  # entry index of this row's first slot
                off = cols != v
                off_src = e0 + np.nonzero(off)[0]
                cols, values = cols[off], values[off]
                lo, hi = g * W, min((g + 1) * W, len(cols))
                row_ids[base + t, p] = v
                col_idx[base + t, p, : hi - lo] = cols[lo:hi]
                vals[base + t, p, : hi - lo] = values[lo:hi]
                val_src[base + t, p, : hi - lo] = off_src[lo:hi]
                diag[base + t, p] = diag_vals[v]
                dpos = np.nonzero(~off)[0]
                if len(dpos):
                    diag_src[base + t, p] = e0 + int(dpos[0])
                accum[base + t, p] = not last
    return ExecPlan(
        n=n,
        k=k,
        W=W,
        row_ids=row_ids,
        col_idx=col_idx,
        vals=vals,
        diag=diag,
        accum=accum,
        step_bounds=np.asarray(step_bounds, dtype=np.int32),
        val_src=val_src,
        diag_src=diag_src,
    )


def plans_bitwise_equal(a: ExecPlan, b: ExecPlan) -> bool:
    """True iff two plans are bitwise identical — every tensor equal in
    value AND dtype, plus the scalar geometry. The acceptance check for
    the copied inspector."""
    if (a.n, a.k, a.W) != (b.n, b.k, b.W):
        return False
    for name in (
        "row_ids", "col_idx", "vals", "diag", "accum", "step_bounds",
        "val_src", "diag_src",
    ):
        ta, tb = getattr(a, name), getattr(b, name)
        if ta is None or tb is None:
            if ta is not tb:
                return False
            continue
        if ta.dtype != tb.dtype or ta.shape != tb.shape:
            return False
        if not np.array_equal(ta, tb):
            return False
    return True
