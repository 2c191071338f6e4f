"""Plan sanitizer — independent audit of ``ExecPlan`` tensors.

Everything here is re-derived from first principles (raw CSR arrays and
the plan tensors themselves); nothing is imported from
``core/plan.py``'s compilation logic, so a compiler bug cannot
self-certify.  The pass proves, for a plan claiming to solve ``Lx = b``:

fast level (the O(n) structural screen, bounded at <= 15% of
``compile_plan`` time — ``repro_torch.launch.check_overhead``):

  * geometry — tensor shapes agree, ``step_bounds`` is a monotone cover
    of ``[0, T]``;
  * bounds — every ``row_ids`` / ``col_idx`` / ``val_src`` / ``diag_src``
    index is inside its target array (min/max reductions; the violating
    slots are only materialized when a bound actually breaks);
  * padding inertness — a padding slot (``row_ids == n``) carries
    exactly the inert tuple (scratch gathers, zero vals, unit diag, no
    accum, no sources), so it can never perturb ``x``;
  * write discipline — every row is finalized exactly once, and every
    final write divides by a nonzero diagonal.

full level adds the O(nnz) elementwise proofs:

  * scratch containment — a scratch-directed gather in a real row is
    inert (zero value, no source), so scratch never escapes into ``x``;
  * accum chains — same-lane consecutive steps ending in their single
    final write, never crossing a superstep barrier;
  * read-after-write — every real gather reads a row finalized at a
    strictly earlier step (scratch reads excluded);
  * value provenance — ``vals`` / ``diag`` / ``col_idx`` are exactly
    the matrix entries named by ``val_src`` / ``diag_src``, and the
    source maps cover each off-diagonal entry exactly once.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.analysis.findings import Finding, finding

CHECK = "plan"


def _ex(idx: np.ndarray, limit: int = 4) -> str:
    """Format the first few flat indices of a violation mask."""
    flat = np.asarray(idx).ravel()[:limit]
    return ", ".join(str(int(i)) for i in flat)


def _final_slots(
    row_ids: np.ndarray, accum: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat indices of final (non-accum, real) slots and the rows they
    finalize."""
    flat = row_ids.ravel()
    fi = np.flatnonzero((flat >= 0) & (flat < n) & ~accum.ravel())
    return fi, np.take(flat, fi)


def packed_writers(
    row_ids: np.ndarray, accum: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Packed writer derivation: ``w_pack[j] = step * k + lane`` of row
    ``j``'s final write (a final slot's flat index IS that packed
    coordinate), ``-1`` for rows never finalized; plus the written-row
    mask and the total count of final slots.  ``n_final >
    have.sum()`` means some row was finalized more than once (the last
    scatter wins, matching the executor's last-write semantics)."""
    fi, rows = _final_slots(row_ids, accum, n)
    w_pack = np.full(n, -1, dtype=np.int64)
    w_pack[rows] = fi
    return w_pack, w_pack >= 0, len(fi)


def plan_writers(
    row_ids: np.ndarray, accum: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Independent writer derivation: for each row, the (step, lane) of
    its final (non-accum) virtual row, plus how many final writes it
    received.  ``-1`` marks rows never finalized."""
    T, k = row_ids.shape
    w_pack, have, _ = packed_writers(row_ids, accum, n)
    w_step = w_pack // k  # floor division keeps -1 at -1
    w_lane = np.where(have, w_pack % k, -1)
    _, rows = _final_slots(row_ids, accum, n)
    w_count = np.bincount(
        rows.astype(np.int64), minlength=n
    )[:n] if n else np.zeros(0, dtype=np.int64)
    return w_step, w_lane, w_count


def verify_exec_plan(
    plan,
    L=None,
    *,
    level: str = "fast",
    expect_coverage: bool = True,
    writers: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> List[Finding]:
    """Audit ``plan`` (an ``ExecPlan``-shaped object).  ``L`` is the
    CSR matrix the plan was compiled from (required for the full-level
    value-provenance checks; fast-level works without it).

    ``expect_coverage=False`` relaxes the every-row-finalized and
    entry-coverage requirements — shard-local plans only own a subset
    of rows (halo slots are written by the exchange, not the plan).
    ``writers`` accepts a precomputed ``packed_writers`` triple so one
    derivation can be shared with ``verify_lane_layout``.
    """
    out: List[Finding] = []
    n, k, W = int(plan.n), int(plan.k), int(plan.W)
    row_ids = np.asarray(plan.row_ids)
    col_idx = np.asarray(plan.col_idx)
    vals = np.asarray(plan.vals)
    diag = np.asarray(plan.diag)
    accum = np.asarray(plan.accum)
    sb = np.asarray(plan.step_bounds, dtype=np.int64)
    val_src = None if plan.val_src is None else np.asarray(plan.val_src)
    diag_src = None if plan.diag_src is None else np.asarray(plan.diag_src)

    # ---- geometry -----------------------------------------------------
    T = row_ids.shape[0]
    shapes_ok = (
        row_ids.shape == (T, k)
        and col_idx.shape == (T, k, W)
        and vals.shape == (T, k, W)
        and diag.shape == (T, k)
        and accum.shape == (T, k)
        and (val_src is None or val_src.shape == (T, k, W))
        and (diag_src is None or diag_src.shape == (T, k))
    )
    if not shapes_ok:
        out.append(finding(
            CHECK, "PLAN_SHAPE",
            f"tensor shapes disagree with (T={T}, k={k}, W={W})",
        ))
        return out  # nothing downstream is meaningful
    if len(sb) < 1 or sb[0] != 0 or sb[-1] != T or (np.diff(sb) < 0).any():
        out.append(finding(
            CHECK, "PLAN_STEP_BOUNDS",
            f"step_bounds is not a monotone cover of [0, {T}]: "
            f"first={sb[0] if len(sb) else '?'}, "
            f"last={sb[-1] if len(sb) else '?'}",
        ))
        return out

    # ---- index bounds (min/max screen; masks only on violation) -------
    if row_ids.size and (row_ids.min() < 0 or row_ids.max() > n):
        bad = (row_ids < 0) | (row_ids > n)
        out.append(finding(
            CHECK, "PLAN_ROW_OOB",
            f"{int(bad.sum())} row_ids outside [0, {n}] "
            f"(slots {_ex(np.nonzero(bad.ravel())[0])})",
        ))
    if col_idx.size and (col_idx.min() < 0 or col_idx.max() > n):
        bad = (col_idx < 0) | (col_idx > n)
        out.append(finding(
            CHECK, "PLAN_COL_OOB",
            f"{int(bad.sum())} col_idx outside [0, {n}] "
            f"(slots {_ex(np.nonzero(bad.ravel())[0])})",
        ))
    nnz = len(L.data) if L is not None else None
    for name, src in (("val_src", val_src), ("diag_src", diag_src)):
        if src is None or not src.size:
            continue
        if src.min() < -1 or (nnz is not None and src.max() >= nnz):
            bad = src < -1
            if nnz is not None:
                bad = bad | (src >= nnz)
            out.append(finding(
                CHECK, "PLAN_SRC_OOB",
                f"{int(bad.sum())} {name} entries outside [-1, nnz) "
                f"(slots {_ex(np.nonzero(bad.ravel())[0])})",
            ))
    if out:
        return out  # out-of-bounds indices poison the gather checks below

    # ---- padding lane inertness --------------------------------------
    pad = row_ids == n
    pidx = np.flatnonzero(pad.ravel())
    if pidx.size:
        # np.take is several times faster than boolean/fancy indexing
        # for these strided row gathers
        p_acc = np.take(accum.ravel(), pidx)
        if p_acc.any():
            out.append(finding(
                CHECK, "PLAN_PAD_ACCUM",
                f"{int(p_acc.sum())} padding slots flagged accum",
            ))
        p_diag = np.take(diag.ravel(), pidx)
        if (p_diag != 1).any():
            out.append(finding(
                CHECK, "PLAN_PAD_DIAG",
                f"{int((p_diag != 1).sum())} padding slots with diag != 1",
            ))
        p_vals = np.take(vals.reshape(-1, W), pidx, axis=0)
        if (p_vals != 0).any():
            out.append(finding(
                CHECK, "PLAN_PAD_VALS",
                f"{int((p_vals != 0).sum())} nonzero vals in padding "
                "slots",
            ))
        p_cols = np.take(col_idx.reshape(-1, W), pidx, axis=0)
        if (p_cols != n).any():
            out.append(finding(
                CHECK, "PLAN_PAD_COLS",
                f"{int((p_cols != n).sum())} padding gathers not aimed "
                "at the scratch slot",
            ))
        if val_src is not None:
            p_src = np.take(val_src.reshape(-1, W), pidx, axis=0)
            if (p_src != -1).any():
                out.append(finding(
                    CHECK, "PLAN_PAD_SRC",
                    f"{int((p_src != -1).sum())} padding slots with live "
                    "val_src",
                ))
        if diag_src is not None:
            p_dsrc = np.take(diag_src.ravel(), pidx)
            if (p_dsrc != -1).any():
                out.append(finding(
                    CHECK, "PLAN_PAD_SRC",
                    f"{int((p_dsrc != -1).sum())} padding slots with "
                    "live diag_src",
                ))

    # ---- write discipline --------------------------------------------
    if writers is None:
        writers = packed_writers(row_ids, accum, n)
    w_pack, have, n_final = writers
    n_written = int(have.sum()) if n else 0
    if expect_coverage and n_written < n:
        out.append(finding(
            CHECK, "PLAN_ROW_UNWRITTEN",
            f"{n - n_written} rows never finalized "
            f"(rows {_ex(np.nonzero(~have)[0])})",
        ))
    if n_final > n_written:
        # slow path only to name the culprits
        _, rows = _final_slots(row_ids, accum, n)
        w_count = np.bincount(rows.astype(np.int64), minlength=n)
        out.append(finding(
            CHECK, "PLAN_DOUBLE_WRITE",
            f"{int((w_count > 1).sum())} rows finalized more than once "
            f"(rows {_ex(np.nonzero(w_count > 1)[0])})",
        ))

    # diagonal of every final write must be nonzero (division)
    if (diag == 0).any():
        zd = (diag == 0) & ~pad & ~accum
        if zd.any():
            out.append(finding(
                CHECK, "PLAN_ZERO_DIAG",
                f"{int(zd.sum())} final rows with zero diagonal",
            ))

    if level != "full":
        return out

    # ---- scratch never escapes (full) --------------------------------
    # a scratch-directed gather in a REAL row must be inert padding:
    # zero value and no source entry feeding it
    real3 = ~pad[:, :, None] & np.ones((1, 1, W), dtype=bool)
    scratch_gather = real3 & (col_idx == n)
    if (vals[scratch_gather] != 0).any():
        out.append(finding(
            CHECK, "PLAN_SCRATCH_VAL",
            f"{int((vals[scratch_gather] != 0).sum())} scratch gathers "
            "carry a nonzero value (scratch contribution escapes into x)",
        ))
    if val_src is not None and (val_src[scratch_gather] != -1).any():
        out.append(finding(
            CHECK, "PLAN_SCRATCH_SRC",
            f"{int((val_src[scratch_gather] != -1).sum())} scratch "
            "gathers wired to a matrix entry (numeric_update would make "
            "scratch escape)",
        ))
    real_gather = real3 & (col_idx < n)
    if val_src is not None and (val_src[real_gather] < 0).any():
        out.append(finding(
            CHECK, "PLAN_SRC_MISSING",
            f"{int((val_src[real_gather] < 0).sum())} real gathers with "
            "no val_src (numeric_update would go stale)",
        ))

    # ---- accum chains (full) -----------------------------------------
    # all slots of one row sit on one lane, on consecutive steps,
    # all-but-last flagged accum, and inside one superstep
    flat_rows = row_ids.ravel().astype(np.int64)
    realf = flat_rows < n
    r_rows = flat_rows[realf]
    r_steps = np.repeat(np.arange(T, dtype=np.int64), k)[realf]
    r_lanes = np.tile(np.arange(k, dtype=np.int64), T)[realf]
    r_accum = accum.ravel()[realf]
    o = np.lexsort((r_steps, r_rows))
    rr, rs, rl, ra = r_rows[o], r_steps[o], r_lanes[o], r_accum[o]
    same = rr[1:] == rr[:-1] if len(rr) > 1 else np.zeros(0, dtype=bool)
    if same.any():
        if ((rl[1:] != rl[:-1]) & same).any():
            out.append(finding(
                CHECK, "PLAN_CHAIN_LANE",
                "accum chain spans multiple lanes (partial sums would "
                "race across cores)",
            ))
        if ((rs[1:] != rs[:-1] + 1) & same).any():
            out.append(finding(
                CHECK, "PLAN_CHAIN_GAP",
                "accum chain steps are not consecutive",
            ))
        if (~ra[:-1] & same).any():
            out.append(finding(
                CHECK, "PLAN_CHAIN_ORDER",
                "non-final virtual row not flagged accum (a later slot "
                "of the same row follows a final write)",
            ))
    # a chain's last slot must be final (rows that are all-accum never
    # produce x); only meaningful when the row was written at all
    last_of_row = np.ones(len(rr), dtype=bool)
    if len(rr) > 1:
        last_of_row[:-1] = ~same
    if (ra[last_of_row]).any():
        out.append(finding(
            CHECK, "PLAN_CHAIN_NO_FINAL",
            f"{int(ra[last_of_row].sum())} rows whose last virtual row "
            "is still accum (x never finalized by the chain)",
        ))
    # chains must not cross a superstep barrier
    if T:
        sup_of_step = np.repeat(
            np.arange(len(sb) - 1, dtype=np.int64), np.diff(sb)
        )
        if same.any() and (
            (sup_of_step[rs[1:]] != sup_of_step[rs[:-1]]) & same
        ).any():
            out.append(finding(
                CHECK, "PLAN_CHAIN_SPANS_BARRIER",
                "accum chain crosses a superstep boundary",
            ))

    # ---- read-after-write (full) -------------------------------------
    # every real gather must read a row finalized at a strictly earlier
    # step; one gather through an extended writer table covers all slots
    # (scratch and unwritten rows map to -1, which no step can precede)
    if T:
        wmap = np.empty(n + 1, dtype=np.int64)
        wmap[:n] = w_pack // k  # unwritten rows stay at -1
        wmap[n] = -1
        early = wmap[col_idx] >= np.arange(T, dtype=np.int64)[:, None, None]
        if early.any():
            out.append(finding(
                CHECK, "PLAN_READ_BEFORE_WRITE",
                f"{int(early.sum())} gathers read a row at or before the "
                f"step that finalizes it (rows {_ex(col_idx[early])})",
            ))
        if expect_coverage and n_written < n:
            unw = np.zeros(n + 1, dtype=bool)
            unw[:n] = ~have
            ru = unw[col_idx] & real_gather
            if ru.any():
                out.append(finding(
                    CHECK, "PLAN_READ_UNWRITTEN",
                    f"{int(ru.sum())} gathers read rows no slot ever "
                    f"finalizes (rows {_ex(col_idx[ru])})",
                ))

    if L is not None:
        out.extend(_verify_values(
            plan, L, real_gather, expect_coverage=expect_coverage,
        ))
    return out


def _verify_values(
    plan, L, real_gather: np.ndarray, *, expect_coverage: bool
) -> List[Finding]:
    """Full-level value provenance: the plan's numeric content is exactly
    the matrix entries its source maps name, and those maps tile the
    matrix (each off-diagonal entry once, each diagonal entry once)."""
    out: List[Finding] = []
    n = int(plan.n)
    indptr = np.asarray(L.indptr, dtype=np.int64)
    indices = np.asarray(L.indices, dtype=np.int64)
    data = np.asarray(L.data)
    # row of each entry, derived from indptr alone
    erow = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    val_src = None if plan.val_src is None else np.asarray(plan.val_src)
    diag_src = None if plan.diag_src is None else np.asarray(plan.diag_src)
    vals = np.asarray(plan.vals)
    diag = np.asarray(plan.diag)
    row_ids = np.asarray(plan.row_ids)
    col_idx = np.asarray(plan.col_idx)

    if val_src is not None:
        src = val_src[real_gather]
        live = src >= 0
        s = src[live]
        rows3 = np.broadcast_to(row_ids[:, :, None], col_idx.shape)
        if (indices[s] != col_idx[real_gather][live]).any():
            out.append(finding(
                CHECK, "PLAN_SRC_COL_MISMATCH",
                "val_src names entries whose column differs from col_idx",
            ))
        if (erow[s] != rows3[real_gather][live]).any():
            out.append(finding(
                CHECK, "PLAN_SRC_ROW_MISMATCH",
                "val_src names entries from a different row than the slot",
            ))
        mism = vals[real_gather][live] != data[s].astype(vals.dtype)
        if mism.any():
            out.append(finding(
                CHECK, "PLAN_VALUE_MISMATCH",
                f"{int(mism.sum())} vals differ bitwise from the matrix "
                "entries val_src names",
            ))
        # off-diagonal coverage: each off-diag entry sourced exactly once
        off_ids = np.nonzero(indices != erow)[0]
        cnt = np.bincount(s, minlength=len(data)) if len(data) else (
            np.zeros(0, dtype=np.int64)
        )
        if len(data):
            dup = cnt[off_ids] > 1
            if dup.any():
                out.append(finding(
                    CHECK, "PLAN_ENTRY_DUP",
                    f"{int(dup.sum())} off-diagonal entries sourced more "
                    "than once",
                ))
            miss = cnt[off_ids] == 0
            if expect_coverage and miss.any():
                out.append(finding(
                    CHECK, "PLAN_ENTRY_MISSING",
                    f"{int(miss.sum())} off-diagonal entries never enter "
                    "the plan",
                ))
            on_diag = cnt[np.nonzero(indices == erow)[0]] > 0
            if on_diag.any():
                out.append(finding(
                    CHECK, "PLAN_ENTRY_DIAG_AS_OFF",
                    f"{int(on_diag.sum())} diagonal entries wired as "
                    "off-diagonal gathers",
                ))
    if diag_src is not None:
        live = diag_src >= 0
        s = diag_src[live].astype(np.int64)
        if len(s):
            if (indices[s] != erow[s]).any():
                out.append(finding(
                    CHECK, "PLAN_DIAG_SRC_OFFDIAG",
                    "diag_src names off-diagonal entries",
                ))
            if (erow[s] != row_ids[live].astype(np.int64)).any():
                out.append(finding(
                    CHECK, "PLAN_DIAG_SRC_ROW",
                    "diag_src names a different row's diagonal",
                ))
            mism = diag[live] != data[s].astype(diag.dtype)
            if mism.any():
                out.append(finding(
                    CHECK, "PLAN_DIAG_MISMATCH",
                    f"{int(mism.sum())} diag values differ bitwise from "
                    "the entries diag_src names",
                ))
    return out


def verify_lane_layout(
    plan,
    sched,
    *,
    level: str = "fast",
    writers: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> List[Finding]:
    """Cross-check plan layout against the schedule that produced it:
    each vertex's slots sit on its assigned core, inside its assigned
    superstep, and (full level) per-(superstep, core) chain loads equal
    the schedule's expansion ``sum(ceil(off_nnz/W))`` with step counts
    equal to the max core load.  ``writers`` accepts a precomputed
    ``packed_writers`` triple shared with ``verify_exec_plan``."""
    out: List[Finding] = []
    n, k = int(plan.n), int(plan.k)
    row_ids = np.asarray(plan.row_ids)
    accum = np.asarray(plan.accum)
    sb = np.asarray(plan.step_bounds, dtype=np.int64)
    T = row_ids.shape[0]
    pi = np.asarray(sched.pi)
    sigma = np.asarray(sched.sigma)
    if len(pi) != n or len(sigma) != n:
        out.append(finding(
            CHECK, "PLAN_SCHED_SIZE",
            f"schedule covers {len(pi)} vertices, plan has n={n}",
        ))
        return out
    if int(sched.k) != k:
        out.append(finding(
            CHECK, "PLAN_SCHED_K",
            f"schedule k={int(sched.k)} != plan k={k}",
        ))
        return out
    if len(sb) - 1 != int(sched.n_supersteps):
        out.append(finding(
            CHECK, "PLAN_SUPERSTEP_COUNT",
            f"plan has {len(sb) - 1} supersteps, schedule claims "
            f"{int(sched.n_supersteps)}",
        ))
        return out

    if writers is None:
        writers = packed_writers(row_ids, accum, n)
    w_pack, have, _ = writers
    # the common case is full coverage — skip the compressions then
    if bool(have.all()):
        wp, piv, sigv = w_pack, pi, sigma
    else:
        wp, piv, sigv = w_pack[have], pi[have], sigma[have]
    ws, wl = np.divmod(wp, k)
    lane_bad = wl != piv
    if lane_bad.any():
        out.append(finding(
            CHECK, "PLAN_LANE_MISMATCH",
            f"{int(lane_bad.sum())} rows execute on a "
            "different core than the schedule assigns",
        ))
    if T:
        sup_of_step = np.repeat(
            np.arange(len(sb) - 1, dtype=np.int64), np.diff(sb)
        )
        step_bad = sup_of_step[ws] != sigv
        if step_bad.any():
            out.append(finding(
                CHECK, "PLAN_STEP_MISMATCH",
                f"{int(step_bad.sum())} rows "
                "execute in a different superstep than the schedule "
                "assigns",
            ))

    if level == "full":
        # per-(superstep, core) load accounting: virtual-row counts per
        # lane must match the schedule's expansion, and each superstep's
        # step count must be the max lane load
        S = len(sb) - 1
        flat = row_ids.ravel().astype(np.int64)
        realf = flat < n
        steps = np.repeat(np.arange(T, dtype=np.int64), k)[realf]
        lanes = np.tile(np.arange(k, dtype=np.int64), T)[realf]
        if T:
            key = sup_of_step[steps] * k + lanes
            load = np.bincount(key, minlength=S * k).reshape(S, k)
        else:
            load = np.zeros((S, k), dtype=np.int64)
        # expected load: every vertex contributes its virtual-row count
        # to lane pi[v] of superstep sigma[v]; the count is recovered
        # from the plan itself (slots per row) so the check stays
        # matrix-free — verify_exec_plan ties slot counts to L
        vrows_per_row = np.bincount(flat[realf], minlength=n)[:n]
        exp = np.zeros((S, k), dtype=np.int64)
        np.add.at(exp, (sigma[have], pi[have]), vrows_per_row[have])
        if (load != exp).any():
            out.append(finding(
                CHECK, "PLAN_STEP_LOADS",
                "per-(superstep, core) slot counts disagree with the "
                "schedule's virtual-row expansion",
            ))
        widths = np.diff(sb)
        if (widths != load.max(axis=1)).any():
            out.append(finding(
                CHECK, "PLAN_STEP_WIDTH",
                "superstep step count differs from its max core load "
                "(padded rectangle is the wrong height)",
            ))
    return out
