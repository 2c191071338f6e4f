"""Level-order checker — independent audit of the order the CUDA kernels walk.

The port's SpTRSV kernels do not walk the plan's supersteps or the elastic
certificate's waves: they walk a *level order* built at bind time
(``kernels/levels.py``), one block barrier per level. The docstring of
that module proves that one barrier per level suffices; this pass audits
the proof's premises on the order a bind really holds, so a fault in the
order shows here, on the host, and not as a race on the card (wrong or
run-to-run different bits).

Everything is re-derived from the plan tensors (``row_ids``, ``accum``,
``col_idx``, ``step_bounds``) and the order's own arrays; nothing is
imported from ``kernels/levels.py``, so a fault there cannot certify
itself. The order is read by attribute: ``perm`` (flat ``step * k +
lane`` index of each lane-step), ``vert_ptr``, ``level_ptr``,
``level_run`` and ``slack``.

fast level (O(lane-steps)):

  * ``perm`` is a bijection onto exactly the real lane-steps
    (``row_ids < n``): padding lane-steps are never walked;
  * ``vert_ptr`` / ``level_ptr`` rise strictly from 0 and cover every
    lane-step / vertex, and there is one ``level_run`` entry a level;
  * each vertex is a consecutive run of steps of one lane and one row in
    one superstep, with exactly one step that is not ``accum`` — the last
    one — and every row is finished by exactly one vertex;
  * ``level_run`` never falls, equals ``superstep // slack`` of every
    vertex of the level, and ``slack`` is the bind's (1 for the bulk
    kernels, the certificate's for the elastic ones).

full level (O(lane-steps x W)) adds:

  * no read before write — every real column a vertex of level l reads
    is finished at a level before l (levels run in order, a barrier after
    each, so this is "an earlier run, or this run at a lower level");
    reads of the scratch slot n are allowed;
  * plan order inside each vertex — its lane-steps are walked in rising
    plan step order, the order of the accumulation the bits rest on.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.analysis.findings import Finding, finding

CHECK = "levels"


def verify_level_order(
    plan, order, *, level: str = "fast", slack: Optional[int] = None
) -> List[Finding]:
    """Audit ``order`` (a level order of ``plan``) against the plan.
    ``slack`` is the run length the bind expects; ``None`` reads it from
    the plan: the certificate's slack where ``plan.elastic`` is attached
    (the elastic bind), else 1 (the bulk bind)."""
    out: List[Finding] = []
    if slack is None:
        ep = getattr(plan, "elastic", None)
        slack = 1 if ep is None else int(ep.slack)
    n, k = int(plan.n), int(plan.k)
    row_ids = np.asarray(plan.row_ids)
    accum = np.asarray(plan.accum)
    T = row_ids.shape[0]
    flat_rows = row_ids.reshape(-1).astype(np.int64)
    perm = np.asarray(order.perm, dtype=np.int64).reshape(-1)
    vert_ptr = np.asarray(order.vert_ptr, dtype=np.int64).reshape(-1)
    level_ptr = np.asarray(order.level_ptr, dtype=np.int64).reshape(-1)
    level_run = np.asarray(order.level_run, dtype=np.int64).reshape(-1)
    P = perm.size

    if int(order.slack) != int(slack):
        out.append(finding(
            CHECK, "LEVEL_SLACK",
            f"order is over runs of {int(order.slack)} supersteps, the "
            f"bind walks runs of {int(slack)}",
        ))

    # ---- perm: a bijection onto the real lane-steps ----------------------
    real = flat_rows < n
    if P and (perm.min() < 0 or perm.max() >= T * k):
        out.append(finding(
            CHECK, "LEVEL_PERM",
            f"{int(((perm < 0) | (perm >= T * k)).sum())} perm entries "
            f"outside the plan's {T * k} lane-steps",
        ))
        return out
    cnt = np.bincount(perm, minlength=T * k)
    pad_hit = int((cnt[~real] > 0).sum())
    miss_or_dup = int((cnt[real] != 1).sum())
    if pad_hit or miss_or_dup:
        out.append(finding(
            CHECK, "LEVEL_PERM",
            f"perm is not a bijection onto the {int(real.sum())} real "
            f"lane-steps ({miss_or_dup} walked other than once, "
            f"{pad_hit} padding lane-steps walked)",
        ))
        return out

    # ---- pointers: strictly rising covers ------------------------------
    V = vert_ptr.size - 1
    L = level_ptr.size - 1
    if (
        V < 0 or vert_ptr[0] != 0 or vert_ptr[-1] != P
        or (np.diff(vert_ptr) <= 0).any()
    ):
        out.append(finding(
            CHECK, "LEVEL_PTR",
            f"vert_ptr is not a strictly rising cover of the {P} "
            "lane-steps",
        ))
        return out
    if (
        L < 0 or level_ptr[0] != 0 or level_ptr[-1] != V
        or (np.diff(level_ptr) <= 0).any() or level_run.size != L
    ):
        out.append(finding(
            CHECK, "LEVEL_PTR",
            f"level_ptr is not a strictly rising cover of the {V} "
            f"vertices with one run a level ({level_run.size} runs for "
            f"{L} levels)",
        ))
        return out
    if P == 0:
        return out

    # ---- vertices: one lane, one row, consecutive steps, one finish ----
    step, lane = np.divmod(perm, k)
    rows = flat_rows[perm]
    fin = ~accum.reshape(-1)[perm]
    sizes = np.diff(vert_ptr)
    vid = np.repeat(np.arange(V, dtype=np.int64), sizes)
    first = vert_ptr[:-1]
    smin = np.minimum.reduceat(step, first)
    smax = np.maximum.reduceat(step, first)
    sb = np.asarray(plan.step_bounds, dtype=np.int64)
    sup_of_step = np.repeat(np.arange(sb.size - 1, dtype=np.int64), np.diff(sb))
    split = (
        (lane != lane[first][vid]) | (rows != rows[first][vid])
        | (sup_of_step[step] != sup_of_step[smin][vid])
    )
    gap = (smax - smin + 1) != sizes  # distinct steps of one lane: a gap
    if split.any() or gap.any():
        out.append(finding(
            CHECK, "LEVEL_VERTEX_SPLIT",
            f"{int(np.unique(vid[split]).size + gap.sum())} vertices are "
            "not one consecutive run of steps of one lane and one row in "
            "one superstep",
        ))
    n_fin = np.add.reduceat(fin.astype(np.int64), first)
    fin_pos = np.flatnonzero(fin)
    fin_late = np.zeros(V, dtype=bool)
    fin_late[vid[fin_pos]] = step[fin_pos] == smax[vid[fin_pos]]
    bad_fin = (n_fin != 1) | ~fin_late
    if bad_fin.any():
        v = int(np.flatnonzero(bad_fin)[0])
        out.append(finding(
            CHECK, "LEVEL_VERTEX_FINISH",
            f"{int(bad_fin.sum())} vertices do not end in exactly one "
            f"finishing step, their last (e.g. vertex {v}: "
            f"{int(n_fin[v])} finishing steps)",
        ))
    fin_rows = rows[fin_pos]
    per_row = np.bincount(fin_rows, minlength=n)[:n]
    if (per_row != 1).any():
        out.append(finding(
            CHECK, "LEVEL_ROW_FINISH",
            f"{int((per_row != 1).sum())} rows finished by other than "
            f"one vertex (rows {_ex(np.flatnonzero(per_row != 1))})",
        ))

    # ---- runs: level_run is superstep // slack of every vertex ---------
    if (np.diff(level_run) < 0).any():
        out.append(finding(
            CHECK, "LEVEL_RUN_ORDER",
            "level_run falls: a later level belongs to an earlier run",
        ))
    lvl_of_v = np.repeat(np.arange(L, dtype=np.int64), np.diff(level_ptr))
    v_run = sup_of_step[smin] // max(int(slack), 1)
    run_bad = v_run != level_run[lvl_of_v]
    if run_bad.any():
        v = int(np.flatnonzero(run_bad)[0])
        out.append(finding(
            CHECK, "LEVEL_RUN_MISMATCH",
            f"{int(run_bad.sum())} vertices sit in a level of another "
            f"run (e.g. vertex {v}: superstep // slack = {int(v_run[v])}, "
            f"level run {int(level_run[lvl_of_v[v]])})",
        ))
    if out or level != "full":
        return out

    # ---- full: plan order inside each vertex ---------------------------
    same_v = vid[1:] == vid[:-1]
    if (same_v & (step[1:] <= step[:-1])).any():
        out.append(finding(
            CHECK, "LEVEL_CHAIN_ORDER",
            f"{int(np.unique(vid[1:][same_v & (step[1:] <= step[:-1])]).size)}"
            " vertices walk their accum chain out of plan order",
        ))

    # ---- full: no read before write -------------------------------------
    # writer level of each row (n: the scratch slot, before every level)
    w_lvl = np.full(n + 1, -1, dtype=np.int64)
    w_lvl[fin_rows] = lvl_of_v[vid[fin_pos]]
    W = int(plan.W)
    cols = np.asarray(plan.col_idx).reshape(-1, W)[perm].astype(np.int64)
    cols = np.clip(cols, 0, n)  # out-of-range columns: the plan check's
    r_lvl = lvl_of_v[vid]
    early = w_lvl[cols] >= r_lvl[:, None]
    if early.any():
        i = int(np.flatnonzero(early.any(axis=1))[0])
        out.append(finding(
            CHECK, "LEVEL_READ_BEFORE_WRITE",
            f"{int(early.sum())} gathers read a row not finished at an "
            f"earlier level (e.g. lane-step {int(perm[i])} at level "
            f"{int(r_lvl[i])} reads a row of level "
            f"{int(w_lvl[cols[i]].max())})",
        ))
    return out


def _ex(idx: np.ndarray, limit: int = 4) -> str:
    """Format the first few indices of a violation."""
    return ", ".join(str(int(i)) for i in np.asarray(idx).ravel()[:limit])
