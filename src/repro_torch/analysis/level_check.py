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

On a mesh (the distributed backend) each position binds its own plan —
a lane of the plan, or a shard's local plan — which finishes only some
rows (``rows=``), and walks it in exchange rounds, one range of levels a
round. ``verify_round_ranges`` checks those ranges: they partition the
levels in order, and round r's range holds exactly the levels whose run
lies in the round's supersteps.

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
    plan, order, *, level: str = "fast", slack: Optional[int] = None, rows=None
) -> List[Finding]:
    """Audit ``order`` (a level order of ``plan``) against the plan.
    ``slack`` is the run length the bind expects; ``None`` reads it from
    the plan: the certificate's slack where ``plan.elastic`` is attached
    (the elastic bind), else 1 (the bulk bind). ``rows`` are the rows the
    plan must finish, each by exactly one vertex (``None``: every row
    ``0..n-1``; a mesh position's plan finishes only its own)."""
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
    owned = None if rows is None else np.asarray(rows, dtype=np.int64).reshape(-1)
    if owned is not None and owned.size and (owned.min() < 0 or owned.max() >= n):
        raise ValueError(f"rows must lie in [0, {n})")

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
    expect = np.ones(n, dtype=np.int64)
    if owned is not None:
        expect[:] = 0
        expect[owned] = 1
    if (per_row != expect).any():
        out.append(finding(
            CHECK, "LEVEL_ROW_FINISH",
            f"{int((per_row != expect).sum())} rows finished by other than "
            f"the expected one vertex (rows "
            f"{_ex(np.flatnonzero(per_row != expect))})",
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


def verify_round_ranges(order, bounds, ranges) -> List[Finding]:
    """Audit the exchange rounds' level ranges of a mesh position's order:
    ``ranges`` (int[F+1]) rise from 0 to the level count, and round r's
    range ``[ranges[r], ranges[r+1])`` holds exactly the levels whose run
    (a superstep, in the bulk order) lies in ``[bounds[r], bounds[r+1])``
    — ``bounds`` being the round's superstep bounds. A level walked in the
    wrong round reads a halo or gathered row before its exchange, or
    finishes a row after the exchange that should carry it."""
    out: List[Finding] = []
    level_run = np.asarray(order.level_run, dtype=np.int64).reshape(-1)
    rng = np.asarray(ranges, dtype=np.int64).reshape(-1)
    eb = np.asarray(bounds, dtype=np.int64).reshape(-1)
    L = level_run.size
    if int(order.slack) != 1:
        out.append(finding(
            CHECK, "LEVEL_ROUND_RANGE",
            f"round ranges cut the bulk order (slack 1); this order is over "
            f"runs of {int(order.slack)} supersteps",
        ))
        return out
    if (
        rng.size != eb.size or rng.size < 2 or rng[0] != 0 or rng[-1] != L
        or (np.diff(rng) < 0).any()
    ):
        out.append(finding(
            CHECK, "LEVEL_ROUND_RANGE",
            f"round ranges {_ex(rng, 8)} do not rise from 0 to the {L} levels "
            f"in {eb.size - 1} rounds",
        ))
        return out
    round_of_level = np.repeat(np.arange(rng.size - 1, dtype=np.int64), np.diff(rng))
    wrong = (level_run < eb[round_of_level]) | (level_run >= eb[round_of_level + 1])
    if wrong.any():
        lv = int(np.flatnonzero(wrong)[0])
        out.append(finding(
            CHECK, "LEVEL_ROUND_RANGE",
            f"{int(wrong.sum())} levels walked in a round that does not hold "
            f"their superstep (e.g. level {lv}: superstep {int(level_run[lv])}, "
            f"round {int(round_of_level[lv])} covers supersteps "
            f"[{int(eb[round_of_level[lv]])}, {int(eb[round_of_level[lv] + 1])}))",
        ))
    return out


def _ex(idx: np.ndarray, limit: int = 4) -> str:
    """Format the first few indices of a violation."""
    return ", ".join(str(int(i)) for i in np.asarray(idx).ravel()[:limit])
