"""Rowshard checker — independent audit of ``RowShardPlan`` artifacts.

The cross-shard edge set is re-derived from the *global* ``ExecPlan``
(writer lanes + gather columns), never from the partitioner's own
tables, and the halo tables are then judged against it:

  * ownership — ``owner`` / ``local_slot`` match the writer-lane block
    partition and the (owner, global id) slot ordering the executor's
    ``b_scatter`` / ``x_gather`` maps rely on;
  * certificate — every cross-shard value is finalized in a strictly
    earlier exchange round than every read of it (re-derived
    writer-round < reader-round);
  * coverage — the halo tables ship *exactly* the cross-shard pair set:
    each (boundary row, consumer shard) pair exactly once, in a round
    at or after the writer's and strictly before the first reader's, in
    both lowered forms (ring and sparse-psum);
  * slot soundness — halo slots stay inside ``[n_loc, n_loc+n_halo)``,
    distinct boundary rows of one consumer never share a slot, ring and
    psum forms agree positionally, and padding stays on scratch;
  * locality — each shard-local plan is exactly the global plan's lane
    block remapped through (ownership + halo assignment); full level
    additionally audits every local plan with the plan sanitizer and
    compares the numeric tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.analysis.findings import Finding, finding
from repro_torch.analysis.plan_check import plan_writers, verify_exec_plan

CHECK = "rowshard"


def _pairs_from_plan(plan, owner_true, kl, round_of_sup, sup_of_step):
    """Cross-shard (row, consumer shard) pairs and first-reader rounds,
    derived from the global plan's gathers alone."""
    n = int(plan.n)
    col_idx = np.asarray(plan.col_idx).astype(np.int64)
    T, k, W = col_idx.shape
    lane3 = np.broadcast_to(
        np.arange(k, dtype=np.int64)[None, :, None], col_idx.shape
    )
    reader_shard = lane3 // kl
    owner_pad = np.concatenate(
        [owner_true, np.asarray([-1], dtype=np.int64)]
    )
    real = col_idx < n
    cross = real & (owner_pad[np.minimum(col_idx, n)] != reader_shard)
    u_all = col_idx[cross]
    d_all = reader_shard[cross]
    t3 = np.broadcast_to(
        np.arange(T, dtype=np.int64)[:, None, None], col_idx.shape
    )
    r_round = round_of_sup[sup_of_step[t3[cross]]]
    return u_all, d_all, r_round


def verify_rowshard(plan, rsp, *, level: str = "fast") -> List[Finding]:
    """Audit ``rsp`` (a ``RowShardPlan``) against the global ``plan`` it
    was partitioned from."""
    out: List[Finding] = []
    n = int(plan.n)
    ns, kl = int(rsp.n_shards), int(rsp.k_local)
    kp = ns * kl

    # ---- geometry -----------------------------------------------------
    if (
        int(rsp.n) != n or int(rsp.W) != int(plan.W)
        or int(rsp.T) != int(plan.n_steps) or kp < int(plan.k)
    ):
        out.append(finding(
            CHECK, "RS_GEOMETRY",
            f"partition geometry disagrees with the plan: n={rsp.n}/{n} "
            f"W={rsp.W}/{plan.W} T={rsp.T}/{plan.n_steps} "
            f"k={kp}(={ns}x{kl}) vs {plan.k}",
        ))
        return out
    sb = np.asarray(plan.step_bounds, dtype=np.int64)
    S = len(sb) - 1
    if tuple(int(x) for x in rsp.step_bounds) != tuple(int(x) for x in sb):
        out.append(finding(
            CHECK, "RS_GEOMETRY",
            "partition step_bounds differ from the plan's",
        ))
        return out
    fb = np.asarray(rsp.exchange_bounds, dtype=np.int64)
    if len(fb) < 2 or fb[0] != 0 or fb[-1] != S or (np.diff(fb) < 1).any():
        out.append(finding(
            CHECK, "RS_EXCHANGE_BOUNDS",
            f"exchange_bounds is not a strictly increasing superstep "
            f"cover of [0, {S}]: {fb.tolist()}",
        ))
        return out
    F = len(fb) - 1
    if len(rsp.rounds) != max(F - 1, 0):
        out.append(finding(
            CHECK, "RS_ROUND_COUNT",
            f"{len(rsp.rounds)} exchange rounds for {F} compute rounds "
            f"(expected {max(F - 1, 0)})",
        ))
        return out

    # ---- ownership (independent writer-lane derivation) ---------------
    w_step, w_lane, w_count = plan_writers(
        np.asarray(plan.row_ids), np.asarray(plan.accum), n
    )
    if (w_count != 1).any():
        out.append(finding(
            CHECK, "RS_PLAN_WRITERS",
            f"{int((w_count != 1).sum())} rows not finalized exactly "
            "once by the global plan — ownership is undefined "
            "(see the plan sanitizer findings)",
        ))
        return out
    owner_true = w_lane // kl
    if (np.asarray(rsp.owner, dtype=np.int64) != owner_true).any():
        bad = int((np.asarray(rsp.owner, np.int64) != owner_true).sum())
        out.append(finding(
            CHECK, "RS_OWNER_MISMATCH",
            f"{bad} rows assigned to a shard other than the one whose "
            "lane block finalizes them",
        ))
    counts = np.bincount(owner_true, minlength=ns)
    offs = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(owner_true, kind="stable")
    ls_true = np.empty(n, dtype=np.int64)
    ls_true[order] = (
        np.arange(n, dtype=np.int64) - offs[owner_true[order]]
    )
    if (np.asarray(rsp.local_slot, dtype=np.int64) != ls_true).any():
        bad = int((np.asarray(rsp.local_slot, np.int64) != ls_true).sum())
        out.append(finding(
            CHECK, "RS_SLOT_MISMATCH",
            f"{bad} rows at a local slot that breaks the (owner, global "
            "id) ordering b_scatter/x_gather assume",
        ))
    if int(rsp.n_loc) != max(int(counts.max()), 1):
        out.append(finding(
            CHECK, "RS_GEOMETRY",
            f"n_loc={rsp.n_loc} but the largest shard owns "
            f"{int(counts.max())} rows",
        ))
    if out:
        return out  # the maps below would cascade misleading findings

    n_loc, n_halo = int(rsp.n_loc), int(rsp.n_halo)
    scratch = n_loc + n_halo

    # ---- cross-shard pair set + certificate ---------------------------
    round_of_sup = np.repeat(np.arange(F, dtype=np.int64), np.diff(fb))
    sup_of_step = np.repeat(np.arange(S, dtype=np.int64), np.diff(sb))
    writer_round = round_of_sup[sup_of_step[w_step]]
    u_all, d_all, r_rounds = _pairs_from_plan(
        plan, owner_true, kl, round_of_sup, sup_of_step
    )
    key = u_all * ns + d_all
    ukey, inv = (
        np.unique(key, return_inverse=True)
        if key.size else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    )
    P = len(ukey)
    u_h, dst_h = ukey // ns, ukey % ns
    min_rd = np.full(P, F, dtype=np.int64)
    if key.size:
        np.minimum.at(min_rd, inv, r_rounds)
    wr_pair = writer_round[u_h] if P else np.zeros(0, np.int64)
    bad = wr_pair >= min_rd
    if bad.any():
        g = int(u_h[bad][0])
        out.append(finding(
            CHECK, "RS_CERT_VIOLATION",
            f"{int(bad.sum())} boundary rows are read across shards in "
            f"or before the exchange round that writes them (e.g. row "
            f"{g}: written round {int(writer_round[g])}, first read "
            f"round {int(min_rd[bad][0])})",
        ))
    if int(rsp.halo_pairs) != P:
        out.append(finding(
            CHECK, "RS_HALO_COUNT",
            f"partition claims {int(rsp.halo_pairs)} halo pairs, the "
            f"plan's cross-shard edge set has {P}",
        ))

    # ---- halo table audit (both lowered forms) ------------------------
    glob_of = np.full((ns, max(n_loc, 1)), -1, dtype=np.int64)
    glob_of[owner_true, ls_true] = np.arange(n, dtype=np.int64)

    ship_cnt = np.zeros(P, dtype=np.int64)  # psum shipments per pair
    ship_slot = np.full(P, -1, dtype=np.int64)
    ring_cnt = np.zeros(P, dtype=np.int64)
    ring_slot = np.full(P, -1, dtype=np.int64)

    def pair_lookup(rows, dsts, form, r):
        """Map shipped (row, dst) to pair ids; flag pairs the plan's
        edge set does not contain."""
        pk = rows * ns + dsts
        j = np.searchsorted(ukey, pk)
        ok = (j < P) & (ukey[np.minimum(j, max(P - 1, 0))] == pk) if P \
            else np.zeros(len(pk), dtype=bool)
        if (~ok).any():
            out.append(finding(
                CHECK, "RS_HALO_EXTRA",
                f"round {r} {form} tables ship {int((~ok).sum())} "
                "(row, shard) pairs outside the cross-shard edge set",
            ))
        return j, ok

    def check_timing(j, r, form):
        early = r < wr_pair[j]
        if early.any():
            out.append(finding(
                CHECK, "RS_HALO_EARLY",
                f"round {r} {form} tables ship {int(early.sum())} rows "
                "before the round that finalizes them (stale value)",
            ))
        late = r >= min_rd[j]
        if late.any():
            out.append(finding(
                CHECK, "RS_HALO_LATE",
                f"round {r} {form} tables ship {int(late.sum())} rows "
                "at or after their first cross-shard read",
            ))

    for r, rd in enumerate(rsp.rounds):
        # -- sparse-psum form: send side builds the pos -> row map
        ss = np.asarray(rd.send_slot, dtype=np.int64)
        sp_ = np.asarray(rd.send_pos, dtype=np.int64)
        src_row = np.broadcast_to(
            np.arange(ns, dtype=np.int64)[:, None], ss.shape
        )
        realS = ss != scratch
        R = int(rd.buf_size)
        pos_row = np.full(R, -1, dtype=np.int64)
        if ((ss[realS] < 0) | (ss[realS] >= n_loc)).any():
            out.append(finding(
                CHECK, "RS_SEND_SLOT",
                f"round {r} psum send slots outside the owned region",
            ))
        else:
            su = glob_of[src_row[realS], ss[realS]]
            sposes = sp_[realS]
            if (su < 0).any():
                out.append(finding(
                    CHECK, "RS_SEND_NOT_OWNED",
                    f"round {r} psum send slots name unoccupied owned "
                    "slots",
                ))
            elif ((sposes < 0) | (sposes >= R)).any():
                out.append(finding(
                    CHECK, "RS_PSUM_SEND",
                    f"round {r} psum send positions outside the "
                    f"boundary buffer [0, {R})",
                ))
            else:
                occupied = np.bincount(sposes, minlength=R)
                if (occupied > 1).any() or (occupied == 0).any():
                    out.append(finding(
                        CHECK, "RS_PSUM_SEND",
                        f"round {r} psum buffer positions not covered "
                        "exactly once by senders "
                        f"({int((occupied != 1).sum())} positions)",
                    ))
                pos_row[sposes] = su

        # -- sparse-psum form: recv side ships pairs
        rs_ = np.asarray(rd.recv_slot, dtype=np.int64)
        rp = np.asarray(rd.recv_pos, dtype=np.int64)
        dst_row = np.broadcast_to(
            np.arange(ns, dtype=np.int64)[:, None], rs_.shape
        )
        realR = rs_ != scratch
        if ((rs_[realR] < n_loc) | (rs_[realR] >= scratch)).any():
            out.append(finding(
                CHECK, "RS_HALO_SLOT_RANGE",
                f"round {r} psum recv slots outside the halo region "
                f"[{n_loc}, {scratch})",
            ))
        elif ((rp[realR] < 0) | (rp[realR] >= R)).any() or (
            R and (pos_row[rp[realR]] < 0).any()
        ):
            out.append(finding(
                CHECK, "RS_PSUM_RECV",
                f"round {r} psum recv positions unmapped in the "
                "boundary buffer",
            ))
        else:
            ru = pos_row[rp[realR]]
            j, ok = pair_lookup(ru, dst_row[realR], "psum", r)
            jv = j[ok]
            np.add.at(ship_cnt, jv, 1)
            ship_slot[jv] = rs_[realR][ok]
            check_timing(jv, r, "psum")

        # -- ring form: positional correspondence per hop
        for (h, hss, hrt) in rd.hops:
            hss = np.asarray(hss, dtype=np.int64)
            hrt = np.asarray(hrt, dtype=np.int64)
            if hss.shape != hrt.shape:
                out.append(finding(
                    CHECK, "RS_RING_SHAPE",
                    f"round {r} hop {h}: send/recv tables have "
                    "different shapes",
                ))
                continue
            rows_i = np.broadcast_to(
                np.arange(ns, dtype=np.int64)[:, None], hss.shape
            )
            cols_p = np.broadcast_to(
                np.arange(hss.shape[1], dtype=np.int64)[None, :],
                hss.shape,
            )
            realH = hss != scratch
            # receiver entries aligned to each sender position
            rt_at = hrt[(rows_i + h) % ns, cols_p]
            pad_mismatch = realH != (rt_at != scratch)
            if pad_mismatch.any():
                out.append(finding(
                    CHECK, "RS_RING_PAD",
                    f"round {r} hop {h}: {int(pad_mismatch.sum())} "
                    "positions padded on one side only",
                ))
            hm = realH & (rt_at != scratch)
            if ((hss[hm] < 0) | (hss[hm] >= n_loc)).any():
                out.append(finding(
                    CHECK, "RS_SEND_SLOT",
                    f"round {r} hop {h}: ring send slots outside the "
                    "owned region",
                ))
                continue
            hu = glob_of[rows_i[hm], hss[hm]]
            if (hu < 0).any():
                out.append(finding(
                    CHECK, "RS_SEND_NOT_OWNED",
                    f"round {r} hop {h}: ring send slots name "
                    "unoccupied owned slots",
                ))
                continue
            hdst = (rows_i[hm] + h) % ns
            hslot = rt_at[hm]
            if ((hslot < n_loc) | (hslot >= scratch)).any():
                out.append(finding(
                    CHECK, "RS_HALO_SLOT_RANGE",
                    f"round {r} hop {h}: ring recv slots outside the "
                    f"halo region [{n_loc}, {scratch})",
                ))
                continue
            j, ok = pair_lookup(hu, hdst, "ring", r)
            jv = j[ok]
            np.add.at(ring_cnt, jv, 1)
            ring_slot[jv] = hslot[ok]
            check_timing(jv, r, "ring")

    for name, cnt in (("psum", ship_cnt), ("ring", ring_cnt)):
        if (cnt == 0).any():
            rows = u_h[cnt == 0][:4]
            out.append(finding(
                CHECK, "RS_HALO_MISSING",
                f"{int((cnt == 0).sum())} cross-shard pairs never "
                f"shipped by the {name} tables (e.g. rows "
                f"{', '.join(str(int(x)) for x in rows)})",
            ))
        if (cnt > 1).any():
            out.append(finding(
                CHECK, "RS_HALO_DUP",
                f"{int((cnt > 1).sum())} cross-shard pairs shipped more "
                f"than once by the {name} tables",
            ))

    both = (ship_slot >= 0) & (ring_slot >= 0)
    if (ship_slot[both] != ring_slot[both]).any():
        out.append(finding(
            CHECK, "RS_RING_MISALIGNED",
            f"{int((ship_slot[both] != ring_slot[both]).sum())} pairs "
            "land on different halo slots in ring vs psum form",
        ))
    # one halo slot per (consumer, boundary row): distinct rows of one
    # consumer must not share a slot, or a later arrival overwrites an
    # earlier value that is still being read
    halo_slot = np.where(ship_slot >= 0, ship_slot, ring_slot)
    have = halo_slot >= 0
    if have.any():
        skey = dst_h[have] * (scratch + 1) + halo_slot[have]
        if len(np.unique(skey)) != int(have.sum()):
            out.append(finding(
                CHECK, "RS_HALO_SLOT_CLASH",
                "two boundary rows of one consumer shard share a halo "
                "slot",
            ))

    # ---- local plans: global lane blocks remapped through the halo map
    out.extend(_verify_local_plans(
        plan, rsp, owner_true, ls_true, u_h, dst_h, halo_slot, level=level
    ))
    return out


def _verify_local_plans(
    plan, rsp, owner_true, ls_true, u_h, dst_h, halo_slot, *, level: str
) -> List[Finding]:
    """Each shard's local plan must be the global plan's lane block with
    rows/cols remapped through (ownership + the tables' halo slots)."""
    out: List[Finding] = []
    n = int(plan.n)
    ns, kl = int(rsp.n_shards), int(rsp.k_local)
    kp, k = ns * kl, int(plan.k)
    T = int(plan.n_steps)
    n_loc, n_halo = int(rsp.n_loc), int(rsp.n_halo)
    scratch = n_loc + n_halo

    g2l = np.full((ns, n + 1), scratch, dtype=np.int64)
    g2l[owner_true, np.arange(n)] = ls_true
    have = halo_slot >= 0
    g2l[dst_h[have], u_h[have]] = halo_slot[have]

    def padk(a, fill):
        if kp == k:
            return np.asarray(a)
        a = np.asarray(a)
        block = np.full((T, kp - k, *a.shape[2:]), fill, dtype=a.dtype)
        return np.concatenate([a, block], axis=1)

    # clip into the g2l domain: an out-of-range id (a corrupt plan — the
    # plan sanitizer owns that finding) lands on scratch instead of
    # crashing the remap comparison
    rows_p = np.clip(padk(plan.row_ids, n), 0, n)
    cols_p = np.clip(padk(plan.col_idx, n), 0, n)
    if level == "full":
        vals_p = padk(plan.vals, 0)
        diag_p = padk(plan.diag, 1)
        acc_p = padk(plan.accum, False)

    for j, sp in enumerate(rsp.shards):
        lanes = slice(j * kl, (j + 1) * kl)
        if (
            int(sp.n) != scratch or int(sp.k) != kl
            or int(sp.W) != int(plan.W) or int(sp.n_steps) != T
        ):
            out.append(finding(
                CHECK, "RS_LOCAL_GEOMETRY",
                f"shard {j} local plan geometry disagrees with the "
                f"partition (n={sp.n}/{scratch}, k={sp.k}/{kl})",
            ))
            continue
        exp_rows = g2l[j, rows_p[:, lanes]]
        if (np.asarray(sp.row_ids, np.int64) != exp_rows).any():
            out.append(finding(
                CHECK, "RS_LOCAL_ROWS",
                f"shard {j} local row slots differ from the remapped "
                "global lane block",
            ))
        exp_cols = g2l[j, cols_p[:, lanes]]
        if (np.asarray(sp.col_idx, np.int64) != exp_cols).any():
            out.append(finding(
                CHECK, "RS_LOCAL_COLS",
                f"shard {j} local gather slots differ from the "
                "ownership + halo-table remap",
            ))
        if level == "full":
            num_ok = (
                np.array_equal(np.asarray(sp.vals), vals_p[:, lanes])
                and np.array_equal(np.asarray(sp.diag), diag_p[:, lanes])
                and np.array_equal(np.asarray(sp.accum), acc_p[:, lanes])
            )
            if not num_ok:
                out.append(finding(
                    CHECK, "RS_LOCAL_NUMERIC",
                    f"shard {j} numeric tensors differ bitwise from the "
                    "global plan's lane block",
                ))
            for f in verify_exec_plan(
                sp, None, level="fast", expect_coverage=False,
            ):
                out.append(dataclasses.replace(
                    f, where=f.where + (("shard", str(j)),)
                ))
    return out
