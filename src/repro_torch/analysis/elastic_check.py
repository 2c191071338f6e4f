"""Elastic certificate checker — soundness audit of ``ElasticPlan``.

The certificate is judged against dependencies re-derived from the
``ExecPlan`` tensors alone (writer map + gather columns), never against
``core.elastic``'s own helpers.  The verifier checks *soundness*, not
bit-identity with the producer: a more conservative certificate (later
readiness, smaller waves, shorter fused runs) is still valid — what can
never happen is a step running before its inputs exist.

Proved properties:

  * geometry — ``M = ceil(T / slack)``, wave ids start at 0 and grow by
    at most 1 per in-window step, ``n_waves`` matches;
  * readiness soundness — the certified ``ready_step[t]`` is never
    *earlier* than the true earliest step at which every gathered value
    exists (an underestimate lets an elastic worker read garbage);
  * wave independence — every step of a wave has its dependencies
    resolved before the wave's first step, so the wave's steps are
    mutually independent (no intra-wave dependency);
  * accum ordering — a step whose predecessor carries a partial-sum
    accumulator in any lane must start a new wave (the carry forces
    sequential order even when gathers are ready);
  * fused-run soundness — within a fused superstep run no superstep
    reads a cross-core value written inside the run, and runs respect
    the ``slack`` staleness cap.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.analysis.findings import Finding, finding
from repro_torch.analysis.plan_check import plan_writers

CHECK = "elastic"


def true_ready_steps(plan) -> np.ndarray:
    """Independent readiness derivation: for each plan step, the
    earliest step at which all its real gathers are valid —
    ``max(writer_step[col] + 1)``, 0 with no real gathers."""
    row_ids = np.asarray(plan.row_ids)
    col_idx = np.asarray(plan.col_idx).astype(np.int64)
    accum = np.asarray(plan.accum)
    n = int(plan.n)
    T = row_ids.shape[0]
    if T == 0:
        return np.zeros(0, dtype=np.int64)
    w_step, _, _ = plan_writers(row_ids, accum, n)
    ws_pad = np.concatenate([w_step, np.asarray([-1], dtype=np.int64)])
    ws = np.where(col_idx < n, ws_pad[np.minimum(col_idx, n)], -1)
    return (ws.max(axis=(1, 2)) + 1).astype(np.int64)


def verify_elastic(plan, ep, *, level: str = "fast") -> List[Finding]:
    """Audit elastic certificate ``ep`` against ``plan``."""
    out: List[Finding] = []
    T = int(plan.n_steps)
    slack = int(ep.slack)
    if slack < 1:
        out.append(finding(
            CHECK, "ELASTIC_SLACK", f"slack must be >= 1, got {slack}",
        ))
        return out
    M_true = max(1, -(-T // slack))
    wave = np.asarray(ep.wave_id)
    n_waves = np.asarray(ep.n_waves)
    ready_cert = np.asarray(ep.ready_step, dtype=np.int64)
    if (
        int(ep.n_steps) != T
        or int(ep.n_macro_steps) != M_true
        or wave.shape != (M_true, slack)
        or n_waves.shape != (M_true,)
        or ready_cert.shape != (T,)
    ):
        out.append(finding(
            CHECK, "ELASTIC_GEOMETRY",
            f"certificate geometry disagrees with the plan: T={T}, "
            f"slack={slack} implies M={M_true}, certificate claims "
            f"M={int(ep.n_macro_steps)} wave_id{tuple(wave.shape)}",
        ))
        return out
    if int(ep.n_supersteps) != int(plan.n_supersteps):
        out.append(finding(
            CHECK, "ELASTIC_GEOMETRY",
            f"certificate superstep count {int(ep.n_supersteps)} != "
            f"plan {int(plan.n_supersteps)}",
        ))

    # wave ids: start at 0, nondecreasing, step by at most 1
    if T and (wave[:, 0] != 0).any():
        out.append(finding(
            CHECK, "ELASTIC_WAVE_BASE",
            "a window's first step is not wave 0",
        ))
    if slack > 1:
        d = np.diff(wave, axis=1)
        if ((d < 0) | (d > 1)).any():
            out.append(finding(
                CHECK, "ELASTIC_WAVE_MONOTONE",
                "wave ids must grow by 0 or 1 per in-window step",
            ))
    if T and (n_waves != wave[:, -1] + 1).any():
        out.append(finding(
            CHECK, "ELASTIC_WAVE_COUNT",
            "n_waves disagrees with the last wave id per window",
        ))
    if out:
        return out

    ready_true = true_ready_steps(plan)
    under = ready_cert < ready_true
    if under.any():
        i = int(np.nonzero(under)[0][0])
        out.append(finding(
            CHECK, "ELASTIC_READY_UNDERESTIMATE",
            f"{int(under.sum())} steps certified ready before their "
            f"inputs exist (e.g. step {i}: certified "
            f"{int(ready_cert[i])}, true {int(ready_true[i])})",
        ))
    over = ready_cert > np.arange(T, dtype=np.int64)
    if over.any():
        out.append(finding(
            CHECK, "ELASTIC_READY_UNSATISFIABLE",
            f"{int(over.sum())} steps certified ready only after their "
            "own position (the schedule itself would deadlock)",
        ))

    # wave independence: every step's TRUE dependencies must resolve
    # before its wave's first step (the wave executes concurrently)
    pad = M_true * slack - T
    ready_p = np.concatenate([
        ready_true, np.zeros(pad, dtype=np.int64)
    ]).reshape(M_true, slack)
    base = np.arange(M_true, dtype=np.int64)[:, None] * slack
    pos = np.arange(slack, dtype=np.int64)[None, :]
    abs_step = base + pos
    head = np.zeros((M_true, slack), dtype=bool)
    head[:, 0] = True
    if slack > 1:
        head[:, 1:] = wave[:, 1:] != wave[:, :-1]
    # absolute step of each step's wave head, via cummax over head marks
    head_step = np.maximum.accumulate(
        np.where(head, abs_step, -1), axis=1
    )
    realm = abs_step < T
    viol = realm & (ready_p > head_step)
    if viol.any():
        t = int(abs_step[viol][0])
        out.append(finding(
            CHECK, "ELASTIC_INTRA_WAVE_DEP",
            f"{int(viol.sum())} steps depend on a value produced inside "
            f"their own wave (e.g. step {t}: ready "
            f"{int(ready_p[viol][0])}, wave starts at "
            f"{int(head_step[viol][0])})",
        ))

    # accum carry: predecessor carrying a partial sum forces a wave break
    carry = np.zeros(T, dtype=bool)
    if T > 1:
        carry[1:] = np.asarray(plan.accum)[:-1].any(axis=1)
    carry_p = np.concatenate([carry, np.zeros(pad, dtype=bool)]).reshape(
        M_true, slack
    )
    fused_carry = carry_p & ~head & realm
    if fused_carry.any():
        t = int(abs_step[fused_carry][0])
        out.append(finding(
            CHECK, "ELASTIC_ACCUM_CHAIN_FUSED",
            f"{int(fused_carry.sum())} steps share a wave with a "
            f"predecessor that carries a partial-sum accumulator "
            f"(e.g. step {t}) — the accum chain order is lost",
        ))

    out.extend(_verify_fused_bounds(plan, ep))
    return out


def _verify_fused_bounds(plan, ep) -> List[Finding]:
    """Fused superstep runs: a run needs one barrier iff no superstep in
    it reads a cross-core value written inside the run.  Cross-core
    readiness is re-derived from the plan's writer map."""
    out: List[Finding] = []
    S = int(plan.n_supersteps)
    fb = np.asarray(ep.fused_bounds, dtype=np.int64)
    slack = int(ep.slack)
    if len(fb) < 1 or fb[0] != 0 or fb[-1] != S or (np.diff(fb) <= 0).any():
        out.append(finding(
            CHECK, "ELASTIC_FUSED_BOUNDS",
            f"fused_bounds is not a strictly monotone cover of [0, {S}]",
        ))
        return out
    runs = np.diff(fb)
    if (runs > slack).any():
        out.append(finding(
            CHECK, "ELASTIC_RUN_TOO_LONG",
            f"{int((runs > slack).sum())} fused runs exceed the slack "
            f"cap of {slack} supersteps",
        ))
    if S == 0:
        return out

    row_ids = np.asarray(plan.row_ids)
    col_idx = np.asarray(plan.col_idx).astype(np.int64)
    accum = np.asarray(plan.accum)
    n = int(plan.n)
    T, k = row_ids.shape
    sb = np.asarray(plan.step_bounds, dtype=np.int64)
    sup_of_step = np.repeat(np.arange(S, dtype=np.int64), np.diff(sb))
    w_step, w_lane, _ = plan_writers(row_ids, accum, n)

    # cross-core readiness per reader superstep: latest writer superstep
    # (+1) over gathers whose writer lane differs from the reader lane
    lane3 = np.broadcast_to(
        np.arange(k, dtype=np.int64)[None, :, None], col_idx.shape
    )
    real = col_idx < n
    cols = np.minimum(col_idx, n - 1 if n else 0)
    cross = real & (w_lane[cols] != lane3) & (w_step[cols] >= 0)
    xready = np.zeros(S, dtype=np.int64)
    if cross.any():
        writer_sup = sup_of_step[w_step[cols[cross]]] + 1
        reader_sup = sup_of_step[np.broadcast_to(
            np.arange(T, dtype=np.int64)[:, None, None], col_idx.shape
        )[cross]]
        np.maximum.at(xready, reader_sup, writer_sup)

    # each superstep's cross-core inputs must exist before its run starts
    run_of_sup = np.repeat(np.arange(len(runs), dtype=np.int64), runs)
    run_start = fb[run_of_sup]
    viol = xready > run_start
    if viol.any():
        s = int(np.nonzero(viol)[0][0])
        out.append(finding(
            CHECK, "ELASTIC_FUSED_RACE",
            f"{int(viol.sum())} supersteps read cross-core values "
            f"written inside their own fused run (e.g. superstep {s}: "
            f"cross-ready {int(xready[s])}, run starts at "
            f"{int(run_start[s])})",
        ))
    return out
