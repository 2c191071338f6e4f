"""Schedule race detector — independent BSP validity check (paper Def. 2.1).

The dependency edge set is re-derived directly from the raw CSR arrays
of the lower-triangular matrix (an entry ``L[v, u]`` with ``u < v`` is
the edge ``u -> v``), NOT from ``sparse.dag`` — the DAG builder is part
of the pipeline under audit.  For every edge ``u -> v`` a valid BSP
schedule must satisfy:

  * ``sigma(u) <= sigma(v)``                       (no backward edge);
  * ``pi(u) != pi(v)  =>  sigma(u) < sigma(v)``    (cross-core values
    only travel through a superstep barrier — same-step cross-core is a
    race);
  * same (superstep, core): ``rank(u) < rank(v)``  (in-chain sequential
    order must respect the dependency).

``verify_reorder`` audits the §5 reordering: the permutation is a
bijection, the post-reorder schedule is exactly the pre-reorder one
relabeled through it, and new vertex ids are nondecreasing in
(superstep, core, rank) order — the property the executor's slot
layout relies on.

Levels: ``fast`` keeps the O(n) screen (sizes, core/superstep bounds,
reorder bijection and monotone order); ``full`` adds the O(nnz) edge
sweep (backward edges, cross-core races, chain order), the rank
collision census and the relabel pullback.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.analysis.findings import Finding, finding

CHECK = "schedule"


def strict_lower_edges(L) -> tuple:
    """Dependency edges (u, v) from raw CSR arrays: one per strictly
    lower-triangular entry L[v, u]."""
    indptr = np.asarray(L.indptr, dtype=np.int64)
    indices = np.asarray(L.indices, dtype=np.int64)
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    mask = indices < rows
    return indices[mask], rows[mask]  # u (source), v (target)


def verify_schedule(L, sched, *, level: str = "full") -> List[Finding]:
    """Race-detect ``sched`` against the matrix it claims to schedule."""
    out: List[Finding] = []
    n = len(np.asarray(L.indptr)) - 1
    pi = np.asarray(sched.pi)
    sigma = np.asarray(sched.sigma)
    rank = np.asarray(sched.rank)
    k = int(sched.k)
    S = int(sched.n_supersteps)

    if not (len(pi) == len(sigma) == len(rank) == n):
        out.append(finding(
            CHECK, "SCHED_SIZE",
            f"schedule arrays cover {len(pi)}/{len(sigma)}/{len(rank)} "
            f"vertices, matrix has {n} rows",
        ))
        return out
    if n and (pi.min() < 0 or pi.max() >= k):
        bad = (pi < 0) | (pi >= k)
        out.append(finding(
            CHECK, "SCHED_CORE_OOB",
            f"{int(bad.sum())} vertices assigned to cores outside "
            f"[0, {k})",
        ))
    if n and (sigma.min() < 0 or sigma.max() >= S):
        bad = (sigma < 0) | (sigma >= S)
        out.append(finding(
            CHECK, "SCHED_STEP_OOB",
            f"{int(bad.sum())} vertices assigned to supersteps outside "
            f"[0, {S})",
        ))
    if out or level != "full":
        return out

    u, v = strict_lower_edges(L)
    su, sv = sigma[u], sigma[v]
    back = su > sv
    if back.any():
        i = np.nonzero(back)[0][0]
        out.append(finding(
            CHECK, "SCHED_EDGE_BACKWARD",
            f"{int(back.sum())} dependency edges point to an earlier "
            f"superstep (e.g. {int(u[i])}@{int(su[i])} -> "
            f"{int(v[i])}@{int(sv[i])})",
        ))
    cross_race = (su == sv) & (pi[u] != pi[v])
    if cross_race.any():
        i = np.nonzero(cross_race)[0][0]
        out.append(finding(
            CHECK, "SCHED_RACE_CROSS_CORE",
            f"{int(cross_race.sum())} cross-core edges inside one "
            f"superstep (e.g. {int(u[i])} on core {int(pi[u[i]])} -> "
            f"{int(v[i])} on core {int(pi[v[i]])} in superstep "
            f"{int(su[i])})",
        ))
    chain = (su == sv) & (pi[u] == pi[v])
    chain_bad = chain & (rank[u] >= rank[v])
    if chain_bad.any():
        i = np.nonzero(chain_bad)[0][0]
        out.append(finding(
            CHECK, "SCHED_CHAIN_ORDER",
            f"{int(chain_bad.sum())} same-chain edges with "
            f"rank(u) >= rank(v) (e.g. {int(u[i])} rank "
            f"{int(rank[u[i]])} -> {int(v[i])} rank {int(rank[v[i]])})",
        ))
    # duplicate (superstep, core, rank) triples leave chain order to the
    # sort's tiebreak — deterministic with a stable sort, but fragile
    key = (sigma.astype(np.int64) * k + pi) * (
        int(rank.max()) + 2 if n else 1
    ) + rank
    if n and len(np.unique(key)) != n:
        out.append(finding(
            CHECK, "SCHED_RANK_COLLISION",
            "two vertices share (superstep, core, rank); chain order "
            "falls back to the sort tiebreak", severity="warn",
        ))
    return out


def verify_reorder(
    perm: np.ndarray,
    sched_after,
    sched_before=None,
    *,
    level: str = "full",
) -> List[Finding]:
    """Audit the §5 reorder permutation against the relabeled schedule.

    ``perm`` maps new vertex id -> old vertex id (``schedule_order``'s
    convention: position i of the lexsorted order).  ``sched_after`` is
    the post-reorder schedule; ``sched_before``, when given, must equal
    ``sched_after`` pulled back through the permutation.
    """
    out: List[Finding] = []
    perm = np.asarray(perm)
    n = len(perm)
    bijective = True
    if n:
        if int(perm.min()) < 0 or int(perm.max()) >= n:
            bijective = False
        else:
            seen = np.zeros(n, dtype=bool)
            seen[perm] = True
            bijective = bool(seen.all())
    if not bijective:
        counts = np.bincount(
            np.clip(perm, 0, n - 1).astype(np.int64), minlength=n
        )
        out.append(finding(
            "reorder", "REORDER_NOT_BIJECTION",
            f"permutation over {n} vertices is not a bijection "
            f"({int((counts != 1).sum())} ids repeated or missing)",
        ))
        return out
    sig = np.asarray(sched_after.sigma)
    pi = np.asarray(sched_after.pi)
    rank = np.asarray(sched_after.rank)
    if len(sig) != n:
        out.append(finding(
            "reorder", "REORDER_SIZE",
            f"permutation covers {n} vertices, schedule {len(sig)}",
        ))
        return out
    if n > 1:
        ds, dp, dr = np.diff(sig), np.diff(pi), np.diff(rank)
        eq = ds == 0
        viol = (ds < 0) | (eq & (dp < 0)) | (eq & (dp == 0) & (dr < 0))
        if viol.any():
            i = int(np.nonzero(viol)[0][0])
            out.append(finding(
                "reorder", "REORDER_ORDER_MISMATCH",
                f"relabeled vertex ids are not sorted by (superstep, "
                f"core, rank): first violation between new ids {i} and "
                f"{i + 1}",
            ))
    if sched_before is not None and level == "full":
        sb = np.asarray(sched_before.sigma, dtype=np.int64)
        pb = np.asarray(sched_before.pi, dtype=np.int64)
        rb = np.asarray(sched_before.rank, dtype=np.int64)
        if len(sb) != n:
            out.append(finding(
                "reorder", "REORDER_SIZE",
                f"pre-reorder schedule covers {len(sb)} vertices, "
                f"permutation {n}",
            ))
        elif (
            (sb[perm] != sig).any() or (pb[perm] != pi).any()
            or (rb[perm] != rank).any()
        ):
            out.append(finding(
                "reorder", "REORDER_RELABEL_MISMATCH",
                "post-reorder schedule is not the pre-reorder schedule "
                "relabeled through the permutation",
            ))
    return out


def verify_schedule_report(
    L, sched, perm: Optional[np.ndarray] = None, *, level: str = "full",
):
    """Convenience wrapper returning a findings list for (matrix,
    schedule) plus an optional reorder permutation of a *separate*
    original schedule."""
    out = verify_schedule(L, sched, level=level)
    if perm is not None:
        out.extend(verify_reorder(perm, sched, level=level))
    return out
