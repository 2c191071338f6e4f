"""Reordering for locality (paper §5).

After scheduling, relabel vertices by (superstep, core, in-chain rank) and
symmetrically permute the matrix and RHS. The permutation is a topological
order (Def. 2.1 + in-chain order), so the permuted matrix stays lower
triangular, and rows computed together on one core become contiguous —
contiguous CSR tiles and contiguous x writes on the executor side.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schedule import Schedule
from repro_torch.sparse.csr import CSRMatrix, permute_symmetric


@dataclasses.dataclass(frozen=True)
class Reordering:
    perm: np.ndarray  # perm[new_id] = old_id
    inv: np.ndarray  # inv[old_id] = new_id


def schedule_order(s: Schedule) -> Reordering:
    """Vertices sorted by (sigma, pi, rank) — §5's traversal order."""
    perm = np.lexsort((s.rank, s.pi, s.sigma)).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(s.n, dtype=np.int64)
    return Reordering(perm=perm, inv=inv)


def apply_reordering(
    L: CSRMatrix, s: Schedule, b: np.ndarray | None = None
):
    """Permute matrix (and optionally RHS) by the schedule order; returns
    (L', schedule', b' | None, reordering). ``schedule'`` relabels pi/sigma
    onto the new IDs; the solve of L'x' = b' satisfies x = x'[inv]."""
    r = schedule_order(s)
    L2 = permute_symmetric(L, r.perm)
    s2 = Schedule(
        n=s.n,
        k=s.k,
        pi=s.pi[r.perm].copy(),
        sigma=s.sigma[r.perm].copy(),
        rank=s.rank[r.perm].copy(),
        n_supersteps=s.n_supersteps,
    )
    b2 = None if b is None else np.asarray(b)[r.perm]
    return L2, s2, b2, r
