"""Acyclicity-preserving DAG coarsening (paper §4).

* ``is_cascade`` — Def. 4.2 checker (used by tests to validate Prop. 4.3
  empirically on random partitions).
* ``funnel_partition`` — Algorithm 4.1: in-funnel coarsening by a reverse
  topological sweep; a vertex u joins the growing funnel U exactly when all
  of its children are already in U, so only the seed has outgoing cut edges
  and every member reaches the seed (in-funnel => cascade => Prop. 4.3
  applies). A size/weight cap keeps parts bounded (paper §4.2: without it, a
  single-sink DAG would collapse to one vertex).
* ``transitive_sparsify`` — the 'remove all long edges in triangles'
  approximate transitive reduction of SpMP [PSSD14 §2.3], O(sum_v deg(v)^2),
  applied before coarsening to expose larger funnels.
* ``coarsen_dag`` / ``pull_back_schedule`` — quotient graph construction
  (Def. 4.1) and schedule pull-back to the fine DAG.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List

import numpy as np

from repro_torch.core.schedule import Schedule
from repro_torch.sparse.dag import SolveDAG, dag_from_edges, gather_ranges


# ---------------------------------------------------------------------------
# cascades (Def. 4.2)
# ---------------------------------------------------------------------------
def is_cascade(dag: SolveDAG, part: np.ndarray) -> bool:
    """Check Def. 4.2 for vertex subset ``part``: every vertex with an
    incoming cut edge must reach (via a directed walk inside G — which, for
    walks between members, can WLOG be taken inside the part's reachability)
    every vertex with an outgoing cut edge.

    Note Def. 4.2 allows the connecting walk to leave U; for DAGs a walk
    v ->* u that leaves U and re-enters is still a witness. We therefore
    check reachability in the full DAG restricted to descendants."""
    part = np.asarray(part, dtype=np.int64)
    in_part = np.zeros(dag.n, dtype=bool)
    in_part[part] = True
    has_in_cut = [
        v for v in part if any(not in_part[p] for p in dag.parents(v))
    ]
    has_out_cut = [
        v for v in part if any(not in_part[c] for c in dag.children(v))
    ]
    if not has_in_cut or not has_out_cut:
        return True
    # BFS descendants of each in-cut vertex; must cover all out-cut vertices
    targets = set(int(x) for x in has_out_cut)
    for v in has_in_cut:
        seen = {int(v)}
        stack = [int(v)]
        reached = {int(v)} & targets
        while stack and len(reached) < len(targets):
            x = stack.pop()
            for c in dag.children(x):
                c = int(c)
                if c not in seen:
                    seen.add(c)
                    if c in targets:
                        reached.add(c)
                    stack.append(c)
        if len(reached) < len(targets):
            return False
    return True


# ---------------------------------------------------------------------------
# transitive sparsification [PSSD14 §2.3]
# ---------------------------------------------------------------------------
def transitive_sparsify(dag: SolveDAG) -> SolveDAG:
    """Remove every edge (u, v) for which a triangle u -> w -> v exists.
    Scheduling on the sparsified DAG remains valid for the original (the
    removed dependency is implied transitively — see tests for the formal
    argument exercised empirically)."""
    keep_edges: List[np.ndarray] = []
    parent_sets = [set(int(p) for p in dag.parents(v)) for v in range(dag.n)]
    for v in range(dag.n):
        ps = dag.parents(v)
        if len(ps) == 0:
            continue
        pset = parent_sets[v]
        kept = [
            u
            for u in ps
            # u is redundant iff some other parent w of v has u as parent
            if not any(int(u) in parent_sets[w] for w in pset if w != int(u))
        ]
        if kept:
            arr = np.empty((len(kept), 2), dtype=np.int64)
            arr[:, 0] = kept
            arr[:, 1] = v
            keep_edges.append(arr)
    edges = (
        np.concatenate(keep_edges, axis=0)
        if keep_edges
        else np.empty((0, 2), dtype=np.int64)
    )
    return dag_from_edges(dag.n, edges, dag.weights)


# ---------------------------------------------------------------------------
# Algorithm 4.1 — in-funnel partition
# ---------------------------------------------------------------------------
def funnel_partition(
    dag: SolveDAG,
    *,
    max_size: int = 64,
    max_weight: float = np.inf,
) -> np.ndarray:
    """Partition V into in-funnels; returns part[v] = part id (0..P-1).

    Reverse-topological sweep; each unvisited seed v grows U by repeatedly
    popping the priority queue of vertices whose children are all in U
    (Alg. 4.1), until the size/weight cap."""
    # reverse topological order: for solve DAGs IDs are topological, but we
    # recompute generically from levels so coarse/pipeline DAGs work too.
    from repro_torch.sparse.dag import topological_levels

    levels = topological_levels(dag)
    order = np.argsort(levels, kind="stable")[::-1]  # deepest first

    out_deg = dag.out_degrees()
    visited = np.zeros(dag.n, dtype=bool)
    children_count = np.zeros(dag.n, dtype=np.int64)
    part = -np.ones(dag.n, dtype=np.int64)
    part_id = 0

    for v in order:
        v = int(v)
        if visited[v]:
            continue
        # grow funnel seeded at v
        members: List[int] = []
        weight = 0.0
        pq: List[int] = [v]
        touched: List[int] = []
        while pq:
            if len(members) >= max_size or weight >= max_weight:
                break
            w = heapq.heappop(pq)
            if visited[w]:
                continue
            members.append(w)
            weight += float(dag.weights[w])
            for u in dag.parents(w):
                u = int(u)
                if visited[u]:
                    continue
                children_count[u] += 1
                touched.append(u)
                if children_count[u] == out_deg[u]:
                    heapq.heappush(pq, u)
        for u in touched:
            children_count[u] = 0
        for w in members:
            visited[w] = True
            part[w] = part_id
        part_id += 1
    assert (part >= 0).all()
    return part


# ---------------------------------------------------------------------------
# quotient graph (Def. 4.1) and pull-back
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Coarsening:
    part: np.ndarray  # int64[n_fine] -> coarse id
    coarse: SolveDAG
    members: List[np.ndarray]  # coarse id -> sorted fine ids


def coarsen_dag(dag: SolveDAG, part: np.ndarray) -> Coarsening:
    part = np.asarray(part, dtype=np.int64)
    n_coarse = int(part.max()) + 1 if len(part) else 0
    # coarse edges: (part[u], part[v]) for fine edges, self-loops dropped
    v_of_edge = np.repeat(np.arange(dag.n, dtype=np.int64), np.diff(dag.parent_ptr))
    u_of_edge = dag.parent_idx
    cu, cv = part[u_of_edge], part[v_of_edge]
    mask = cu != cv
    edges = np.unique(np.stack([cu[mask], cv[mask]], axis=1), axis=0)
    weights = np.zeros(n_coarse, dtype=np.int64)
    np.add.at(weights, part, dag.weights)
    coarse = dag_from_edges(n_coarse, edges, weights)
    members = [np.sort(np.nonzero(part == c)[0]) for c in range(n_coarse)]
    return Coarsening(part=part, coarse=coarse, members=members)


def pull_back_schedule(c: Coarsening, coarse_sched: Schedule, n_fine: int) -> Schedule:
    """Pull a coarse schedule back to the fine DAG: every member of a part
    inherits (sigma, pi); in-chain order = coarse rank, then fine ID
    (ID order is topological inside a part for solve DAGs)."""
    pi = np.zeros(n_fine, dtype=np.int32)
    sigma = np.zeros(n_fine, dtype=np.int32)
    rank = np.zeros(n_fine, dtype=np.int64)
    # order parts per (superstep, core) chain by coarse rank
    chains = coarse_sched.chains()
    for (s, p), parts_in_order in chains.items():
        pos = 0
        for cp in parts_in_order:
            m = c.members[int(cp)]
            pi[m] = p
            sigma[m] = s
            rank[m] = np.arange(pos, pos + len(m))
            pos += len(m)
    return Schedule(
        n=n_fine,
        k=coarse_sched.k,
        pi=pi,
        sigma=sigma,
        rank=rank,
        n_supersteps=coarse_sched.n_supersteps,
    )
