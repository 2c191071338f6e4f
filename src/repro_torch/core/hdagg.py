"""HDagg-like baseline (Zarebavani et al. [ZCL+22]).

HDagg glues consecutive wavefronts into one superstep while a balanced
workload can be maintained. Its unit of placement is a *weakly-connected
component* of the sub-DAG induced by the glued window: placing whole
components on one core guarantees no cross-core dependency inside a
superstep (Def. 2.1 then holds within the superstep for free).

Window acceptance follows HDagg's balance test: after LPT bin-packing the
components onto k cores, the window is kept while
    max_p Omega_p  <=  tau * (sum_p Omega_p) / k.
If a single wavefront already violates the test (giant component), it is
still emitted (the algorithm must make progress) — exactly the failure mode
that makes HDagg collapse on narrow-band matrices (paper Table 7.1: 0.88x,
i.e. slower than serial).

The union-find over window components is incremental: gluing one more
wavefront only unions the new vertices' edges, so a full schedule is
O(|E| alpha(|V|) + #windows * k log k).

This is a faithful re-implementation of the published algorithm's scheduling
logic (not a binding of the original C++).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import Schedule
from repro_torch.sparse.dag import SolveDAG, gather_ranges, wavefronts


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _lpt_pack(comp_w: np.ndarray, k: int):
    """LPT bin-packing; returns (core per component, max load, total)."""
    order = np.argsort(-comp_w, kind="stable")
    loads = np.zeros(k, dtype=np.float64)
    comp_core = np.zeros(len(comp_w), dtype=np.int32)
    for c in order:
        p = int(np.argmin(loads))
        comp_core[c] = p
        loads[p] += comp_w[c]
    return comp_core, float(loads.max()), float(loads.sum())


def hdagg_schedule(
    dag: SolveDAG, k: int, *, balance_tau: float = 1.15
) -> Schedule:
    levels = wavefronts(dag)
    pi = np.zeros(dag.n, dtype=np.int32)
    sigma = np.zeros(dag.n, dtype=np.int32)
    rank = np.zeros(dag.n, dtype=np.int64)
    weights = dag.weights.astype(np.float64)

    uf = _UnionFind(dag.n)
    in_window = np.zeros(dag.n, dtype=bool)

    superstep = 0
    i = 0
    while i < len(levels):
        window_verts = [levels[i]]
        _absorb(dag, uf, in_window, levels[i])
        accepted = _try_pack(uf, np.concatenate(window_verts), weights, k, np.inf)
        j = i + 1
        while j < len(levels):
            _absorb(dag, uf, in_window, levels[j])
            cand_verts = np.concatenate(window_verts + [levels[j]])
            cand = _try_pack(uf, cand_verts, weights, k, balance_tau)
            if cand is None:
                # level j is evicted; _absorb re-initializes its union-find
                # roots when it seeds the next window, so the failed unions
                # cannot leak into later windows.
                in_window[levels[j]] = False
                break
            accepted = cand
            window_verts.append(levels[j])
            j += 1
        verts = np.concatenate(window_verts)
        cores = accepted
        sigma[verts] = superstep
        pi[verts] = cores
        order = np.argsort(verts, kind="stable")  # ID order is topological
        sv, sc = verts[order], cores[order]
        for p in range(k):
            sel = sv[sc == p]
            rank[sel] = np.arange(len(sel))
        in_window[verts] = False
        superstep += 1
        i = j
    return Schedule(
        n=dag.n, k=k, pi=pi, sigma=sigma, rank=rank, n_supersteps=superstep
    )


def _absorb(dag: SolveDAG, uf: _UnionFind, in_window: np.ndarray, verts: np.ndarray):
    """Add one wavefront to the window: re-initialize the new vertices as
    fresh union-find roots (windows never share components with finalized
    supersteps) and union each new vertex with its in-window parents."""
    uf.parent[verts] = verts
    in_window[verts] = True
    parents, srcs = gather_ranges(dag.parent_ptr, dag.parent_idx, verts)
    mask = in_window[parents]
    for a, b in zip(srcs[mask], parents[mask]):
        uf.union(int(a), int(b))


def _try_pack(uf: _UnionFind, verts: np.ndarray, weights: np.ndarray, k: int, tau: float):
    roots = np.asarray([uf.find(int(v)) for v in verts], dtype=np.int64)
    comp_ids, comp_inv = np.unique(roots, return_inverse=True)
    comp_w = np.zeros(len(comp_ids), dtype=np.float64)
    np.add.at(comp_w, comp_inv, weights[verts])
    comp_core, max_load, total = _lpt_pack(comp_w, k)
    if total > 0 and max_load > tau * total / k:
        return None
    return comp_core[comp_inv]
