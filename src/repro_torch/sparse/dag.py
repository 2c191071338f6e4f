"""The SpTRSV dependency DAG (paper §2.2, Fig. 1.1).

Vertex i = row i of the lower-triangular matrix L. Edge (j, i) iff L[i, j] != 0
for j < i. Vertex weight ω(i) = nnz of row i (paper §2.2: "the weight ω(v) of
each vertex ... is simply defined as the number of non-zero entries in the
corresponding row").

The DAG is stored as two CSR adjacency structures (parents = the strictly-lower
CSR of L itself; children = its transpose), which is what every scheduler here
consumes. Pure numpy; sizes up to |E| ~ 10^8 are fine.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, csr_from_coo, transpose_csr


@dataclasses.dataclass(frozen=True)
class SolveDAG:
    """DAG G=(V,E,ω) of a forward-substitution solve."""

    n: int
    # parents[i] = {j : (j,i) in E}: CSR over rows (strictly-lower structure)
    parent_ptr: np.ndarray  # int64[n+1]
    parent_idx: np.ndarray  # int64[|E|]
    # children[j] = {i : (j,i) in E}
    child_ptr: np.ndarray  # int64[n+1]
    child_idx: np.ndarray  # int64[|E|]
    weights: np.ndarray  # int64[n] — ω(v) = row nnz (incl. diagonal)

    @property
    def n_edges(self) -> int:
        return len(self.parent_idx)

    def parents(self, v: int) -> np.ndarray:
        return self.parent_idx[self.parent_ptr[v] : self.parent_ptr[v + 1]]

    def children(self, v: int) -> np.ndarray:
        return self.child_idx[self.child_ptr[v] : self.child_ptr[v + 1]]

    def in_degrees(self) -> np.ndarray:
        return np.diff(self.parent_ptr)

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.child_ptr)

    def total_work(self) -> int:
        return int(self.weights.sum())


def dag_from_lower_csr(L: CSRMatrix) -> SolveDAG:
    """Build the solve DAG from a lower-triangular CSR matrix."""
    rows = L.row_of_entry()
    strict = L.indices < rows  # drop the diagonal: it is not a dependency
    erow = rows[strict]
    ecol = L.indices[strict]
    n = L.n_rows
    # parents CSR: row i -> its parents (the strictly-lower column ids)
    pmat = csr_from_coo(n, n, erow, ecol, np.ones(len(erow)))
    cmat = transpose_csr(pmat)
    weights = L.row_nnz().astype(np.int64)
    # Guard: weight must be >= 1 even for structurally-empty rows.
    weights = np.maximum(weights, 1)
    return SolveDAG(
        n=n,
        parent_ptr=pmat.indptr,
        parent_idx=pmat.indices,
        child_ptr=cmat.indptr,
        child_idx=cmat.indices,
        weights=weights,
    )


def dag_from_edges(n: int, edges: np.ndarray, weights: np.ndarray | None = None) -> SolveDAG:
    """Build a SolveDAG from an explicit (u, v) edge list (u -> v). Used by
    tests, the coarsener (quotient DAGs) and the pipeline-schedule generator."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    pmat = csr_from_coo(n, n, edges[:, 1], edges[:, 0], np.ones(len(edges)))
    cmat = transpose_csr(pmat)
    if weights is None:
        weights = np.ones(n, dtype=np.int64)
    return SolveDAG(
        n=n,
        parent_ptr=pmat.indptr,
        parent_idx=pmat.indices,
        child_ptr=cmat.indptr,
        child_idx=cmat.indices,
        weights=np.asarray(weights, dtype=np.int64),
    )


def gather_ranges(ptr: np.ndarray, idx: np.ndarray, verts: np.ndarray):
    """Return (flat_targets, src_repeat) where flat_targets concatenates
    ``idx[ptr[v]:ptr[v+1]]`` for every v in ``verts`` and ``src_repeat``
    repeats each v by its range length. Fully vectorized adjacency gather —
    the workhorse of every wavefront-style sweep here."""
    verts = np.asarray(verts, dtype=np.int64)
    starts = ptr[verts]
    counts = ptr[verts + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    rep_starts = np.repeat(starts, counts)
    cum_before = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(cum_before, counts)
    return idx[rep_starts + within], np.repeat(verts, counts)


def topological_levels(dag: SolveDAG) -> np.ndarray:
    """level[v] = length of the longest path ending at v (0 for sources).

    Vectorized Kahn sweep (one numpy pass per wavefront); works for any DAG,
    not just triangular-matrix DAGs."""
    level = np.zeros(dag.n, dtype=np.int64)
    indeg = dag.in_degrees().copy()
    frontier = np.nonzero(indeg == 0)[0]
    processed = 0
    while len(frontier):
        processed += len(frontier)
        kids, srcs = gather_ranges(dag.child_ptr, dag.child_idx, frontier)
        if len(kids) == 0:
            break
        np.maximum.at(level, kids, level[srcs] + 1)
        np.subtract.at(indeg, kids, 1)
        frontier = np.unique(kids[indeg[kids] == 0])
    if processed != dag.n:
        raise ValueError("graph has a cycle: not a DAG")
    return level


def wavefronts(dag: SolveDAG) -> List[np.ndarray]:
    """The wavefronts of the DAG (Fig. 1.1b): vertices grouped by level."""
    level = topological_levels(dag)
    n_levels = int(level.max()) + 1 if dag.n else 0
    order = np.argsort(level, kind="stable")
    sorted_levels = level[order]
    bounds = np.searchsorted(sorted_levels, np.arange(n_levels + 1))
    return [order[bounds[i] : bounds[i + 1]] for i in range(n_levels)]


def longest_path_length(dag: SolveDAG) -> int:
    """Number of vertices on the longest path (= #wavefronts)."""
    if dag.n == 0:
        return 0
    return int(topological_levels(dag).max()) + 1


def average_wavefront_size(dag: SolveDAG) -> float:
    """Paper §6.2: n / longest-path-length — the parallelizability proxy."""
    lp = longest_path_length(dag)
    return dag.n / lp if lp else 0.0


def is_topological_order(dag: SolveDAG, order: np.ndarray) -> bool:
    pos = np.empty(dag.n, dtype=np.int64)
    pos[order] = np.arange(dag.n)
    # every edge (parent -> child) must go forward
    for v in range(dag.n):
        ps = dag.parents(v)
        if len(ps) and (pos[ps] >= pos[v]).any():
            return False
    return True
