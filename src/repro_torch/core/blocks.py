"""Block-parallel scheduling (paper §3.1, Fig. 3.1, Table 7.7).

The lower-triangular matrix is split into ``n_blocks`` contiguous diagonal
blocks. Each block's *diagonal sub-DAG* (edges with both endpoints in the
block) is scheduled independently — in parallel across scheduler threads —
and the per-block schedules are concatenated with a barrier between blocks
(superstep offsets). Cross-block dependencies always point to earlier blocks,
so the concatenation is valid (Def. 2.1) by construction.

Vertex weights still use the FULL row nnz (paper §3.1 last remark: "for the
weight of the vertices ... we still use the number of non-zeros in the full
matrix" — the executor computes the whole row, including the off-diagonal
block part).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

import numpy as np

from repro_torch.core.schedule import Schedule
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.dag import SolveDAG, dag_from_edges


def split_ranges(n: int, n_blocks: int) -> List[tuple]:
    bounds = np.linspace(0, n, n_blocks + 1).astype(np.int64)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_blocks)]


def block_sub_dag(dag: SolveDAG, lo: int, hi: int) -> SolveDAG:
    """Sub-DAG induced by vertices [lo, hi) — only intra-block edges; weights
    keep the full-row weight."""
    v_of_edge = np.repeat(
        np.arange(dag.n, dtype=np.int64), np.diff(dag.parent_ptr)
    )
    u_of_edge = dag.parent_idx
    mask = (u_of_edge >= lo) & (u_of_edge < hi) & (v_of_edge >= lo) & (v_of_edge < hi)
    edges = np.stack([u_of_edge[mask] - lo, v_of_edge[mask] - lo], axis=1)
    return dag_from_edges(hi - lo, edges, dag.weights[lo:hi])


def block_parallel_schedule(
    dag: SolveDAG,
    k: int,
    n_blocks: int,
    scheduler: Callable[[SolveDAG, int], Schedule],
    *,
    parallel: bool = True,
) -> Schedule:
    """Schedule each diagonal block independently and concatenate."""
    ranges = split_ranges(dag.n, n_blocks)
    subs = [block_sub_dag(dag, lo, hi) for (lo, hi) in ranges]
    if parallel and n_blocks > 1:
        with ThreadPoolExecutor(max_workers=min(n_blocks, 16)) as pool:
            scheds = list(pool.map(lambda d: scheduler(d, k), subs))
    else:
        scheds = [scheduler(d, k) for d in subs]
    return concatenate_schedules(dag.n, k, ranges, scheds)


def concatenate_schedules(
    n: int, k: int, ranges: Sequence[tuple], scheds: Sequence[Schedule]
) -> Schedule:
    pi = np.zeros(n, dtype=np.int32)
    sigma = np.zeros(n, dtype=np.int32)
    rank = np.zeros(n, dtype=np.int64)
    offset = 0
    for (lo, hi), s in zip(ranges, scheds):
        pi[lo:hi] = s.pi
        sigma[lo:hi] = s.sigma + offset
        rank[lo:hi] = s.rank
        offset += s.n_supersteps
    return Schedule(n=n, k=k, pi=pi, sigma=sigma, rank=rank, n_supersteps=offset)
