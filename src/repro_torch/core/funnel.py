"""Funnel+GL — the paper's combined pipeline (Tables 7.1–7.2).

Transitive sparsification, in-funnel coarsening, GrowLocal on the coarse
DAG, pull-back to the fine DAG. A module of its own so the pipeline
registry (``repro_torch.pipeline.registry``) can treat it like the others.
"""
from __future__ import annotations

from repro_torch.core.coarsen import (
    coarsen_dag,
    funnel_partition,
    pull_back_schedule,
    transitive_sparsify,
)
from repro_torch.core.growlocal import grow_local
from repro_torch.core.schedule import DEFAULT_L, Schedule
from repro_torch.sparse.dag import SolveDAG


def funnel_grow_local(
    dag: SolveDAG,
    k: int,
    *,
    max_size: int = 64,
    L: float = DEFAULT_L,
    sparsify: bool = True,
) -> Schedule:
    """Funnel+GL (paper Tables 7.1–7.2): transitive sparsification, in-funnel
    coarsening, GrowLocal on the coarse DAG, pull-back."""
    work = transitive_sparsify(dag) if sparsify else dag
    part = funnel_partition(work, max_size=max_size)
    c = coarsen_dag(work, part)
    coarse_sched = grow_local(c.coarse, k, L=L)
    return pull_back_schedule(c, coarse_sched, dag.n)
