"""Wavefront (level-set) scheduler — the classical baseline [AS89, Sal90].

Every wavefront becomes one superstep; vertices of a wavefront are split
across cores. Two splitting rules:
  * ``contiguous`` — ID-contiguous weight-balanced chunks (good locality;
    this is also the synchronous projection of SpMP's level scheduling,
    see ``spmp_like``),
  * ``cyclic`` — round-robin (the classic locality-oblivious variant).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import Schedule
from repro_torch.sparse.dag import SolveDAG, wavefronts


def wavefront_schedule(
    dag: SolveDAG, k: int, *, split: str = "contiguous"
) -> Schedule:
    pi = np.zeros(dag.n, dtype=np.int32)
    sigma = np.zeros(dag.n, dtype=np.int32)
    rank = np.zeros(dag.n, dtype=np.int64)
    levels = wavefronts(dag)
    for s, verts in enumerate(levels):
        verts = np.sort(verts)
        sigma[verts] = s
        if split == "cyclic":
            cores = np.arange(len(verts)) % k
        elif split == "contiguous":
            w = dag.weights[verts].astype(np.float64)
            cum = np.cumsum(w) - w / 2.0
            total = max(float(w.sum()), 1e-30)
            cores = np.minimum((cum / total * k).astype(np.int64), k - 1)
        else:
            raise ValueError(f"unknown split rule: {split}")
        pi[verts] = cores
        # rank: position within (superstep, core)
        for p in range(k):
            sel = verts[cores == p]
            rank[sel] = np.arange(len(sel))
    return Schedule(
        n=dag.n,
        k=k,
        pi=pi,
        sigma=sigma,
        rank=rank,
        n_supersteps=len(levels),
    )
