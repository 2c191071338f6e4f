"""SpMP-like baseline (Park et al. [PSSD14]) — synchronous projection.

SpMP is an *asynchronous* wavefront scheduler: threads advance to their part
of the next wavefront as soon as the point-to-point prerequisites are met,
with an approximate transitive reduction sparsifying the synchronization
edges. The point-to-point flag mechanism has no counterpart in a
bulk-synchronous plan, so we reproduce the parts that do transfer:

  1. the approximate transitive reduction ('remove long edges in triangles',
     [PSSD14 §2.3]) — implemented in ``core.coarsen.transitive_sparsify``;
  2. level scheduling with ID-contiguous, weight-balanced per-core chunks
     (SpMP's per-thread portion of a wavefront is ID-contiguous).

The synchronous projection charges a full barrier per wavefront; SpMP's
async advantage is modeled in the BSP cost model by an effective barrier
cost L_p2p < L (a thread waits only for its neighbours, not the world).
``bsp_cost(dag, spmp_like_schedule(...), L=L_P2P_EFFECTIVE)`` is the
number we report next to measured executor baselines.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.coarsen import transitive_sparsify
from repro_torch.core.schedule import Schedule
from repro_torch.core.wavefront import wavefront_schedule
from repro_torch.sparse.dag import SolveDAG

# Effective barrier price for a p2p-synchronized wavefront step, relative to
# the L=500-cycle global barrier of the BSP model (paper §C.2): SpMP's
# per-edge spin-wait costs tens of cycles, not hundreds.
L_P2P_EFFECTIVE = 50.0


def spmp_like_schedule(dag: SolveDAG, k: int, *, sparsify: bool = True) -> Schedule:
    """Level schedule on the transitively-sparsified DAG with ID-contiguous
    weight-balanced chunks. The schedule is valid for the original DAG
    (transitive reduction preserves the dependency closure)."""
    work_dag = transitive_sparsify(dag) if sparsify else dag
    return wavefront_schedule(work_dag, k, split="contiguous")
