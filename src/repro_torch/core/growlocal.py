"""GrowLocal — the paper's scheduler (§3, Algorithm 3.1).

Superstep formation: iterations with a growing length parameter alpha
(20, 30, 45, ... — factor 1.5). In an iteration, core 1 receives up to alpha
vertices (weight Omega_1); cores 2..k are filled until their weight reaches
Omega_1. The iteration's parallelization score is

    beta = sum_p Omega_p / (max_p Omega_p + L).

An iteration is *worthy* iff beta >= WORTHY_FACTOR * best beta seen in this
superstep (first iteration always worthy; Appendix B uses 0.97). Worthy
iterations are remembered and invalidated; alpha grows; the first unworthy
iteration finalizes the last worthy assignment as the superstep.

Vertex selection — Rule I: when assigning to core p, prefer vertices that are
executable *only on p* in this superstep (a parent was assigned to p since the
last barrier); among candidates, smallest ID. Exclusive-first is the
[PAKY24]-inspired rule; smallest-ID keeps consecutive matrix rows together,
which the reordering step (§5) then turns into locality.

Complexity: O(|E| log |V|) under the paper's Thm 3.1 assumptions — iteration
sizes grow geometrically, so speculative assignments are amortized by the
finalized superstep size.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.schedule import DEFAULT_L, Schedule
from repro_torch.sparse.dag import SolveDAG

ALPHA_INIT = 20
ALPHA_GROWTH = 1.5
WORTHY_FACTOR = 0.97

_FREE = -1  # claimed[] sentinel: executable on any core
_BLOCKED = -2  # parents on >= 2 distinct cores this superstep


def grow_local(
    dag: SolveDAG,
    k: int,
    *,
    L: float = DEFAULT_L,
    alpha_init: int = ALPHA_INIT,
    alpha_growth: float = ALPHA_GROWTH,
    worthy_factor: float = WORTHY_FACTOR,
    frontier_widening: bool = False,
) -> Schedule:
    """Run GrowLocal on ``dag`` for ``k`` cores; returns a valid Schedule.

    ``frontier_widening`` (beyond-paper, off by default to stay faithful):
    on single-/few-source DAGs the paper's worthiness rule never cuts — beta
    = Omega_1/(Omega_1 + L) increases monotonically while one core's
    exclusive chain swallows the whole DAG (their SuiteSparse filter,
    avg wavefront >= 2k, hides this regime). When the DAG has parallelism to
    unlock (avg wavefront >= 2) but the current superstep keeps less than
    half the cores busy, we stop growing alpha: the barrier releases the
    frontier to the free pool and the next superstep engages all cores.
    EXPERIMENTS.md §Perf quantifies the effect (narrow-band: ~2x model
    speed-up; ichol grids: serial -> parallel)."""
    n = dag.n
    if n == 0:
        return Schedule(
            n=0,
            k=k,
            pi=np.zeros(0, np.int32),
            sigma=np.zeros(0, np.int32),
            rank=np.zeros(0, np.int64),
            n_supersteps=0,
        )
    weights = dag.weights
    child_ptr, child_idx = dag.child_ptr, dag.child_idx

    widen_cut = False
    if frontier_widening:
        from repro_torch.sparse.dag import average_wavefront_size

        widen_cut = average_wavefront_size(dag) >= 2.0

    # --- global (cross-superstep) state -----------------------------------
    final_remaining = dag.in_degrees().astype(np.int64)  # unfinalized parents
    scheduled = np.zeros(n, dtype=bool)
    pi = np.full(n, -1, dtype=np.int32)
    sigma = np.full(n, -1, dtype=np.int32)
    rank = np.zeros(n, dtype=np.int64)
    free_heap: List[int] = np.nonzero(final_remaining == 0)[0].tolist()
    heapq.heapify(free_heap)

    # --- per-iteration scratch (reset via touched lists) ------------------
    cur_done = np.zeros(n, dtype=np.int64)  # parents assigned this iteration
    claimed = np.full(n, _FREE, dtype=np.int64)
    iter_tag = np.zeros(n, dtype=np.int64)  # last iteration id touching v
    assigned_tag = np.zeros(n, dtype=np.int64)  # last iteration id assigning v
    iteration_id = 0

    n_scheduled = 0
    superstep = 0

    def _touch(v: int):
        if iter_tag[v] != iteration_id:
            iter_tag[v] = iteration_id
            cur_done[v] = 0
            claimed[v] = _FREE

    while n_scheduled < n:
        alpha = float(alpha_init)
        best_beta = -np.inf
        last_worthy: Optional[List[Tuple[int, int]]] = None
        prev_total = -1

        while True:
            iteration_id += 1
            assignment: List[Tuple[int, int]] = []  # (vertex, core) in order
            popped_free: List[int] = []
            excl_heaps: List[List[int]] = [[] for _ in range(k)]
            omega = np.zeros(k, dtype=np.float64)

            def _next_vertex(p: int) -> int:
                """Rule I pop for core p; -1 if nothing assignable."""
                eh = excl_heaps[p]
                while eh:
                    v = heapq.heappop(eh)
                    # exclusive entries are iteration-local; always fresh
                    return v
                while free_heap:
                    v = free_heap[0]
                    if scheduled[v] or assigned_tag[v] == iteration_id:
                        heapq.heappop(free_heap)  # stale
                        continue
                    heapq.heappop(free_heap)
                    popped_free.append(v)
                    return v
                return -1

            def _assign(v: int, p: int):
                assigned_tag[v] = iteration_id
                assignment.append((v, p))
                omega[p] += weights[v]
                lo, hi = child_ptr[v], child_ptr[v + 1]
                for u in child_idx[lo:hi]:
                    _touch(u)
                    cur_done[u] += 1
                    if claimed[u] == _FREE:
                        claimed[u] = p
                    elif claimed[u] != p:
                        claimed[u] = _BLOCKED
                    if (
                        final_remaining[u] - cur_done[u] == 0
                        and claimed[u] == p
                        and not scheduled[u]
                    ):
                        heapq.heappush(excl_heaps[p], int(u))

            # I. assign up to alpha vertices to core 1 (index 0)
            quota = max(1, int(alpha))
            for _ in range(quota):
                v = _next_vertex(0)
                if v < 0:
                    break
                _assign(v, 0)
            # cores 2..k: fill until Omega_p reaches Omega_1
            for p in range(1, k):
                while omega[p] < omega[0]:
                    v = _next_vertex(p)
                    if v < 0:
                        break
                    _assign(v, p)

            # II. parallelization score
            total_w = float(omega.sum())
            max_w = float(omega.max())
            beta = total_w / (max_w + L) if (max_w + L) > 0 else 0.0
            total_assigned = len(assignment)

            first_iteration = last_worthy is None
            worthy = first_iteration or beta >= worthy_factor * best_beta
            if widen_cut and not first_iteration:
                # economics of the cut: a barrier (price L) only pays off if
                # the superstep already carries >= L weight on under-utilized
                # cores — then stop growing and let the barrier release the
                # frontier to the free pool. (The unconditional cut was
                # tried and refuted: it drowns in barrier cost — see
                # EXPERIMENTS.md §Perf, scheduler iteration log.)
                active = int((omega > 0).sum())
                if active <= 1 and total_w >= L:
                    worthy = False
            best_beta = max(best_beta, beta)

            exhausted = n_scheduled + total_assigned >= n
            stalled = total_assigned <= prev_total  # alpha growth gained nothing
            prev_total = total_assigned

            if worthy:
                last_worthy = assignment
                if exhausted or stalled:
                    finalize = last_worthy
                    # nothing to restore: pool entries already popped are
                    # exactly the free vertices of `finalize`
                    restore = []
                    break
                # invalidate: restore popped free vertices, grow alpha
                for v in popped_free:
                    heapq.heappush(free_heap, v)
                alpha *= alpha_growth
            else:
                finalize = last_worthy
                restore = popped_free  # current (rejected) iteration's pops
                break

        # --- finalize the superstep ---------------------------------------
        for v in restore:
            heapq.heappush(free_heap, v)
        chain_pos = np.zeros(k, dtype=np.int64)
        newly_ready: List[int] = []
        for (v, p) in finalize:
            scheduled[v] = True
            pi[v] = p
            sigma[v] = superstep
            rank[v] = chain_pos[p]
            chain_pos[p] += 1
            n_scheduled += 1
        for (v, p) in finalize:
            lo, hi = child_ptr[v], child_ptr[v + 1]
            for u in child_idx[lo:hi]:
                final_remaining[u] -= 1
                if final_remaining[u] == 0 and not scheduled[u]:
                    newly_ready.append(int(u))
        for u in newly_ready:
            heapq.heappush(free_heap, u)
        superstep += 1

    return Schedule(
        n=n, k=k, pi=pi, sigma=sigma, rank=rank, n_supersteps=superstep
    )
