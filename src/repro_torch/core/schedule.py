"""BSP schedules (paper Def. 2.1) — representation, validity, cost model.

A schedule assigns every DAG vertex a core ``pi``, a superstep ``sigma`` and an
in-chain execution rank. Validity (Def. 2.1): for every edge (u, v):
  * sigma(u) <= sigma(v);
  * if pi(u) != pi(v) then sigma(u) < sigma(v);
  * if sigma(u) == sigma(v) and pi(u) == pi(v), u executes before v (rank).

Cost model (§2.2): the BSP cost of a schedule is
    sum_s max_p Omega_p(s)  +  L * n_supersteps
in vertex-weight units (weight = row nnz ~ 2 flops per nnz); L is the barrier
penalty (paper: 500; architecture-dependent).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.sparse.dag import SolveDAG

DEFAULT_L = 500.0


@dataclasses.dataclass
class Schedule:
    n: int
    k: int  # number of cores
    pi: np.ndarray  # int32[n] — core assignment
    sigma: np.ndarray  # int32[n] — superstep assignment, 0-based
    rank: np.ndarray  # int64[n] — execution order within (superstep, core)
    n_supersteps: int

    def __post_init__(self):
        assert self.pi.shape == (self.n,)
        assert self.sigma.shape == (self.n,)
        assert self.rank.shape == (self.n,)

    def chains(self) -> Dict[Tuple[int, int], np.ndarray]:
        """Map (superstep, core) -> vertex ids in execution order."""
        order = np.lexsort((self.rank, self.pi, self.sigma))
        out: Dict[Tuple[int, int], np.ndarray] = {}
        if self.n == 0:
            return out
        key = self.sigma[order].astype(np.int64) * self.k + self.pi[order]
        cuts = np.nonzero(np.diff(key))[0] + 1
        for seg in np.split(order, cuts):
            v0 = seg[0]
            out[(int(self.sigma[v0]), int(self.pi[v0]))] = seg
        return out

    def superstep_loads(self, weights: np.ndarray) -> np.ndarray:
        """float64[n_supersteps, k]: Omega_p(s)."""
        loads = np.zeros((self.n_supersteps, self.k), dtype=np.float64)
        np.add.at(loads, (self.sigma, self.pi), weights.astype(np.float64))
        return loads


def check_validity(dag: SolveDAG, s: Schedule) -> None:
    """Raise AssertionError if the schedule violates Def. 2.1. Vectorized."""
    assert s.n == dag.n
    assert (s.pi >= 0).all() and (s.pi < s.k).all()
    assert (s.sigma >= 0).all() and (s.sigma < s.n_supersteps).all()
    # edge list: (parent u = parent_idx entry, child v = row)
    v_of_edge = np.repeat(
        np.arange(dag.n, dtype=np.int64), np.diff(dag.parent_ptr)
    )
    u_of_edge = dag.parent_idx
    su, sv = s.sigma[u_of_edge], s.sigma[v_of_edge]
    assert (su <= sv).all(), "edge goes backwards in supersteps"
    cross = s.pi[u_of_edge] != s.pi[v_of_edge]
    assert (su[cross] < sv[cross]).all(), "cross-core edge without barrier"
    same_step_same_core = (~cross) & (su == sv)
    assert (
        s.rank[u_of_edge[same_step_same_core]]
        < s.rank[v_of_edge[same_step_same_core]]
    ).all(), "in-chain order violates a dependency"


def bsp_cost(dag: SolveDAG, s: Schedule, L: float = DEFAULT_L) -> float:
    loads = s.superstep_loads(dag.weights)
    return float(loads.max(axis=1).sum() + L * s.n_supersteps)


# Per-plan-step dispatch penalty for the *step-granular* cost model used
# by the elastic mode decision. The BSP model above charges L per
# superstep barrier; the single-chip executors additionally pay a small
# fixed cost per scan/grid step (dispatch, carry shuffling), which
# dominates on deep, narrow DAGs where steps are tiny. Like L it is
# architecture-dependent; the ratio to L is what matters for the
# elastic-vs-bulk decision, not the absolute value.
DEFAULT_L_STEP = 50.0


def schedule_step_count(s: Schedule) -> int:
    """Row-level executor step count T of a schedule: sum over supersteps
    of the longest per-core chain (the scan trip count before virtual-row
    expansion widens rows past W)."""
    if s.n == 0:
        return 0
    key = s.sigma.astype(np.int64) * s.k + s.pi
    chain_len = np.bincount(key, minlength=s.n_supersteps * s.k)
    return int(chain_len.reshape(s.n_supersteps, s.k).max(axis=1).sum())


def step_cost(dag: SolveDAG, s: Schedule, *, l_step: float = DEFAULT_L_STEP) -> float:
    """Step-granular cost of the bulk-synchronous scan executor:
    critical-path work plus one dispatch per plan step."""
    loads = s.superstep_loads(dag.weights)
    return float(loads.max(axis=1).sum() + l_step * schedule_step_count(s))


def elastic_cost(
    dag: SolveDAG, s: Schedule, slack: int, *, l_step: float = DEFAULT_L_STEP
) -> float:
    """Step-granular cost of the elastic executor at staleness window
    ``slack``: critical-path work plus one macro-step dispatch per slack
    window (``ceil(T / slack)`` instead of ``T``). Compare against
    ``step_cost`` to score ``mode="elastic"`` in the autotuner."""
    loads = s.superstep_loads(dag.weights)
    t = schedule_step_count(s)
    macro = -(-t // slack) if t else 0
    return float(loads.max(axis=1).sum() + l_step * macro)


def schedule_stats(dag: SolveDAG, s: Schedule, L: float = DEFAULT_L) -> dict:
    loads = s.superstep_loads(dag.weights)
    maxima = loads.max(axis=1)
    means = loads.sum(axis=1) / s.k
    total = float(dag.weights.sum())
    return {
        "n_supersteps": s.n_supersteps,
        "bsp_cost": float(maxima.sum() + L * s.n_supersteps),
        "work": total,
        "critical_work": float(maxima.sum()),
        # perfect parallelization would give total/k; >= 1, lower is better
        "imbalance": float(maxima.sum() / max(total / s.k, 1e-30)),
        "mean_superstep_load": float(means.mean()) if len(means) else 0.0,
        "speedup_model": total / float(maxima.sum() + L * s.n_supersteps),
    }


def serial_schedule(dag: SolveDAG) -> Schedule:
    """Everything on core 0 in one superstep, topological (ID) order."""
    return Schedule(
        n=dag.n,
        k=1,
        pi=np.zeros(dag.n, dtype=np.int32),
        sigma=np.zeros(dag.n, dtype=np.int32),
        rank=np.arange(dag.n, dtype=np.int64),
        n_supersteps=1 if dag.n else 0,
    )
