"""Beyond-paper: GrowLocal as a pipeline-parallel schedule generator.

The paper notes GrowLocal "can also be interpreted as scheduler for general
DAGs". A pipeline-parallel training step IS a DAG-scheduling instance:
vertices = (microbatch m, stage s, phase fwd/bwd), edges = fwd(m,s) ->
fwd(m,s+1), bwd(m,s+1) -> bwd(m,s), fwd(m,S-1) -> bwd(m,S-1). Cores =
pipeline stages is fixed by placement, so here GrowLocal's degree of freedom
is the SUPERSTEP structure: how many microbatch units run between device
synchronizations — exactly the 1F1B-vs-GPipe trade-off expressed in BSP
terms (L = pipeline flush cost).

``pipeline_dag`` builds the DAG; ``grow_local_pipeline`` schedules it with
the stage-placement constraint (pi is fixed, sigma/rank from a wavefront-
with-gluing pass using the paper's beta score); ``pipeline_stats`` reports
bubble fraction vs GPipe.

A copy of the JAX package's ``core/pipeline_schedule.py`` on the port's
``core.schedule.Schedule`` and ``sparse.dag.dag_from_edges``; the logic is
unchanged, so the arrays it returns equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.schedule import DEFAULT_L, Schedule
from repro_torch.sparse.dag import SolveDAG, dag_from_edges


@dataclasses.dataclass(frozen=True)
class PipelineProblem:
    n_stages: int
    n_microbatches: int
    fwd_cost: float = 1.0
    bwd_cost: float = 2.0


def _vid(p: PipelineProblem, m: int, s: int, phase: int) -> int:
    """vertex id; phase 0 = fwd, 1 = bwd. IDs are topologically ordered by
    (m + s) so smallest-ID selection keeps the pipeline front moving."""
    return (m * p.n_stages + s) * 2 + phase


def pipeline_dag(p: PipelineProblem) -> Tuple[SolveDAG, np.ndarray]:
    """-> (DAG, stage_of_vertex). Weights in fwd_cost units (x2 for bwd)."""
    edges = []
    n = p.n_stages * p.n_microbatches * 2
    stage = np.zeros(n, dtype=np.int64)
    w = np.ones(n, dtype=np.int64)
    for m in range(p.n_microbatches):
        for s in range(p.n_stages):
            stage[_vid(p, m, s, 0)] = s
            stage[_vid(p, m, s, 1)] = s
            w[_vid(p, m, s, 1)] = int(round(p.bwd_cost / p.fwd_cost))
            if s + 1 < p.n_stages:
                edges.append((_vid(p, m, s, 0), _vid(p, m, s + 1, 0)))
                edges.append((_vid(p, m, s + 1, 1), _vid(p, m, s, 1)))
            else:
                edges.append((_vid(p, m, s, 0), _vid(p, m, s, 1)))
            # in-stage serialization of same-phase microbatches keeps the
            # DAG honest about one-executor-per-stage
            if m + 1 < p.n_microbatches:
                edges.append((_vid(p, m, s, 0), _vid(p, m + 1, s, 0)))
                edges.append((_vid(p, m, s, 1), _vid(p, m + 1, s, 1)))
    dag = dag_from_edges(n, np.asarray(edges), w)
    return dag, stage


def _schedule_with_alpha(p: PipelineProblem, alpha: float) -> Schedule:
    """Fixed-alpha barrier schedule: every superstep gives each stage up to
    alpha units of ready work (ID order, cross-stage hand-offs barriered)."""
    dag, stage = pipeline_dag(p)
    n, k = dag.n, p.n_stages
    remaining = dag.in_degrees().copy()
    done = np.zeros(n, dtype=bool)
    sigma = np.full(n, -1, dtype=np.int32)
    rank = np.zeros(n, dtype=np.int64)
    ready = sorted(np.nonzero(remaining == 0)[0].tolist())
    superstep = 0
    n_done = 0
    while n_done < n:
        sel, _ = _fill(dag, stage, ready, remaining, done, k, alpha)
        chain_pos = np.zeros(k, dtype=np.int64)
        for v in sel:
            done[v] = True
            sigma[v] = superstep
            rank[v] = chain_pos[stage[v]]
            chain_pos[stage[v]] += 1
            n_done += 1
            for u in dag.children(v):
                remaining[u] -= 1
                if remaining[u] == 0:
                    ready.append(int(u))
        ready = sorted(set(r for r in ready if not done[r]))
        superstep += 1
    return Schedule(n=n, k=k, pi=stage.astype(np.int32), sigma=sigma,
                    rank=rank, n_supersteps=superstep)


def grow_local_pipeline(
    p: PipelineProblem, *, L: float = DEFAULT_L, growth: float = 1.5,
) -> Schedule:
    """GrowLocal economics applied to pipeline scheduling.

    The paper's per-superstep alpha-growth loop degenerates on pipeline DAGs
    (a superstep that only activates stage 0 has monotonically increasing
    beta, so the 0.97-of-best rule never cuts — the same single-source
    behaviour §3 exhibits, see core/growlocal.py). For pipelines the
    superstep length trade-off is GLOBAL (alpha ticks repeat), so we apply
    the same geometric alpha ladder but score each candidate by its full BSP
    cost  sum_s max_p Omega_p(s) + L * S  and keep the argmin: small L ->
    alpha=1 wavefront ticks (1F1B-flavoured, bubble-light), large L -> glued
    supersteps (GPipe-flavoured, barrier-light)."""
    dag, _ = pipeline_dag(p)
    weights = dag.weights.astype(np.float64)
    best, best_cost = None, np.inf
    alpha = 1.0
    max_alpha = p.n_microbatches * max(p.bwd_cost / p.fwd_cost, 1.0) * 2
    while alpha <= max_alpha:
        sched = _schedule_with_alpha(p, alpha)
        loads = sched.superstep_loads(weights)
        cost = float(loads.max(axis=1).sum()) + L * sched.n_supersteps
        if cost < best_cost:
            best, best_cost = sched, cost
        alpha *= growth
    return best


def _fill(dag, stage, ready, remaining, done, k, alpha):
    """One speculative iteration: stages consume ready vertices in ID order.
    Def. 2.1 constraint: a vertex finished in THIS superstep can feed a
    same-superstep child only on the same core — with pi pinned to stages,
    any cross-stage hand-off blocks the child until the next barrier."""
    rem = remaining.copy()
    blocked = set()
    omega = np.zeros(k)
    counts = np.zeros(k)
    sel = []
    frontier = sorted(ready)
    progress = True
    while progress:
        progress = False
        for v in list(frontier):
            s = stage[v]
            if counts[s] >= alpha:
                continue
            sel.append(v)
            frontier.remove(v)
            counts[s] += 1
            omega[s] += dag.weights[v]
            for u in dag.children(v):
                rem[u] -= 1
                if stage[u] != s:
                    blocked.add(int(u))  # needs a barrier first
                if rem[u] == 0 and not done[u] and int(u) not in blocked:
                    frontier.append(int(u))
            frontier.sort()
            progress = True
    return sel, omega


def pipeline_stats(p: PipelineProblem, sched: Schedule) -> dict:
    dag, stage = pipeline_dag(p)
    loads = sched.superstep_loads(dag.weights.astype(np.float64))
    crit = float(loads.max(axis=1).sum())
    total = float(dag.weights.sum())
    ideal = total / p.n_stages
    # GPipe reference: fwd sweep + bwd sweep with full flushes
    unit_f, unit_b = p.fwd_cost, p.bwd_cost
    gpipe = (p.n_microbatches + p.n_stages - 1) * (unit_f + unit_b) * (
        total / (p.n_microbatches * p.n_stages * (unit_f + unit_b) / 1.0)
    ) / p.n_microbatches if p.n_microbatches else 0.0
    return {
        "supersteps": sched.n_supersteps,
        "critical_work": crit,
        "bubble_fraction": 1.0 - ideal / crit if crit else 0.0,
        "ideal_work_per_stage": ideal,
    }
