"""Elastic macro-step transform — bounded-slack fusion of plan steps.

A NumPy copy of the JAX package's ``core/elastic.py``;
``tests/test_torch_elastic.py`` holds every certificate array equal to
the original's. The executor names below are the reference's: in this
package the macro-step loop is ``solver.executor.solve_with_elastic``;
the CUDA kernels (``csrc/sptrsv.cu``) read only the certificate's
``slack``: they walk the plan level by level over runs of ``slack``
supersteps (``kernels/levels.py``), one block barrier per level, where the
TPU kernel walks readiness waves.

The bulk-synchronous executors pay one ``lax.scan`` step (scan backend)
or one grid step (Pallas) per plan step, and — on the distributed
backend — one cross-device barrier per *superstep*.  On deep, narrow
DAGs (chain/banded regimes) that per-step overhead, not FLOPs, sets
wall-clock: the solve is a long sequence of tiny dependent steps.

``elastic_transform`` computes the *slack certificate* that lets an
executor break the step barrier safely.  For every plan step ``t`` it
derives

  * ``writer_step[row]`` — the step at which ``row``'s final (non-accum)
    virtual row executes, i.e. when ``x[row]`` becomes valid;
  * ``ready_step[t]``    — the earliest step at which every value step
    ``t`` gathers is valid: ``max(writer_step[col] + 1)`` over its real
    column indices (0 when it has none).

Step ``t`` may execute any time at or after ``ready_step[t]`` — the
elastic analogue of the paper's §4 funnel depth: instead of waiting for
the global step counter to reach ``t``, a worker only has to respect a
bounded *staleness window* of unresolved predecessors.

Two fused views are derived from the certificate, one per executor
layer:

  * **Macro-steps** (scan executor): the ``T`` plan steps are tiled into
    windows of ``slack`` consecutive steps.  One ``lax.scan`` step then
    executes a whole window with the step bodies unrolled sequentially
    *inside* it — the scan trip count drops from ``T`` to
    ``ceil(T / slack)``.  Because the window is made of the *same* steps
    in the *same* order, each row's accumulation order is untouched and
    the result is bitwise-identical to the bulk-synchronous scan.
  * **Waves** (Pallas kernel): within each window, consecutive steps
    whose dependencies all resolve *before* the window join one
    readiness wave (``wave_id``).  A wave's steps are mutually
    independent, so the kernel's ``fori_loop`` iterates per *wave*
    (``n_waves[w] <= slack``) with per-row readiness masks instead of
    one iteration per step — per-row readiness flags replace the level
    barrier.
  * **Fused superstep bounds** (barrier certificate): runs of
    supersteps whose *cross-core* dependencies all resolve before the
    run starts, capped at ``slack`` supersteps per run.  A distributed
    executor could replace the per-superstep barrier with one barrier
    per fused run; ``ExecPlan.stats()`` reports the before/after
    barrier counts.

A step starts a new wave when ``ready_step[t]`` falls inside the
current wave, or when step ``t-1`` carries a partial-sum accumulator in
any lane (``accum`` chains are same-lane consecutive steps — the carry
forces sequential order even though the gather columns may be ready).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.plan import ExecPlan

# Default staleness window (plan steps fused per macro-step).  Calibrated
# on the deep-DAG corpus regimes (chain/banded) in
# benchmarks/table7e_elastic.py: large enough to amortize per-scan-step
# dispatch, small enough to keep the unrolled window body cheap to
# compile (measured best on chain/banded at 20k rows: 1.3-1.7x over the
# bulk scan, degrading past ~16 as the unrolled body's fixed cost grows).
DEFAULT_SLACK = 8


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """The slack certificate + fused geometry for ``mode="elastic"``.

    Shapes (``T`` = plan steps, ``M = ceil(T / slack)`` macro-steps,
    ``F`` = fused superstep runs):

    slack          staleness window (plan steps per macro-step)
    n_steps        T — bulk-synchronous scan trip count
    n_macro_steps  M — elastic scan trip count
    ready_step     int64[T]  earliest step each plan step may execute
    wave_id        int32[M, slack]  readiness wave of each step within
                   its window (padding steps join the last wave)
    n_waves        int32[M]  waves per window (kernel inner trip count)
    fused_bounds   int64[F+1]  fused superstep runs: run f covers
                   supersteps [fused_bounds[f], fused_bounds[f+1])
    n_supersteps   superstep count of the underlying schedule
    """

    slack: int
    n_steps: int
    n_macro_steps: int
    ready_step: np.ndarray
    wave_id: np.ndarray
    n_waves: np.ndarray
    fused_bounds: np.ndarray
    n_supersteps: int

    @property
    def n_fused_supersteps(self) -> int:
        return len(self.fused_bounds) - 1

    def stats(self) -> dict:
        """Barrier/step accounting before vs after elastic fusion."""
        t, m = self.n_steps, self.n_macro_steps
        s, f = self.n_supersteps, self.n_fused_supersteps
        return {
            "slack": self.slack,
            "n_steps": t,
            "n_macro_steps": m,
            "step_fusion": t / max(m, 1),
            "n_supersteps": s,
            "n_fused_supersteps": f,
            "barrier_fusion": s / max(f, 1),
            "mean_waves_per_macro": float(self.n_waves.mean()) if m else 0.0,
        }


def step_dependencies(plan: ExecPlan):
    """Per-row writer step/lane and per-step readiness for ``plan``.

    Returns ``(writer_step, writer_lane, ready_step)``:
    ``writer_step[row]`` / ``writer_lane[row]`` locate the step and core
    that finalize ``x[row]`` (the row's last, non-accum virtual row);
    ``ready_step[t] = max(writer_step[col] + 1)`` over step ``t``'s real
    gather columns, 0 when it gathers none.  All pure NumPy passes —
    this is inspector-phase work and must stay O(nnz).
    """
    T, k = plan.row_ids.shape
    n = plan.n
    real = plan.row_ids != n
    final = real & ~plan.accum  # slots that write x

    writer_step = np.zeros(n, dtype=np.int64)
    writer_lane = np.zeros(n, dtype=np.int32)
    t_idx = np.broadcast_to(np.arange(T, dtype=np.int64)[:, None], (T, k))
    l_idx = np.broadcast_to(np.arange(k, dtype=np.int32)[None, :], (T, k))
    writer_step[plan.row_ids[final]] = t_idx[final]
    writer_lane[plan.row_ids[final]] = l_idx[final]

    # gather readiness: pad the writer map with -1 at the scratch slot n
    # so padded columns contribute ready step 0 (-1 + 1) for free
    ws_pad = np.concatenate([writer_step, [-1]])
    ready = (ws_pad[plan.col_idx] + 1).max(axis=(1, 2)) if T else (
        np.zeros(0, dtype=np.int64)
    )
    return writer_step, writer_lane, ready


def _wave_ids(plan: ExecPlan, ready: np.ndarray, slack: int):
    """Readiness waves within each ``slack``-step window.

    Vectorized across windows: one Python pass over the ``slack``
    in-window positions maintains, per window, the absolute step index
    of the current wave's first step and breaks a new wave when a step's
    dependencies resolve inside the wave or the previous step carries an
    accumulator.
    """
    T = plan.n_steps
    M = max(1, -(-T // slack))
    pad = M * slack - T
    # padding steps: no deps (ready 0), no accum carry -> join last wave
    ready_p = np.concatenate([ready, np.zeros(pad, dtype=np.int64)])
    carry = np.zeros(T, dtype=bool)
    if T > 1:
        carry[1:] = plan.accum[:-1].any(axis=1)
    carry_p = np.concatenate([carry, np.zeros(pad, dtype=bool)])

    rs = ready_p.reshape(M, slack)
    cb = carry_p.reshape(M, slack)
    wave = np.zeros((M, slack), dtype=np.int32)
    base = np.arange(M, dtype=np.int64) * slack
    wave_start = base.copy()  # absolute step of the current wave's head
    for j in range(1, slack):
        brk = (rs[:, j] > wave_start) | cb[:, j]
        wave[:, j] = wave[:, j - 1] + brk
        wave_start = np.where(brk, base + j, wave_start)
    return wave, wave[:, -1] + 1, M


def _fused_superstep_bounds(
    plan: ExecPlan, writer_step, writer_lane, slack: int
) -> np.ndarray:
    """Greedy fusion of superstep runs under the slack certificate.

    A run of supersteps needs only ONE barrier (before the run) iff no
    superstep in it reads a *cross-core* value written inside the run:
    same-core chains are sequential on their core anyway, so only
    cross-lane gathers force synchronization.  Runs are capped at
    ``slack`` supersteps so the staleness bound also bounds how far any
    worker can run ahead.
    """
    S = plan.n_supersteps
    if S == 0:
        return np.zeros(1, dtype=np.int64)
    T, k = plan.row_ids.shape
    sb = np.asarray(plan.step_bounds, dtype=np.int64)
    sup_of_step = np.repeat(np.arange(S, dtype=np.int64), np.diff(sb))

    # cross-core readiness per superstep: over entries whose writer sits
    # on a different core, the latest writer superstep + 1
    wl_pad = np.concatenate([writer_lane, [-1]])
    ws_pad = np.concatenate([writer_step, [-1]])
    lane = np.broadcast_to(
        np.arange(k, dtype=np.int32)[None, :, None], plan.col_idx.shape
    )
    real_col = plan.col_idx != plan.n
    cross = real_col & (wl_pad[plan.col_idx] != lane)
    xready = np.zeros(S, dtype=np.int64)
    if cross.any():
        sup_writer = sup_of_step[ws_pad[plan.col_idx[cross]]] + 1
        sup_reader = sup_of_step[
            np.broadcast_to(
                np.arange(T, dtype=np.int64)[:, None, None],
                plan.col_idx.shape,
            )[cross]
        ]
        np.maximum.at(xready, sup_reader, sup_writer)

    bounds = [0]
    start = 0
    for s in range(1, S):
        if xready[s] > start or s - start >= slack:
            bounds.append(s)
            start = s
    bounds.append(S)
    return np.asarray(bounds, dtype=np.int64)


def elastic_transform(plan: ExecPlan, slack: int = DEFAULT_SLACK) -> ElasticPlan:
    """Compute the elastic certificate and fused geometry for ``plan``.

    ``slack`` is the staleness window: the scan executor fuses runs of
    ``slack`` consecutive plan steps into one macro-step, the Pallas
    kernel iterates readiness waves within that window, and fused
    superstep runs are capped at ``slack`` supersteps.  Any ``slack >=
    1`` is valid — correctness never depends on the choice (the window
    replays the same steps in the same order), only the fused counts do.
    """
    if slack < 1:
        raise ValueError(f"slack must be >= 1, got {slack}")
    writer_step, writer_lane, ready = step_dependencies(plan)
    wave, n_waves, M = _wave_ids(plan, ready, slack)
    fused = _fused_superstep_bounds(plan, writer_step, writer_lane, slack)
    return ElasticPlan(
        slack=int(slack),
        n_steps=plan.n_steps,
        n_macro_steps=M,
        ready_step=ready,
        wave_id=wave,
        n_waves=n_waves,
        fused_bounds=fused,
        n_supersteps=plan.n_supersteps,
    )
