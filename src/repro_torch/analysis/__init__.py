"""``repro_torch.analysis`` — independent static verification of inspector
artifacts, plus a determinism lint for the port's solver and kernel source.

A copy of the JAX package's ``repro.analysis`` (the passes are NumPy on
the host in both), with one pass of its own. Five passes, all
re-implemented from first principles (no code shared with
``core/plan.py`` / ``core/elastic.py`` / ``core/rowshard.py`` /
``kernels/levels.py``, so a compiler bug cannot self-certify):

  * **schedule** (``schedule_check``) — BSP validity (Def. 2.1) against
    edges re-derived from the raw CSR arrays, §5 reorder bijection and
    (superstep, core, rank) order;
  * **plan** (``plan_check``) — ``ExecPlan`` tensor audit: bounds,
    padding inertness, write-once-before-read, accum-chain ordering,
    scratch containment, value provenance, lane-layout agreement;
  * **elastic** (``elastic_check``) — slack-certificate soundness:
    readiness never underestimated, waves dependency-free, accum
    carries break waves, fused runs respect cross-core readiness;
  * **rowshard** (``rowshard_check``) — halo tables cover exactly the
    re-derived cross-shard edge set, writer-round < reader-round, ring
    and psum forms consistent, local plans are faithful remaps;
  * **levels** (``level_check``, the port's own) — the level order the
    CUDA kernels walk, one block barrier per level: a bijection onto the
    real lane-steps, whole accum chains as vertices, runs of ``slack``
    supersteps, and no read of a row before the level that finishes it.

Plus the AST ``lint`` (``LINT_NONDET_REDUCTION``, retargeted at torch)
and a mutation harness (``analysis.mutate``) whose seeded corruptions
double as the verifier's own false-negative test.

Entry points: ``TriangularSolver.plan(validate="fast"|"full")`` (or the
``REPRO_VALIDATE`` env var, the same one the JAX package reads) verifies
at build time, and on the ``kernel`` backend checks the bound level order
after the bind (on the ``distributed`` backend, every mesh position's
order with its round ranges, and with ``shard="rows"`` the halo
partition); ``python -m repro_torch.launch.check`` sweeps the
corpus; ``python -m repro_torch.analysis.lint`` runs the source lint.

Levels: ``"fast"`` is the O(n) structural screen that rides along on
every build — tensor geometry and bounds, padding inertness, writer
bijection, reorder bijection + monotone order, lane/superstep layout
agreement, the level order's structure (bounded at <= 15% of
``compile_plan`` time, ``repro_torch.launch.check_overhead``).
``"full"`` adds the O(nnz) proofs: edge race detection, scratch
containment, accum chains, read-after-write (of the plan and of the
level order), value provenance, load accounting and per-shard local plan
audits — the depth the CI sweep and the mutation harness run at.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from repro_torch.analysis.elastic_check import true_ready_steps, verify_elastic
from repro_torch.analysis.findings import (
    Finding,
    Report,
    VerificationError,
    finding,
)
from repro_torch.analysis.level_check import verify_level_order, verify_round_ranges
from repro_torch.analysis.lint import lint_paths, lint_source
from repro_torch.analysis.plan_check import (
    packed_writers,
    plan_writers,
    verify_exec_plan,
    verify_lane_layout,
)
from repro_torch.analysis.rowshard_check import verify_rowshard
from repro_torch.analysis.schedule_check import verify_reorder, verify_schedule

__all__ = [
    "Artifacts",
    "Finding",
    "Report",
    "VerificationError",
    "VALIDATE_LEVELS",
    "finding",
    "lint_paths",
    "lint_source",
    "plan_writers",
    "resolve_level",
    "true_ready_steps",
    "verify_artifacts",
    "verify_elastic",
    "verify_exec_plan",
    "verify_lane_layout",
    "verify_level_order",
    "verify_levels_report",
    "verify_mesh_levels_report",
    "verify_reorder",
    "verify_rowshard",
    "verify_rowshard_report",
    "verify_round_ranges",
    "verify_schedule",
]

VALIDATE_LEVELS = ("off", "fast", "full")


def resolve_level(validate: Optional[str] = None) -> str:
    """Normalize a ``validate=`` argument: explicit value wins, then the
    ``REPRO_VALIDATE`` env var, then ``"off"``."""
    if validate is None:
        validate = os.environ.get("REPRO_VALIDATE", "") or "off"
    level = str(validate).lower()
    if level not in VALIDATE_LEVELS:
        raise ValueError(
            f"validate must be one of {VALIDATE_LEVELS}; got {validate!r}"
        )
    return level


@dataclasses.dataclass
class Artifacts:
    """One inspector run's verifiable artifacts.

    L              lower-triangular CSRMatrix the plan solves (post-reorder)
    sched          the (post-reorder) Schedule the plan was compiled from
    plan           the compiled ExecPlan
    perm           §5 reorder permutation (new id -> old id), optional
    sched_pre      pre-reorder Schedule (checked against perm), optional
    elastic        ElasticPlan certificate, optional (falls back to
                   ``plan.elastic``)
    rowshard       RowShardPlan partition, optional
    levels         the bulk kernels' level order (runs of 1 superstep),
                   optional
    elastic_levels the elastic kernels' level order (runs of the
                   certificate's slack), optional
    """

    L: object
    sched: object
    plan: object
    perm: Optional[np.ndarray] = None
    sched_pre: object = None
    elastic: object = None
    rowshard: object = None
    levels: object = None
    elastic_levels: object = None


def verify_artifacts(art: Artifacts, *, level: str = "fast") -> Report:
    """Run every applicable pass over ``art``; returns the full report
    (``.raise_if_failed()`` to gate)."""
    from repro_torch import obs

    level = resolve_level(level)
    rep = Report()
    if level == "off":
        return rep
    n = int(art.plan.n) if art.plan is not None else 0
    with obs.span(
        "analysis.verify", cat="analysis", level=level, n=n
    ) as sp:
        if art.sched is not None and art.L is not None:
            rep.extend("schedule", verify_schedule(
                art.L, art.sched, level=level
            ))
        if art.perm is not None:
            rep.extend("reorder", verify_reorder(
                art.perm, art.sched, art.sched_pre, level=level
            ))
        if art.plan is not None:
            # one writer derivation shared by the plan and lane passes
            writers = None
            rid = np.asarray(art.plan.row_ids)
            acc = np.asarray(art.plan.accum)
            if rid.ndim == 2 and rid.shape == acc.shape:
                writers = packed_writers(rid, acc, int(art.plan.n))
            plan_found = verify_exec_plan(
                art.plan, art.L, level=level, writers=writers
            )
            rep.extend("plan", plan_found)
            if art.sched is not None:
                rep.extend("plan", verify_lane_layout(
                    art.plan, art.sched, level=level, writers=writers
                ))
            # certificates are judged against the plan; once the plan
            # itself is corrupt their findings would only cascade
            plan_ok = not any(f.severity == "error" for f in plan_found)
            ep = art.elastic
            if ep is None:
                ep = getattr(art.plan, "elastic", None)
            if ep is not None and plan_ok:
                rep.extend("elastic", verify_elastic(
                    art.plan, ep, level=level
                ))
            if art.rowshard is not None and plan_ok:
                rep.extend("rowshard", verify_rowshard(
                    art.plan, art.rowshard, level=level
                ))
            # a level order is derived from the plan after every other
            # artifact; judged against a faulty one it would only cascade
            if rep.ok:
                _extend_levels(rep, art.plan, art.levels, 1, level)
                if ep is not None:
                    _extend_levels(
                        rep, art.plan, art.elastic_levels, int(ep.slack),
                        level,
                    )
        sp.set(findings=len(rep.findings), ok=rep.ok)
    obs.counter_add("analysis.verifications", 1)
    if rep.findings:
        obs.counter_add("analysis.findings", len(rep.findings))
    return rep


def _extend_levels(rep: Report, plan, order, slack: int, level: str) -> None:
    if order is not None:
        rep.extend("levels", verify_level_order(
            plan, order, level=level, slack=slack
        ))


def _one_pass_report(check: str, level: str, n: int, run) -> Report:
    """A report of the single pass ``run(level)`` under its own span — the
    post-bind hooks, whose artifact is built at bind time."""
    from repro_torch import obs

    level = resolve_level(level)
    rep = Report()
    if level == "off":
        return rep
    with obs.span(
        f"analysis.verify.{check}", cat="analysis", level=level, n=n,
    ) as sp:
        rep.extend(check, run(level))
        sp.set(findings=len(rep.findings), ok=rep.ok)
    obs.counter_add("analysis.verifications", 1)
    if rep.findings:
        obs.counter_add("analysis.findings", len(rep.findings))
    return rep


def verify_rowshard_report(plan, rsp, *, level: str = "fast") -> Report:
    """Rowshard-only report over a partition cut from ``plan``
    (``core.rowshard.partition_plan``)."""
    return _one_pass_report(
        "rowshard", level, int(plan.n),
        lambda lv: verify_rowshard(plan, rsp, level=lv),
    )


def verify_levels_report(
    plan, order, *, level: str = "fast", slack: Optional[int] = None
) -> Report:
    """Level-order-only report — the post-bind hook of the ``kernel``
    backend (the order is built at bind time). ``slack``: the run length
    the bind walks (``None``: the certificate's where ``plan.elastic`` is
    attached, else 1)."""
    return _one_pass_report(
        "levels", level, int(plan.n),
        lambda lv: verify_level_order(plan, order, level=lv, slack=slack),
    )


def verify_mesh_levels_report(audit, *, level: str = "fast") -> Report:
    """Level-order report over a mesh bind's positions — the post-bind hook
    of the ``distributed`` backend (``level_audit()``: one ``(plan, order,
    rows, bounds, ranges)`` per position of a data row): each position's
    bulk order against the plan it was built from and the rows it must
    finish, and its exchange rounds' level ranges."""
    audit = list(audit)

    def run(lv):
        out = []
        for plan, order, rows, bounds, ranges in audit:
            out += verify_level_order(plan, order, level=lv, slack=1, rows=rows)
            out += verify_round_ranges(order, bounds, ranges)
        return out

    return _one_pass_report("levels", level, int(audit[0][0].n) if audit else 0, run)
