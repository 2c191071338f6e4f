"""Layer 2 of the autotuner: transparent, feature-driven strategy selection.

Two stages, both inspectable:

1.  ``classify`` maps the DAG features to a *regime* label, and
    ``shortlist`` maps the regime to 2–3 candidate
    ``(strategy, ScheduleOptions)`` configs. The rules are a small,
    documented table calibrated on the scenario corpus
    (``autotune.corpus``; thresholds re-checked by the JAX package's
    ``tests/test_autotune.py``):

      regime     trigger (features f, cores k, in order)   candidates
      ---------  ----------------------------------------  ----------------
      serial     f.avg_wavefront < 2  or  f.n <= 64        serial, growlocal
      wide       f.depth <= 8                              hdagg, growlocal,
                                                           serial
      banded     0 < f.mean_band <= 0.1 * f.n              growlocal, serial,
                                                           funnel-gl
      wide       f.avg_wavefront >= 8k                     (as above)
      mixed      everything else                           growlocal,
                                                           funnel-gl, serial

    Rationale: chain-like DAGs cannot amortize a single barrier (§2.2's L
    dwarfs the work), so serial wins; shallow-wide DAGs are the one place
    level-set schedulers (HDagg) beat GrowLocal because every level is
    wide enough to balance; locality-friendly banded/FEM DAGs are
    GrowLocal/Funnel territory (the paper's headline regime); the funnel
    coarsening only pays off when there is depth to collapse.

    The rule ORDER is part of the N>=1e5 recalibration (ROADMAP): the
    locality rule must fire before the wavefront-width rule because
    ``avg_wavefront >= 8k`` stops implying "few barriers" at scale — a
    deep narrow-band DAG at N=1e5 has avg_wavefront ~ 80 yet thousands
    of L-costed supersteps, so it must stay "banded". The depth <= 8
    trigger (definitionally shallow) still precedes it, and the banded
    rule requires mean_band > 0 so edge-free (fully parallel) DAGs keep
    classifying "wide". Scale stability is asserted by the JAX package's
    ``tests/test_autotune.py::test_classify_stable_at_scale`` over the
    ``scale_corpus`` tier (``autotune.corpus``).

2.  ``select_schedule`` runs every shortlisted candidate and scores it
    with the exact §2.2 objective ``bsp_cost(dag, s, L)`` — the model the
    schedulers themselves optimize — keeping the first minimum
    (deterministic: the shortlist order is the tie-break).

    With ``allow_elastic=True`` (the solver passes it when the target
    backend advertises the ``"elastic"`` capability and the caller did
    not force ``mode="bsp"``) a second, step-granular rule runs on the
    winner: in the deep-DAG regimes ("serial", "banded") — where the
    plan's scan trip count ``T`` (``schedule_step_count``), not the
    barrier count, dominates single-chip wall-clock — elastic execution
    is turned on (``options.slack = DEFAULT_SLACK``) whenever fusing
    slack-sized runs shrinks the trip count at least 2x, i.e.
    ``elastic_cost(dag, s, slack)`` halves the ``l_step`` term of
    ``step_cost(dag, s)``. The selection's ``cost`` stays the winner's
    ``bsp_cost`` — elastic changes how the schedule is *executed*, not
    which schedule wins.

``resolve_auto`` wraps this for ``TriangularSolver.plan(strategy="auto")``
and memoizes the outcome per (sparsity fingerprint, options, orientation)
— in the passed ``PlanCache`` when there is one (so refactorizations skip
selection entirely and resolve straight to a concrete plan-cache key),
else in a module-level table. With ``tune=True`` it additionally *times*
the shortlisted compiled plans on the real backend (measured trials, like
"Elasticity in Parallel Sparse Triangular Solve" adapts execution mode to
the instance) and lets wall-clock override the model; when elastic is
allowed, the winner is further swept over the small ``SLACK_GRID`` of
staleness windows so the slack too is clock-picked (memoized per
fingerprint with the rest of the selection).

A copy of the JAX package's ``autotune/selector.py``; the rules, the
shortlists and the elastic rule are the same word for word, so with
``tune=False`` a ``Selection`` equals the JAX one. Three things differ:

* **The binding key.** Measured trials default to the port's
  ``backend="kernel"``, and a tuned pick is keyed on the port's
  ``binding_fingerprint`` (backend, dtype, width, device, mesh, shard). The device is
  resolved first, so ``device=None`` and ``"cuda"`` share one memo entry
  and ``"cpu"`` has its own. The model-based path stays binding-free.
* **Trial timing.** ``solve`` returns before the card has run the
  kernel, so each trial puts ``b`` on the solver's device once, outside
  the clock, and times each repetition between two
  ``torch.cuda.synchronize()`` calls (on the CPU, the host clock alone).
* **What a unit of slack is.** The elastic rule counts plan steps
  (``schedule_step_count``; ``elastic_cost`` charges ``ceil(T / slack)``
  macro-steps), as in the JAX package. On the ``"scan"`` backend the
  slack it picks counts plan steps too; on the ``"kernel"`` backend the
  same ``slack`` counts supersteps: the kernel walks the levels of runs
  of ``slack`` supersteps (``TriangularSolver.info()["slack_unit"]``).
  The bits are the same either way. The rule is not rewritten for the
  kernel: with ``tune=True`` the sweep over ``SLACK_GRID`` times the
  slack on the backend that will run it, so the card's clock settles it.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.autotune.features import MatrixFeatures, dag_features, matrix_features
from repro_torch.core import DEFAULT_SLACK, Schedule, bsp_cost, schedule_step_count
from repro_torch.device import resolve_device
from repro_torch.pipeline.registry import ScheduleOptions, get_scheduler
from repro_torch.sparse.csr import CSRMatrix, pattern_fingerprint
from repro_torch.sparse.dag import SolveDAG, dag_from_lower_csr

REGIMES = ("serial", "wide", "banded", "mixed")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One shortlisted config; ``cost`` is filled in once scored."""

    strategy: str
    options: ScheduleOptions
    cost: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Selection:
    """Outcome of one auto-selection — the winner plus the full scored
    shortlist, so callers can audit why a strategy was chosen."""

    strategy: str
    options: ScheduleOptions
    cost: float  # bsp_cost of the winner (model units)
    regime: str
    features: MatrixFeatures
    candidates: Tuple[Candidate, ...]  # scored, in shortlist order
    tuned: bool = False
    # (strategy, median solve seconds) per candidate when tune=True
    timings: Optional[Tuple[Tuple[str, float], ...]] = None
    # (slack, median solve seconds) per swept staleness window on the
    # clock winner when tune=True ran with elastic allowed
    slack_timings: Optional[Tuple[Tuple[int, float], ...]] = None

    def as_dict(self) -> dict:
        return {
            "strategy": self.strategy,
            "regime": self.regime,
            "cost": self.cost,
            "slack": self.options.slack,  # > 0 when elastic was enabled
            "candidates": [(c.strategy, c.cost) for c in self.candidates],
            "tuned": self.tuned,
            "timings": None if self.timings is None else list(self.timings),
            "slack_timings": (
                None if self.slack_timings is None
                else list(self.slack_timings)
            ),
        }


def classify(f: MatrixFeatures, k: int = 8) -> str:
    """Map features to a regime label (see module docstring table — the
    rule order matters and is part of the N>=1e5 recalibration)."""
    if f.avg_wavefront < 2.0 or f.n <= 64:
        return "serial"
    if f.depth <= 8:
        return "wide"
    if 0.0 < f.mean_band <= 0.1 * f.n:
        return "banded"
    if f.avg_wavefront >= 8 * max(k, 1):
        return "wide"
    return "mixed"


_SHORTLISTS: Dict[str, Tuple[str, ...]] = {
    "serial": ("serial", "growlocal"),
    "wide": ("hdagg", "growlocal", "serial"),
    "banded": ("growlocal", "serial", "funnel-gl"),
    "mixed": ("growlocal", "funnel-gl", "serial"),
}


def shortlist(
    f: MatrixFeatures, options: Optional[ScheduleOptions] = None
) -> Tuple[Candidate, ...]:
    """2–3 candidate configs for these features, in tie-break order.
    Strategy-specific knobs are adapted from the features where it is
    known to matter: the funnel coarsening cap tracks the average
    wavefront so funnels span whole levels (§4)."""
    o = options or ScheduleOptions()
    out = []
    for name in _SHORTLISTS[classify(f, o.k)]:
        oc = o
        if name == "funnel-gl" and o.max_size == ScheduleOptions.max_size:
            # cap funnels near the average level width: big enough to
            # collapse whole wavefronts, small enough to keep k busy —
            # but only when the caller left max_size at its default (an
            # explicitly passed knob is respected as-is)
            oc = o.replace(
                max_size=int(np.clip(2 * f.avg_wavefront, 16, 256))
            )
        out.append(Candidate(strategy=name, options=oc))
    return tuple(out)


def select_schedule(
    dag: SolveDAG,
    options: Optional[ScheduleOptions] = None,
    *,
    features: Optional[MatrixFeatures] = None,
    allow_elastic: bool = False,
) -> Tuple[Selection, Schedule]:
    """Pick a strategy for ``dag``: classify -> shortlist -> score every
    candidate with ``bsp_cost`` -> first minimum wins. Returns the
    audit-friendly ``Selection`` together with the winning schedule (so
    ``schedule(dag, strategy="auto")`` costs nothing extra).

    ``allow_elastic=True`` additionally applies the step-granular elastic
    rule (module docstring): in the "serial"/"banded" regimes, when the
    winning schedule's step count fuses >= 2x at ``DEFAULT_SLACK``, the
    returned options carry ``slack=DEFAULT_SLACK`` so the solver binds
    the elastic executor. The slack is applied to EVERY candidate's
    options, not just the winner's — measured trials (``tune=True``)
    rebuild the tuned Selection from whichever candidate wins the clock,
    and that candidate must keep the elastic decision."""
    o = options or ScheduleOptions()
    if features is not None:
        f = features
    else:
        with obs.span("autotune.features", cat="autotune", n=dag.n):
            f = dag_features(dag)
    regime = classify(f, o.k)
    with obs.span(
        "autotune.select", cat="autotune", regime=regime, n=dag.n
    ) as sel_sp:
        best = None  # (cost, candidate, schedule)
        scored = []
        for c in shortlist(f, o):
            with obs.span(
                f"autotune.score.{c.strategy}", cat="autotune"
            ):
                s = get_scheduler(c.strategy)(dag, c.options)
                cost = bsp_cost(dag, s, L=c.options.L)
            scored.append(dataclasses.replace(c, cost=cost))
            if best is None or cost < best[0]:
                best = (cost, scored[-1], s)
        cost, c, s = best
        sel_sp.set(strategy=c.strategy)
    if allow_elastic and o.slack == 0 and regime in ("serial", "banded"):
        # step-granular rule: elastic pays when the fused trip count
        # ceil(T / slack) is at most half the plan's step count T (the
        # l_step term of step_cost vs elastic_cost; critical work is
        # identical, so comparing the fusion ratio IS comparing costs)
        n_steps = schedule_step_count(s)
        n_macro = -(-n_steps // DEFAULT_SLACK)
        if n_steps >= 2 * n_macro:
            scored = [
                dataclasses.replace(
                    sc, options=sc.options.replace(slack=DEFAULT_SLACK)
                )
                for sc in scored
            ]
            c = dataclasses.replace(
                c, options=c.options.replace(slack=DEFAULT_SLACK)
            )
    sel = Selection(
        strategy=c.strategy,
        options=c.options,
        cost=cost,
        regime=regime,
        features=f,
        candidates=tuple(scored),
    )
    return sel, s


# ------------------------------------------------------------ plan() hook
# Fallback memo for cache-less plans. Unlike a PlanCache's selection dict
# (tiny, scoped to the cache's lifetime) this table is process-global, so
# it is FIFO-capped: a serving loop streaming distinct patterns through
# cache=None must not grow it forever.
_MEMO_LOCK = threading.Lock()
_MEMO_MAX = 4096
_SELECTION_MEMO: Dict[tuple, Selection] = {}


def _memo_store(key: tuple, sel: Selection) -> None:
    with _MEMO_LOCK:
        while len(_SELECTION_MEMO) >= _MEMO_MAX:
            _SELECTION_MEMO.pop(next(iter(_SELECTION_MEMO)))
        _SELECTION_MEMO[key] = sel


def clear_selection_memo() -> None:
    with _MEMO_LOCK:
        _SELECTION_MEMO.clear()


def _binding_key(plan_kwargs: Optional[dict]) -> tuple:
    """The plan_kwargs that influence measured-trial timings (tune=True):
    two bindings that run differently must not share a tuned pick.
    Delegates to the same ``binding_fingerprint`` that keys the plan
    cache, so the two identities can never drift apart. The backend name
    is resolved against ``repro_torch.backends.registry`` — measured
    trials run on whatever backend the registry serves for that name, so
    an unknown name fails here instead of inside a half-timed trial — and
    the device through ``resolve_device`` (``None`` is the card)."""
    from repro_torch.backends import get_backend
    from repro_torch.pipeline.solver import binding_fingerprint

    pk = plan_kwargs or {}
    return binding_fingerprint(
        backend=get_backend(pk.get("backend", "kernel")).name,
        dtype=pk.get("dtype", torch.float32),
        width=pk.get("width"),
        device=resolve_device(pk.get("device")),
        mesh=pk.get("mesh"),
        shard=pk.get("shard", "model"),
    )


def selection_key(
    fp: str, options: ScheduleOptions, lower: bool, tune: bool,
    binding: Optional[tuple] = None, elastic: bool = False,
) -> tuple:
    """Memo key for one auto-selection. ``binding`` (see ``_binding_key``)
    only matters for measured trials; the model-based path is binding-free.
    ``elastic`` is the caller's ``allow_elastic`` flag — the same pattern
    resolved for an elastic-capable binding and for one that cannot run
    elastic (e.g. the distributed backend) must not share a memo entry,
    or the slack decision would leak across backends."""
    return (fp, options, lower, tune, binding if tune else None, elastic)


def resolve_auto(
    a: CSRMatrix,
    *,
    options: ScheduleOptions,
    lower: bool = True,
    tune: bool = False,
    cache=None,
    fp: Optional[str] = None,
    plan_kwargs: Optional[dict] = None,
    allow_elastic: bool = False,
) -> Selection:
    """Resolve ``strategy="auto"`` for matrix ``a`` to a concrete
    ``Selection``, memoized per sparsity fingerprint — in ``cache`` (a
    ``PlanCache``) when given, else module-level. On a memo hit nothing
    is recomputed: the caller goes straight to a concrete plan-cache key.
    """
    sel, _, _ = resolve_auto_full(
        a, options=options, lower=lower, tune=tune, cache=cache, fp=fp,
        plan_kwargs=plan_kwargs, allow_elastic=allow_elastic,
    )
    return sel


def resolve_auto_full(
    a: CSRMatrix,
    *,
    options: ScheduleOptions,
    lower: bool = True,
    tune: bool = False,
    cache=None,
    fp: Optional[str] = None,
    plan_kwargs: Optional[dict] = None,
    allow_elastic: bool = False,
) -> Tuple[Selection, Optional[Schedule], Optional[object]]:
    """``resolve_auto`` plus two cold-path artifacts for ``plan()``:

    * the winner's already-computed ``Schedule`` when the model-based
      selection ran fresh (skips re-running the winning scheduler), or
    * the winner's fully-built trial *solver* when ``tune=True`` ran
      measured trials (skips recompiling the winner).

    Both are None on a memo hit — the caller's plan cache already has, or
    will rebuild, the concrete plan. A fresh selection runs inside one
    ``autotune.resolve`` span (args: the chosen ``strategy``, ``slack`` and
    ``regime``), its DAG build inside ``inspector.dag``."""
    fp = fp if fp is not None else pattern_fingerprint(a)
    # the binding only keys measured trials (selection_key drops it
    # otherwise); resolving it needs the device, which tune=False never uses
    key = selection_key(
        fp, options, lower, tune,
        _binding_key(plan_kwargs) if tune else None, allow_elastic,
    )
    if cache is not None:
        sel = cache.get_selection(key)
    else:
        with _MEMO_LOCK:
            sel = _SELECTION_MEMO.get(key)
    if sel is not None:
        return sel, None, None

    # the same mirror step plan() uses, so the features and candidate
    # costs describe the DAG that will actually be scheduled
    from repro_torch.pipeline.solver import mirror_to_lower

    with obs.span("autotune.resolve", cat="autotune", n=a.n_rows) as sp:
        m0, _ = mirror_to_lower(a, lower)
        with obs.span("inspector.dag", cat="inspector", n=m0.n_rows):
            dag = dag_from_lower_csr(m0)
        with obs.span("autotune.features", cat="autotune", n=m0.n_rows):
            f = matrix_features(m0, dag=dag)
        sel, winning_sched = select_schedule(
            dag, options, features=f, allow_elastic=allow_elastic
        )
        winner_solver = None
        if tune:
            sel, winner_solver = _timed_refine(
                a, sel, lower=lower, plan_kwargs=plan_kwargs,
                allow_elastic=allow_elastic,
            )
            winning_sched = None
        sp.set(strategy=sel.strategy, slack=sel.options.slack, regime=sel.regime)

    if cache is not None:
        cache.store_selection(key, sel)
    else:
        _memo_store(key, sel)
    return sel, winning_sched, winner_solver


# tune=True slack grid: the elastic staleness windows measured trials
# sweep on the winning strategy (plus slack=0, bulk-synchronous, and the
# model rule's pick when it differs). Small on purpose — each point is a
# compile + timed solves; the tuned pick is memoized per fingerprint via
# the selection memo, so the sweep runs once per pattern.
SLACK_GRID = (4, 8, 16)


def _timed_refine(
    a: CSRMatrix,
    sel: Selection,
    *,
    lower: bool,
    plan_kwargs: Optional[dict],
    reps: int = 3,
    allow_elastic: bool = False,
) -> Tuple[Selection, object]:
    """Measured-trial mode: compile every shortlisted candidate through
    the real pipeline and let the median wall-clock of an actual solve
    pick the winner. Trials run against a PRIVATE plan cache — losing
    plans never pollute (or evict hot entries from) the caller's cache,
    and the winner solver is still private when the tuned Selection is
    recorded on it, so no published object is ever mutated. The winner is
    returned for ``plan()`` to insert under its concrete key.

    With ``allow_elastic=True`` the winning strategy is additionally
    swept over ``SLACK_GRID`` (and slack=0): the model's step-granular
    elastic rule picks a fusion ratio, but the best staleness window is
    an instance property only the clock can settle. The swept points
    ride the Selection's ``slack_timings`` (``timings`` stays one row
    per shortlisted strategy), and the tuned options carry whichever
    slack won."""
    import time

    from repro_torch.pipeline.cache import PlanCache
    from repro_torch.pipeline.solver import TriangularSolver

    kw = dict(plan_kwargs or {})
    kw.pop("strategy", None)
    kw.pop("options", None)
    kw["cache"] = PlanCache()  # private to this selection
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.n_rows)

    def _time_plan(label, strategy, options):
        with obs.span(
            f"autotune.trial.{label}", cat="autotune", reps=reps
        ) as tr_sp:
            solver = TriangularSolver.plan(
                a, strategy=strategy, options=options, lower=lower, **kw
            )
            # b on the solver's device once, outside the clock
            bt = torch.as_tensor(b).to(device=solver.device, dtype=solver.dtype)
            on_card = solver.device.type == "cuda"

            def sync():
                if on_card:
                    torch.cuda.synchronize(solver.device)

            solver.solve(bt)  # build the kernels + warm up
            ts = []
            for _ in range(reps):
                # solve() returns before the card has run it: time the
                # repetition between two synchronizations
                sync()
                t0 = time.perf_counter()
                solver.solve(bt)
                sync()
                ts.append(time.perf_counter() - t0)
            median = float(np.median(ts))
            tr_sp.set(median_us=round(median * 1e6, 1))
        return solver, median

    timings = []
    trial = {}  # strategy -> solver
    for c in sel.candidates:
        solver, median = _time_plan(c.strategy, c.strategy, c.options)
        trial[c.strategy] = solver
        timings.append((c.strategy, median))
    t_of = dict(timings)
    winner = min(sel.candidates, key=lambda c: t_of[c.strategy])
    win_options = winner.options
    winner_solver = trial[winner.strategy]

    slack_timings = None
    if allow_elastic:
        # sweep the slack dimension on the clock winner; the point the
        # model already picked (win_options.slack) reuses its timing
        base_slack = win_options.slack
        best = (t_of[winner.strategy], base_slack, winner_solver)
        slack_rows = [(base_slack, best[0])]
        for s in sorted({0, *SLACK_GRID} - {base_slack}):
            solver_s, median = _time_plan(
                f"{winner.strategy}.slack{s}",
                winner.strategy,
                win_options.replace(slack=s),
            )
            slack_rows.append((s, median))
            if median < best[0]:
                best = (median, s, solver_s)
        if best[1] != base_slack:
            win_options = win_options.replace(slack=best[1])
            winner_solver = best[2]
        slack_timings = tuple(sorted(slack_rows))

    tuned = dataclasses.replace(
        sel,
        strategy=winner.strategy,
        options=win_options,
        cost=winner.cost,
        tuned=True,
        timings=tuple(timings),
        slack_timings=slack_timings,
    )
    winner_solver._selection = tuned  # still private — safe to record
    return tuned, winner_solver
