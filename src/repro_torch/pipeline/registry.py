"""Scheduler registry: every strategy behind one uniform signature.

The paper compares five schedulers (plus serial and the §3.1 block
variant); benchmarks, examples and the ``TriangularSolver`` front-end all
want to swap them per call. Each registered strategy is a callable

    fn(dag: SolveDAG, opts: ScheduleOptions) -> Schedule

and ``schedule(dag, k, strategy=..., **opts)`` is the public entry point.
Third-party strategies can join via ``@register_scheduler("name")``.

``strategy="auto"`` is a *meta*-strategy, not a registry entry: it asks
the autotuner (``repro_torch.autotune``) to pick among the registered strategies
by DAG features + the §2.2 cost model. It is accepted by ``schedule`` and
``TriangularSolver.plan`` but deliberately absent from
``available_strategies()`` — everything listed there is a concrete
schedule an auto-selection can resolve *to*.

A copy of the JAX package's ``pipeline/registry.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch import obs
from repro_torch.core import (
    DEFAULT_L,
    Schedule,
    block_parallel_schedule,
    funnel_grow_local,
    grow_local,
    hdagg_schedule,
    serial_schedule,
    spmp_like_schedule,
    wavefront_schedule,
)
from repro_torch.sparse.dag import SolveDAG


@dataclasses.dataclass(frozen=True)
class ScheduleOptions:
    """Knobs shared by all strategies (strategy-specific ones are simply
    ignored by strategies that don't use them — the point is that one
    options object can drive any registry entry)."""

    k: int = 8  # cores (plan lanes)
    L: float = DEFAULT_L  # barrier penalty (paper §2.2)
    max_size: int = 64  # funnel coarsening cap (§4)
    sparsify: bool = True  # transitive sparsification pre-pass
    reorder: bool = True  # §5 locality reordering (consumed by the solver)
    n_blocks: int = 4  # diagonal blocks for the "block" strategy (§3.1)
    # elastic staleness window (consumed by the solver's backend binding,
    # not the schedulers): 0 = bulk-synchronous, s > 0 runs the plan in
    # windows of s plan steps (scan) or s supersteps (kernel)
    # (core.elastic; mode="elastic")
    slack: int = 0

    def replace(self, **kw) -> "ScheduleOptions":
        return dataclasses.replace(self, **kw)


SchedulerFn = Callable[[SolveDAG, ScheduleOptions], Schedule]

_REGISTRY: Dict[str, SchedulerFn] = {}


def register_scheduler(name: str):
    """Decorator: ``@register_scheduler("mine")`` on a
    ``fn(dag, opts) -> Schedule``."""

    def deco(fn: SchedulerFn) -> SchedulerFn:
        key = name.lower()
        if key == "auto":
            raise ValueError(
                "'auto' is reserved for the autotuner meta-strategy"
            )
        if key in _REGISTRY:
            raise ValueError(f"scheduler {name!r} already registered")
        _REGISTRY[key] = fn
        return fn

    return deco


def get_scheduler(name: str) -> SchedulerFn:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        if name.lower() == "auto":
            raise KeyError(
                "'auto' is a meta-strategy with no registry entry; call "
                "schedule(dag, strategy='auto') or "
                "TriangularSolver.plan(a, strategy='auto') instead"
            ) from None
        raise KeyError(
            f"unknown strategy {name!r}; available: {available_strategies()}"
        ) from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def schedule(
    dag: SolveDAG,
    k: int | None = None,
    *,
    strategy: str = "growlocal",
    options: ScheduleOptions | None = None,
    **opts,
) -> Schedule:
    """Run a registered strategy (or ``"auto"`` — the autotuner picks one
    by DAG features). ``k``/keyword opts override ``options``."""
    strategy = strategy.lower()
    o = options or ScheduleOptions()
    if k is not None:
        o = o.replace(k=k)
    if opts:
        o = o.replace(**opts)
    if strategy == "auto":
        from repro_torch.autotune.selector import select_schedule

        return select_schedule(dag, o)[1]
    with obs.span(
        f"inspector.schedule.{strategy}",
        cat="inspector",
        n=dag.n,
        k=o.k,
    ):
        return get_scheduler(strategy)(dag, o)


@register_scheduler("growlocal")
def _growlocal(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return grow_local(dag, o.k, L=o.L)


@register_scheduler("funnel-gl")
def _funnel_gl(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return funnel_grow_local(
        dag, o.k, max_size=o.max_size, L=o.L, sparsify=o.sparsify
    )


@register_scheduler("hdagg")
def _hdagg(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return hdagg_schedule(dag, o.k)


@register_scheduler("spmp")
def _spmp(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return spmp_like_schedule(dag, o.k, sparsify=o.sparsify)


@register_scheduler("wavefront")
def _wavefront(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return wavefront_schedule(dag, o.k)


@register_scheduler("serial")
def _serial(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return serial_schedule(dag)


@register_scheduler("block")
def _block(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return block_parallel_schedule(
        dag, o.k, o.n_blocks, lambda d, k: grow_local(d, k, L=o.L)
    )
