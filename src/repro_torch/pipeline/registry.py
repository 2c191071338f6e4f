"""Scheduler registry: every strategy behind one uniform signature.

Each registered strategy is a callable

    fn(dag: SolveDAG, opts: ScheduleOptions) -> Schedule

and ``schedule(dag, k, strategy=..., **opts)`` is the public entry point.
Third-party strategies can join via ``@register_scheduler("name")``.

A copy of the JAX package's ``pipeline/registry.py`` with the strategies
the port has so far: ``growlocal`` (the paper's, the default) and
``serial``. The other strategies join with their ``core`` modules.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch import obs
from repro_torch.core import DEFAULT_L, Schedule, grow_local, serial_schedule
from repro_torch.sparse.dag import SolveDAG


@dataclasses.dataclass(frozen=True)
class ScheduleOptions:
    """Knobs shared by all strategies (strategy-specific ones are simply
    ignored by strategies that don't use them)."""

    k: int = 8  # cores (plan lanes)
    L: float = DEFAULT_L  # barrier penalty (paper §2.2)
    reorder: bool = True  # §5 locality reordering (consumed by the solver)
    # elastic staleness window (consumed by the solver's backend binding,
    # not the schedulers): 0 = bulk-synchronous, s > 0 runs the plan in
    # s-step windows (core.elastic; mode="elastic")
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
        if key in _REGISTRY:
            raise ValueError(f"scheduler {name!r} already registered")
        _REGISTRY[key] = fn
        return fn

    return deco


def get_scheduler(name: str) -> SchedulerFn:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
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
    """Run a registered strategy. ``k``/keyword opts override ``options``."""
    strategy = strategy.lower()
    o = options or ScheduleOptions()
    if k is not None:
        o = o.replace(k=k)
    if opts:
        o = o.replace(**opts)
    with obs.span(
        f"inspector.schedule.{strategy}", cat="inspector", n=dag.n, k=o.k
    ):
        return get_scheduler(strategy)(dag, o)


@register_scheduler("growlocal")
def _growlocal(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return grow_local(dag, o.k, L=o.L)


@register_scheduler("serial")
def _serial(dag: SolveDAG, o: ScheduleOptions) -> Schedule:
    return serial_schedule(dag)
