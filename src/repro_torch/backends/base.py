"""The execution-backend protocol: ``Backend.bind(plan) -> BoundSolve``.

  * ``Backend`` — a named, stateless factory. ``bind(exec_plan, *, dtype,
    device, slack)`` moves the plan tensors to the device (the card unless
    the caller passes ``device="cpu"``) once and returns a ``BoundSolve``;
    ``slack > 0`` binds ``mode="elastic"`` where ``capabilities()`` lists
    ``"elastic"``.
  * ``BoundSolve`` — an immutable bound solver:
      - ``solve(b)`` for ``b`` f[n] or f[n, m] (multi-RHS), a tensor on
        the bound's device, in plan row order;
      - ``solve_timed(b) -> (x, steps)`` — the same bits, with per-step
        timings at the finest granularity the backend can observe;
      - ``update_values(data) -> BoundSolve`` refreshes the numeric values
        *on the device* — a ``torch.where`` gather of the new entry data
        through the plan's ``val_src``/``diag_src`` maps — and returns a NEW
        bound solve sharing the (read-only) index tensors; the old bound is
        untouched;
      - ``describe()`` — a JSON-ready dict for telemetry.

The value contract ``update_values`` must honor: a solve after
``update_values(data)`` is bitwise-identical to a solve on a fresh ``bind``
of a plan compiled from the same pattern with ``data``.

The port keeps its own registry (``repro_torch.backends.registry``); it
never registers into the JAX package's.
"""
from __future__ import annotations

import abc
from typing import Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import timed_us

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy twin of a solver dtype (float32 or float64); raises on
    any other."""
    try:
        return np.dtype(_NP_DTYPE[dtype])
    except KeyError:
        raise ValueError(
            f"dtype must be torch.float32 or torch.float64; got {dtype!r}"
        ) from None


def masked_value_gather(data, val_src, vals_old, diag_src, diag_old):
    """The shared device-side numeric refresh: gather ``data`` (the new
    matrix's entry values, already cast to the plan dtype, on the plan's
    device) through the source maps, keeping the old value wherever the map
    says padding (``src < 0``). Returns ``(vals, diag)`` as new tensors.

    Bitwise-identical to the host path (``ExecPlan.numeric_update`` +
    re-bind): the f64 -> plan-dtype cast happens per element on the host,
    and the gather moves bits unchanged."""
    vals = torch.where(val_src >= 0, data[val_src.clamp(min=0)], vals_old)
    diag = torch.where(diag_src >= 0, data[diag_src.clamp(min=0)], diag_old)
    return vals, diag


def expected_entry_count(exec_plan) -> int:
    """Length the ``update_values`` data vector must have: the planned
    pattern's entry count, recovered from the source maps (every stored
    entry of a full-diagonal matrix is referenced by exactly one of
    them, so the max index + 1 is the nnz)."""
    hi = -1
    if exec_plan.val_src is not None and exec_plan.val_src.size:
        hi = max(hi, int(exec_plan.val_src.max()))
    if exec_plan.diag_src is not None and exec_plan.diag_src.size:
        hi = max(hi, int(exec_plan.diag_src.max()))
    return hi + 1


class BoundSolve(abc.ABC):
    """A plan bound to one execution backend. Immutable: value refreshes
    return a new instance (see module docstring)."""

    backend: str  # registry name of the backend that produced this
    n: int  # problem size (scratch row excluded)
    n_entries: int  # entry count update_values data must match

    def _check_data(self, data) -> np.ndarray:
        """Reject mis-sized update data: a wrong-pattern data vector would
        otherwise gather garbage values instead of raising."""
        data = np.asarray(data)
        if data.ndim != 1 or data.shape[0] != self.n_entries:
            raise ValueError(
                f"update_values expects the planned pattern's entry data "
                f"f[{self.n_entries}]; got shape {data.shape}"
            )
        return data

    @abc.abstractmethod
    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Solve for ``b`` f[n] or f[n, m]; returns x shaped like b."""

    def solve_timed(self, b: torch.Tensor):
        """``solve`` plus per-step timings: returns ``(x, steps)``, where
        ``steps`` is a list of JSON-ready dicts at the finest granularity
        the backend can observe. This fallback times the whole solve as
        ONE step (``device.timed_us``: CUDA events around it on the card,
        the host clock on the CPU); the scan backend overrides it with
        per-superstep (bulk) / per-macro-step (elastic) segments."""
        with obs.span("executor.solve_timed", cat="executor", n=self.n):
            x, us = timed_us(lambda: self.solve(b), b.device)
        return x, [{"step": 0, "n_steps": None, "us": us}]

    @abc.abstractmethod
    def update_values(self, data: np.ndarray) -> "BoundSolve":
        """Device-side numeric refresh from ``data`` (the ``.data`` of a
        matrix with the planned pattern, in plan entry order). Returns a
        NEW BoundSolve sharing index tensors; self is untouched."""

    @abc.abstractmethod
    def describe(self) -> dict:
        """JSON-ready binding telemetry (backend, shapes, device bytes)."""


class Backend(abc.ABC):
    """A named execution backend — a ``BoundSolve`` factory."""

    name: str

    @abc.abstractmethod
    def bind(
        self, exec_plan, *, dtype=torch.float32, device=None, slack: int = 0
    ) -> BoundSolve:
        """Move ``exec_plan``'s tensors to ``device`` and return a
        ``BoundSolve``. ``device=None`` means the card and raises without
        CUDA (``repro_torch.device.resolve_device``); pass ``"cpu"`` to
        bind on the CPU.

        ``slack > 0`` requests ``mode="elastic"`` (bounded-slack execution,
        see ``core.elastic``); a backend that does not advertise the
        ``"elastic"`` capability must raise rather than silently fall back
        to bulk-synchronous."""

    def capabilities(self) -> Tuple[str, ...]:
        """Optional features this backend's bounds implement beyond the
        core contract. Known so far: ``"elastic"`` — ``bind(slack=s)``
        executes the bounded-slack mode, bitwise-identical to the
        bulk-synchronous bound."""
        return ()
