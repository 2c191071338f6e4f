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
      - ``describe()`` — a JSON-ready dict for telemetry;
      - ``take_row_order(perm)`` — where the bound can (the ``kernel``
        backend on the card), it takes the caller's row permutation once
        and from then on ``solve_ordered(b)`` solves b in the caller's row
        order, bitwise ``solve(b[perm])[inv]``, and ``front_door`` reads
        ``"ordered"``; elsewhere it declines and the front door gathers;
      - where ``supports_grouped``: classmethods that solve one rhs per
        plan of one width class in one dispatch (``solve_grouped``), over
        a bank stacked once (``stack_bank`` / ``solve_bank``), and over a
        resident rhs bank (``blank_rhs`` / ``insert_lane`` /
        ``extract_lane`` / ``solve_resident``).

The value contract ``update_values`` must honor: a solve after
``update_values(data)`` is bitwise-identical to a solve on a fresh ``bind``
of a plan compiled from the same pattern with ``data``.

The port keeps its own registry (``repro_torch.backends.registry``); it
never registers into the JAX package's.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.elastic import elastic_transform
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


def bind_checks(exec_plan, slack: int):
    """What a one-device bind checks of ``exec_plan`` before it moves
    anything, and the plan it binds: the value-source maps present, the
    entry count ``update_values`` data must match, and for ``slack > 0``
    the plan with an elastic certificate at that slack (``plan.elastic``
    where it has that slack, else ``core.elastic.elastic_transform``).
    Returns ``(exec_plan, n_entries)``."""
    if exec_plan.val_src is None or exec_plan.diag_src is None:
        raise ValueError("the plan carries no value-source maps")
    n_entries = expected_entry_count(exec_plan)
    ep = exec_plan.elastic
    if slack > 0 and (ep is None or ep.slack != slack):
        exec_plan = dataclasses.replace(exec_plan, elastic=elastic_transform(exec_plan, slack))
    return exec_plan, n_entries


def device_bytes(tensors) -> int:
    """The bytes ``tensors`` hold: a bound's ``describe()["device_bytes"]``."""
    return int(sum(t.numel() * t.element_size() for t in tensors))


class BoundSolve(abc.ABC):
    """A plan bound to one execution backend. Immutable: value refreshes
    return a new instance (see module docstring)."""

    backend: str  # registry name of the backend that produced this
    n: int  # problem size (scratch row excluded)
    n_entries: int  # entry count update_values data must match

    # width-class grouping: True when this bound can solve one rhs per
    # plan of one width class in a single dispatch (capability
    # ``"grouped"``). Advertising it is a three-method contract:
    # ``solve_grouped`` (stack per call; the replay path) plus
    # ``stack_bank`` / ``solve_bank`` (the serving path —
    # ``repro_torch.pipeline.GroupBank`` dispatches through them).
    supports_grouped: bool = False

    # "ordered": solve_ordered takes b in the caller's row order (after
    # take_row_order); "gather": the front door permutes around solve
    front_door: str = "gather"

    def take_row_order(self, perm: torch.Tensor) -> None:
        """Take the caller's row permutation ``perm`` (int64[n]: plan row
        i is the caller's row ``perm[i]``) where this bound can, so that
        ``solve_ordered`` serves b in the caller's order and ``front_door``
        reads ``"ordered"``; here it cannot, and ``front_door`` stays
        ``"gather"``."""

    def solve_ordered(self, b: torch.Tensor) -> torch.Tensor:
        """Solve for ``b`` f[n] or f[n, m] in the caller's row order (where
        ``front_door`` reads ``"ordered"``); x in the caller's row order."""
        raise self._unsupported("solves in the caller's row order")

    @classmethod
    def _unsupported(cls, what: str):
        return NotImplementedError(
            f"backend {getattr(cls, 'backend', cls.__name__)!r} does not support {what}"
        )

    @classmethod
    def solve_grouped(cls, bounds, b_cols):
        """Solve lane j of ``b_cols`` f[g, n] (plan row order) against
        ``bounds[j]`` — one dispatch for the whole group. All bounds share
        one width class (equal plan tensor shapes, dtype and device).
        Returns x f[g, n]. Only meaningful when ``supports_grouped``."""
        raise cls._unsupported("width-class grouped solves")

    @classmethod
    def stack_bank(cls, bounds, perms, invs):
        """Stack one width class's bounds into an opaque device bank (lane
        axis first, padded up to a power of two) with per-lane row
        permutations ``perms`` / ``invs`` (int64[n] each) — restacked only
        when membership changes; only ever passed back to ``solve_bank`` /
        ``solve_resident``."""
        raise cls._unsupported("width-class grouped solves (no bank support)")

    @classmethod
    def solve_bank(cls, bank, lane_idx, B):
        """Solve column j of ``B`` f[n, m] (caller row order) against bank
        lane ``lane_idx[j]``; returns x f[n, m] (caller order), bitwise
        ``solve_grouped`` on the same lanes."""
        raise cls._unsupported("width-class grouped solves (no bank support)")

    # resident RHS slots — the continuous-batching serve contract
    # (capability ``"slots"``): a resident rhs bank f[n, S] on the device
    # that admission writes slot by slot (``insert_lane``), each dispatch
    # pass solves a lane prefix of (``solve_resident``, bitwise
    # ``solve_bank`` on the same lanes), and completion reads out of
    # (``extract_lane``). The three device ops move bits unchanged and
    # never perturb neighbour slots.
    @classmethod
    def blank_rhs(cls, n, slots, dtype, device):
        """A zeroed resident rhs bank f[n, slots] on ``device``."""
        raise cls._unsupported("resident RHS slots (no 'slots' capability)")

    @classmethod
    def insert_lane(cls, B_res, lane, b):
        """A NEW resident bank with column ``lane`` replaced by ``b`` f[n];
        every other column's bits are untouched and the input bank is not
        mutated (a pass in flight keeps its snapshot)."""
        raise cls._unsupported("resident RHS slots (no 'slots' capability)")

    @classmethod
    def extract_lane(cls, X, lane):
        """Column ``lane`` of a pass result ``X`` f[n, S] as f[n], bits
        unchanged."""
        raise cls._unsupported("resident RHS slots (no 'slots' capability)")

    @classmethod
    def solve_resident(cls, bank, lane_idx, B_res):
        """One continuous-mode pass: solves the first ``len(lane_idx)``
        columns of the resident bank (the engine's pow2 occupied-lane
        prefix), bitwise ``solve_bank`` on that prefix; ``B_res`` is on
        the device already, so nothing re-uploads."""
        raise cls._unsupported("resident RHS slots (no 'slots' capability)")

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

    def requires(self) -> Tuple[str, ...]:
        """Binding parameters this backend cannot run without: ``("mesh",)``
        for the distributed backend, which ``TriangularSolver.plan`` then
        hands ``mesh=`` and ``shard=``."""
        return ()

    def capabilities(self) -> Tuple[str, ...]:
        """Optional features this backend's bounds implement beyond the
        core contract: ``"grouped"`` — the bulk bound solves one rhs per
        plan of one width class in a single dispatch
        (``BoundSolve.solve_grouped`` / ``stack_bank`` / ``solve_bank``;
        the serve layer's cross-pattern batching keys on it);
        ``"elastic"`` — ``bind(slack=s)`` executes the bounded-slack mode,
        bitwise-identical to the bulk-synchronous bound; ``"slots"`` —
        resident RHS slots on the stacked bank (``blank_rhs`` /
        ``insert_lane`` / ``extract_lane`` / ``solve_resident``; the
        continuous-batching serve engine, ``repro_torch.serve.slots``,
        requires it); ``"shard-rows"`` — ``bind(shard="rows")`` partitions
        the plan's rows across a mesh (the distributed backend)."""
        return ()
