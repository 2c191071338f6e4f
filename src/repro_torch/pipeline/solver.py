"""``TriangularSolver`` — plan once, solve many times, on the card.

``TriangularSolver.plan(L)`` runs the full inspector pipeline

    DAG build -> schedule (registry strategy) -> §5 reordering ->
    ``compile_plan`` -> backend binding (``repro_torch.backends`` registry)

and returns a bound solver whose ``solve(b)`` applies and undoes every
permutation internally — callers never see reordered indices. ``b`` may be
``f[n]`` or batched ``f[n, m]`` (multi-RHS; one plan traversal), as numpy
or torch; the result is a torch tensor on the solver's device.

The solver runs on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises when CUDA is not available;
it never drops silently to the CPU. The default backend ``"kernel"`` runs
the CUDA kernels; ``"scan"`` runs the plain PyTorch executor.
``mode="elastic"`` runs the plan under a staleness bound of ``slack``
(``core.elastic``), bitwise-identical to the default ``"bsp"``: the
``"scan"`` backend in macro-steps of ``slack`` plan steps, the ``"kernel"``
backend level by level over runs of ``slack`` supersteps.

``lower=False`` solves an *upper*-triangular system via the
reverse-permutation trick (an upper-triangular matrix reversed
symmetrically is lower triangular again), which together with
``factor_pair`` gives the forward/backward pair PCG needs:

    fwd, bwd = factor_pair(Lf)        # Lf y = b, then Lf^T x = y

Pass a ``PlanCache`` to amortize the inspector across solves that share a
sparsity pattern — hits skip scheduling entirely and only refresh the
numeric values (paper §7.7's regime).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends import get_backend
from repro_torch.backends.base import numpy_dtype
from repro_torch.core import (
    DEFAULT_SLACK,
    apply_reordering,
    compile_plan,
    elastic_transform,
)
from repro_torch.core.plan import ExecPlan
from repro_torch.device import resolve_device
from repro_torch.pipeline.cache import PlanCache
from repro_torch.pipeline.registry import ScheduleOptions, get_scheduler
from repro_torch.sparse.csr import (
    CSRMatrix,
    pattern_fingerprint,
    permute_symmetric,
    transpose_csr,
)
from repro_torch.sparse.dag import dag_from_lower_csr


def binding_fingerprint(*, backend, dtype, width, device, slack=0) -> tuple:
    """The backend-binding part of a plan's identity — everything beyond
    (pattern, strategy, options, orientation) that changes the bound
    solver. ``slack > 0`` marks an elastic binding, a different execution
    from the bulk one even though the plan tensors match.
    ``steps_per_tile`` is not part of it: no kernel of the port reads it."""
    return (
        backend,
        str(dtype),
        width if width is not None else "auto",
        str(device),
        slack,
    )


def mirror_to_lower(a: CSRMatrix, lower: bool):
    """``(m0, outer)``: the lower-triangular matrix the schedulers actually
    see, plus the outer reverse permutation (None when ``lower=True``).
    Reversed symmetrically, an upper-triangular matrix is lower triangular
    again (the L^T trick, paper §5 footnote)."""
    if lower:
        if not a.is_lower_triangular():
            raise ValueError("expected a lower-triangular matrix")
        return a, None
    if not bool(np.all(a.indices >= a.row_of_entry())):
        raise ValueError("lower=False expects an upper-triangular matrix")
    outer = np.arange(a.n_rows, dtype=np.int64)[::-1].copy()
    return permute_symmetric(a, outer), outer


def _entry_permutation(m: CSRMatrix, perm: np.ndarray) -> np.ndarray:
    """``e`` such that ``permute_symmetric(m, perm).data == m.data[e]``.

    Two relabel gathers and one ``lexsort`` whose key order (cols minor,
    rows major) matches ``csr_from_coo`` exactly; the (row, col) pairs of
    a CSR pattern are unique, so the result is identical entry-for-entry.
    """
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty(m.n_rows, dtype=np.int64)
    inv[perm] = np.arange(m.n_rows, dtype=np.int64)
    return np.lexsort((inv[m.indices], inv[m.row_of_entry()]))


def _entry_data(a, fingerprint: str, what: str) -> np.ndarray:
    """The entry values of ``a`` — a CSRMatrix with the planned pattern
    (fingerprint-checked) or its raw ``.data``."""
    if isinstance(a, CSRMatrix):
        if pattern_fingerprint(a) != fingerprint:
            raise ValueError(
                f"{what} requires the sparsity pattern the plan was built "
                "for (pattern fingerprint mismatch)"
            )
        return a.data
    return np.asarray(a)


class TriangularSolver:
    """A bound, permutation-transparent triangular solver. Construct via
    :meth:`plan` (or :func:`factor_pair`), not directly."""

    def __init__(
        self,
        *,
        exec_plan: ExecPlan,
        total_perm: np.ndarray,
        backend: str,
        dtype: torch.dtype,
        device: torch.device,
        fingerprint: str,
        strategy: str,
        lower: bool,
        inspector_seconds: float,
        steps_per_tile: int = 8,
        slack: int = 0,
    ):
        self.exec_plan = exec_plan
        self.backend = backend
        self.dtype = dtype
        self.device = device
        self.fingerprint = fingerprint
        self.strategy = strategy
        self.lower = lower
        self.inspector_seconds = inspector_seconds
        self._steps_per_tile = steps_per_tile
        self._slack = slack  # > 0: elastic execution mode
        self._source_data: Optional[np.ndarray] = None  # set by plan()
        self.plan_key = None  # plan-cache key, set by plan()
        total_inv = np.empty_like(total_perm)
        total_inv[total_perm] = np.arange(len(total_perm))
        self._perm = torch.as_tensor(total_perm, dtype=torch.int64).to(device)
        self._inv = torch.as_tensor(total_inv, dtype=torch.int64).to(device)
        # bind once; numeric refreshes go through the bound solve's
        # device-side update_values gather, never back here
        self._bound = get_backend(backend).bind(
            exec_plan, dtype=dtype, device=device, slack=slack
        )

    @property
    def bound(self):
        """The backend ``BoundSolve`` this solver executes through
        (telemetry via ``bound.describe()``)."""
        return self._bound

    # ---------------------------------------------------------- solving
    def _check_b(self, b) -> torch.Tensor:
        b = torch.as_tensor(b).to(device=self.device, dtype=self.dtype)
        if b.dim() not in (1, 2) or b.shape[0] != self.n:
            raise ValueError(
                f"b must be [n] or [n, m] with n={self.n}; got {tuple(b.shape)}"
            )
        return b

    def solve(self, b) -> torch.Tensor:
        """Solve the planned system for ``b``: f[n] or f[n, m] (multi-RHS),
        numpy or torch. Input/output live in the caller's original row
        ordering; the result is a tensor on the solver's device."""
        b = self._check_b(b)
        with obs.span("executor.solve", cat="executor", n=self.n):
            x = self._bound.solve(b[self._perm])
            return x[self._inv]

    __call__ = solve

    def numeric_update(self, a) -> None:
        """Refresh values from ``a`` — a CSRMatrix with the planned sparsity
        pattern, or its raw ``.data`` — without rescheduling. Mutates THIS
        solver in place (plan-cache hits clone instead, so solvers returned
        from earlier ``plan`` calls are never touched behind their backs)."""
        data = _entry_data(a, self.fingerprint, "numeric_update")
        # host mirror: the host plan tensors stay a faithful source for any
        # future bind of this plan (a deliberate O(plan) host cost)
        self.exec_plan.numeric_update(data)
        self._source_data = np.array(data)
        # device refresh: an O(nnz) gather through val_src/diag_src
        self._bound = self._bound.update_values(data)

    def _with_values(self, data: np.ndarray) -> "TriangularSolver":
        """A sibling solver with new numeric values: shares the (read-only)
        schedule/index structure, owns its value tensors and binding."""
        new = copy.copy(self)
        new.exec_plan = dataclasses.replace(
            self.exec_plan,
            vals=self.exec_plan.vals.copy(),
            diag=self.exec_plan.diag.copy(),
        )
        new.numeric_update(data)
        return new

    def clone_with_values(self, a) -> "TriangularSolver":
        """Sibling with new values: ``a`` is a CSRMatrix with the planned
        pattern (fingerprint-checked) or its raw ``.data``. THIS solver is
        untouched."""
        return self._with_values(_entry_data(a, self.fingerprint, "clone_with_values"))

    @property
    def source_values(self) -> Optional[np.ndarray]:
        """The caller-order entry values this solver was built/refreshed
        from."""
        return self._source_data

    @property
    def n(self) -> int:
        return self.exec_plan.n

    @property
    def n_supersteps(self) -> int:
        return self.exec_plan.n_supersteps

    def info(self) -> dict:
        binding = self._bound.describe()
        return {
            "strategy": self.strategy,
            "backend": self.backend,
            "mode": "elastic" if self._slack else "bsp",
            "slack": self._slack,
            # what one unit of slack is to the backend: "plan_steps" (scan)
            # or "supersteps" (kernel); None in mode="bsp"
            "slack_unit": binding.get("slack_unit"),
            "device": str(self.device),
            "lower": self.lower,
            "n_supersteps": self.n_supersteps,
            "inspector_seconds": self.inspector_seconds,
            "steps_per_tile": self._steps_per_tile,
            "plan": self.exec_plan.stats(),
            "binding": binding,
        }

    # ---------------------------------------------------------- planning
    @classmethod
    def plan(
        cls,
        a: CSRMatrix,
        *,
        strategy: str = "growlocal",
        backend: str = "kernel",
        lower: bool = True,
        k: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        width: Optional[int] = None,
        options: Optional[ScheduleOptions] = None,
        cache: Optional[PlanCache] = None,
        steps_per_tile: int = 8,
        mode: Optional[str] = None,
        device=None,
        **opts,
    ) -> "TriangularSolver":
        """Plan a solver for triangular ``a`` (lower, or upper with
        ``lower=False``) on ``device`` (default: the CUDA device; raises
        without CUDA unless ``device="cpu"``). ``dtype`` is
        ``torch.float32`` or ``torch.float64``; ``backend`` is ``"kernel"``
        or ``"scan"``. With ``cache``, a repeated sparsity pattern skips the
        inspector: identical values return the cached solver as-is; new
        values return a clone with refreshed numerics (solvers from earlier
        calls are never mutated). ``steps_per_tile`` (the TPU kernel's tile
        size) is accepted and reported by ``info()``; the CUDA kernels do
        not tile, so it changes neither the binding nor the cache key.

        ``mode`` selects the execution mode: ``"bsp"`` (bulk-synchronous,
        the default) or ``"elastic"`` — the plan runs under a staleness
        bound of ``slack`` (``core.elastic``), with bitwise the same result:
        the ``"scan"`` backend in macro-steps of ``slack`` plan steps, the
        ``"kernel"`` backend level by level over runs of ``slack``
        supersteps (``info()["slack_unit"]`` says which). ``mode="elastic"``
        takes ``slack`` from ``slack=...`` (a ``ScheduleOptions`` knob) or
        ``core.DEFAULT_SLACK``; ``slack > 0`` alone also selects elastic.
        The backend must advertise the ``"elastic"`` capability."""
        strategy = strategy.lower()
        # fail fast on an unknown backend, with the registry naming options
        backend_caps = get_backend(backend).capabilities()
        np_dtype = numpy_dtype(dtype)
        dev = resolve_device(device)
        o = options or ScheduleOptions()
        if k is not None:
            o = o.replace(k=k)
        if opts:
            o = o.replace(**opts)
        if o.slack < 0:  # the JAX package takes it for bsp, and info() for elastic
            raise ValueError(f"slack must be >= 0; got {o.slack}")
        if mode is not None and mode not in ("bsp", "elastic"):
            raise ValueError(
                f"mode must be 'bsp' or 'elastic'; got {mode!r}"
            )
        if mode == "elastic" and o.slack == 0:
            o = o.replace(slack=DEFAULT_SLACK)
        if mode == "bsp" and o.slack > 0:
            raise ValueError(
                f"mode='bsp' conflicts with slack={o.slack}; drop one"
            )
        if o.slack > 0 and "elastic" not in backend_caps:
            raise ValueError(
                f"backend {backend!r} does not support mode='elastic' "
                f"(requested slack={o.slack}, no 'elastic' capability)"
            )
        get_scheduler(strategy)  # fail fast on an unknown strategy
        fp = pattern_fingerprint(a)
        key = (fp, strategy, o, lower) + binding_fingerprint(
            backend=backend, dtype=dtype, width=width, device=dev, slack=o.slack
        )

        def build() -> "TriangularSolver":
            t0 = time.perf_counter()
            n = a.n_rows
            m0, outer = mirror_to_lower(a, lower)
            with obs.span("inspector.dag", cat="inspector", n=n):
                dag = dag_from_lower_csr(m0)
            with obs.span(
                f"inspector.schedule.{strategy}", cat="inspector", n=n, k=o.k
            ):
                s = get_scheduler(strategy)(dag, o)
            if o.reorder:
                with obs.span("inspector.reorder", cat="inspector", n=n):
                    m2, s2, _, r = apply_reordering(m0, s)
                inner = r.perm
            else:
                m2, s2, inner = m0, s, np.arange(n, dtype=np.int64)

            plan = compile_plan(m2, s2, width=width, dtype=np_dtype)
            if o.slack > 0:
                # attach the slack certificate so the backend bind (and
                # ExecPlan.stats barrier accounting) reuse one transform
                with obs.span("inspector.elastic", cat="inspector", n=n):
                    plan.elastic = elastic_transform(plan, o.slack)

            # rebase the plan's value-source maps onto a's entry order so
            # numeric_update() consumes a.data directly
            entry_map = _entry_permutation(m0, inner)  # m2 entry -> m0 entry
            if outer is not None:
                entry_map = _entry_permutation(a, outer)[entry_map]
            vmask = plan.val_src >= 0
            plan.val_src[vmask] = entry_map[plan.val_src[vmask]]
            dmask = plan.diag_src >= 0
            plan.diag_src[dmask] = entry_map[plan.diag_src[dmask]]

            total_perm = inner if outer is None else outer[inner]
            solver = cls(
                exec_plan=plan,
                total_perm=total_perm,
                backend=backend,
                dtype=dtype,
                device=dev,
                fingerprint=fp,
                strategy=strategy,
                lower=lower,
                inspector_seconds=time.perf_counter() - t0,
                steps_per_tile=steps_per_tile,
                slack=o.slack,
            )
            solver._source_data = np.array(a.data)
            solver.plan_key = key
            return solver

        if cache is None:
            return build()
        solver, hit = cache.get_or_build(key, build)
        if hit and not np.array_equal(solver._source_data, a.data):
            # same pattern, new values: clone with refreshed numerics (the
            # cached entry — and anyone holding it — stays untouched), then
            # make the clone canonical so repeats of THESE values are free
            solver = solver._with_values(a.data)
            cache.replace(key, solver)
            cache.note_numeric_update()
        return solver


def factor_pair(lf: CSRMatrix, *, cache: Optional[PlanCache] = None, **kw):
    """Plan the (L, L^T) solver pair of a factorization: ``fwd`` solves
    ``Lf y = b``, ``bwd`` solves ``Lf^T x = y`` — together an application of
    ``(Lf Lf^T)^{-1}``, PCG's preconditioner."""
    fwd = TriangularSolver.plan(lf, lower=True, cache=cache, **kw)
    bwd = TriangularSolver.plan(transpose_csr(lf), lower=False, cache=cache, **kw)
    return fwd, bwd
