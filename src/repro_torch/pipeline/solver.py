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

``strategy="auto"`` hands the choice to the autotuner
(``repro_torch.autotune``: DAG features -> rule shortlist -> §2.2 cost
model; ``tune=True`` adds measured trials on the solver's device); the
outcome is memoized in the ``PlanCache`` and recorded on
``Solver.selection``. A fresh selection is inspector work: its seconds are
in ``inspector_seconds`` and, on their own, in ``selection_seconds``.

``timed=True`` routes every solve through ``solve_timed``: the same bits,
with per-step timings (``BoundSolve.solve_timed``) kept on
``last_step_timings`` and, when tracing is on, spans in the active buffer.

``backend="distributed"`` with ``mesh=`` (``repro_torch.mesh.make_mesh``)
runs the plan across a mesh of card positions: ``shard="model"`` puts a
lane of the plan on each position of the mesh's ``model`` axis,
``shard="rows"`` a shard of its rows (``core.rowshard``) with halo
exchange; either way each position walks its share of each exchange round
with one range launch of the level kernel, bitwise the single-device
solve.

Solvers of one ``width_class`` (equal plan shapes, one binding) solve one
right-hand side each in a single dispatch: ``grouped_solve`` stacks them
per call, a ``GroupBank`` once (the serve layer's cross-pattern batching;
on the ``kernel`` backend one launch of the banked level walk).
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import analysis, obs
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
from repro_torch.mesh import Mesh, mesh_fingerprint
from repro_torch.pipeline.cache import PlanCache
from repro_torch.pipeline.registry import ScheduleOptions, get_scheduler
from repro_torch.sparse.csr import (
    CSRMatrix,
    pattern_fingerprint,
    permute_symmetric,
    transpose_csr,
)
from repro_torch.sparse.dag import dag_from_lower_csr


def binding_fingerprint(*, backend, dtype, width, device, slack=0, mesh=None,
                        shard="model") -> tuple:
    """The backend-binding part of a plan's identity — everything beyond
    (pattern, strategy, options, orientation) that changes the bound
    solver. ``slack > 0`` marks an elastic binding, a different execution
    from the bulk one even though the plan tensors match. ``mesh`` keys by
    structure (``mesh_fingerprint``: axes, sizes, devices) and ``shard``
    by decomposition: ``"rows"`` row-partitions the plan across the mesh,
    a different execution from the default ``"model"``.
    ``steps_per_tile`` is not part of it: no kernel of the port reads it."""
    return (
        backend,
        str(dtype),
        width if width is not None else "auto",
        str(device),
        slack,
        mesh_fingerprint(mesh),
        shard,
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
        selection_seconds: float = 0.0,
        steps_per_tile: int = 8,
        slack: int = 0,
        mesh=None,
        shard: str = "model",
    ):
        self.exec_plan = exec_plan
        self.backend = backend
        self.dtype = dtype
        self.device = device
        self.fingerprint = fingerprint
        self.strategy = strategy
        self.lower = lower
        self.inspector_seconds = inspector_seconds
        # the part of inspector_seconds a fresh strategy="auto" selection
        # took (the DAG, the features, every candidate's schedule); 0.0
        # for a fixed strategy and on a selection memo hit
        self.selection_seconds = selection_seconds
        self._steps_per_tile = steps_per_tile
        self._slack = slack  # > 0: elastic execution mode
        self._mesh = mesh  # repro_torch.mesh.Mesh (distributed backend)
        self._shard = shard  # mesh decomposition ("model" | "rows")
        # per-step timed execution: an observability toggle, not part of
        # the plan's identity (results are the same bits)
        self.timed = False  # set by plan()
        self.last_step_timings: Optional[list] = None
        self._source_data: Optional[np.ndarray] = None  # set by plan()
        self.plan_key = None  # plan-cache key, set by plan()
        self._selection = None  # autotune Selection, set by plan(auto)
        total_inv = np.empty_like(total_perm)
        total_inv[total_perm] = np.arange(len(total_perm))
        self._perm = torch.as_tensor(total_perm, dtype=torch.int64).to(device)
        self._inv = torch.as_tensor(total_inv, dtype=torch.int64).to(device)
        # bind once; numeric refreshes go through the bound solve's
        # device-side update_values gather, never back here
        be = get_backend(backend)
        mesh_kw = dict(mesh=mesh, shard=shard) if "mesh" in be.requires() else {}
        self._bound = be.bind(exec_plan, dtype=dtype, device=device, slack=slack, **mesh_kw)

    @property
    def bound(self):
        """The backend ``BoundSolve`` this solver executes through
        (telemetry via ``bound.describe()``)."""
        return self._bound

    @property
    def width_class(self) -> tuple:
        """Structural identity of this solver's bound solve: two solvers
        with equal width classes hold equally shaped ``ExecPlan`` tensors
        (n, T, k, W, superstep bounds) bound the same way (backend, dtype,
        device, slack), so when the backend supports it their requests can
        ride one grouped dispatch (``grouped_solve``; the serve layer's
        cross-pattern batching). Orientation (``lower``) is left out: it
        changes only the host-side permutation."""
        p = self.exec_plan
        return (p.n, p.n_steps, p.k, p.W, tuple(int(x) for x in p.step_bounds)) + (
            binding_fingerprint(backend=self.backend, dtype=self.dtype, width=p.W,
                                device=self.device, slack=self._slack, mesh=self._mesh,
                                shard=self._shard))

    @property
    def supports_grouping(self) -> bool:
        """True when this solver's bound can serve width-class grouped
        solves (one dispatch, one plan per column)."""
        return bool(getattr(self._bound, "supports_grouped", False))

    # ---------------------------------------------------------- solving
    def _check_b(self, b) -> torch.Tensor:
        b = torch.as_tensor(b).to(device=self.device, dtype=self.dtype)
        if b.dim() not in (1, 2) or b.shape[0] != self.n:
            raise ValueError(
                f"b must be [n] or [n, m] with n={self.n}; got {tuple(b.shape)}"
            )
        return b

    def _permute(self, b: torch.Tensor) -> torch.Tensor:
        with obs.span("executor.permute", cat="executor"):
            return b[self._perm]

    def _unpermute(self, x: torch.Tensor) -> torch.Tensor:
        with obs.span("executor.unpermute", cat="executor"):
            return x[self._inv]

    def solve(self, b) -> torch.Tensor:
        """Solve the planned system for ``b``: f[n] or f[n, m] (multi-RHS),
        numpy or torch. Input/output live in the caller's original row
        ordering; the result is a tensor on the solver's device. With the
        ``timed`` toggle on, routes through :meth:`solve_timed`."""
        if self.timed:
            return self.solve_timed(b)[0]
        with obs.span("executor.solve", cat="executor", n=self.n):
            x = self._bound.solve(self._permute(self._check_b(b)))
            return self._unpermute(x)

    def solve_timed(self, b):
        """``solve`` with per-step timing: returns ``(x, steps)``, where
        ``steps`` holds one JSON-ready dict per step the backend can
        observe (``BoundSolve.solve_timed``: per superstep or macro-step on
        ``scan``, one per launch on ``kernel``). The last list is kept on
        ``last_step_timings``."""
        with obs.span("executor.solve", cat="executor", n=self.n, timed=True):
            x, steps = self._bound.solve_timed(self._permute(self._check_b(b)))
            x = self._unpermute(x)
        self.last_step_timings = steps
        return x, steps

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
        out = {
            "strategy": self.strategy,
            "backend": self.backend,
            "mode": "elastic" if self._slack else "bsp",
            "slack": self._slack,
            # what one unit of slack is to the backend: "plan_steps" (scan)
            # or "supersteps" (kernel); None in mode="bsp"
            "slack_unit": binding.get("slack_unit"),
            "shard": self._shard,
            "device": str(self.device),
            "timed": self.timed,
            "lower": self.lower,
            "n_supersteps": self.n_supersteps,
            "inspector_seconds": self.inspector_seconds,
            "selection_seconds": self.selection_seconds,
            "steps_per_tile": self._steps_per_tile,
            "plan": self.exec_plan.stats(),
            "binding": binding,
        }
        if self._selection is not None:
            out["selection"] = self._selection.as_dict()
        return out

    @property
    def selection(self):
        """The autotuner's ``Selection`` recorded when this solver object
        was *built* by a ``strategy="auto"`` plan (None when it was built
        with a fixed strategy). Cached solvers are never mutated after the
        fact: an auto plan that cache-hits an entry originally built by a
        fixed-strategy plan returns it with ``selection`` still None — the
        resolved outcome remains available via the cache's selection memo.
        """
        return self._selection

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
        timed: bool = False,
        sched=None,
        tune: bool = False,
        validate: Optional[str] = None,
        mesh=None,
        shard: str = "model",
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
        ``sched`` bypasses the registry with a pre-built ``Schedule``
        (never cached — the cache cannot key on arbitrary schedules; the
        solver's strategy reads ``"(prebuilt)"``).

        ``mode`` selects the execution mode: ``"bsp"`` (bulk-synchronous,
        the default) or ``"elastic"`` — the plan runs under a staleness
        bound of ``slack`` (``core.elastic``), with bitwise the same result:
        the ``"scan"`` backend in macro-steps of ``slack`` plan steps, the
        ``"kernel"`` backend level by level over runs of ``slack``
        supersteps (``info()["slack_unit"]`` says which). ``mode="elastic"``
        takes ``slack`` from ``slack=...`` (a ``ScheduleOptions`` knob) or
        ``core.DEFAULT_SLACK``; ``slack > 0`` alone also selects elastic.
        The backend must advertise the ``"elastic"`` capability.

        ``strategy="auto"`` lets the autotuner choose: DAG features ->
        rule-based shortlist -> §2.2 cost model (``repro_torch.autotune``);
        with ``tune=True`` the shortlisted plans are additionally built and
        *timed* on this call's backend and device. When the backend
        supports elastic (and ``mode`` does not force ``"bsp"``), the
        selector may also turn elastic mode on via its step-granular cost
        rule. The resolved config is memoized per sparsity fingerprint
        (inside ``cache`` when given), and the plan is cached under the
        resolved *concrete* key — so repeated auto plans on one pattern
        skip both selection and scheduling. A solver built after a fresh
        selection counts it in ``inspector_seconds`` and, on its own, in
        ``selection_seconds`` (0.0 after a memo hit); the winner's
        schedule is reused, not run again.

        ``validate`` runs the independent static verifier
        (``repro_torch.analysis``) over the freshly built artifacts —
        schedule, reorder permutation, plan tensors and elastic
        certificate, against the matrix the plan was compiled from — and,
        on the ``kernel`` backend, over the level order the bind built,
        the one the CUDA kernels walk (``analysis.level_check``):
        ``"fast"`` is the vectorized invariant set, ``"full"`` adds value
        provenance and the read-before-write proofs, ``"off"`` (default)
        skips. ``None`` defers to the ``REPRO_VALIDATE`` env var. A finding
        raises ``analysis.VerificationError`` with the findings table,
        before any solve. Build-time only, and not part of the cache key:
        cache hits return the already-verified entry without re-checking.

        ``timed=True`` turns on per-step timed execution: every ``solve``
        routes through ``solve_timed``. It is NOT part of the plan identity
        (the cache key): a cache hit returns the same solver with the
        toggle set to THIS call's value.

        ``mesh`` (``repro_torch.mesh.make_mesh``) and ``shard`` bind a
        backend that requires a mesh (``"distributed"``): ``shard="model"``
        (default) puts lane p of the plan on model position p (k must not
        exceed the model axis); ``shard="rows"`` partitions the plan's rows
        across the model axis (``core.rowshard``) with halo exchange, and
        needs the backend's ``"shard-rows"`` capability. The right-hand
        sides split over the mesh's ``data`` axis. With a mesh and no
        ``device``, b arrives and x returns on the mesh's first position's
        device. Under ``validate``, ``shard="rows"`` also audits the halo
        partition (``analysis.verify_rowshard_report``), and every
        position's bound level order is checked with its round ranges."""
        strategy = strategy.lower()
        # resolve (and reject) the validation level before any scheduling
        # work; "off" keeps the verifier entirely off the build path
        check_level = analysis.resolve_level(validate)
        # fail fast on an unknown backend, with the registry naming options
        be = get_backend(backend)
        backend_caps = be.capabilities()
        np_dtype = numpy_dtype(dtype)
        if "mesh" in be.requires():
            if mesh is None:
                raise ValueError(f"backend={backend!r} requires a mesh")
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a repro_torch.mesh.Mesh; got {type(mesh).__name__}")
        elif mesh is not None:
            # not dropped: a mesh on a one-device backend would solve
            # somewhere the caller did not ask for
            raise ValueError(
                f"backend {backend!r} runs on one device and takes no mesh "
                "(mesh= is for backend='distributed')"
            )
        if shard != "model" and f"shard-{shard}" not in backend_caps:
            raise ValueError(
                f"backend {backend!r} does not support shard={shard!r} "
                f"(no 'shard-{shard}' capability)"
            )
        dev = mesh.devices.flat[0] if mesh is not None and device is None else resolve_device(
            device)
        if tune and (strategy != "auto" or sched is not None):
            raise ValueError(
                "tune=True runs measured trials to refine an auto "
                "selection; it requires strategy='auto' (and no pre-built "
                "sched)"
            )
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
        # the selector may only turn elastic ON when the binding can run
        # it and the caller did not force bulk-synchronous
        elastic_ok = mode != "bsp" and "elastic" in backend_caps

        fp = pattern_fingerprint(a)
        selection = None
        pre_sched = None  # winning Schedule the selector already computed
        pre_solver = None  # winner's trial solver (tune=True measured run)
        selection_seconds = 0.0  # a fresh auto selection's share of the inspector
        if strategy == "auto" and sched is None:
            from repro_torch.autotune.selector import resolve_auto_full

            t_sel = time.perf_counter()
            selection, pre_sched, pre_solver = resolve_auto_full(
                a,
                options=o,
                lower=lower,
                tune=tune,
                cache=cache,
                fp=fp,
                allow_elastic=elastic_ok,
                plan_kwargs=dict(
                    backend=backend, dtype=dtype, width=width, device=dev,
                    steps_per_tile=steps_per_tile, mesh=mesh, shard=shard,
                ),
            )
            # a memo hit hands back neither artifact: no selection ran
            if pre_sched is not None or pre_solver is not None:
                selection_seconds = time.perf_counter() - t_sel
            strategy, o = selection.strategy, selection.options
        elif sched is None:
            get_scheduler(strategy)  # fail fast on an unknown strategy
        # o (a frozen dataclass) covers every scheduling knob incl. k,
        # reorder and the elastic slack; the binding keys too
        key = (fp, strategy, o, lower) + binding_fingerprint(
            backend=backend, dtype=dtype, width=width, device=dev, slack=o.slack,
            mesh=mesh, shard=shard,
        )

        def build() -> "TriangularSolver":
            t0 = time.perf_counter()
            n = a.n_rows
            m0, outer = mirror_to_lower(a, lower)
            if sched is not None:
                s = sched
            elif pre_sched is not None:
                s = pre_sched  # already computed while scoring candidates
            else:
                with obs.span("inspector.dag", cat="inspector", n=n):
                    dag = dag_from_lower_csr(m0)
                with obs.span(
                    f"inspector.schedule.{strategy}", cat="inspector",
                    n=n, k=o.k,
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

            if check_level != "off":
                # verify against m2 BEFORE the val_src rebase below —
                # the provenance audit matches sources against the
                # matrix the plan was actually compiled from
                analysis.verify_artifacts(
                    analysis.Artifacts(
                        L=m2, sched=s2, plan=plan,
                        perm=inner if o.reorder else None,
                        sched_pre=s if o.reorder else None,
                    ),
                    level=check_level,
                ).raise_if_failed()

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
                strategy=strategy if sched is None else "(prebuilt)",
                lower=lower,
                inspector_seconds=time.perf_counter() - t0 + selection_seconds,
                selection_seconds=selection_seconds,
                steps_per_tile=steps_per_tile,
                slack=o.slack,
                mesh=mesh,
                shard=shard,
            )
            solver._source_data = np.array(a.data)
            # selection is recorded at build time only — cached solvers are
            # never mutated after being handed out (see the property doc)
            solver._selection = selection
            if check_level != "off":
                # the level order is built at bind time: audit the one the
                # bound kernels will walk, before any launch
                order = getattr(getattr(solver.bound, "_la", None), "order", None)
                if order is not None:
                    analysis.verify_levels_report(
                        plan, order, level=check_level, slack=max(o.slack, 1)
                    ).raise_if_failed()
                rsp = getattr(solver.bound, "_rsp", None)
                if rsp is not None:
                    # the halo partition is cut at bind time: audit it
                    # against the plan it was cut from
                    analysis.verify_rowshard_report(
                        plan, rsp, level=check_level
                    ).raise_if_failed()
                if hasattr(solver.bound, "level_audit"):
                    # every position's level order and round ranges
                    analysis.verify_mesh_levels_report(
                        solver.bound.level_audit(), level=check_level
                    ).raise_if_failed()
            return solver

        # the tuned winner was built and warmed during the measured trials
        # (against a private cache) and carries its Selection — use it as
        # the builder so the work is not redone; it enters the shared
        # cache fully formed, so no published solver is ever mutated. Its
        # own build ran inside the selection, so the selection's seconds
        # are the whole inspector's
        if pre_solver is not None:
            pre_solver.inspector_seconds = pre_solver.selection_seconds = selection_seconds
        builder = build if pre_solver is None else (lambda: pre_solver)
        if cache is None or sched is not None:
            solver = builder()
            if sched is None:  # prebuilt schedules have no cacheable key
                solver.plan_key = key
            solver.timed = timed
            return solver
        solver, hit = cache.get_or_build(key, builder)
        # idempotent on hits (the key IS the entry's key)
        solver.plan_key = key
        if hit and not np.array_equal(solver._source_data, a.data):
            # same pattern, new values: clone with refreshed numerics (the
            # cached entry — and anyone holding it — stays untouched), then
            # make the clone canonical so repeats of THESE values are free
            solver = solver._with_values(a.data)
            cache.replace(key, solver)
            cache.note_numeric_update()
        solver.timed = timed
        return solver


def grouped_solve(solvers, B) -> torch.Tensor:
    """Solve column j of ``B`` f[n, m] with ``solvers[j]`` — one grouped
    dispatch (``BoundSolve.solve_grouped``: one launch of the banked kernel
    on the ``kernel`` backend), each column against its own plan (pattern
    and values may differ per column; the solvers share one
    ``width_class``). Per-column permutations are applied and undone here,
    so columns may mix orientations. Returns x f[n, m] on the solvers'
    device.

    A column's bits depend only on its own (plan, b), never on its
    neighbours; the replay reference of a grouped result is the same call
    with the request's own solver in every column
    (``repro_torch.serve.GroupReplay``)."""
    if not solvers:
        raise ValueError("grouped_solve needs at least one solver")
    wc = solvers[0].width_class
    for s in solvers[1:]:
        if s.width_class != wc:
            raise ValueError(
                "grouped_solve requires one width class; got solvers "
                f"with {s.width_class} vs {wc}"
            )
    bound0 = solvers[0]._bound
    if not getattr(bound0, "supports_grouped", False):
        raise NotImplementedError(
            f"backend {solvers[0].backend!r} does not support width-class "
            "grouped solves"
        )
    B = torch.as_tensor(B).to(device=solvers[0].device, dtype=solvers[0].dtype)
    if B.dim() != 2 or B.shape[0] != solvers[0].n or B.shape[1] != len(solvers):
        raise ValueError(
            f"B must be [n={solvers[0].n}, m={len(solvers)}] (one column "
            f"per solver); got {tuple(B.shape)}"
        )
    b_cols = torch.stack([B[:, j][s._perm] for j, s in enumerate(solvers)])
    X = type(bound0).solve_grouped([s._bound for s in solvers], b_cols)
    return torch.stack([X[j][s._inv] for j, s in enumerate(solvers)], dim=1)


class GroupBank:
    """Device-side bank of one width class's live plans — the serving path
    for cross-pattern grouped batches.

    ``grouped_solve`` stacks the plans on every call (fine for replay); a
    bank stacks its members ONCE (``BoundSolve.stack_bank``) and lets every
    microbatch index its lanes in one dispatch (``solve_bank``): the same
    bits. Members are keyed by caller-chosen hashable keys (the serve layer
    uses ``(fingerprint, version)``); adding or dropping a member
    invalidates the stack, which is rebuilt on the next solve (the lane
    count pads to a power of two).

    Backend-agnostic: the bank dispatches through the ``BoundSolve`` bank
    contract, which every backend advertising ``supports_grouped``
    implements — the ``kernel`` backend with one launch of its banked
    level walk, the ``scan`` backend with its plain grouped scan."""

    def __init__(self):
        self._lock = threading.Lock()
        self._solvers: Dict = {}  # key -> solver; dict order = lane order
        self._index: Dict = {}
        self._bank = None
        self.rebuilds = 0  # telemetry: restacks actually performed

    def __len__(self) -> int:
        with self._lock:
            return len(self._solvers)

    def add(self, key, solver: "TriangularSolver") -> None:
        """Register ``solver`` under ``key`` (idempotent). The solver must
        support grouping and share the bank's width class."""
        if not solver.supports_grouping:
            raise NotImplementedError(
                f"backend {solver.backend!r} does not support width-class "
                "grouped solves"
            )
        with self._lock:
            if key in self._solvers:
                return
            if self._solvers:
                wc0 = next(iter(self._solvers.values())).width_class
                if solver.width_class != wc0:
                    raise ValueError(
                        "GroupBank requires one width class; got "
                        f"{solver.width_class} vs {wc0}"
                    )
            self._solvers[key] = solver
            self._bank = None

    def drop(self, key) -> None:
        with self._lock:
            if self._solvers.pop(key, None) is not None:
                self._bank = None

    def prune(self, keep) -> None:
        """Drop every member whose key fails ``keep(key)`` — the serve
        layer retires lanes of superseded, drained plan versions. ``keep``
        runs under the bank lock, serialized with concurrent ``add``s."""
        with self._lock:
            dead = [k for k in self._solvers if not keep(k)]
            for k in dead:
                del self._solvers[k]
            if dead:
                self._bank = None

    def _ensure_locked(self):
        if self._bank is None:
            solvers = list(self._solvers.values())
            cls = type(solvers[0]._bound)
            self._bank = cls.stack_bank(
                [s._bound for s in solvers],
                [s._perm for s in solvers],
                [s._inv for s in solvers],
            )
            self._bound_cls = cls
            self._index = {k: i for i, k in enumerate(self._solvers)}
            self.rebuilds += 1
        return self._bound_cls, self._bank, self._index

    def _lanes(self, keys):
        with self._lock:
            cls, bank, index = self._ensure_locked()
            lane_idx = np.fromiter((index[k] for k in keys), np.int32, count=len(keys))
        return cls, bank, lane_idx

    def solve(self, keys, B) -> torch.Tensor:
        """Solve column j of ``B`` f[n, m] (caller row order) against the
        member registered under ``keys[j]``; returns x f[n, m] on the
        device. Bitwise ``grouped_solve`` on the same members, so
        ``GroupReplay`` stays the replay reference of bank-served
        results."""
        cls, bank, lane_idx = self._lanes(keys)
        return cls.solve_bank(bank, lane_idx, B)

    def solve_resident(self, keys, B_res) -> torch.Tensor:
        """One continuous-mode pass: column j of the resident ``B_res``
        f[n, S] against the member under ``keys[j]`` — bitwise
        :meth:`solve` on the same keys, but ``B_res`` stays on the device
        (the continuous engine, ``repro_torch.serve.slots``, writes it
        slot by slot with ``insert_lane``)."""
        cls, bank, lane_idx = self._lanes(keys)
        return cls.solve_resident(bank, lane_idx, B_res)

    def describe(self) -> dict:
        with self._lock:
            return {
                "n_lanes": len(self._solvers),
                "rebuilds": self.rebuilds,
            }


def factor_pair(lf: CSRMatrix, *, cache: Optional[PlanCache] = None, **kw):
    """Plan the (L, L^T) solver pair of a factorization: ``fwd`` solves
    ``Lf y = b``, ``bwd`` solves ``Lf^T x = y`` — together an application of
    ``(Lf Lf^T)^{-1}``, PCG's preconditioner."""
    fwd = TriangularSolver.plan(lf, lower=True, cache=cache, **kw)
    bwd = TriangularSolver.plan(transpose_csr(lf), lower=False, cache=cache, **kw)
    return fwd, bwd
