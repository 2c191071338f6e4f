"""Kernel backend — the hand-written CUDA SpTRSV kernels behind the
``Backend`` protocol (wrappers in ``repro_torch.kernels.sptrsv``). The
port's counterpart of the JAX package's ``pallas`` backend, and the default
of ``TriangularSolver.plan``. A bind holds the plan once, in level order
(``kernels.levels``): the bulk order, a run per superstep, or in
``mode="elastic"`` the order over runs of ``slack`` supersteps. Beside the
level tensors it holds the plan's value sources gathered into the same
order, through which a value refresh gathers new values on the device
(``kernels.ops.refresh_level_values``, the distributed backend's refresh
too). Every solve is one launch of a level walk, for one right-hand side
and for m (a block per column). The bulk bound's grouped, banked and
resident-slot solves (``"grouped"``, ``"slots"``: the serve layer's
width-class batching) are one launch of the banked level walk over a
``LevelBank``, each column on its own plan. CPU tensors take the kernels'
plain version. A timed solve is that one launch, timed as one step. On the
card a bound takes the solver's row permutation (``take_row_order``), and
the front door's solve is then one cooperative launch that takes b and
returns x in the caller's row order (``solve_ordered``;
``describe()["front_door"]`` reads ``"ordered"``)."""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.backends.base import (
    Backend,
    BoundSolve,
    bind_checks,
    device_bytes,
    numpy_dtype,
)
from repro_torch.backends.registry import register_backend
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (
    elastic_kernel_arrays,
    level_plan_arrays,
    level_sources,
    ordered_walk,
    refresh_level_values,
    solve_ordered,
    solve_with_elastic_kernel_arrays,
    solve_with_kernel_arrays,
    solve_with_level_bank,
    stack_level_bank,
)
from repro_torch.kernels.sptrsv import ordered_columns
from repro_torch.solver import executor


class _KernelBound(BoundSolve):
    """What both kernel bounds share: the plan's level tensors (``_la``)
    and their level-ordered value sources, the value refresh through them,
    the timed solve, the front door's ordered solve and ``describe()``.

    A solve is one launch, so it is timed as one step
    (``BoundSolve.solve_timed``), as the JAX package's Pallas backend does.
    The runtime block counts the timed solves and the levels they walked
    (every launch walks all of its level order's levels).

    On the card ``take_row_order`` binds the level tensors and the solver's
    row permutation once, and ``solve_ordered`` is then one launch a solve
    (more right-hand sides than the card holds blocks at once gather around
    ``solve``); a value refresh keeps the row order. A timed solve stays in
    plan row order."""

    backend = "kernel"
    _perm = None  # the row permutation, int64[n]
    _walk = None  # and the ordered solve bound with it

    def __init__(self, la, val_src, diag_src, *, shape, n_entries, elastic=None):
        self._la = la  # kernels.ops.LevelArrays
        self._val_src = val_src  # int32[P, W] on the device (-1 marks padding)
        self._diag_src = diag_src  # int32[P] on the device (-1 marks padding)
        self._shape = tuple(shape)  # (T, k, W) of the plan
        self._elastic = elastic  # core.elastic.ElasticPlan certificate, elastic only
        self.n = la.n
        self.n_entries = n_entries
        self._runtime = {"timed_solves": 0, "levels_walked": 0}

    def take_row_order(self, perm) -> None:
        # the ordered solve is a kernel: on the CPU the front door gathers
        if self._la.vals.device.type == "cuda":
            self._bind_row_order(perm)

    def _bind_row_order(self, perm) -> None:
        self._walk = ordered_walk(self._la, perm, elastic=self._elastic is not None)
        self._perm = torch.as_tensor(perm).to(device=self._la.vals.device, dtype=torch.int64)
        self.front_door = "ordered"

    def solve_ordered(self, b):
        if b.dim() == 2 and b.shape[1] > ordered_columns(self._walk):
            x = torch.empty_like(b)
            x[self._perm] = self.solve(b[self._perm])
            return x
        return solve_ordered(self._walk, b)

    def _n_levels(self) -> int:
        return self._la.level_ptr.numel() - 1

    def solve_timed(self, b):
        x, steps = super().solve_timed(b)
        self._runtime["timed_solves"] += 1
        self._runtime["levels_walked"] += self._n_levels()
        return x, steps

    def update_values(self, data) -> "_KernelBound":
        la = self._la
        with obs.span("backend.update_values", cat="backend", backend=self.backend):
            data = self._check_data(data).astype(numpy_dtype(la.vals.dtype))
            la = refresh_level_values(la, self._val_src, self._diag_src,
                                      torch.from_numpy(data).to(la.vals.device))
        new = type(self)(la, self._val_src, self._diag_src,  # index tensors shared, read-only
                         shape=self._shape, n_entries=self.n_entries, elastic=self._elastic)
        if self._walk is not None:
            new._bind_row_order(self._perm)
        return new

    def describe(self) -> dict:
        T, k, W = self._shape
        la, ch = self._la, self._la.chunks
        held = (*la[:8], ch.chunk_ptr, ch.level_chunk, self._val_src, self._diag_src)
        if self._walk is not None:
            held += (self._walk.tensors[7],)  # the int32 row permutation
        rt = dict(self._runtime)
        if rt["timed_solves"]:
            rt["levels_per_solve"] = round(rt["levels_walked"] / rt["timed_solves"], 2)
        return {
            "backend": self.backend,
            "n": self.n,
            "n_steps": T,
            "k": k,
            "W": W,
            "dtype": str(la.vals.dtype).removeprefix("torch."),
            "device": str(la.vals.device),
            "device_bytes": device_bytes(held),
            "n_levels": self._n_levels(),
            "front_door": self.front_door,
            "runtime": {**rt, "predicted_levels": self._n_levels()},
            # how often the kernel's stages engage (kernels.levels.LevelChunks)
            "staging": ch.stats(),
        }


class KernelBoundSolve(_KernelBound):
    """The plan in the bulk level order; a solve, of one right-hand side or
    of m, runs ``sptrsv_level_cuda`` over it (one block barrier per
    level)."""

    supports_grouped = True

    def solve(self, b):
        return solve_with_kernel_arrays(self._la, b)

    # width-class grouping and resident slots: the banked kernel over the
    # members' level tensors (a launch per solve); the resident bank's
    # inserts and reads are the plain executor's, which move bits only
    @classmethod
    def solve_grouped(cls, bounds, b_cols):
        # the distinct plans stacked for this call (a replay that repeats
        # one plan in every lane stacks it once), in plan row order
        las = list({id(b._la): b._la for b in bounds}.values())
        member = {id(la): i for i, la in enumerate(las)}
        rows = torch.arange(las[0].n, device=las[0].vals.device)
        bank = stack_level_bank(las, [rows] * len(las), [rows] * len(las))
        return solve_with_level_bank(bank, [member[id(b._la)] for b in bounds], b_cols.T).T

    @classmethod
    def stack_bank(cls, bounds, perms, invs):
        return stack_level_bank([b._la for b in bounds], perms, invs)

    @classmethod
    def solve_bank(cls, bank, lane_idx, B):
        return solve_with_level_bank(bank, lane_idx, B)

    @classmethod
    def blank_rhs(cls, n, slots, dtype, device):
        return executor.blank_rhs(n, slots, dtype, device)

    @classmethod
    def insert_lane(cls, B_res, lane, b):
        return executor.insert_lane(B_res, lane, b)

    @classmethod
    def extract_lane(cls, X, lane):
        return executor.extract_lane(X, lane)

    @classmethod
    def solve_resident(cls, bank, lane_idx, B_res):
        return solve_with_level_bank(bank, lane_idx, B_res[:, : len(lane_idx)])


class ElasticKernelBoundSolve(_KernelBound):
    """The ``mode="elastic"`` kernel bound: the plan in the level order over
    runs of the certificate's ``slack`` supersteps; the solve runs
    ``sptrsv_elastic_cuda`` (one block barrier per level),
    bitwise-identical to ``KernelBoundSolve``."""

    # as the JAX package's elastic bounds: no grouped twin (BoundSolve's
    # bank and slot methods raise)
    supports_grouped = False

    def solve(self, b):
        return solve_with_elastic_kernel_arrays(self._la, b)

    def describe(self) -> dict:
        ep = self._elastic
        return {
            **super().describe(),
            "mode": "elastic",
            "n_macro_steps": ep.n_macro_steps,
            "slack": ep.slack,
            # the level order's runs: slack counts supersteps here, plan
            # steps in the scan bound's macro-steps
            "slack_unit": "supersteps",
            "certificate": ep.stats(),
        }


@register_backend
class KernelBackend(Backend):
    """Single- and multi-RHS CUDA kernels: one launch per solve; inside it
    one block barrier per level, of the bulk level order or, elastic, of
    the order over runs of ``slack`` supersteps; grouped, banked and
    resident-slot solves one launch of the banked walk. Binding also checks
    the plan's index contents and the elastic certificate, which the
    kernels read unchecked."""

    name = "kernel"

    def capabilities(self):
        return ("grouped", "elastic", "slots")

    def bind(self, exec_plan, *, dtype=torch.float32, device=None, slack=0) -> BoundSolve:
        numpy_dtype(dtype)
        device = resolve_device(device)
        with obs.span("backend.bind", cat="backend", backend=self.name, n=exec_plan.n,
                      slack=slack):
            exec_plan, n_entries = bind_checks(exec_plan, slack)
            kw = dict(shape=exec_plan.col_idx.shape, n_entries=n_entries)
            if slack > 0:
                la = elastic_kernel_arrays(exec_plan, dtype=dtype, device=device)
                cls, kw["elastic"] = ElasticKernelBoundSolve, exec_plan.elastic
            else:
                la = level_plan_arrays(exec_plan, dtype=dtype, device=device)
                cls = KernelBoundSolve
            return cls(la, *level_sources(exec_plan, la.order, device=device), **kw)
