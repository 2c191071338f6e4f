"""Kernel backend — the hand-written CUDA SpTRSV kernels behind the
``Backend`` protocol (wrappers in ``repro_torch.kernels.sptrsv``). The
port's counterpart of the JAX package's ``pallas`` backend, and the default
of ``TriangularSolver.plan``. Every solve is one launch of a level walk
(``kernels.levels``): over the bulk level order, a run per superstep, for
one right-hand side and for m (a block per column), and in
``mode="elastic"`` over runs of ``slack`` supersteps. The bulk bound's
grouped, banked and resident-slot solves (``"grouped"``, ``"slots"``: the
serve layer's width-class batching) are one launch of the banked level
walk over a ``LevelBank``, each column on its own plan; it overrides every
bank method of the scan bound it subclasses that solves, so none reaches
the plain executor. CPU tensors take the kernels' plain version. A timed
solve is that one launch, timed as one step: the kernel, not the scan's
segments. On the card a bound takes the solver's row permutation
(``take_row_order``), and the front door's solve is then one cooperative
launch that takes b and returns x in the caller's row order
(``solve_ordered``; ``describe()["front_door"]`` reads ``"ordered"``)."""
from __future__ import annotations

import torch

from repro_torch.backends.base import BoundSolve
from repro_torch.backends.registry import register_backend
from repro_torch.backends.scan import (
    ElasticScanBoundSolve,
    ScanBackend,
    ScanBoundSolve,
    _device_bytes,
)
from repro_torch.kernels.ops import (
    elastic_kernel_arrays,
    kernel_plan_arrays,
    level_plan_arrays,
    ordered_walk,
    solve_ordered,
    solve_with_elastic_kernel_arrays,
    solve_with_kernel_arrays,
    solve_with_level_bank,
    stack_level_bank,
)
from repro_torch.kernels.sptrsv import ordered_columns
from repro_torch.solver.executor import elastic_plan_arrays


def kernel_arrays(exec_plan, *, dtype, device):
    """``(PlanArrays, LevelArrays)``: the padded plan (the value refresh's
    source; no kernel reads it) and the plan in the bulk level order, which
    the kernels read."""
    return (
        kernel_plan_arrays(exec_plan, dtype=dtype, device=device),
        level_plan_arrays(exec_plan, dtype=dtype, device=device),
    )


def _refreshed_levels(la, vals, diag):
    """``la`` with the values gathered by ``la.perm`` from refreshed plan
    tensors (any layout whose flat ``step * k + lane`` index is the
    plan's), on the device."""
    return la._replace(vals=vals.reshape(-1, vals.shape[-1])[la.perm],
                       diag=diag.reshape(-1)[la.perm])


class _KernelTimed:
    """Timed solves of the kernel bounds. They subclass the scan bounds for
    the plan tensors and the value refresh, but must not inherit the scan's
    segmented ``solve_timed``, which would time the plain version: a solve
    is one launch, so it is timed as one step (``BoundSolve.solve_timed``),
    as the JAX package's Pallas backend does. The runtime block counts the
    timed solves and the levels they walked (every launch walks all of its
    level order's levels), in the kernel's own unit, not macro-steps.

    Also the front door's ordered solve: on the card ``take_row_order``
    binds the level tensors and the solver's row permutation once, and
    ``solve_ordered`` is then one launch a solve (more right-hand sides
    than the card holds blocks at once gather around ``solve``); a value
    refresh keeps the row order. A timed solve stays in plan row order."""

    _elastic_walk = False  # the ordered solve's launch kinds: bulk or elastic
    _perm = None  # the row permutation, int64[n]
    _walk = None  # and the ordered solve bound with it

    def _start_runtime(self):
        self._kernel_runtime = {"timed_solves": 0, "levels_walked": 0}

    def take_row_order(self, perm) -> None:
        # the ordered solve is a kernel: on the CPU the front door gathers
        if self._la.vals.device.type == "cuda":
            self._bind_row_order(perm)

    def _bind_row_order(self, perm) -> None:
        self._walk = ordered_walk(self._la, perm, elastic=self._elastic_walk)
        self._perm = torch.as_tensor(perm).to(device=self._la.vals.device, dtype=torch.int64)
        self.front_door = "ordered"

    def _keep_row_order(self, old):
        """After a value refresh: ``old``'s row order over this bound's
        values."""
        if old._walk is not None:
            self._bind_row_order(old._perm)
        return self

    def solve_ordered(self, b):
        if b.dim() == 2 and b.shape[1] > ordered_columns(self._walk):
            x = torch.empty_like(b)
            x[self._perm] = self.solve(b[self._perm])
            return x
        return solve_ordered(self._walk, b)

    def _n_levels(self) -> int:
        return self._la.level_ptr.numel() - 1

    def solve_timed(self, b):
        x, steps = BoundSolve.solve_timed(self, b)
        self._kernel_runtime["timed_solves"] += 1
        self._kernel_runtime["levels_walked"] += self._n_levels()
        return x, steps

    def _describe_levels(self, out):
        rt = dict(self._kernel_runtime)
        if rt["timed_solves"]:
            rt["levels_per_solve"] = round(rt["levels_walked"] / rt["timed_solves"], 2)
        ch = self._la.chunks
        out["n_levels"] = self._n_levels()
        out["device_bytes"] += _device_bytes((*self._la[:8], ch.chunk_ptr, ch.level_chunk))
        out["front_door"] = self.front_door
        if self._walk is not None:
            out["device_bytes"] += _device_bytes((self._walk.tensors[7],))
        out["runtime"] = {**rt, "predicted_levels": out["n_levels"]}
        # how often the kernel's stages engage (kernels.levels.LevelChunks)
        out["staging"] = ch.stats()
        return out


class KernelBoundSolve(_KernelTimed, ScanBoundSolve):
    """The scan bound's plan tensors and value refresh, plus the plan in
    the bulk level order; a solve, of one right-hand side or of m, runs
    ``sptrsv_level_cuda`` over the latter (one block barrier per level).
    A value refresh gathers the level tensors from the refreshed plan
    tensors by the level order's ``perm``, on the device."""

    backend = "kernel"
    supports_grouped = True

    def __init__(self, arrays, val_src, diag_src, *, n_entries):
        pa, self._la = arrays
        super().__init__(pa, val_src, diag_src, n_entries=n_entries)
        self._start_runtime()

    def solve(self, b):
        return solve_with_kernel_arrays(self._la, b)

    # width-class grouping and resident slots: the banked kernel over the
    # members' level tensors (a launch per solve); the resident bank's
    # inserts and reads are the scan bound's, which move bits only
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
    def solve_resident(cls, bank, lane_idx, B_res):
        return solve_with_level_bank(bank, lane_idx, B_res[:, : len(lane_idx)])

    def update_values(self, data) -> "KernelBoundSolve":
        vals, diag = self._refreshed(data)
        return type(self)(
            (self._pa._replace(vals=vals, diag=diag), _refreshed_levels(self._la, vals, diag)),
            self._val_src,  # index tensors shared, read-only
            self._diag_src,
            n_entries=self.n_entries,
        )._keep_row_order(self)

    def describe(self) -> dict:
        return self._describe_levels(super().describe())


class ElasticKernelBoundSolve(_KernelTimed, ElasticScanBoundSolve):
    """The ``mode="elastic"`` kernel bound: the elastic scan bound's
    macro-step tensors and value refresh, plus the plan in the level order
    over runs of ``slack`` supersteps; the solve runs
    ``sptrsv_elastic_cuda`` (one block barrier per level),
    bitwise-identical to ``KernelBoundSolve``. A value refresh gathers the
    level tensors from the refreshed macro-step tensors by ``perm``, on the
    device: the window padding sits after the T real steps, so a real
    lane-step's flat ``step * k + lane`` index is the same in both."""

    backend = "kernel"
    # as the JAX package's elastic bounds: no grouped twin (its inherited
    # bank methods raise)
    supports_grouped = False
    _elastic_walk = True

    def __init__(self, arrays, elastic, val_src, diag_src, *, n_entries):
        ea, self._la = arrays
        super().__init__(ea, elastic, val_src, diag_src, n_entries=n_entries)
        self._start_runtime()

    def solve(self, b):
        return solve_with_elastic_kernel_arrays(self._la, b)

    def update_values(self, data) -> "ElasticKernelBoundSolve":
        vals, diag = self._refreshed(data)
        return type(self)(
            (self._ea._replace(vals=vals, diag=diag), _refreshed_levels(self._la, vals, diag)),
            self._elastic,
            self._val_src,  # index tensors shared, read-only
            self._diag_src,
            n_entries=self.n_entries,
        )._keep_row_order(self)

    def describe(self) -> dict:
        # the level order's runs: slack counts supersteps here, plan steps
        # in the scan bound's macro-steps
        return self._describe_levels({**super().describe(), "slack_unit": "supersteps"})


@register_backend
class KernelBackend(ScanBackend):
    """Single- and multi-RHS CUDA kernels: one launch per solve; inside it
    one block barrier per level, of the bulk level order or, elastic, of
    the order over runs of ``slack`` supersteps; grouped, banked and
    resident-slot solves one launch of the banked walk. Binding also checks the
    plan's index contents and the elastic certificate, which the kernels
    read unchecked."""

    name = "kernel"
    bound_cls = KernelBoundSolve
    elastic_bound_cls = ElasticKernelBoundSolve
    plan_arrays = staticmethod(kernel_arrays)

    def capabilities(self):
        return ("grouped", "elastic", "slots")

    @staticmethod
    def elastic_arrays(exec_plan, *, dtype, device):
        """``(ElasticArrays, LevelArrays)``: the macro-step tensors (the
        value refresh's source) and the elastic kernels' level tensors."""
        return (
            elastic_plan_arrays(exec_plan, slack=exec_plan.elastic.slack, dtype=dtype,
                                device=device),
            elastic_kernel_arrays(exec_plan, dtype=dtype, device=device),
        )
