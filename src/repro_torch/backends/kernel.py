"""Kernel backend — the hand-written CUDA SpTRSV kernels behind the
``Backend`` protocol (wrappers in ``repro_torch.kernels.sptrsv``). The
port's counterpart of the JAX package's ``pallas`` backend, and the default
of ``TriangularSolver.plan``. Every solve is one launch of a level walk
(``kernels.levels``): over the bulk level order, a run per superstep, for
one right-hand side and for m (a block per column), and in
``mode="elastic"`` over runs of ``slack`` supersteps. CPU tensors take the
kernels' plain version."""
from __future__ import annotations

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
    solve_with_elastic_kernel_arrays,
    solve_with_kernel_arrays,
)
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


def _describe_levels(out, la):
    out["n_levels"] = la.level_ptr.numel() - 1
    out["device_bytes"] += _device_bytes(la[:8])
    return out


class KernelBoundSolve(ScanBoundSolve):
    """The scan bound's plan tensors and value refresh, plus the plan in
    the bulk level order; a solve, of one right-hand side or of m, runs
    ``sptrsv_level_cuda`` over the latter (one block barrier per level).
    A value refresh gathers the level tensors from the refreshed plan
    tensors by the level order's ``perm``, on the device."""

    backend = "kernel"

    def __init__(self, arrays, val_src, diag_src, *, n_entries):
        pa, self._la = arrays
        super().__init__(pa, val_src, diag_src, n_entries=n_entries)

    def solve(self, b):
        return solve_with_kernel_arrays(self._la, b)

    def update_values(self, data) -> "KernelBoundSolve":
        vals, diag = self._refreshed(data)
        return type(self)(
            (self._pa._replace(vals=vals, diag=diag), _refreshed_levels(self._la, vals, diag)),
            self._val_src,  # index tensors shared, read-only
            self._diag_src,
            n_entries=self.n_entries,
        )

    def describe(self) -> dict:
        return _describe_levels(super().describe(), self._la)


class ElasticKernelBoundSolve(ElasticScanBoundSolve):
    """The ``mode="elastic"`` kernel bound: the elastic scan bound's
    macro-step tensors and value refresh, plus the plan in the level order
    over runs of ``slack`` supersteps; the solve runs
    ``sptrsv_elastic_cuda`` (one block barrier per level),
    bitwise-identical to ``KernelBoundSolve``. A value refresh gathers the
    level tensors from the refreshed macro-step tensors by ``perm``, on the
    device: the window padding sits after the T real steps, so a real
    lane-step's flat ``step * k + lane`` index is the same in both."""

    backend = "kernel"

    def __init__(self, arrays, elastic, val_src, diag_src, *, n_entries):
        ea, self._la = arrays
        super().__init__(ea, elastic, val_src, diag_src, n_entries=n_entries)

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
        )

    def describe(self) -> dict:
        # the level order's runs: slack counts supersteps here, plan steps
        # in the scan bound's macro-steps
        return _describe_levels({**super().describe(), "slack_unit": "supersteps"}, self._la)


@register_backend
class KernelBackend(ScanBackend):
    """Single- and multi-RHS CUDA kernels: one launch per solve; inside it
    one block barrier per level, of the bulk level order or, elastic, of
    the order over runs of ``slack`` supersteps. Binding also checks the
    plan's index contents and the elastic certificate, which the kernels
    read unchecked."""

    name = "kernel"
    bound_cls = KernelBoundSolve
    elastic_bound_cls = ElasticKernelBoundSolve
    plan_arrays = staticmethod(kernel_arrays)

    @staticmethod
    def elastic_arrays(exec_plan, *, dtype, device):
        """``(ElasticArrays, LevelArrays)``: the macro-step tensors (the
        value refresh's source) and the elastic kernels' level tensors."""
        return (
            elastic_plan_arrays(exec_plan, slack=exec_plan.elastic.slack, dtype=dtype,
                                device=device),
            elastic_kernel_arrays(exec_plan, dtype=dtype, device=device),
        )
