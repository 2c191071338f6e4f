"""Kernel backend — the hand-written CUDA SpTRSV kernels behind the
``Backend`` protocol (wrappers in ``repro_torch.kernels.sptrsv``). The
port's counterpart of the JAX package's ``pallas`` backend, and the default
of ``TriangularSolver.plan``. CPU tensors take the kernels' plain version."""
from __future__ import annotations

from repro_torch.backends.registry import register_backend
from repro_torch.backends.scan import (
    ElasticScanBoundSolve,
    ScanBackend,
    ScanBoundSolve,
)
from repro_torch.kernels.ops import (
    elastic_kernel_arrays,
    kernel_plan_arrays,
    solve_with_elastic_kernel_arrays,
    solve_with_kernel_arrays,
)


class KernelBoundSolve(ScanBoundSolve):
    """Same tensors and value refresh as the scan bound; the solve runs
    ``sptrsv_cuda``."""

    backend = "kernel"

    def solve(self, b):
        return solve_with_kernel_arrays(self._pa, b)


class ElasticKernelBoundSolve(ElasticScanBoundSolve):
    """The ``mode="elastic"`` kernel bound: the elastic scan bound's
    macro-step tensors and value refresh, plus the certificate's wave
    tensors; the solve runs ``sptrsv_elastic_cuda`` (one block barrier per
    readiness wave), bitwise-identical to ``KernelBoundSolve``."""

    backend = "kernel"

    def solve(self, b):
        return solve_with_elastic_kernel_arrays(self._ea, *self._waves, b)


@register_backend
class KernelBackend(ScanBackend):
    """Single- and multi-RHS CUDA kernels: one launch per solve, one block
    barrier per superstep (bulk) or per readiness wave (elastic) inside it.
    Binding also checks the plan's index contents and the elastic
    certificate, which the kernels read unchecked."""

    name = "kernel"
    bound_cls = KernelBoundSolve
    elastic_bound_cls = ElasticKernelBoundSolve
    plan_arrays = staticmethod(kernel_plan_arrays)

    @staticmethod
    def elastic_arrays(exec_plan, *, dtype, device):
        ea, wave_id, n_waves = elastic_kernel_arrays(exec_plan, dtype=dtype, device=device)
        return ea, (wave_id, n_waves)
