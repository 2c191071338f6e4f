"""Kernel backend — the hand-written CUDA SpTRSV kernels behind the
``Backend`` protocol (wrapper in ``repro_torch.kernels.sptrsv``). The port's
counterpart of the JAX package's ``pallas`` backend, and the default of
``TriangularSolver.plan``. CPU tensors take the kernels' plain version."""
from __future__ import annotations

from repro_torch.backends.registry import register_backend
from repro_torch.backends.scan import ScanBackend, ScanBoundSolve
from repro_torch.kernels.ops import kernel_plan_arrays, solve_with_kernel_arrays


class KernelBoundSolve(ScanBoundSolve):
    """Same tensors and value refresh as the scan bound; the solve runs
    ``sptrsv_cuda``."""

    backend = "kernel"

    def solve(self, b):
        return solve_with_kernel_arrays(self._pa, b)


@register_backend
class KernelBackend(ScanBackend):
    """Single- and multi-RHS CUDA kernels: one launch per solve, one block
    barrier per superstep inside it. Binding also checks the plan's index
    contents, which the kernels read unchecked."""

    name = "kernel"
    bound_cls = KernelBoundSolve
    plan_arrays = staticmethod(kernel_plan_arrays)
