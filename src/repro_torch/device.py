"""Where the port's tensors live: on the card unless the caller asks for
the CPU.

Every entry point that places tensors (``TriangularSolver.plan``,
``Backend.bind``, ``plan_arrays``, ``elastic_plan_arrays``,
``make_solver``, the kernel wrappers in ``kernels.ops`` and
``kernels.spmv.spmv``) takes ``device=None`` and resolves it here.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; without CUDA that raises instead of
    falling back to the CPU. Anything else is passed to ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch solves on the CUDA device by default and CUDA "
                "is not available; pass device='cpu' to solve on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
