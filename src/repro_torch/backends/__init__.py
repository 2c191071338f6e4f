"""Execution backends of the port: ``Backend.bind(plan) -> BoundSolve``.

Built in: ``kernel`` (the CUDA kernels; their plain version on CPU
tensors) and ``scan`` (the plain PyTorch executor), both with the
``"grouped"``, ``"elastic"`` and ``"slots"`` capabilities, and
``distributed`` (a mesh of card positions, ``repro_torch.mesh``; the level
kernels one range a position and round; ``"elastic"`` and
``"shard-rows"``). See ``base`` for the protocol and ``registry``
for registration.
"""
from repro_torch.backends.base import (
    Backend,
    BoundSolve,
    expected_entry_count,
    masked_value_gather,
)
from repro_torch.backends.registry import (
    available_backends,
    backends_with,
    bind,
    get_backend,
    register_backend,
    unregister_backend,
)

# the built-ins register themselves on import
from repro_torch.backends.kernel import (  # noqa: E402
    ElasticKernelBoundSolve,
    KernelBackend,
    KernelBoundSolve,
)
from repro_torch.backends.scan import (  # noqa: E402
    ElasticScanBoundSolve,
    ScanBackend,
    ScanBoundSolve,
)
from repro_torch.backends.distributed import (  # noqa: E402
    DistributedBackend,
    DistributedBoundSolve,
    RowShardedBoundSolve,
)

__all__ = [
    "Backend",
    "BoundSolve",
    "DistributedBackend",
    "DistributedBoundSolve",
    "ElasticKernelBoundSolve",
    "ElasticScanBoundSolve",
    "KernelBackend",
    "KernelBoundSolve",
    "RowShardedBoundSolve",
    "ScanBackend",
    "ScanBoundSolve",
    "available_backends",
    "backends_with",
    "bind",
    "expected_entry_count",
    "get_backend",
    "masked_value_gather",
    "register_backend",
    "unregister_backend",
]
