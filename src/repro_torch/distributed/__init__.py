"""The port's ``distributed/``: logical-axis -> mesh spec resolution
(``meshes.py``), the activation-sharding context (``sharding_ctx.py``),
the fault-tolerance runtime (``fault_tolerance.py``) and gradient
compression (``compression.py``), as in the JAX package."""
from repro_torch.distributed.compression import (
    compressed_grad_transform,
    dequantize_int8,
    ef_compress_tree,
    init_error_buffers,
    quantize_int8,
)
from repro_torch.distributed.meshes import (
    batch_axes,
    logical_to_shardings,
    resolve_spec,
    shardings_for,
)

__all__ = [
    "batch_axes",
    "resolve_spec",
    "shardings_for",
    "logical_to_shardings",
    "quantize_int8",
    "dequantize_int8",
    "ef_compress_tree",
    "init_error_buffers",
    "compressed_grad_transform",
]
