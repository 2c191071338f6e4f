"""Gradient compression of the port (the JAX package's
``distributed/compression.py``)."""
from repro_torch.distributed.compression import (
    compressed_grad_transform,
    dequantize_int8,
    ef_compress_tree,
    init_error_buffers,
    quantize_int8,
)

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "ef_compress_tree",
    "init_error_buffers",
    "compressed_grad_transform",
]
