"""Error-feedback gradient compression, as in the JAX package's
``distributed/compression.py``: gradients quantized to int8 with a float32
scale per block of 256 (symmetric, round half to even), the quantization
residual kept in an error-feedback buffer and added back the next step,
so that the compression's bias does not accumulate.

The float32 arithmetic is spelled as XLA compiles the JAX functions under
jit, so that the two agree bit for bit: the scale ``max|x| / 127 + 1e-12``
as one fused multiply-add of ``max|x|`` and ``float32(1/127)``, the
residual ``g - q * scale`` as one fused multiply-add (``torch.addcmul``, as
the port's plain SpTRSV step). JAX run op by op rounds each operation, an
ulp away in places.

``compressed_grad_transform`` plugs into ``make_train_step(grad_transform=
...)``. On one card there is no slow hop to save, so the pair is what the
JAX package makes of it on any mesh: quantize then dequantize, a no-op up
to bounded noise. The port runs eagerly, so the buffer in
``error_state["e"]`` is carried from step to step.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import tree_leaves, tree_map

Pytree = Any

BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x flattened, zero-padded to whole blocks: [n_blocks, BLOCK]."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.shape[0]) % BLOCK)).reshape(-1, BLOCK)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of x (any shape, flattened):
    (q int8 [n_blocks, BLOCK], scale f32 [n_blocks, 1])."""
    blocks = _blocks(x)
    # JAX's max / 127.0 + 1e-12 as XLA compiles it under jit: one fused
    # multiply-add of the largest |x| and float32(1 / 127)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    inv127 = torch.full((), 1 / 127.0, dtype=amax.dtype, device=x.device)
    scale = torch.addcmul(torch.full_like(amax, 1e-12), amax, inv127)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, size) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def ef_compress_tree(grads: Pytree, error: Pytree) -> Tuple[Pytree, Pytree]:
    """(compressed-then-decompressed grads, new error buffers)."""

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s, g32.shape, g32.numel())
        # g32 - deq, as XLA fuses it: g32 - q * scale rounded once
        err = torch.addcmul(_blocks(g32), q.to(torch.float32), s, value=-1)
        return deq.to(g.dtype), err.reshape(-1)[:g32.numel()].reshape(g32.shape)

    outs = iter([one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error))])
    pairs = tree_map(lambda _: next(outs), grads)
    return tree_map(lambda o: o[0], pairs), tree_map(lambda o: o[1], pairs)


def init_error_buffers(params: Pytree) -> Pytree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compressed_grad_transform(error_state: dict) -> Callable[[Pytree], Pytree]:
    """A grad_transform that carries its buffers through the closure:
    ``error_state['e']`` holds them and is replaced every call."""

    def transform(grads: Pytree) -> Pytree:
        new_g, new_e = ef_compress_tree(grads, error_state["e"])
        error_state["e"] = new_e
        return new_g

    return transform
