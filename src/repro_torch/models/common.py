"""Shared model building blocks: parameter specs, norms, RoPE, MLPs, the loss.

Parameters are plain nested dicts of tensors, and every parameter carries a
*logical* sharding tuple built from the placeholder axis names ``'tp'``,
``'fsdp'`` and ``'batch'``, as in the JAX package, so the spec trees of the
two compare leaf for leaf. On one card nothing reads them.

A tree here is a nested ``dict`` whose leaves are ``ParamSpec``s or
tensors. Trees are walked in sorted key order (the order in which
``jax.tree_util`` flattens a dict), so ``init_params`` draws its leaves in
a fixed order from one generator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # logical sharding per dim
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.logical)


def tree_map(fn: Callable, tree: Pytree) -> Pytree:
    """``fn`` on every leaf, the dicts rebuilt in sorted key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree: Pytree) -> list:
    """The leaves in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree: Pytree, prefix: Tuple[str, ...] = ()) -> dict:
    """``{path: leaf}``, a path being the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_paths(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def init_params(
    specs: Pytree,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Pytree:
    """Materialize parameters from a ParamSpec tree.

    Normal leaves get ``scale / sqrt(fan_in)`` with ``fan_in = shape[0]``,
    the JAX package's rule kept as it is: for the stacked layer weights
    ``shape[0]`` is the layer count, not the input width. Draws come from
    ``generator`` on its own device, leaf by leaf in sorted key order, and
    land on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
        std = spec.scale / math.sqrt(fan_in)
        arr = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                          device=generator.device)
        return arr.mul_(std).to(device=dev, dtype=dtype)

    return tree_map(make, specs)


def abstract_params(specs: Pytree, dtype: torch.dtype = torch.float32) -> Pytree:
    """Tensors on the ``meta`` device: shapes and dtypes, no allocation."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def logical_specs(specs: Pytree) -> Pytree:
    """Tree of logical-axis tuples, same structure as the params."""
    return tree_map(lambda s: s.logical, specs)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalized in float32, cast back to ``x``'s dtype, then times gamma."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D]; cos/sin: [S, D/2] (or [1, D/2] for decode).
    Rotation runs in f32 (tables are f32) and casts back to x.dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]  # broadcast over heads
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """GELU MLP; the tanh approximation, which is ``jax.nn.gelu``'s default."""
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in float32: ``logsumexp`` minus the gold logit.
    logits [..., V]; labels int [...]; ``mask`` weights the tokens (the
    mean over its sum, at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)  # a bool mask too, as JAX promotes it
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
