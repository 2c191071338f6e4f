"""AdamW with decoupled weight decay, global-norm clipping and a linear
warmup + cosine decay schedule, as in the JAX package. The moments are
float32 trees shaped like the parameters; ``step`` is an int32 0-d tensor.

The arithmetic is spelled in float32 tensors, as JAX spells it: the
schedule, ``b1 ** step`` and the bias corrections are 0-d float32 tensors,
and each leaf's update is JAX's expression, one operation at a time (no
fused multiply-add). A divisor is a tensor, never a Python number (CUDA
torch multiplies by the reciprocal of a Python divisor), and the square
root is correctly rounded (``_sqrt_rn``). ``global_norm`` sums the
leaves' squares left to right in sorted key order, JAX's leaf order.

``adamw_update_`` writes the new parameters and moments into the given
tensors (on one card a second copy of a full-width state does not fit:
granite-3-2b's parameters and moments are 31.7 GB in float32);
``adamw_update`` is the pure form, JAX's, on copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: Pytree) -> Pytree:
    """Zero float32 moments shaped like ``params``, on their devices, and
    step 0."""
    dev = tree_leaves(params)[0].device

    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"mu": tree_map(zeros32, params), "nu": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA and CUDA take it.
    torch's vectorized float32 sqrt on the CPU is not (it misses by an ulp
    on ~0.6% of inputs); the float64 root rounded to float32 is."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor): linear warmup, then a
    cosine from ``lr`` down to ``min_lr_ratio * lr`` at ``total_steps``."""
    step = step.to(torch.float32)
    warm = step / torch.full_like(step, max(cfg.warmup_steps, 1))
    progress = (step - cfg.warmup_steps) / torch.full_like(
        step, max(cfg.total_steps - cfg.warmup_steps, 1))
    progress = torch.clamp(progress, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(torch.full_like(step, math.pi) * progress))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the leaves' float32 sums of squares, summed left to right."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update_(cfg: AdamWConfig, params: Pytree, grads: Pytree,
                  opt_state: Pytree) -> Tuple[Pytree, Pytree, dict]:
    """One AdamW step written into ``params`` and ``opt_state``'s moments;
    returns (params, opt_state with the new step, {"grad_norm", "lr"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    lr = lr_at(cfg, step)
    step32 = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(step32, b1), step32)
    bc2 = 1 - torch.pow(torch.full_like(step32, b2), step32)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_(g * (1 - b1))  # m2 = b1 * m + (1 - b1) * g
        v.mul_(b2).add_(g * (1 - b2) * g)  # v2 = b2 * v + (1 - b2) * g * g
        del g
        den = _sqrt_rn(v / bc2).add_(cfg.eps)  # sqrt(vh) + eps
        delta = (m / bc1).div_(den)  # mh / (sqrt(vh) + eps)
        del den
        delta.add_(cfg.weight_decay * p.to(torch.float32))
        if p.dtype == torch.float32:
            p.sub_(lr * delta)
        else:
            p.copy_(p.to(torch.float32) - lr * delta)
    opt_state = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def adamw_update(cfg: AdamWConfig, params: Pytree, grads: Pytree,
                 opt_state: Pytree) -> Tuple[Pytree, Pytree, dict]:
    """``adamw_update_`` on copies: the given trees are left as they are."""
    return adamw_update_(cfg, tree_map(torch.clone, params), grads,
                         {"mu": tree_map(torch.clone, opt_state["mu"]),
                          "nu": tree_map(torch.clone, opt_state["nu"]),
                          "step": opt_state["step"]})
