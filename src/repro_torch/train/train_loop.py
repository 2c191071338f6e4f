"""The train step, as in the JAX package's ``train/train_loop.py``.

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)``:
  * the batch ``[B, ...]`` is split into ``[M, B/M, ...]`` microbatches
    (JAX's reshape), and their float32 gradients are summed in order and
    divided by M (``microbatch_grads``): activations of one microbatch
    live at a time;
  * ``grad_transform`` (gradient compression, ``distributed/
    compression.py``) then sees the mean gradient, and AdamW applies it.

The step is eager PyTorch. It writes the new parameters and moments into
``state``'s tensors and returns that state (on one card a full-width
state does not fit twice; JAX's jitted step is pure): clone a state to
keep it. The JAX package's ``activation_constraint`` argument, which no
caller there passes, is left out: its sequence-parallel sharding
constraint has no meaning on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.lm import ModelConfig, loss_fn
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update_

Pytree = Any


@dataclasses.dataclass
class TrainState:
    params: Pytree
    opt_state: Pytree


def init_train_state(cfg: ModelConfig, params: Pytree) -> TrainState:
    return TrainState(params=params, opt_state=adamw_init(params))


def train_state_specs(param_logical: Pytree) -> TrainState:
    """Logical specs for the whole TrainState (moments shard like params)."""
    return TrainState(
        params=param_logical,
        opt_state={"mu": param_logical, "nu": param_logical, "step": ()},
    )


def clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` that a train step on ``state`` leaves alone."""
    return TrainState(params=tree_map(torch.clone, state.params),
                      opt_state=tree_map(torch.clone, state.opt_state))


def microbatch_grads(cfg: ModelConfig, params: Pytree, batch: dict, microbatches: int = 1):
    """(mean float32 gradient tree, mean loss) of ``loss_fn(train=True)``
    over ``microbatches`` equal slices of the batch, taken in order: the
    gradients summed microbatch by microbatch, then divided by M, as JAX's
    scan does (JAX starts the sum from zeros; the first microbatch's
    gradient here, which differs only in the sign of a zero)."""
    M = microbatches
    mbs = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:]) for k, v in batch.items()}
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    gsum, lsum = None, None
    for i in range(M):
        loss, _ = loss_fn(cfg, tracked, {k: v[i] for k, v in mbs.items()}, train=True)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
        loss = loss.detach()
        if gsum is None:
            gsum = [g.to(torch.float32) for g in grads]
            lsum = loss
        else:
            for acc, g in zip(gsum, grads):
                acc.add_(g.to(torch.float32))
            lsum = lsum + loss
        del grads
    m = torch.full_like(lsum, M)  # a tensor divisor: see optimizer.py
    for g in gsum:
        g.div_(m)
    it = iter(gsum)
    return tree_map(lambda _: next(it), params), lsum / m


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    grad_transform: Optional[Callable[[Pytree], Pytree]] = None,
):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: {"tokens": int[B, S], "labels": int[B, S], ...} on the
    parameters' device. Metrics (0-d tensors): ``loss`` (the mean over
    the microbatches), ``grad_norm`` (of the transformed mean gradient,
    before clipping) and ``lr``."""

    def train_step(state: TrainState, batch):
        grads, loss = microbatch_grads(cfg, state.params, batch, microbatches)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = adamw_update_(opt_cfg, state.params, grads,
                                                       state.opt_state)
        del grads
        return TrainState(params=params, opt_state=opt_state), {"loss": loss, **opt_metrics}

    return train_step
