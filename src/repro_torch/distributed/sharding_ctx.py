"""Ambient sharding-constraint context, as in the JAX package's
``distributed/sharding_ctx.py``.

The launcher installs a context with the mesh and the activation rules;
``constrain(x, role)`` marks the few load-bearing points (residual stream,
microbatch inputs, logits). The rules are the JAX package's:

  residual          [B, S, D]  -> (batch, seq?, None)  (seq-sharding lever)
  tokens            [B, S]     -> (batch, None)
  logits            [B, S, V]  -> (batch, None, 'model')
  microbatch_tokens [M, B, S]  -> (None, batch, None)
  decode_batch      [B]        -> (batch,)

``constrain`` returns ``x`` unchanged, inside a context or not: one
process holds each tensor whole, so there is no layout to constrain. The
rules are data for whoever reads them (the dry run takes the logits
rule); the model code does not call ``constrain``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from repro_torch.distributed.meshes import batch_axes, entry

_CTX: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "sharding_rules", default=None
)


def activation_rules(mesh, *, seq_sharded: bool = False) -> dict:
    """The five role rules for ``mesh``, each a spec tuple (an entry per
    dimension, as the JAX package's ``PartitionSpec``s hold them)."""
    batch = entry(batch_axes(mesh)) or None
    seq = "model" if (seq_sharded and "model" in mesh.axis_names) else None
    return {
        "residual": (batch, seq, None),
        "tokens": (batch, None),
        "logits": (batch, None, "model" if "model" in mesh.axis_names else None),
        "microbatch_tokens": (None, batch, None),
        "decode_batch": (batch,),
    }


@contextlib.contextmanager
def activation_sharding(mesh, *, seq_sharded: bool = False):
    token = _CTX.set(activation_rules(mesh, seq_sharded=seq_sharded))
    try:
        yield
    finally:
        _CTX.reset(token)


def constrain(x, role: str):
    """``x`` itself: one process has no layout to constrain (JAX's
    ``with_sharding_constraint`` has no counterpart here)."""
    return x
