"""The training slice's gradients against the JAX package's, RG-LRU hybrid
(recurrentgemma: one superblock and two tail layers). ``jax.grad`` of
``loss_fn(train=True)`` (jitted) and the port's ``microbatch_grads`` on the
CPU, on the same reduced parameters and ``make_train_batch`` tokens (batch
2, sequence 32, attention chunks of 16).

Tolerance (``tests/_lm_parity.py::grad_run``): the loss and every gradient
leaf at ``rtol = 1e-4`` and ``atol = 1e-4 * max|leaf|``, plus twice the
spread measured here: JAX and the port each against itself with
one-ulp-nudged parameters, and JAX jitted against JAX op by op. The
backward pass amplifies the RG-LRU's float32 conditioning: the spread is
~9% of a leaf's largest, and the port lies by JAX op by op.
"""
import functools

import pytest

import _lm_parity as P

S = 32
ARCHS = ["recurrentgemma_2b"]


@functools.lru_cache(maxsize=None)
def _run(arch):
    return P.grad_run(arch, S, attn_kv_chunk=16, op_by_op=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    run = _run(arch)
    P.assert_loss_close(run["port_loss"], run)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    run = _run(arch)
    P.assert_grads_close(run["port_grads"], run["grads"], run["spread"])
