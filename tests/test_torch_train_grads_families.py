"""The training slice's gradients against the JAX package's: the MoE
family (deepseek-moe with shared experts, mixtral with its window), RWKV-6
(the WKV loop), the encoder-decoder (seamless-m4t: 8 projected frames
through the encoder, the decoder cross-attending to them) and the vision
frontend (llava: 16 patches ahead of 16 tokens, the loss on the text tail
only). ``jax.grad`` of ``loss_fn(train=True)`` (jitted) and the port's
``microbatch_grads`` on the CPU, on the same reduced parameters and
``make_train_batch`` tokens (batch 2, sequence 32, attention chunks of 8:
the decoder's 32 positions in four, the encoder's 8 frames in one).

Tolerance (``tests/_lm_parity.py::grad_run``): the loss and every gradient
leaf at ``rtol = 1e-4`` and ``atol = 1e-4 * max|leaf|``, plus twice the
spread measured here: JAX and the port each against itself with
one-ulp-nudged parameters. The MoE's router gradient passes through
``top_p``, whose softmax is not bitwise JAX's (``tests/test_torch_lm_moe.py``).
"""
import functools

import pytest

import _lm_parity as P

S = 32
ARCHS = [
    "deepseek_moe_16b",
    "mixtral_8x7b",
    "rwkv6_7b",
    "seamless_m4t_large_v2",
    "llava_next_mistral_7b",
]


@functools.lru_cache(maxsize=None)
def _run(arch):
    return P.grad_run(arch, S, attn_kv_chunk=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    run = _run(arch)
    P.assert_loss_close(run["port_loss"], run)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    run = _run(arch)
    P.assert_grads_close(run["port_grads"], run["grads"], run["spread"])
