"""The training slice's loss and training forward on the CPU:
``cross_entropy_loss`` against the JAX package's (with and without a
mask), ``loss_fn`` with the vocabulary's padding columns masked and on a
frontend's token tail, ``forward(train=True)`` bitwise
``forward(train=False)`` for each family, and the per-layer remat
(``torch.utils.checkpoint`` when ``cfg.remat``): gradients with and without
it bitwise equal, one checkpoint a layer.

Tolerance against JAX (float32): rtol = atol = 1e-4, the LM parity tests'
(``tests/_lm_parity.py``); the gradient checks of ``loss_fn`` are in
``tests/test_torch_train_grads_*.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as P
from repro.launch.inputs import make_train_batch as jax_batch
from repro.models import loss_fn as jax_loss
from repro.models.common import cross_entropy_loss as jax_ce
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import forward, init_params, loss_fn, param_specs
from repro_torch.models import lm as TL
from repro_torch.models.common import cross_entropy_loss
from repro_torch.train.train_loop import microbatch_grads

RTOL = ATOL = 1e-4
# one reduced config a family, and the vision frontend
FAMILIES = {
    "dense": "granite_3_2b",
    "moe": "deepseek_moe_16b",
    "rwkv6": "rwkv6_7b",
    "hybrid": "recurrentgemma_2b",
    "encdec": "seamless_m4t_large_v2",
    "vision": "llava_next_mistral_7b",
}


def _logits_and_labels(seed, shape=(2, 7), V=50):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((*shape, V)) * 4).astype(np.float32)
    labels = rng.integers(0, V, size=shape)
    return logits, labels


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    logits, labels = _logits_and_labels(0)
    mask = (np.random.default_rng(1).random(labels.shape) < 0.6).astype(np.float32)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    ref = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels, jnp.int32), jm))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), tm)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)


def test_cross_entropy_mask_edge_cases():
    logits, labels = _logits_and_labels(2)
    t, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    # an all-zero mask divides by max(sum, 1): a zero loss, as in JAX
    zero = np.zeros(labels.shape, np.float32)
    assert float(cross_entropy_loss(t, lab, torch.from_numpy(zero))) == 0.0
    assert float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(zero))) == 0.0
    # a bool mask is the float one
    keep = np.random.default_rng(3).random(labels.shape) < 0.5
    assert torch.equal(cross_entropy_loss(t, lab, torch.from_numpy(keep)),
                       cross_entropy_loss(t, lab, torch.from_numpy(keep.astype(np.float32))))
    # bfloat16 logits are scored in float32
    assert cross_entropy_loss(t.bfloat16(), lab).dtype == torch.float32


def _loss_pair(arch, S=32, **changes):
    jc, tc = P.configs(arch, **changes)
    jparams = P.jax_params(jc)
    tparams = P.port_params(tc, jparams)
    jb = jax_batch(jc, batch=2, seq_len=S, seed=4)
    tb = make_train_batch(tc, batch=2, seq_len=S, seed=4, device="cpu")
    ref = jax.jit(lambda p, b: jax_loss(jc, p, b, train=True))(jparams, jb)
    return tc, tparams, tb, ref, loss_fn(tc, tparams, tb, train=True)


def test_loss_masks_the_vocab_padding():
    # 250 tokens padded to 256: the six padding columns are set to -1e30
    tc, params, batch, (jl, jparts), (loss, parts) = _loss_pair(
        "granite_3_2b", vocab_size=250)
    assert tc.padded_vocab == 256
    for got, ref in ((loss, jl), (parts["ce"], jparts["ce"]), (parts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got), float(ref), rtol=RTOL, atol=ATOL)
    # the padding logits take no probability, so the unembedding's padding
    # columns get an exact zero gradient
    grads, _ = microbatch_grads(tc, params, batch)
    assert not grads["unembed"][:, 250:].any() and grads["unembed"][:, :250].any()
    # without the mask the loss is another number
    unmasked = dataclasses.replace(tc, vocab_size=256)
    assert abs(float(loss_fn(unmasked, params, batch)[0]) - float(loss)) > 1e-3


@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "seamless_m4t_large_v2"])
def test_loss_scores_the_token_tail(arch):
    tc, params, batch, (jl, jparts), (loss, parts) = _loss_pair(arch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL, atol=ATOL)
    logits, aux = forward(tc, params, batch, train=True)
    labels = batch["labels"]
    if tc.frontend == "vision":  # 16 patch positions ahead of the 16 tokens
        assert logits.shape[1] == 32 and labels.shape[1] == 16
    want = cross_entropy_loss(logits[:, -labels.shape[1]:], labels) + aux
    assert torch.equal(loss, want) and torch.equal(parts["ce"] + parts["aux"], loss)


def test_moe_loss_carries_the_aux():
    tc, params, batch, (jl, jparts), (loss, parts) = _loss_pair("deepseek_moe_16b")
    assert float(parts["aux"]) > 0
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL, atol=ATOL)


def _port(arch, **changes):
    cfg = dataclasses.replace(P.configs(arch)[1], **changes)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    batch = make_train_batch(cfg, batch=2, seq_len=32, seed=5, device="cpu")
    return cfg, params, batch


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_forward_is_the_serving_forward(family):
    cfg, params, batch = _port(FAMILIES[family])
    logits, aux = forward(cfg, params, batch, train=False)
    for remat in (True, False):
        got, got_aux = forward(dataclasses.replace(cfg, remat=remat), params, batch, train=True)
        assert torch.equal(got, logits) and torch.equal(got_aux, aux)
    # under autograd too
    tracked = TL.tree_map(lambda t: t.detach().requires_grad_(), params)
    got, got_aux = forward(cfg, tracked, batch, train=True)
    assert torch.equal(got.detach(), logits) and torch.equal(got_aux.detach(), aux)


def _layer_calls(cfg):
    """The layers a training forward checkpoints: one a stacked layer (the
    hybrid's superblock as one, each tail layer, each encoder and decoder
    layer)."""
    if cfg.family == "hybrid":
        return sum(divmod(cfg.n_layers, 3))
    if cfg.family == "encdec":
        return cfg.n_layers + (cfg.n_dec_layers or cfg.n_layers)
    return cfg.n_layers


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gradients_are_bitwise_and_checkpoint_each_layer(family, monkeypatch):
    cfg, params, batch = _port(FAMILIES[family])
    calls = []
    real = TL.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(TL, "checkpoint", counting)
    grads = {}
    for remat in (True, False):
        calls.clear()
        g, loss = microbatch_grads(dataclasses.replace(cfg, remat=remat), params, batch, 2)
        grads[remat] = (TL.tree_leaves(g), loss)
        # one checkpoint a layer a microbatch, non-reentrant; none without remat
        assert len(calls) == (2 * _layer_calls(cfg) if remat else 0)
        assert all(kw == {"use_reentrant": False} for kw in calls)
    (with_remat, l1), (without, l0) = grads[True], grads[False]
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(with_remat, without))
