"""The encoder-decoder family and the frontend stubs of the port against the
JAX package's.

Serving: ``prefill``, twelve teacher-forced ``decode_step``s and
``forward(train=False)`` on the reduced seamless-m4t (encoder-decoder,
audio frames; prompts of 8 and 64 tokens, 2 and 16 encoder frames, and
16 tokens with a 1-layer decoder under a 3-layer encoder) and
the reduced llava-next (dense with the vision frontend; prompts of 16 and
64 positions, half of them patches), JAX's parameters carried over with
``convert.lm_params_from_numpy``, both sides fed the same
``make_train_batch`` tokens and frontend embeddings. Every cache leaf
(``k``, ``v``; seamless's cross caches ``xk``, ``xv``) is compared after
prefill and after each step. Tolerances those of
``tests/test_torch_lm_decode.py`` plus twice the reference's own spread
(``tests/_lm_parity.py`` says how it is measured and why): the attention
logits have std ~50 at the JAX init, and the reduced seamless at 64
tokens moves JAX's own logits by ~5e-4 between its jitted, nudged and
op-by-op runs.

Then the pieces on their own against JAX: the frontend projection (not
scaled by sqrt(d_model), prepended to the scaled tokens), the encoder,
``init_decode_cache(enc_len=)`` against prefill's cache and JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as P
from repro.launch.inputs import make_train_batch as jax_batch
from repro.models import decode as JD
from repro.models import lm as JL
from repro_torch.configs import get_reduced
from repro_torch.launch.inputs import make_train_batch, token_split
from repro_torch.models import forward, init_decode_cache, prefill
from repro_torch.models import lm as TL
from repro_torch.models.common import tree_paths

STEPS = 12
# name -> (arch, prompt length, config changes)
CASES = {
    "seamless_short": ("seamless_m4t_large_v2", 8, {}),
    "seamless": ("seamless_m4t_large_v2", 64, {}),
    # a decoder shallower than the encoder: each stack keeps its own depth
    "seamless_shallow_decoder": ("seamless_m4t_large_v2", 16, {"n_layers": 3,
                                                               "n_dec_layers": 1}),
    "llava_short": ("llava_next_mistral_7b", 16, {}),
    "llava": ("llava_next_mistral_7b", 64, {}),
}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    arch, S, changes = CASES[request.param]
    jc, tc = P.configs(arch, **changes)
    jp = P.jax_params(jc)
    jax_run = P.run_jax(jc, jp, S, STEPS)
    port_run = P.run_port(tc, P.port_params(tc, jp), S, jax_run["tokens"])
    return {"cfg": tc, "S": S, "jax": jax_run, "port": port_run}


def test_prefill_matches_jax(run):
    cfg, S, spread = run["cfg"], run["S"], run["jax"]["spread"]
    frames, text = token_split(cfg, S)
    assert frames > 0  # the frontend is fed
    assert np.array_equal(run["port"]["batch_tokens"], run["jax"]["batch_tokens"])
    # encdec: the decoder's tokens; llava: the patches and the tokens
    assert run["port"]["pos"] == run["jax"]["pos"] == (
        text if cfg.family == "encdec" else frames + text) == S
    assert run["port"]["logits"][0].shape == (2, cfg.padded_vocab)
    P.assert_logits_close(run["port"]["logits"][0], run["jax"]["logits"][0], spread["logits"])
    cache = run["port"]["caches"][0]
    want = {("k",), ("v",), ("xk",), ("xv",)} if cfg.family == "encdec" else {("k",), ("v",)}
    assert cache.keys() == want
    if cfg.family == "encdec":
        assert cache[("xk",)].shape == (cfg.n_dec_layers, 2, frames, cfg.n_kv_heads, cfg.hd)
    P.assert_cache_close(cache, run["jax"]["caches"][0], spread["cache"])


def test_decode_steps_match_jax(run):
    spread = run["jax"]["spread"]
    for i in range(1, STEPS + 1):
        assert torch.isfinite(run["port"]["logits"][i]).all()
        P.assert_logits_close(run["port"]["logits"][i], run["jax"]["logits"][i],
                              spread["logits"])
        P.assert_cache_close(run["port"]["caches"][i], run["jax"]["caches"][i],
                             spread["cache"])
    if run["cfg"].family == "encdec":  # decode leaves the cross caches as prefill made them
        for key in (("xk",), ("xv",)):
            assert np.array_equal(run["port"]["caches"][-1][key], run["port"]["caches"][0][key])


def test_greedy_tokens_equal_where_the_margin_allows(run):
    assert P.assert_greedy_equal_where_clear(
        run["port"]["logits"], run["jax"]["logits"], run["cfg"].vocab_size,
        run["jax"]["spread"]["logits"]) > 0


def test_forward_matches_jax_and_prefill(run):
    spread = run["jax"]["spread"]
    fwd = run["port"]["forward"]
    assert fwd.shape == (2, run["S"], run["cfg"].padded_vocab)
    P.assert_logits_close(fwd, run["jax"]["forward"], spread["forward"])
    assert float(run["port"]["aux"]) == 0.0 and run["port"]["aux"].dtype == torch.float32
    np.testing.assert_allclose(fwd[:, -1].numpy(), run["port"]["logits"][0].numpy(),
                               rtol=P.RTOL, atol=P.ATOL + 2 * spread["logits"])


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "llava_next_mistral_7b"])
def test_frontend_projection_and_encoder_match_jax(arch):
    jc, tc = P.configs(arch)
    jp = P.jax_params(jc)
    tp = P.port_params(tc, jp)
    jb = jax_batch(jc, batch=2, seq_len=32, seed=5)
    tb = make_train_batch(tc, batch=2, seq_len=32, seed=5, device="cpu")
    frames = token_split(tc, 32)[0]
    proj = TL._project_frontend(tp, tb["frontend_embeds"])
    want = np.einsum("bpd,de->bpe", np.asarray(jb["frontend_embeds"]),
                     np.asarray(jp["frontend_proj"]))
    np.testing.assert_allclose(proj.numpy(), want, rtol=1e-5, atol=1e-5)
    if arch == "llava_next_mistral_7b":
        h = TL._embed_inputs(tc, tp, tb)
        np.testing.assert_allclose(h.numpy(), np.asarray(JL._embed_inputs(jc, jp, jb)),
                                   rtol=1e-5, atol=1e-5)
        # the patches unscaled ahead of the tokens, which are scaled by sqrt(d_model)
        assert torch.equal(h[:, :frames], proj)
        assert torch.equal(h[:, frames:], TL._embed_tokens(tc, tp, tb["tokens"]))
        # without frontend embeddings the tokens alone, as in JAX
        bare = {"tokens": tb["tokens"]}
        np.testing.assert_allclose(
            TL._embed_inputs(tc, tp, bare).numpy(),
            np.asarray(JL._embed_inputs(jc, jp, {"tokens": jb["tokens"]})), rtol=1e-5, atol=1e-5)
    else:
        enc = TL._encode(tc, tp, tb["frontend_embeds"])
        assert enc.shape == (2, frames, tc.d_model)
        np.testing.assert_allclose(
            enc.numpy(), np.asarray(jax.jit(lambda p, f: JD._encode(jc, p, f))(
                jp, jb["frontend_embeds"])), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "llava_next_mistral_7b"])
def test_init_decode_cache_matches_prefill_and_jax(arch):
    jc, tc = P.configs(arch)
    tp = P.port_params(tc, P.jax_params(jc))
    S, max_len = 24, 40
    batch = make_train_batch(tc, batch=2, seq_len=S, seed=3, device="cpu")
    _, cache, _ = prefill(tc, tp, batch, max_len=max_len)
    enc_len = token_split(tc, S)[0] if tc.family == "encdec" else 0
    blank = init_decode_cache(tc, 2, max_len, enc_len=enc_len, device="cpu")
    jblank = P.jax_paths(JD.init_decode_cache(jc, 2, max_len, enc_len=enc_len,
                                              dtype=jnp.float32))
    assert tree_paths(cache).keys() == tree_paths(blank).keys() == jblank.keys()
    for path, leaf in tree_paths(cache).items():
        other = tree_paths(blank)[path]
        assert leaf.shape == other.shape == jblank[path].shape, path
        assert leaf.dtype == other.dtype == torch.float32 and not other.any(), path
    if tc.family == "encdec":
        assert tree_paths(blank)[("xv",)].shape == (2, 2, 6, 4, 16)
        wide = init_decode_cache(tc, 2, max_len, enc_len=enc_len, dtype=torch.float64,
                                 device="cpu")
        assert all(t.dtype == torch.float64 for t in tree_paths(wide).values())


def test_forward_train_raises_for_the_encoder_decoder():
    cfg = get_reduced("seamless_m4t_large_v2")
    with pytest.raises(NotImplementedError, match="training"):
        forward(cfg, {}, {}, train=True)


def test_encoder_and_decoder_stacks_keep_their_own_depths():
    _, tc = P.configs("seamless_m4t_large_v2", n_layers=3, n_dec_layers=1)
    specs = TL.param_specs(tc)
    assert specs["enc_layers"]["attn"]["wq"].shape == (3, 64, 4, 16)
    assert specs["dec_layers"]["cross_attn"]["wq"].shape == (1, 64, 4, 16)
    assert init_decode_cache(tc, 2, 8, enc_len=3, device="cpu")["xk"].shape == (1, 2, 3, 4, 16)
    # n_dec_layers None: the decoder as deep as the encoder
    same = dataclasses.replace(tc, n_dec_layers=None)
    assert TL.param_specs(same)["dec_layers"]["ln3"].shape == (3, 64)
