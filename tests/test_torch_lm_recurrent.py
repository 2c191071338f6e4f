"""The RWKV-6 and RG-LRU hybrid families of the port against the JAX
package's.

Serving: ``prefill`` (every cache leaf), twelve teacher-forced
``decode_step``s and ``forward(train=False)`` on the reduced rwkv6 (the
per-token WKV loop, and the chunked path with ``wkv_chunk=8``) and the
reduced recurrentgemma (1 superblock and 2 tail layers; local window 32,
prompts of 24 and 64 tokens: the ring wraps in decode, and in prefill),
JAX's parameters carried over with ``convert.lm_params_from_numpy``.
Tolerances those of ``tests/test_torch_lm_decode.py`` plus twice the
reference's own spread (``tests/_lm_parity.py``: it is what decides the
hybrid's bound, whose recurrence is ill-conditioned at these weights).

Blocks: the chunked WKV against the per-token loop on the port, as
``tests/test_rwkv_chunked.py`` holds JAX's (chunk 4 / 8 / 16 x decay
scale 0.3 / 1 / 2, tolerance ``2e-4 * max(1, chunk * decay / 8)``); the
RG-LRU block, the causal conv and the RWKV time / channel mix against
JAX's on inputs where the recurrence is well conditioned (rtol 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as P
from repro.models import common as JC
from repro.models import rglru as JR
from repro.models import rwkv6 as JW
from repro_torch.models import rglru as TR
from repro_torch.models import rwkv6 as TW
from repro_torch.models.common import tree_map

STEPS = 12
# name -> (arch, config changes, prompt length)
CASES = {
    "rwkv6": ("rwkv6_7b", {}, 64),
    "rwkv6_chunked": ("rwkv6_7b", {"wkv_chunk": 8}, 64),
    "recurrentgemma": ("recurrentgemma_2b", {}, 64),
    "recurrentgemma_wrapped": ("recurrentgemma_2b", {}, 24),
}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    arch, changes, S = CASES[request.param]
    jc, tc = P.configs(arch, **changes)
    jp = P.jax_params(jc)
    jax_run = P.run_jax(jc, jp, S, STEPS)
    port_run = P.run_port(tc, P.port_params(tc, jp), S, jax_run["tokens"])
    return {"cfg": tc, "S": S, "jax": jax_run, "port": port_run}


def test_prefill_matches_jax(run):
    spread = run["jax"]["spread"]
    assert np.array_equal(run["port"]["batch_tokens"], run["jax"]["batch_tokens"])
    assert run["port"]["pos"] == run["jax"]["pos"] == run["S"]
    assert run["port"]["logits"][0].shape == (2, run["cfg"].padded_vocab)
    P.assert_logits_close(run["port"]["logits"][0], run["jax"]["logits"][0], spread["logits"])
    P.assert_cache_close(run["port"]["caches"][0], run["jax"]["caches"][0], spread["cache"])


def test_decode_steps_match_jax(run):
    spread = run["jax"]["spread"]
    for i in range(1, STEPS + 1):
        assert torch.isfinite(run["port"]["logits"][i]).all()
        P.assert_logits_close(run["port"]["logits"][i], run["jax"]["logits"][i],
                              spread["logits"])
        P.assert_cache_close(run["port"]["caches"][i], run["jax"]["caches"][i],
                             spread["cache"])
    assert P.assert_greedy_equal_where_clear(run["port"]["logits"], run["jax"]["logits"],
                                             run["cfg"].vocab_size, spread["logits"]) > 0


def test_forward_matches_jax(run):
    fwd = run["port"]["forward"]
    assert fwd.shape == (2, run["S"], run["cfg"].padded_vocab)
    P.assert_logits_close(fwd, run["jax"]["forward"], run["jax"]["spread"]["forward"])
    assert float(run["port"]["aux"]) == float(run["jax"]["aux"]) == 0.0


def test_state_layout(run):
    """The recurrent states are float32 and constant in size; the hybrid's
    attention cache is a ring of the local window whatever the prompt."""
    cfg, cache = run["cfg"], run["port"]["caches"][0]
    if cfg.family == "rwkv6":
        H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
        assert cache[("wkv",)].shape == (cfg.n_layers, 2, H, Dh, Dh)
        assert cache[("shift_tm",)].shape == cache[("shift_cm",)].shape == (
            cfg.n_layers, 2, 1, cfg.d_model)
    else:
        n_super, n_tail = divmod(cfg.n_layers, 3)
        assert (n_super, n_tail) == (1, 2)
        assert cache[("super", "attn", "k")].shape == (1, 2, cfg.local_window, 1, cfg.hd)
        assert cache[("tail", "h")].shape == (2, 2, cfg.d_rnn)
        assert cache[("tail", "conv")].shape == (2, 2, 3, cfg.d_rnn)
    for path, leaf in cache.items():
        want = np.float32
        assert leaf.dtype == want, path


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _random_wkv_inputs(rng, B, S, H, Dh, decay_scale):
    """``tests/test_rwkv_chunked.py``'s inputs, as torch tensors."""
    r, k, v = (rng.standard_normal((B, S, H, Dh)).astype(np.float32) for _ in range(3))
    dd = (rng.standard_normal((B, S, H, Dh)) * decay_scale).astype(np.float32)
    log_w = -np.exp(dd)
    w = np.exp(log_w)
    u = (rng.standard_normal((H, Dh)) * 0.3).astype(np.float32)
    S0 = (rng.standard_normal((B, H, Dh, Dh)) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (r, k, v, w, log_w, u, S0))


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("decay_scale", [0.3, 1.0, 2.0])
def test_chunked_wkv_matches_the_loop(chunk, decay_scale):
    rng = np.random.default_rng(chunk * 100 + int(decay_scale * 10))
    B, S, H, Dh = 2, 32, 3, 8
    r, k, v, w, log_w, u, S0 = _random_wkv_inputs(rng, B, S, H, Dh, decay_scale)
    S_seq, o_seq = TW._wkv_sequential(r, k, v, w, u, S0)
    S_chk, o_chk = TW._wkv_chunked(r, k, v, log_w, u, S0, chunk)
    # the two orders accumulate the decay differently (see the JAX test)
    tol = 2e-4 * max(1.0, chunk * decay_scale / 8.0)
    np.testing.assert_allclose(o_chk.numpy(), o_seq.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(S_chk.numpy(), S_seq.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [None, 8])
def test_wkv_paths_match_jax(chunk):
    rng = np.random.default_rng(7)
    B, S, H, Dh = 2, 16, 3, 8
    inputs = _random_wkv_inputs(rng, B, S, H, Dh, 1.0)
    r, k, v, w, log_w, u, S0 = (jnp.asarray(t.numpy()) for t in inputs)
    if chunk:
        ref = JW._wkv_chunked(r, k, v, log_w, u, S0, chunk)
        got = TW._wkv_chunked(*inputs[:3], inputs[4], *inputs[5:], chunk)
    else:
        ref = JW._wkv_sequential(r, k, v, w, u, S0)
        got = TW._wkv_sequential(*inputs[:4], *inputs[5:])
    for g, j in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def _params(specs, seed, std=None):
    """JAX's ``init_params`` of ``specs`` as numpy, normal leaves rescaled
    to ``std`` where given."""
    p = jax.tree_util.tree_map(
        np.asarray, JC.init_params(specs, jax.random.PRNGKey(seed), dtype=jnp.float32))
    if std is not None:
        p = {k: (v / max(v.std(), 1e-30) * std if specs[k].init == "normal" else v)
             for k, v in p.items()}
    return p


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


@pytest.mark.parametrize("decode", [False, True])
def test_rglru_block_matches_jax(decode):
    cfg = JR.RGLRUConfig(d_model=32, d_rnn=48)
    # gates of moderate size: r stays away from 0, so 1 - a^2 is many ulps
    params = _params(JR.rglru_param_specs(cfg), 1, std=0.05)
    params["lambda_p"] = np.linspace(-1.0, 0.5, 48).astype(np.float32)
    rng = np.random.default_rng(2)
    S = 1 if decode else 12
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    prev = {"conv_prev": rng.standard_normal((2, 3, 48)).astype(np.float32),
            "h_prev": rng.standard_normal((2, 48)).astype(np.float32)} if decode else {}
    yj, (cj, hj) = jax.jit(lambda p, x, kw: JR.rglru_block(p, cfg, x, **kw))(
        params, x, prev)
    yt, (ct, ht) = TR.rglru_block(_to_torch(params), TR.RGLRUConfig(32, 48),
                                  torch.from_numpy(x), **_to_torch(prev))
    assert ht.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5, atol=1e-5)


def test_conv1d_sums_its_taps_left_to_right():
    rng = np.random.default_rng(4)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 5), (4, 5), (5,)))
    prev = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for p in (None, prev):
        oj, sj = JR._conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            None if p is None else jnp.asarray(p))
        ot, st = TR._conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            None if p is None else torch.from_numpy(p))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("chunk", [None, 4])
def test_time_and_channel_mix_match_jax(chunk):
    cfg = JW.RWKVConfig(d_model=32, n_heads=4, d_ff=64, decay_lora=8)
    specs = JW.rwkv_param_specs(cfg)
    tm, cm = _params(specs["time_mix"], 3, std=0.1), _params(specs["channel_mix"], 4, std=0.1)
    tm["bonus_u"] = np.linspace(-0.5, 0.5, 32).astype(np.float32)
    x = np.random.default_rng(5).standard_normal((2, 8, 32)).astype(np.float32)
    yj, (sj, stj) = jax.jit(lambda p, x: JW.time_mix(p, cfg, x, chunk=chunk))(tm, x)
    tcfg = TW.RWKVConfig(**dataclasses.asdict(cfg))
    yt, (st, stt) = TW.time_mix(_to_torch(tm), tcfg, torch.from_numpy(x), chunk=chunk)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(stt.numpy(), np.asarray(stj), rtol=1e-5, atol=1e-5)
    cj, lj = jax.jit(lambda p, x: JW.channel_mix(p, cfg, x))(cm, x)
    ct, lt = TW.channel_mix(_to_torch(cm), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
