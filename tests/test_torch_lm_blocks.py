"""The LM stack's building blocks in the port against the JAX package's,
on the same numpy inputs: RMSNorm, RoPE and its tables, SwiGLU, the KV
expansion, the chunked (online-softmax) attention and the one-token decode
attention with its cache update, and the ring fill of a window cache.

Float32 throughout, the JAX side under ``jax.jit`` on the CPU; tolerance
``rtol=1e-5, atol=1e-6`` (``assert_close`` below).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import common as JC
from repro.models import decode as JD
from repro.models import lm as JL
from repro_torch.configs import get_reduced
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import decode as TD
from repro_torch.models import lm as TL

RTOL, ATOL = 1e-5, 1e-6


def assert_close(port, ref, rtol=RTOL, atol=ATOL):
    ref = np.asarray(ref)
    port = port.detach().cpu().numpy()
    assert port.shape == ref.shape and port.dtype == ref.dtype
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, g = _normal(rng, (2, 7, 48), 3.0), _normal(rng, (48,))
    for eps in (1e-6, 1e-5):
        ref = jax.jit(lambda a, b: JC.rms_norm(a, b, eps))(x, g)
        assert_close(TC.rms_norm(_t(x), _t(g), eps), ref)


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_32b"])
def test_rope_tables_and_apply_rope(arch):
    cfg = get_reduced(arch)
    positions = np.arange(80, dtype=np.int32)
    cj, sj = jax.jit(lambda p: JL._rope_tables(cfg, p))(positions)
    ct, st = TL._rope_tables(cfg, torch.arange(80))
    assert_close(ct, cj)
    assert_close(st, sj)
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 80, 4, cfg.hd), 2.0)
    assert_close(TC.apply_rope(_t(x), ct, st), jax.jit(JC.apply_rope)(x, cj, sj))
    # decode: one position's row
    cj1, sj1 = jax.jit(lambda p: JL._rope_tables(cfg, p[None]))(np.int32(37))
    ct1, st1 = TL._rope_tables(cfg, torch.tensor(37)[None])
    assert_close(ct1, cj1)
    x1 = x[:, :1]
    assert_close(TC.apply_rope(_t(x1), ct1, st1), jax.jit(JC.apply_rope)(x1, cj1, sj1))


def test_swiglu_and_gelu_mlp():
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 5, 32))
    wg, wu, wd = _normal(rng, (32, 64), 0.2), _normal(rng, (32, 64), 0.2), _normal(rng, (64, 32), 0.2)
    assert_close(TC.swiglu(*map(_t, (x, wg, wu, wd))), jax.jit(JC.swiglu)(x, wg, wu, wd))
    assert_close(TC.gelu_mlp(*map(_t, (x, wu, wd))), jax.jit(JC.gelu_mlp)(x, wu, wd))


@pytest.mark.parametrize("groups", [1, 4])
def test_expand_kv(groups):
    rng = np.random.default_rng(3)
    k = _normal(rng, (2, 6, 2, 8))
    out = TA._expand_kv(_t(k), 2 * groups)
    assert torch.equal(out, _t(JA._expand_kv(jnp.asarray(k), 2 * groups)))
    # head h reads kv head h // G
    for h in range(2 * groups):
        assert torch.equal(out[:, :, h], _t(k[:, :, h // groups]))


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_causal_window_mask(causal, window, q_offset):
    ref = JA._causal_window_mask(6, 12, window, causal, q_offset)
    assert torch.equal(TA._causal_window_mask(6, 12, window, causal, q_offset), _t(ref))


@pytest.mark.parametrize("kv_chunk", [32, 8])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention(causal, window, kv_chunk):
    # T = 32: kv_chunk == T and a proper divisor. With window 8 and chunks
    # of 8, rows 15.. have a fully masked first chunk.
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, (2, 32, 4, 16)) for _ in range(3))
    ref = jax.jit(lambda a, b, c: JA._chunked_attention(
        a, b, c, causal=causal, window=window, kv_chunk=kv_chunk))(q, k, v)
    out = TA._chunked_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                                kv_chunk=kv_chunk)
    assert torch.isfinite(out).all()
    assert_close(out, ref)


def test_chunked_attention_rejects_ragged_chunks():
    x = torch.zeros(1, 12, 1, 4)
    with pytest.raises(AssertionError):
        TA._chunked_attention(x, x, x, causal=True, window=None, kv_chunk=8)


def _attn_cfg(groups, qk_norm, window=None):
    return JA.AttnConfig(d_model=32, n_heads=2 * groups, n_kv_heads=2, head_dim=8,
                         qk_norm=qk_norm, window=window)


def _attn_params(cfg, rng):
    # weights of std 1 / sqrt(fan in), so unit-scale inputs give unit-scale
    # outputs (wo's fan in is H * Dh)
    specs = JA.attn_param_specs(cfg)
    return {k: (np.ones(s.shape, np.float32) if s.init == "ones"
                else _normal(rng, s.shape, (np.prod(s.shape) / s.shape[-1]) ** -0.5
                             if k == "wo" else s.shape[0] ** -0.5))
            for k, s in specs.items()}


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_multi_head_attention(groups, qk_norm):
    jcfg = _attn_cfg(groups, qk_norm)
    tcfg = TA.AttnConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(5)
    p = _attn_params(jcfg, rng)
    x = _normal(rng, (2, 16, 32))
    cos, sin = (np.asarray(a) for a in JL._rope_tables(
        dataclasses.replace(get_reduced("granite_3_2b"), head_dim=8), jnp.arange(16)))
    ref = jax.jit(lambda pp, xx: JA.multi_head_attention(
        pp, jcfg, xx, rope_cos=cos, rope_sin=sin, kv_chunk=8))(p, x)
    out = TA.multi_head_attention({k: _t(a) for k, a in p.items()}, tcfg, _t(x),
                                  rope_cos=_t(cos), rope_sin=_t(sin), kv_chunk=8)
    assert_close(out, ref)


def _decode_case(groups, qk_norm, window, S_max, positions):
    jcfg = _attn_cfg(groups, qk_norm, window)
    tcfg = TA.AttnConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(6 + groups)
    p = _attn_params(jcfg, rng)
    tp = {k: _t(a) for k, a in p.items()}
    cache = {"k": _normal(rng, (2, S_max, 2, 8)), "v": _normal(rng, (2, S_max, 2, 8))}
    tcache = {k: _t(a) for k, a in cache.items()}
    mcfg = dataclasses.replace(get_reduced("granite_3_2b"), head_dim=8)
    step = jax.jit(lambda pp, xx, cc, pos, c, s: JA.decode_attention(
        pp, jcfg, xx, cc, pos, rope_cos=c, rope_sin=s))
    for pos in positions:
        x = _normal(rng, (2, 1, 32))
        c, s = (np.asarray(a) for a in JL._rope_tables(mcfg, jnp.asarray([pos])))
        y_ref, cache = step(p, x, cache, jnp.asarray(pos, jnp.int32), c, s)
        y, tcache = TA.decode_attention(tp, tcfg, _t(x), tcache, pos,
                                        rope_cos=_t(c), rope_sin=_t(s))
        assert_close(y, y_ref)
        assert_close(tcache["k"], cache["k"])
        assert_close(tcache["v"], cache["v"])


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_decode_attention(groups, qk_norm):
    _decode_case(groups, qk_norm, None, 12, [3, 4, 11])


@pytest.mark.parametrize("groups", [1, 4])
def test_decode_attention_window_ring(groups):
    # a ring of 6 slots: positions before the wrap, at it, and after it
    _decode_case(groups, False, 6, 6, [2, 5, 6, 7, 13])


def test_decode_attention_takes_a_tensor_position():
    jcfg = _attn_cfg(2, False)
    tcfg = TA.AttnConfig(**{**dataclasses.asdict(jcfg), "rope": False})
    rng = np.random.default_rng(9)
    tp = {k: _t(a) for k, a in _attn_params(jcfg, rng).items()}
    x = _t(_normal(rng, (2, 1, 32)))
    c1 = TA.init_kv_cache(tcfg, 2, 8, device="cpu")
    c2 = TA.init_kv_cache(tcfg, 2, 8, device="cpu")
    y1, _ = TA.decode_attention(tp, tcfg, x, c1, 3)
    y2, _ = TA.decode_attention(tp, tcfg, x, c2, torch.tensor(3, dtype=torch.int32))
    assert torch.equal(y1, y2) and torch.equal(c1["k"], c2["k"])
    with pytest.raises(ValueError, match="outside"):
        TA.decode_attention(tp, tcfg, x, c1, 8)


@pytest.mark.parametrize("S", [5, 8, 13, 21])
def test_ring_fill(S):
    rng = np.random.default_rng(10)
    k = _normal(rng, (2, S, 2, 4))
    ref = JD._ring_fill(jnp.asarray(k), 8)
    out = TD._ring_fill(_t(k), 8)
    assert torch.equal(out, _t(ref))
