"""Prefill + single-token decode, the dense family.

Cache layout (stacked over the layer dimension):
  dense : {"k","v": [L, B, C, Hkv, Dh]}   C = min(max_len, window)

Sliding-window caches are ring buffers (slot = pos % window). ``prefill``
allocates the stacked cache once and fills layer by layer; ``decode_step``
writes each layer's new k / v into its slice of the same tensors, in
place, so nothing is concatenated or copied whole per step.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    AttnConfig,
    _chunked_attention,
    _expand_kv,
    apply_rope,
    check_position,
    decode_attention,
)
from repro_torch.models.common import rms_norm, swiglu
from repro_torch.models.lm import (
    ModelConfig,
    _embed_inputs,
    _embed_tokens,
    _rope_tables,
    check_ported,
    layer_params,
)

Pytree = Any


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _ring_fill(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Place the last ``cache_len`` tokens of k [B,S,...] into ring slots
    (slot = absolute_pos % cache_len)."""
    S = k.shape[1]
    out = k.new_zeros((k.shape[0], cache_len, *k.shape[2:]))
    if S <= cache_len:
        out[:, :S] = k
        return out
    slots = torch.arange(S - cache_len, S, device=k.device) % cache_len
    out[:, slots] = k[:, -cache_len:]
    return out


def _attn_prefill(params, acfg: AttnConfig, x, cos, sin, cache_len: int, kv_chunk: int):
    """Attention over the full prompt; returns (out, k_cache, v_cache)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if acfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if acfg.rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    ke = _expand_kv(k, acfg.n_heads)
    ve = _expand_kv(v, acfg.n_heads)
    out = _chunked_attention(
        q, ke, ve, causal=acfg.causal, window=acfg.window,
        kv_chunk=min(kv_chunk, x.shape[1]),
    )
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, _ring_fill(k, cache_len), _ring_fill(v, cache_len)


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------
def _dense_prefill(cfg: ModelConfig, params, batch, max_len: int):
    h = _embed_inputs(cfg, params, batch)
    B, S, _ = h.shape
    cos, sin = _rope_tables(cfg, torch.arange(S, device=h.device))
    C = _cache_len(cfg, max_len)
    cache = init_decode_cache(cfg, B, max_len, dtype=h.dtype, device=h.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        a, kc, vc = _attn_prefill(
            lp["attn"], cfg.attn_cfg(), rms_norm(h, lp["ln1"], cfg.norm_eps),
            cos, sin, C, cfg.attn_kv_chunk,
        )
        cache["k"][i] = kc
        cache["v"][i] = vc
        h = h + a
        ff_in = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + swiglu(ff_in, lp["mlp"]["w_gate"], lp["mlp"]["w_up"], lp["mlp"]["w_down"])
    h = rms_norm(h, params["out_norm"], cfg.norm_eps)
    logits = torch.einsum("bd,dv->bv", h[:, -1], params["unembed"])
    return logits, cache, S


def _dense_decode(cfg: ModelConfig, params, cache, pos, token):
    h = _embed_tokens(cfg, params, token[:, None])  # [B,1,D]
    check_position(pos, cfg.window, cache["k"].shape[2])
    pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
    cos, sin = _rope_tables(cfg, pos[None])
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        kv = {"k": cache["k"][i], "v": cache["v"][i]}  # views: written in place
        a, _ = decode_attention(
            lp["attn"], cfg.attn_cfg(), rms_norm(h, lp["ln1"], cfg.norm_eps),
            kv, pos, rope_cos=cos, rope_sin=sin,
        )
        h = h + a
        ff_in = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + swiglu(ff_in, lp["mlp"]["w_gate"], lp["mlp"]["w_up"], lp["mlp"]["w_down"])
    h = rms_norm(h, params["out_norm"], cfg.norm_eps)
    logits = torch.einsum("bd,dv->bv", h[:, 0], params["unembed"])
    return logits, cache


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def prefill(cfg: ModelConfig, params, batch, *, max_len: int):
    """Process the full prompt; returns (last-token logits, cache, pos)."""
    check_ported(cfg)
    return _dense_prefill(cfg, params, batch, max_len)


def decode_step(cfg: ModelConfig, params, cache, pos, token):
    """One token for the whole batch; returns (logits [B,Vpad], cache), the
    cache updated in place."""
    check_ported(cfg)
    return _dense_decode(cfg, params, cache, pos, token)


def init_decode_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 0,
    dtype: torch.dtype = torch.float32, device=None,
) -> Pytree:
    """Zero-initialized cache with the right (stacked) structure; ``enc_len``
    sizes the encoder-decoder family's cross caches, which come with its
    slice."""
    check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, _cache_len(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
