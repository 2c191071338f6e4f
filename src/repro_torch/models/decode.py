"""Prefill + single-token decode for every model family.

Cache layouts (stacked over the layer dimension):
  dense/moe : {"k","v": [L, B, C, Hkv, Dh]}   C = min(max_len, window)
  rwkv6     : {"shift_tm": [L,B,1,D], "wkv": [L,B,H,Dh,Dh] float32,
               "shift_cm": [L,B,1,D]}
  hybrid    : {"super": {"rec1"/"rec2": {"conv": [Sb,B,3,R], "h": [Sb,B,R]
               float32}, "attn": ring {"k","v": [Sb,B,W,Hkv,Dh]}},
               "tail": {"conv": [Tl,B,3,R], "h": [Tl,B,R] float32}}
               W = local_window whatever max_len is; "tail" only when the
               depth is not a multiple of 3
  encdec    : {"k","v": [Ld,B,C,Hkv,Dh]} the decoder's self-attention,
               {"xk","xv": [Ld,B,T_enc,Hkv,Dh]} the cross-attention's k / v
               of the encoder output, made once by prefill

Sliding-window caches are ring buffers (slot = pos % window). ``prefill``
allocates the stacked cache once and fills layer by layer; ``decode_step``
writes each layer's new state into its slice of the same tensors, in
place, so nothing is concatenated or copied whole per step.

MoE routing keeps JAX's groups: prefill routes each sequence as a group,
decode the batch's B tokens as one group (capacity depends on the group).
A frontend's embeddings (``frontend_embeds``) come ahead of the prompt's
tokens in a decoder-only model, so its prefill returns the position after
both; the encoder-decoder family encodes them, and its position counts
the decoder's tokens alone.
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
    multi_head_attention,
)
from repro_torch.models.common import rms_norm, swiglu
from repro_torch.models.lm import (
    ModelConfig,
    _embed_inputs,
    _embed_tokens,
    _encode,
    _rope_tables,
    layer_params,
    stack_depth,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rglru import rglru_block
from repro_torch.models.rwkv6 import channel_mix, time_mix

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
# dense / moe
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, lp, ff_in, *, decode: bool):
    """The layer's FFN: SwiGLU, or the MoE with JAX's grouping (prefill one
    group a sequence, decode one group of the B tokens)."""
    if cfg.family != "moe":
        return swiglu(ff_in, lp["mlp"]["w_gate"], lp["mlp"]["w_up"], lp["mlp"]["w_down"])
    if decode:
        ff, _ = moe_ffn(lp["moe"], cfg.moe, ff_in.transpose(0, 1))
        return ff.transpose(0, 1)
    return moe_ffn(lp["moe"], cfg.moe, ff_in)[0]


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
        h = h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps), decode=False)
    return _last_logits(cfg, params, h[:, -1]), cache, S


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
        h = h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps), decode=True)
    return _last_logits(cfg, params, h[:, 0]), cache


def _last_logits(cfg: ModelConfig, params, h_last):
    """Logits [B, Vpad] of one position's hidden state [B, D]."""
    h_last = rms_norm(h_last, params["out_norm"], cfg.norm_eps)
    return torch.einsum("bd,dv->bv", h_last, params["unembed"])


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------
def _rwkv_layer(cfg: ModelConfig, lp, h, st, decode: bool):
    """One RWKV layer; ``st`` is the layer's cache slice (views), read as
    the previous state in decode and overwritten with the new state."""
    rc = cfg.rwkv_cfg()
    y, (sx_tm, wkv) = time_mix(
        lp["time_mix"], rc, rms_norm(h, lp["ln1"], cfg.norm_eps),
        shift_prev=st["shift_tm"] if decode else None,
        state=st["wkv"] if decode else None,
        chunk=None if decode else cfg.wkv_chunk,
    )
    h = h + y
    y, sx_cm = channel_mix(lp["channel_mix"], rc, rms_norm(h, lp["ln2"], cfg.norm_eps),
                           shift_prev=st["shift_cm"] if decode else None)
    st["shift_tm"].copy_(sx_tm)
    st["wkv"].copy_(wkv)
    st["shift_cm"].copy_(sx_cm)
    return h + y


def _rwkv_prefill(cfg: ModelConfig, params, batch, max_len: int):
    h = _embed_inputs(cfg, params, batch)
    cache = init_decode_cache(cfg, h.shape[0], max_len, dtype=h.dtype, device=h.device)
    for i in range(cfg.n_layers):
        h = _rwkv_layer(cfg, layer_params(params["layers"], i), h,
                        layer_params(cache, i), decode=False)
    return _last_logits(cfg, params, h[:, -1]), cache, h.shape[1]


def _rwkv_decode(cfg: ModelConfig, params, cache, pos, token):
    del pos  # constant-size state
    h = _embed_tokens(cfg, params, token[:, None])
    for i in range(cfg.n_layers):
        h = _rwkv_layer(cfg, layer_params(params["layers"], i), h, layer_params(cache, i),
                        decode=True)
    return _last_logits(cfg, params, h[:, 0]), cache


# ---------------------------------------------------------------------------
# hybrid (RecurrentGemma)
# ---------------------------------------------------------------------------
def _hybrid_mlp(cfg: ModelConfig, lp, h):
    ff_in = rms_norm(h, lp["ln2"], cfg.norm_eps)
    return h + swiglu(ff_in, lp["mlp"]["w_gate"], lp["mlp"]["w_up"], lp["mlp"]["w_down"])


def _hybrid_rec(cfg: ModelConfig, lp, h, st, decode: bool):
    """A recurrent block; ``st`` (views) holds conv / h, read in decode and
    overwritten with the new state."""
    x = rms_norm(h, lp["ln1"], cfg.norm_eps)
    y, (conv, hstate) = rglru_block(
        lp["temporal"], cfg.rglru_cfg(), x,
        conv_prev=st["conv"] if decode else None, h_prev=st["h"] if decode else None)
    st["conv"].copy_(conv)
    st["h"].copy_(hstate)
    return _hybrid_mlp(cfg, lp, h + y)


def _hybrid_prefill(cfg: ModelConfig, params, batch, max_len: int):
    h = _embed_inputs(cfg, params, batch)
    B, S, _ = h.shape
    cos, sin = _rope_tables(cfg, torch.arange(S, device=h.device))
    W = cfg.local_window
    cache = init_decode_cache(cfg, B, max_len, dtype=h.dtype, device=h.device)
    for i in range(stack_depth(params["superblocks"])):
        lp, st = layer_params(params["superblocks"], i), layer_params(cache["super"], i)
        h = _hybrid_rec(cfg, lp["rec1"], h, st["rec1"], decode=False)
        h = _hybrid_rec(cfg, lp["rec2"], h, st["rec2"], decode=False)
        a, kc, vc = _attn_prefill(
            lp["attn"]["temporal"], cfg.attn_cfg(window=W),
            rms_norm(h, lp["attn"]["ln1"], cfg.norm_eps), cos, sin, W, cfg.attn_kv_chunk,
        )
        st["attn"]["k"].copy_(kc)
        st["attn"]["v"].copy_(vc)
        h = _hybrid_mlp(cfg, lp["attn"], h + a)
    for i in range(stack_depth(params.get("tail"))):
        h = _hybrid_rec(cfg, layer_params(params["tail"], i), h,
                        layer_params(cache["tail"], i), decode=False)
    return _last_logits(cfg, params, h[:, -1]), cache, S


def _hybrid_decode(cfg: ModelConfig, params, cache, pos, token):
    h = _embed_tokens(cfg, params, token[:, None])
    pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
    cos, sin = _rope_tables(cfg, pos[None])
    for i in range(stack_depth(params["superblocks"])):
        lp, st = layer_params(params["superblocks"], i), layer_params(cache["super"], i)
        h = _hybrid_rec(cfg, lp["rec1"], h, st["rec1"], decode=True)
        h = _hybrid_rec(cfg, lp["rec2"], h, st["rec2"], decode=True)
        a, _ = decode_attention(
            lp["attn"]["temporal"], cfg.attn_cfg(window=cfg.local_window),
            rms_norm(h, lp["attn"]["ln1"], cfg.norm_eps), st["attn"], pos,
            rope_cos=cos, rope_sin=sin,
        )
        h = _hybrid_mlp(cfg, lp["attn"], h + a)
    for i in range(stack_depth(params.get("tail"))):
        h = _hybrid_rec(cfg, layer_params(params["tail"], i), h,
                        layer_params(cache["tail"], i), decode=True)
    return _last_logits(cfg, params, h[:, 0]), cache


# ---------------------------------------------------------------------------
# encdec (seamless)
# ---------------------------------------------------------------------------
def _encdec_prefill(cfg: ModelConfig, params, batch, max_len: int):
    enc_h = _encode(cfg, params, batch["frontend_embeds"])
    h = _embed_tokens(cfg, params, batch["tokens"])
    B, S, _ = h.shape
    cos, sin = _rope_tables(cfg, torch.arange(S, device=h.device))
    C = _cache_len(cfg, max_len)
    cache = init_decode_cache(cfg, B, max_len, enc_len=enc_h.shape[1], dtype=h.dtype,
                              device=h.device)
    for i in range(stack_depth(params["dec_layers"])):
        lp = layer_params(params["dec_layers"], i)
        a, kc, vc = _attn_prefill(
            lp["self_attn"], cfg.attn_cfg(), rms_norm(h, lp["ln1"], cfg.norm_eps),
            cos, sin, C, cfg.attn_kv_chunk,
        )
        cache["k"][i] = kc
        cache["v"][i] = vc
        h = h + a
        # cross-attention, and the encoder projections it reads kept for decode
        cache["xk"][i] = torch.einsum("btd,dhk->bthk", enc_h, lp["cross_attn"]["wk"])
        cache["xv"][i] = torch.einsum("btd,dhk->bthk", enc_h, lp["cross_attn"]["wv"])
        h = h + multi_head_attention(
            lp["cross_attn"], cfg.attn_cfg(causal=False), rms_norm(h, lp["ln2"], cfg.norm_eps),
            kv_source=enc_h, kv_chunk=cfg.attn_kv_chunk,
        )
        h = h + swiglu(rms_norm(h, lp["ln3"], cfg.norm_eps), lp["mlp"]["w_gate"],
                       lp["mlp"]["w_up"], lp["mlp"]["w_down"])
    return _last_logits(cfg, params, h[:, -1]), cache, S


def _encdec_decode(cfg: ModelConfig, params, cache, pos, token):
    h = _embed_tokens(cfg, params, token[:, None])
    check_position(pos, cfg.window, cache["k"].shape[2])
    pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
    cos, sin = _rope_tables(cfg, pos[None])
    acfg = cfg.attn_cfg(causal=False)
    for i in range(stack_depth(params["dec_layers"])):
        lp = layer_params(params["dec_layers"], i)
        kv = {"k": cache["k"][i], "v": cache["v"][i]}  # views: written in place
        a, _ = decode_attention(
            lp["self_attn"], cfg.attn_cfg(), rms_norm(h, lp["ln1"], cfg.norm_eps),
            kv, pos, rope_cos=cos, rope_sin=sin,
        )
        h = h + a
        # cross-attention against the encoder projections prefill cached
        q = torch.einsum("bsd,dhk->bshk", rms_norm(h, lp["ln2"], cfg.norm_eps),
                         lp["cross_attn"]["wq"])
        kk = _expand_kv(cache["xk"][i], acfg.n_heads)
        vv = _expand_kv(cache["xv"][i], acfg.n_heads)
        logits = torch.einsum("bshk,bthk->bhst", q, kk) * (acfg.head_dim ** -0.5)
        probs = torch.softmax(logits.float(), dim=-1).to(h.dtype)
        c = torch.einsum("bhst,bthk->bshk", probs, vv)
        h = h + torch.einsum("bshk,hkd->bsd", c, lp["cross_attn"]["wo"])
        h = h + swiglu(rms_norm(h, lp["ln3"], cfg.norm_eps), lp["mlp"]["w_gate"],
                       lp["mlp"]["w_up"], lp["mlp"]["w_down"])
    return _last_logits(cfg, params, h[:, 0]), cache


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
_PREFILL = {
    "dense": _dense_prefill,
    "moe": _dense_prefill,
    "rwkv6": _rwkv_prefill,
    "hybrid": _hybrid_prefill,
    "encdec": _encdec_prefill,
}
_DECODE = {
    "dense": _dense_decode,
    "moe": _dense_decode,
    "rwkv6": _rwkv_decode,
    "hybrid": _hybrid_decode,
    "encdec": _encdec_decode,
}


def prefill(cfg: ModelConfig, params, batch, *, max_len: int):
    """Process the full prompt; returns (last-token logits, cache, pos)."""
    return _PREFILL[cfg.family](cfg, params, batch, max_len)


def decode_step(cfg: ModelConfig, params, cache, pos, token):
    """One token for the whole batch; returns (logits [B,Vpad], cache), the
    cache updated in place."""
    return _DECODE[cfg.family](cfg, params, cache, pos, token)


def init_decode_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 0,
    dtype: torch.dtype = torch.float32, device=None,
) -> Pytree:
    """Zero-initialized cache with the right (stacked) structure; the
    recurrent states (``wkv``, ``h``) are float32 whatever ``dtype`` is.
    ``enc_len`` sizes the encoder-decoder family's cross caches (the
    encoder's frame count)."""
    dev = resolve_device(device)
    B, Hkv, Dh = batch, cfg.n_kv_heads, cfg.hd

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family in ("dense", "moe"):
        shape = (cfg.n_layers, B, _cache_len(cfg, max_len), Hkv, Dh)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    if cfg.family == "rwkv6":
        L, H, D = cfg.n_layers, cfg.n_heads, cfg.d_model
        return {"shift_tm": zeros(L, B, 1, D), "wkv": zeros(L, B, H, D // H, D // H,
                                                             dt=torch.float32),
                "shift_cm": zeros(L, B, 1, D)}
    if cfg.family == "encdec":
        Ld = cfg.n_dec_layers or cfg.n_layers
        self_kv, cross_kv = (Ld, B, _cache_len(cfg, max_len), Hkv, Dh), (Ld, B, enc_len, Hkv, Dh)
        return {"k": zeros(*self_kv), "v": zeros(*self_kv),
                "xk": zeros(*cross_kv), "xv": zeros(*cross_kv)}
    if cfg.family != "hybrid":
        raise ValueError(cfg.family)
    n_super, n_tail = divmod(cfg.n_layers, 3)
    R, W = cfg.d_rnn or cfg.d_model, cfg.local_window

    def rec(n):
        return {"conv": zeros(n, B, 3, R), "h": zeros(n, B, R, dt=torch.float32)}

    cache = {"super": {"rec1": rec(n_super), "rec2": rec(n_super),
                       "attn": {"k": zeros(n_super, B, W, Hkv, Dh),
                                "v": zeros(n_super, B, W, Hkv, Dh)}}}
    if n_tail:
        cache["tail"] = rec(n_tail)
    return cache
