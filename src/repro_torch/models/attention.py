"""Attention: GQA / MHA, sliding window, qk-norm, and the KV-cache decode
path.

Layout conventions: activations [B, S, D]; per-head tensors [B, S, H, Dh];
caches [B, S_max, Hkv, Dh]. The same online softmax as the JAX package,
written in torch ops: no library attention.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ParamSpec, apply_rope, rms_norm

# a large finite negative, not -inf: a causal row whose first KV chunk is
# all masked takes exp(m - m_new) = exp(0) there and stays finite
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    window: Optional[int] = None  # sliding-window size (None = full)
    causal: bool = True
    rope: bool = True
    rope_theta: float = 10000.0


def attn_param_specs(cfg: AttnConfig):
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((D, H, Dh), ("fsdp", "tp", None)),
        "wk": ParamSpec((D, Hkv, Dh), ("fsdp", "tp", None)),
        "wv": ParamSpec((D, Hkv, Dh), ("fsdp", "tp", None)),
        "wo": ParamSpec((H, Dh, D), ("tp", None, "fsdp")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((Dh,), (None,), init="ones")
        specs["k_norm"] = ParamSpec((Dh,), (None,), init="ones")
    return specs


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, Hkv, Dh] -> [B, S, H, Dh]: head h reads KV head h // G."""
    hkv = k.shape[-2]
    if hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hkv, dim=-2)


def _causal_window_mask(
    q_len: int, kv_len: int, window: Optional[int], causal: bool, q_offset: int = 0,
    device=None,
) -> torch.Tensor:
    """bool[q_len, kv_len]: True = attendable."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _chunk_scores(q32, kb, m, mask):
    """The step's probabilities: (m_new, correction, p) of one KV chunk."""
    logits = torch.einsum("bshk,bthk->bhst", q32, kb)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    return m_new, correction, p


class _ChunkStep(torch.autograd.Function):
    """One KV chunk of the online softmax, ``(m, l, acc) -> (m_new, l_new,
    acc_new)``, saving only its inputs: the backward recomputes the chunk's
    probabilities, as the JAX package's ``jax.checkpoint(step,
    nothing_saveable)``, so a training step keeps no [B, H, S, C]
    probabilities per chunk. As there, the recompute is the logits product
    alone: the backward of ``acc_new = acc * correction + p @ vb`` needs p
    and vb, not the product."""

    @staticmethod
    def forward(ctx, q32, kb, vb, m, l, acc, mask):
        m_new, correction, p = _chunk_scores(q32, kb, m, mask)
        l_new = l * correction + p.sum(dim=-1)
        acc_new = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
            "bhst,bthk->bshk", p, vb
        )
        ctx.save_for_backward(q32, kb, vb, m, l, acc, mask)
        return m_new, l_new, acc_new

    @staticmethod
    def backward(ctx, g_m, g_l, g_acc):
        q32, kb, vb, m, l, acc, mask = ctx.saved_tensors
        with torch.enable_grad():
            q_, kb_, m_, l_, acc_ = (t.detach().requires_grad_()
                                     for t in (q32, kb, m, l, acc))
            m_new, correction, p = _chunk_scores(q_, kb_, m_, mask)
            l_new = l_ * correction + p.sum(dim=-1)
            acc_kept = acc_ * correction.transpose(1, 2)[..., None]
        g_p = torch.einsum("bshk,bthk->bhst", g_acc, vb)
        g_vb = torch.einsum("bhst,bshk->bthk", p.detach(), g_acc)
        g_q, g_kb, g_m0, g_l0, g_acc0 = torch.autograd.grad(
            (m_new, l_new, acc_kept, p), (q_, kb_, m_, l_, acc_), (g_m, g_l, g_acc, g_p))
        return g_q, g_kb, g_vb, g_m0, g_l0, g_acc0, None


def _chunked_attention(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, T, H, Dh]
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    kv_chunk: int,
) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with the running max and
    sum in f32, memory O(B*H*S*kv_chunk) instead of O(B*H*S*T). Each chunk
    is one ``_ChunkStep``, whose backward recomputes the chunk's
    probabilities (the JAX package's remat of the chunk step)."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    assert T % kv_chunk == 0, "pad kv length to a multiple of kv_chunk"
    n_chunks = T // kv_chunk
    scale = Dh ** -0.5
    q32 = (q * scale).float()
    q_pos = torch.arange(S, device=q.device)[:, None]

    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, Dh), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        kb = k[:, idx * kv_chunk:(idx + 1) * kv_chunk].float()
        vb = v[:, idx * kv_chunk:(idx + 1) * kv_chunk].float()
        k_pos = idx * kv_chunk + torch.arange(kv_chunk, device=q.device)[None, :]
        mask = torch.ones((S, kv_chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        m, l, acc = _ChunkStep.apply(q32, kb, vb, m, l, acc, mask)
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def multi_head_attention(
    params,
    cfg: AttnConfig,
    x: torch.Tensor,
    *,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    kv_source: Optional[torch.Tensor] = None,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Full-sequence attention (prefill), flash-style chunked.
    ``kv_source`` switches to cross-attention (encoder outputs)."""
    src = x if kv_source is None else kv_source
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", src, params["wk"])
    v = torch.einsum("btd,dhk->bthk", src, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.rope and kv_source is None:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    k = _expand_kv(k, cfg.n_heads)
    v = _expand_kv(v, cfg.n_heads)
    causal = cfg.causal and kv_source is None
    window = cfg.window if kv_source is None else None
    chunk = min(kv_chunk, src.shape[1])
    out = _chunked_attention(q, k, v, causal=causal, window=window, kv_chunk=chunk)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
def check_position(pos, window: Optional[int], cache_len: int) -> None:
    """A host-side position must fit a cache that is not a ring (a device
    tensor is taken as it is: reading it would wait for the card)."""
    if not torch.is_tensor(pos) and window is None and not 0 <= pos < cache_len:
        raise ValueError(f"position {pos} outside a cache of length {cache_len}")


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32, device=None):
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_attention(
    params,
    cfg: AttnConfig,
    x: torch.Tensor,  # [B, 1, D]
    cache,  # {"k","v": [B, S_max, Hkv, Dh]}
    pos,  # int or 0-d integer tensor: the current position
    *,
    rope_cos: Optional[torch.Tensor] = None,  # [1, Dh/2] at pos
    rope_sin: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """One-token decode with cache update. For sliding-window configs the
    cache is a ring buffer of size window (cache length == window).

    The new token's k / v are written into ``cache`` in place (slot
    ``pos``, or ``pos % S_max`` in a ring), and ``cache`` is returned."""
    B = x.shape[0]
    S_max = cache["k"].shape[1]
    check_position(pos, cfg.window, S_max)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.rope:
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    slot = (pos % S_max if cfg.window is not None else pos).reshape(1)
    ck = cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    # Grouped GQA: q reshaped to [B,1,Hkv,G,Dh] contracts against the cache
    # directly; query head h = kv * G + g reads KV head h // G, the order
    # of ``_expand_kv``.
    Hkv = cfg.n_kv_heads
    G = cfg.n_heads // Hkv
    qg = q.reshape(B, 1, Hkv, G, cfg.head_dim)
    scale = cfg.head_dim ** -0.5
    logits = torch.einsum("bshgk,bthk->bhgst", qg, ck) * scale  # [B,Hkv,G,1,S]
    t_pos = torch.arange(S_max, device=x.device)
    if cfg.window is not None:
        # ring buffer of size == window: before wrap-around only slots
        # <= pos hold tokens; after wrap-around every slot is live.
        valid = (t_pos <= pos) | (pos >= S_max)
    else:
        valid = t_pos <= pos
    logits = torch.where(valid[None, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhgst,bthk->bshgk", probs, cv)
    y = torch.einsum(
        "bshk,hkd->bsd", out.reshape(B, 1, cfg.n_heads, cfg.head_dim), params["wo"]
    )
    return y, cache
