"""The composable LM: one ModelConfig covers the ten architectures of the
JAX package, and the port runs all five families.

Families:
  dense   — decoder-only transformer, GQA (+ optional SWA window, qk-norm)
  moe     — dense attention + MoE FFN (mixtral, deepseek-moe)
  rwkv6   — attention-free time-mix/channel-mix stack
  hybrid  — RecurrentGemma: (rec, rec, local-attn) superblocks + MLP
  encdec  — seamless: bidirectional encoder + causal decoder w/ cross-attn

``ModelConfig`` carries every field of every family, so a config compares
field for field with the JAX package's. The modality frontends
([audio]/[vlm]) are stubs, as in the JAX package: the batch carries
precomputed frame / patch embeddings (``frontend_embeds``), projected by
``frontend_proj``; a decoder-only model prepends them to the token
embeddings, the encoder-decoder family encodes them. Layers are stacked
on a leading dimension, as in the JAX package (the hybrid's in
``superblocks`` of (rec, rec, local-attn) and a recurrent ``tail``; the
encoder-decoder's in ``enc_layers`` and ``dec_layers``), and a Python
loop over layers takes the place of ``lax.scan``. The JAX package's
``sharding_ctx.constrain`` calls are left out: the port's
``distributed.sharding_ctx.constrain`` returns its input unchanged, as one
process has no layout to constrain.

``forward(train=True)`` is the training forward: with ``cfg.remat`` each
layer (the hybrid's superblock, each tail, encoder and decoder layer) runs
under ``torch.utils.checkpoint``, which keeps only the layer's input and
recomputes the rest in the backward pass, as the JAX package's
``jax.checkpoint(policy=nothing_saveable)``. Its logits are those of
``forward(train=False)`` bit for bit. ``loss_fn`` scores them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import AttnConfig, attn_param_specs, multi_head_attention
from repro_torch.models.common import (
    ParamSpec,
    cross_entropy_loss,
    rms_norm,
    swiglu,
    tree_leaves,
    tree_map,
)
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_param_specs
from repro_torch.models.rglru import RGLRUConfig, rglru_block, rglru_param_specs
from repro_torch.models.rwkv6 import RWKVConfig, channel_mix, rwkv_param_specs, time_mix

Pytree = Any

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv6 | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    window: Optional[int] = None  # sliding-window attention (mixtral)
    local_window: Optional[int] = None  # hybrid local attention window
    moe: Optional[MoEConfig] = None
    n_dec_layers: Optional[int] = None  # encdec decoder depth
    frontend: Optional[str] = None  # None | "audio" | "vision" (stub)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    remat: bool = True
    vocab_pad_to: int = 2048
    d_rnn: Optional[int] = None  # hybrid recurrent width
    attn_kv_chunk: int = 1024
    wkv_chunk: Optional[int] = None  # chunked-WKV block (rwkv6)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """Can this config decode at 500k context? (constant/windowed state)"""
        if self.family in ("rwkv6", "hybrid"):
            return True
        return self.window is not None

    def attn_cfg(self, *, causal=True, window=None) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.hd,
            qk_norm=self.qk_norm,
            window=window if window is not None else self.window,
            causal=causal,
            rope_theta=self.rope_theta,
        )

    def rwkv_cfg(self) -> RWKVConfig:
        return RWKVConfig(d_model=self.d_model, n_heads=self.n_heads, d_ff=self.d_ff)

    def rglru_cfg(self) -> RGLRUConfig:
        return RGLRUConfig(d_model=self.d_model, d_rnn=self.d_rnn or self.d_model)

    def param_count(self, params: Pytree) -> int:
        """Elements over a tree of tensors or ParamSpecs (anything with a
        ``shape``)."""
        return sum(math.prod(p.shape) for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
def _mlp_specs(cfg: ModelConfig):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((D, F), ("fsdp", "tp")),
        "w_up": ParamSpec((D, F), ("fsdp", "tp")),
        "w_down": ParamSpec((F, D), ("tp", "fsdp")),
    }


def _norm(cfg: ModelConfig):
    return ParamSpec((cfg.d_model,), (None,), init="ones")


def _dense_layer_specs(cfg: ModelConfig):
    return {
        "attn": attn_param_specs(cfg.attn_cfg()),
        "mlp": _mlp_specs(cfg),
        "ln1": _norm(cfg),
        "ln2": _norm(cfg),
    }


def _moe_layer_specs(cfg: ModelConfig):
    return {
        "attn": attn_param_specs(cfg.attn_cfg()),
        "moe": moe_param_specs(cfg.moe),
        "ln1": _norm(cfg),
        "ln2": _norm(cfg),
    }


def _rwkv_layer_specs(cfg: ModelConfig):
    specs = rwkv_param_specs(cfg.rwkv_cfg())
    specs["ln1"] = _norm(cfg)
    specs["ln2"] = _norm(cfg)
    return specs


def _hybrid_superblock_specs(cfg: ModelConfig):
    """One (rec, rec, local-attn) superblock, each with its own MLP."""
    local = cfg.attn_cfg(window=cfg.local_window)

    def blk(temporal):
        return {"temporal": temporal, "mlp": _mlp_specs(cfg), "ln1": _norm(cfg),
                "ln2": _norm(cfg)}

    return {
        "rec1": blk(rglru_param_specs(cfg.rglru_cfg())),
        "rec2": blk(rglru_param_specs(cfg.rglru_cfg())),
        "attn": blk(attn_param_specs(local)),
    }


def _stack(specs: Pytree, n: int) -> Pytree:
    """Prepend a stacked layer dimension to every ParamSpec."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), (None, *s.logical), s.init, s.scale), specs
    )


def param_specs(cfg: ModelConfig) -> Pytree:
    V, D = cfg.padded_vocab, cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((V, D), ("tp", "fsdp"), init="embed", scale=1.0),
        "unembed": ParamSpec((D, V), ("fsdp", "tp")),
        "out_norm": _norm(cfg),
    }
    if cfg.family == "dense":
        specs["layers"] = _stack(_dense_layer_specs(cfg), cfg.n_layers)
    elif cfg.family == "moe":
        specs["layers"] = _stack(_moe_layer_specs(cfg), cfg.n_layers)
    elif cfg.family == "rwkv6":
        specs["layers"] = _stack(_rwkv_layer_specs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        n_super, n_tail = divmod(cfg.n_layers, 3)
        specs["superblocks"] = _stack(_hybrid_superblock_specs(cfg), n_super)
        if n_tail:
            # tail layers are recurrent blocks (Griffin starts each triple
            # with recurrence; 26 = 8*3 + 2 leaves two rec blocks)
            specs["tail"] = _stack(_hybrid_superblock_specs(cfg)["rec1"], n_tail)
    elif cfg.family == "encdec":
        enc_layer = {
            "attn": attn_param_specs(cfg.attn_cfg(causal=False)),
            "mlp": _mlp_specs(cfg),
            "ln1": _norm(cfg),
            "ln2": _norm(cfg),
        }
        dec_layer = {
            "self_attn": attn_param_specs(cfg.attn_cfg()),
            "cross_attn": attn_param_specs(cfg.attn_cfg(causal=False)),
            "mlp": _mlp_specs(cfg),
            "ln1": _norm(cfg),
            "ln2": _norm(cfg),
            "ln3": _norm(cfg),
        }
        specs["enc_layers"] = _stack(enc_layer, cfg.n_layers)
        specs["dec_layers"] = _stack(dec_layer, cfg.n_dec_layers or cfg.n_layers)
        specs["enc_norm"] = _norm(cfg)
    else:
        raise ValueError(f"unknown family {cfg.family}")
    if cfg.frontend:
        # stub projection for precomputed frame/patch embeddings
        specs["frontend_proj"] = ParamSpec((D, D), ("fsdp", "tp"))
    return specs


def layer_params(params: Pytree, i: int) -> Pytree:
    """Layer ``i``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], params)


def stack_depth(stacked: Optional[Pytree]) -> int:
    """The leading (layer) dimension of a stacked tree; 0 for ``None``."""
    return 0 if stacked is None else tree_leaves(stacked)[0].shape[0]


# ---------------------------------------------------------------------------
# forward pass (prefill)
# ---------------------------------------------------------------------------
def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    half = cfg.hd // 2
    inv = 1.0 / (
        cfg.rope_theta
        ** (torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    )
    freqs = positions.float()[:, None] * inv[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def _dense_block(cfg: ModelConfig, params, h, cos, sin):
    """A dense or MoE layer: (h, its aux loss)."""
    a = multi_head_attention(
        params["attn"],
        cfg.attn_cfg(),
        rms_norm(h, params["ln1"], cfg.norm_eps),
        rope_cos=cos,
        rope_sin=sin,
        kv_chunk=cfg.attn_kv_chunk,
    )
    h = h + a
    ff_in = rms_norm(h, params["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        ff, aux = moe_ffn(params["moe"], cfg.moe, ff_in)
    else:
        ff = swiglu(ff_in, params["mlp"]["w_gate"], params["mlp"]["w_up"],
                    params["mlp"]["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ff, aux


def _rwkv_block(cfg: ModelConfig, params, h):
    y, _ = time_mix(params["time_mix"], cfg.rwkv_cfg(),
                    rms_norm(h, params["ln1"], cfg.norm_eps), chunk=cfg.wkv_chunk)
    h = h + y
    y, _ = channel_mix(params["channel_mix"], cfg.rwkv_cfg(),
                       rms_norm(h, params["ln2"], cfg.norm_eps))
    return h + y


def _hybrid_block(cfg: ModelConfig, params, h, cos, sin, kind: str):
    x = rms_norm(h, params["ln1"], cfg.norm_eps)
    if kind == "rec":
        y, _ = rglru_block(params["temporal"], cfg.rglru_cfg(), x)
    else:
        y = multi_head_attention(
            params["temporal"],
            cfg.attn_cfg(window=cfg.local_window),
            x,
            rope_cos=cos,
            rope_sin=sin,
            kv_chunk=cfg.attn_kv_chunk,
        )
    h = h + y
    ff_in = rms_norm(h, params["ln2"], cfg.norm_eps)
    ff = swiglu(ff_in, params["mlp"]["w_gate"], params["mlp"]["w_up"],
                params["mlp"]["w_down"])
    return h + ff


def _embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows times sqrt(d_model), in the activations' dtype."""
    h = params["embed"][tokens]
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype, device=h.device)


def _project_frontend(params, frontend_embeds: torch.Tensor) -> torch.Tensor:
    """Frame / patch embeddings [B, P, D] through ``frontend_proj``, in the
    parameters' dtype (not scaled by sqrt(d_model), unlike the tokens)."""
    return torch.einsum("bpd,de->bpe", frontend_embeds.to(params["embed"].dtype),
                        params["frontend_proj"])


def _embed_inputs(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Token embeddings, with frontend embeddings prepended when present."""
    h = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.frontend and "frontend_embeds" in batch:
        h = torch.cat([_project_frontend(params, batch["frontend_embeds"]), h], dim=1)
    return h


def _layers(stacked: Optional[Pytree], train: bool) -> list:
    """The per-layer trees of a stacked tree. Serving takes views
    (``layer_params``); the training forward unbinds every leaf once, so
    that autograd stacks the layers' gradients once a leaf, where a
    ``t[i]`` a layer would make a zero gradient of the whole stack each."""
    n = stack_depth(stacked)
    if not train or n == 0:
        return [layer_params(stacked, i) for i in range(n)]
    parts = tree_map(torch.unbind, stacked)
    return [tree_map(lambda t, i=i: t[i], parts) for i in range(n)]


def _maybe_remat(f, cfg: ModelConfig, train: bool):
    """``f`` under ``torch.utils.checkpoint`` when training with
    ``cfg.remat``: only its inputs are kept, the rest recomputed in the
    backward pass. The JAX package also puts ``_grad_safe_barrier`` (an
    ``optimization_barrier``) inside the rematted region, against an XLA
    rewrite that hoists a convert of the whole saved stack out of the
    backward loop; torch makes no such rewrite, so the port has none."""
    if train and cfg.remat:
        return lambda *args: checkpoint(f, *args, use_reentrant=False)
    return f


def forward(cfg: ModelConfig, params, batch, *, train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits [B,S,Vpad], aux_loss)."""
    if cfg.family == "encdec":
        return _forward_encdec(cfg, params, batch, train=train)
    h = _embed_inputs(cfg, params, batch)
    S = h.shape[1]
    cos, sin = _rope_tables(cfg, torch.arange(S, device=h.device))
    auxes = []
    if cfg.family in ("dense", "moe"):
        layer = _maybe_remat(lambda h, lp: _dense_block(cfg, lp, h, cos, sin), cfg, train)
        for lp in _layers(params["layers"], train):
            h, aux = layer(h, lp)
            auxes.append(aux)
    elif cfg.family == "rwkv6":
        layer = _maybe_remat(lambda h, lp: _rwkv_block(cfg, lp, h), cfg, train)
        for lp in _layers(params["layers"], train):
            h = layer(h, lp)
    elif cfg.family == "hybrid":
        def superblock(h, lp):
            h = _hybrid_block(cfg, lp["rec1"], h, cos, sin, "rec")
            h = _hybrid_block(cfg, lp["rec2"], h, cos, sin, "rec")
            return _hybrid_block(cfg, lp["attn"], h, cos, sin, "attn")

        superblock = _maybe_remat(superblock, cfg, train)
        for lp in _layers(params["superblocks"], train):
            h = superblock(h, lp)
        tail = _maybe_remat(lambda h, lp: _hybrid_block(cfg, lp, h, cos, sin, "rec"), cfg,
                            train)
        for lp in _layers(params.get("tail"), train):
            h = tail(h, lp)
    else:
        raise ValueError(cfg.family)
    aux_total = torch.stack(auxes).sum() if auxes else torch.zeros(
        (), dtype=torch.float32, device=h.device)
    return _all_logits(cfg, params, h), aux_total


def _all_logits(cfg: ModelConfig, params, h) -> torch.Tensor:
    h = rms_norm(h, params["out_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", h, params["unembed"])


def _encode(cfg: ModelConfig, params, frontend_embeds: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """The encoder-decoder family's encoder over the projected frames:
    bidirectional attention with RoPE over the frame positions, then
    ``enc_norm``; [B, T_enc, D]."""
    h = _project_frontend(params, frontend_embeds)
    cos, sin = _rope_tables(cfg, torch.arange(h.shape[1], device=h.device))
    acfg = cfg.attn_cfg(causal=False)

    def enc_layer(h, lp):
        h = h + multi_head_attention(lp["attn"], acfg, rms_norm(h, lp["ln1"], cfg.norm_eps),
                                     rope_cos=cos, rope_sin=sin, kv_chunk=cfg.attn_kv_chunk)
        return h + swiglu(rms_norm(h, lp["ln2"], cfg.norm_eps), lp["mlp"]["w_gate"],
                          lp["mlp"]["w_up"], lp["mlp"]["w_down"])

    enc_layer = _maybe_remat(enc_layer, cfg, train)
    for lp in _layers(params["enc_layers"], train):
        h = enc_layer(h, lp)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _forward_encdec(cfg: ModelConfig, params, batch, *, train: bool):
    enc_h = _encode(cfg, params, batch["frontend_embeds"], train)
    h = _embed_tokens(cfg, params, batch["tokens"])
    cos, sin = _rope_tables(cfg, torch.arange(h.shape[1], device=h.device))

    def dec_layer(h, lp, enc_h):
        h = h + multi_head_attention(lp["self_attn"], cfg.attn_cfg(),
                                     rms_norm(h, lp["ln1"], cfg.norm_eps), rope_cos=cos,
                                     rope_sin=sin, kv_chunk=cfg.attn_kv_chunk)
        h = h + multi_head_attention(lp["cross_attn"], cfg.attn_cfg(causal=False),
                                     rms_norm(h, lp["ln2"], cfg.norm_eps), kv_source=enc_h,
                                     kv_chunk=cfg.attn_kv_chunk)
        return h + swiglu(rms_norm(h, lp["ln3"], cfg.norm_eps), lp["mlp"]["w_gate"],
                          lp["mlp"]["w_up"], lp["mlp"]["w_down"])

    dec_layer = _maybe_remat(dec_layer, cfg, train)
    for lp in _layers(params["dec_layers"], train):
        h = dec_layer(h, lp, enc_h)
    return _all_logits(cfg, params, h), torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg: ModelConfig, params, batch, *, train: bool = True):
    """(ce + aux, {"ce", "aux"}): the mean token cross-entropy of the last
    ``labels.shape[1]`` positions (frontend positions carry no labels),
    the vocabulary's padding columns set to -1e30 first."""
    logits, aux = forward(cfg, params, batch, train=train)
    labels = batch["labels"]
    logits = logits[:, -labels.shape[1]:]
    V = cfg.vocab_size
    if cfg.padded_vocab != V:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= V
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)
    ce = cross_entropy_loss(logits, labels)
    return ce + aux, {"ce": ce, "aux": aux}
