"""Input construction for every (arch × shape) cell, as in the JAX
package's ``launch/inputs.py``: as shapes and ``meta`` tensors (the dry
run; no allocation) and as real tensors (tests, examples, serving). The
token batches are drawn from the same ``np.random.default_rng(seed)``
stream as the JAX package's, so one seed gives both identical tokens.

Frontend stubs: [audio] gets precomputed frame embeddings (T_frames =
seq_len / 4), [vlm] gets anyres patch embeddings (2880 patches) that
occupy the first positions of the sequence; text tokens fill the rest.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.decode import init_decode_cache
from repro_torch.models.lm import ModelConfig

Pytree = Any

VLM_PATCHES = 2880  # anyres: 4 tiles + base thumbnail, 576 each
AUDIO_SUBSAMPLE = 4


def token_split(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(frontend positions, text positions) summing to seq_len."""
    if cfg.frontend == "vision":
        p = min(VLM_PATCHES, seq_len // 2)
        return p, seq_len - p
    if cfg.family == "encdec":
        return seq_len // AUDIO_SUBSAMPLE, seq_len
    return 0, seq_len


def train_batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """{name: (shape, numpy dtype)} of a train batch, the JAX package's
    (int32 tokens; the port's own batches carry int64)."""
    B, S = shape.global_batch, shape.seq_len
    p, t = token_split(cfg, S)
    out = {"tokens": ((B, t), np.int32), "labels": ((B, t), np.int32)}
    if p:
        out["frontend_embeds"] = ((B, p, cfg.d_model), np.float32)
    return out


def make_train_batch(
    cfg: ModelConfig, *, batch: int, seq_len: int, seed: int = 0, device=None
) -> Dict[str, torch.Tensor]:
    """``tokens`` and ``labels`` int64 [batch, text positions] (and
    ``frontend_embeds`` f32 where the config has a frontend), on the card
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    p, t = token_split(cfg, seq_len)
    out = {
        "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, t)),
                                  dtype=torch.int64).to(dev),
        "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, t)),
                                  dtype=torch.int64).to(dev),
    }
    if p:
        out["frontend_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, p, cfg.d_model)), dtype=torch.float32).to(dev)
    return out


def decode_state_shapes(cfg: ModelConfig, shape: ShapeConfig):
    """(the cache as bfloat16 ``meta`` tensors, token/pos shapes) for decode
    cells: shapes and dtypes with no memory, as JAX's ``eval_shape`` gives
    them. The dtype is passed, as JAX's default is bfloat16 and the
    port's float32."""
    B, S = shape.global_batch, shape.seq_len
    enc_len = S // AUDIO_SUBSAMPLE if cfg.family == "encdec" else 0
    cache = init_decode_cache(cfg, B, S, enc_len=enc_len, dtype=torch.bfloat16,
                              device="meta")
    return cache, ((B,), np.int32)


# ---------------------------------------------------------------------------
# logical shardings for inputs/caches
# ---------------------------------------------------------------------------
def batch_logical(cfg: ModelConfig, shape_kind: str) -> Dict[str, tuple]:
    out = {
        "tokens": ("batch", None),
        "labels": ("batch", None),
    }
    if cfg.frontend == "vision" or cfg.family == "encdec":
        out["frontend_embeds"] = ("batch", None, None)
    return out


def cache_logical(cfg: ModelConfig) -> Pytree:
    """Logical axes for every cache leaf (structure mirrors
    init_decode_cache). KV caches shard on the SEQUENCE dim, as in the JAX
    package: attention contracts over Dh and softmaxes over S, and with S
    sharded both einsums stay local."""
    kv = (None, "batch", "tp", None, None)  # shard the sequence/slots dim

    if cfg.family in ("dense", "moe"):
        return {"k": kv, "v": kv}
    if cfg.family == "rwkv6":
        return {
            "shift_tm": (None, "batch", None, "tp"),
            "wkv": (None, "batch", "tp", None, None),
            "shift_cm": (None, "batch", None, "tp"),
        }
    if cfg.family == "hybrid":
        rec = {"conv": (None, "batch", None, "tp"), "h": (None, "batch", "tp")}
        out = {
            "super": {
                "rec1": dict(rec),
                "rec2": dict(rec),
                "attn": {"k": kv, "v": kv},
            }
        }
        if cfg.n_layers % 3:
            out["tail"] = dict(rec)
        return out
    if cfg.family == "encdec":
        return {"k": kv, "v": kv, "xk": kv, "xv": kv}
    raise ValueError(cfg.family)


def resolve_kv_logical(mesh, logical, shape):
    """Special-case 'tp2': place 'model' on the kv-head dim when divisible,
    otherwise on head_dim ('tp2' slot)."""
    from repro_torch.distributed.meshes import resolve_spec

    if "tp2" not in logical:
        return resolve_spec(mesh, logical, shape)
    heads_dim = logical.index("tp")
    hd_dim = logical.index("tp2")
    model_size = mesh.shape.get("model", 1)
    use_heads = shape[heads_dim] % model_size == 0
    fixed = tuple(
        (
            "tp"
            if (i == heads_dim and use_heads) or (i == hd_dim and not use_heads)
            else (None if i in (heads_dim, hd_dim) else ax)
        )
        for i, ax in enumerate(logical)
    )
    return resolve_spec(mesh, fixed, shape)
