"""Input construction for the LM stack: the token batches of the JAX
package's ``launch/inputs.py``, drawn from the same
``np.random.default_rng(seed)`` stream, so one seed gives the port and
the JAX package identical tokens.

Frontend stubs: [audio] gets precomputed frame embeddings (T_frames =
seq_len / 4), [vlm] gets anyres patch embeddings (2880 patches) that
occupy the first positions of the sequence; text tokens fill the rest.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import ModelConfig

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
