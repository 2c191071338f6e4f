"""Roofline constants and the analytic counts of the dry run, as in the
JAX package's ``launch/roofline.py``, with the constants of one NVIDIA
H100 SXM in place of the TPU v5e's (the data sheet's peaks):

  compute    = FLOPs                / (chips * 989e12 FLOP/s bf16 dense)
  compute    = FLOPs (SpTRSV cells) / (chips * 67e12  FLOP/s fp32, no
               tensor cores: the SpTRSV cells are float32 and use none)
  memory     = bytes_accessed       / (chips * 3.35e12 B/s HBM3)
  collective = collective_bytes     / (chips * 450e9  B/s NVLink, each way)

The LM cells' FLOPs and bytes come from counting the port's own eager
program (``launch/op_analysis.py``). There is no HLO, so the JAX
package's ``collective_bytes_from_hlo`` has no counterpart and the LM
cells' collective bytes are ``None`` ("one process, no sharded program").
``essential_bytes`` and ``model_flops`` count bytes and operations, not
time, and are the JAX package's unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM per-chip constants (data sheet)
PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
FP32_FLOPS = 67e12  # fp32, CUDA cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way

NO_COLLECTIVES = "one process, no sharded program"


@dataclasses.dataclass
class RooflineTerms:
    """Per-cell totals over ``chips`` (evenly shared) and the three times;
    ``collective_bytes`` None leaves that term out of ``dominant``."""

    flops: float
    bytes_accessed: float
    collective_bytes: Optional[float]
    chips: int
    peak_flops: float = PEAK_FLOPS  # FP32_FLOPS for work outside the tensor cores

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> Optional[float]:
        if self.collective_bytes is None:
            return None
        return self.collective_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max((k for k, v in terms.items() if v is not None), key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def essential_bytes(cfg, shape, n_params: int, chips: int, microbatches: int = 1,
                    tp: int = 16) -> float:
    """Analytic LOWER BOUND on per-chip HBM traffic (bytes): weight reads,
    optimizer state r/w, saved residual w+r, logits, decode-cache traffic."""
    P = float(n_params)
    D, V = cfg.d_model, cfg.padded_vocab
    B, S = shape.global_batch, shape.seq_len
    dp = max(chips // tp, 1)
    w_bf16 = 2 * P / tp  # per-chip bytes of one full weight sweep (TP shard)
    if shape.kind == "train":
        M = microbatches
        weights = 3.0 * M * w_bf16  # fwd + remat-fwd + bwd
        opt = (4 * 2 + 4 * 2 + 2 + 4) * P / chips  # m,v r/w + param w + grad
        resid = 2.0 * (cfg.n_layers * M * (B / M) * S * D * 2 / dp)
        logits = 2.0 * (B * S * V * 2 / chips)
        return weights + opt + resid + logits
    if shape.kind == "prefill":
        weights = w_bf16
        resid = 2.0 * cfg.n_layers * B * S * D * 2 / dp
        cache_w = 2.0 * B * S * cfg.n_kv_heads * cfg.hd * 2 * cfg.n_layers / dp
        return weights + resid + cache_w
    # decode: weights once + cache read/write
    weights = w_bf16
    C = min(S, cfg.window) if cfg.window else S
    if cfg.family == "rwkv6":
        cache = B * cfg.n_layers * (cfg.d_model * (cfg.d_model // cfg.n_heads)) * 4
    elif cfg.family == "hybrid":
        n_super = cfg.n_layers // 3
        cache = B * (n_super * cfg.local_window * cfg.n_kv_heads * cfg.hd * 2 * 2
                     + cfg.n_layers * (cfg.d_rnn or D) * 4)
    else:
        cache = 2 * B * C * cfg.n_kv_heads * cfg.hd * 2 * cfg.n_layers
    return weights + 2.0 * cache / chips


def model_flops(cfg, shape, n_params: int, n_active_params: Optional[int] = None):
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for training;
    2·N·D for inference forward passes."""
    n = n_active_params if n_active_params is not None else n_params
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * 1 * shape.global_batch  # decode: one token
