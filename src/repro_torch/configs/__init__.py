"""Architecture registry: ``get_config(arch_id)`` -> ModelConfig,
``get_reduced(arch_id)`` -> CPU-testable ModelConfig of the same family,
plus the canonical input-shape sets. The configs are copies of the JAX
package's, field for field.

Shapes (assigned to every LM arch):
  train_4k     seq 4096,   global batch 256  (train_step)
  prefill_32k  seq 32768,  global batch 32   (prefill)
  decode_32k   kv 32768,   global batch 128  (decode_step)
  long_500k    kv 524288,  global batch 1    (decode_step; sub-quadratic only)

The port serves every one of them: the dense family (granite_3_2b,
phi3_mini_3_8b, qwen3_32b, mistral_large_123b, and llava_next_mistral_7b
with its vision frontend stub), the MoE family (deepseek_moe_16b,
mixtral_8x7b), RWKV-6 (rwkv6_7b), the RG-LRU hybrid (recurrentgemma_2b)
and the encoder-decoder family with its audio frontend stub
(seamless_m4t_large_v2).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.models.lm import ModelConfig

ARCH_IDS = [
    "granite_3_2b",
    "phi3_mini_3_8b",
    "mistral_large_123b",
    "qwen3_32b",
    "rwkv6_7b",
    "deepseek_moe_16b",
    "mixtral_8x7b",
    "seamless_m4t_large_v2",
    "recurrentgemma_2b",
    "llava_next_mistral_7b",
]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    microbatches: int = 1

    def cell_name(self, arch: str) -> str:
        return f"{arch}×{self.name}"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def canonical(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch)}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).MODEL


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise the skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "full quadratic attention: 500k-token decode is out of scope by "
            "assignment (sub-quadratic archs only)"
        )
    return None


def all_cells():
    """Every (arch, shape) pair with its skip status."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            out.append((arch, shape.name, shape_applicable(cfg, shape)))
    return out
