"""Architecture registry: ``get_config(arch_id)`` -> ModelConfig,
``get_reduced(arch_id)`` -> CPU-testable ModelConfig of the same family,
plus the canonical input-shape sets. The configs are copies of the JAX
package's, field for field.

Shapes (assigned to every LM arch):
  train_4k     seq 4096,   global batch 256  (train_step)
  prefill_32k  seq 32768,  global batch 32   (prefill)
  decode_32k   kv 32768,   global batch 128  (decode_step)
  long_500k    kv 524288,  global batch 1    (decode_step; sub-quadratic only)

The port runs the dense family (granite_3_2b, phi3_mini_3_8b, qwen3_32b,
mistral_large_123b), the MoE family (deepseek_moe_16b, mixtral_8x7b),
RWKV-6 (rwkv6_7b) and the RG-LRU hybrid (recurrentgemma_2b). Asking for
seamless_m4t_large_v2 or llava_next_mistral_7b raises
``NotImplementedError`` naming the slice of the port that brings it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.lm import LATER_FAMILIES, LATER_FRONTEND, ModelConfig

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

# arch -> the slice of the port that brings its config
_LATER = {
    "seamless_m4t_large_v2": LATER_FAMILIES["encdec"],
    "llava_next_mistral_7b": LATER_FRONTEND,
}


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
    name = canonical(arch)
    if name in _LATER:
        raise NotImplementedError(f"{name} is not ported yet: it comes with {_LATER[name]}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).MODEL


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED
