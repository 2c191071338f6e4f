"""llava-next-mistral-7b [vlm]: mistral-7b backbone (32L d_model=4096 32H
GQA kv=8 d_ff=14336 vocab=32000) + anyres patch embeddings
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. The vision tower is a
stub by assignment: input_specs provides precomputed patch embeddings
(anyres tiling -> up to 2880 patches) that are projected and prepended."""
from repro_torch.models.lm import ModelConfig

N_PATCHES = 2880  # anyres: up to 4 tiles + base, 576 patches each

MODEL = ModelConfig(
    name="llava-next-mistral-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    frontend="vision",
)

REDUCED = ModelConfig(
    name="llava-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    vocab_pad_to=64,
    frontend="vision",
    attn_kv_chunk=32,
)
