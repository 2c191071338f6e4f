"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32, i.e. MHA)
d_ff=8192 vocab=32064 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""
from repro_torch.models.lm import ModelConfig

MODEL = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
)

REDUCED = ModelConfig(
    name="phi3-mini-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    vocab_pad_to=64,
    attn_kv_chunk=32,
)
