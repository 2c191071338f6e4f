"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]. head_dim=128 per the
Qwen3 family (q projection is 64*128=8192 wide)."""
from repro_torch.models.lm import ModelConfig

MODEL = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
)

REDUCED = ModelConfig(
    name="qwen3-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vocab_pad_to=64,
    qk_norm=True,
    attn_kv_chunk=32,
)
