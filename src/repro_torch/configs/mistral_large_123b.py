"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified].
head_dim=128 (96*128=12288)."""
from repro_torch.models.lm import ModelConfig

MODEL = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
)

REDUCED = ModelConfig(
    name="mistral-large-reduced",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    vocab_pad_to=64,
    attn_kv_chunk=32,
)
