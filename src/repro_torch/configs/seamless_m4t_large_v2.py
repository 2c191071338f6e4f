"""seamless-m4t-large-v2 [audio]: enc-dec, 24L each, d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]. The speech frontend
is a stub by assignment: input_specs provides precomputed frame embeddings
[B, T_frames, d_model]."""
from repro_torch.models.lm import ModelConfig

MODEL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
)

REDUCED = ModelConfig(
    name="seamless-reduced",
    family="encdec",
    n_layers=2,
    n_dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    vocab_pad_to=64,
    frontend="audio",
    attn_kv_chunk=32,
)
