"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892; hf]. 64 heads of dim 64."""
from repro_torch.models.lm import ModelConfig

MODEL = ModelConfig(
    name="rwkv6-7b",
    family="rwkv6",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # head_dim 64 (RWKV6 standard)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    # chunked WKV by default, as in the JAX package; the port's two paths
    # are held to each other in tests/test_torch_lm_recurrent.py. Set
    # wkv_chunk=None for the per-token loop.
    wkv_chunk=32,
)

REDUCED = ModelConfig(
    name="rwkv6-reduced",
    family="rwkv6",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    vocab_pad_to=64,
)
