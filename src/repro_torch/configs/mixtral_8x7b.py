"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, SWA 4096 [arXiv:2401.04088; hf].
8 experts < 16 'model' devices -> shard_mode='tp' (expert-internal TP)."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.moe import MoEConfig

MODEL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    window=4096,  # sliding-window attention => long_500k runs
    moe=MoEConfig(
        d_model=4096, d_expert=14336, n_experts=8, top_k=2, n_shared=0,
        shard_mode="tp",
    ),
)

REDUCED = ModelConfig(
    name="mixtral-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    vocab_pad_to=64,
    window=32,
    attn_kv_chunk=32,
    moe=MoEConfig(
        d_model=64, d_expert=128, n_experts=4, top_k=2, n_shared=0,
        shard_mode="tp",
    ),
)
