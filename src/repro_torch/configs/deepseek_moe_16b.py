"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained
[arXiv:2401.06066; hf]. Experts shard over 'model' (EP)."""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.moe import MoEConfig

MODEL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(
        d_model=2048,
        d_expert=1408,
        n_experts=64,
        top_k=6,
        n_shared=2,
        shard_mode="ep",
    ),
)

REDUCED = ModelConfig(
    name="deepseek-moe-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=256,
    vocab_pad_to=64,
    attn_kv_chunk=32,
    moe=MoEConfig(
        d_model=64, d_expert=96, n_experts=8, top_k=2, n_shared=2,
        shard_mode="ep",
    ),
)
