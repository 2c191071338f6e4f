"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attn : 2 rec [arXiv:2402.19427;
hf]. Local window 2048; lru width 2560; 26 = 8 superblocks (rec,rec,attn)
+ 2 tail rec layers."""
from repro_torch.models.lm import ModelConfig

MODEL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    local_window=2048,
    d_rnn=2560,
)

REDUCED = ModelConfig(
    name="recurrentgemma-reduced",
    family="hybrid",
    n_layers=5,  # 1 superblock + 2 tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vocab_pad_to=64,
    local_window=32,
    d_rnn=64,
    attn_kv_chunk=32,
)
