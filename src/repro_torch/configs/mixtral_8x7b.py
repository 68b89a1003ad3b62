"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, SWA 4096.  [arXiv:2401.04088; hf]
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    act="swiglu",
    rope_theta=1e6,
    window=4096,                 # sliding-window attention
    n_experts=8,
    top_k=2,
    ep_blocks=2,                 # 8 experts x 2 column-blocks = 16 EP units
    expert_shard="ffn",
    tie_embeddings=False,
))
