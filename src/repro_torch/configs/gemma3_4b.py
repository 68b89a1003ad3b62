"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    act="geglu",
    qk_norm=True,
    rope_theta=1e6,
    local_global_ratio=5,        # 5 local layers per 1 global
    local_window=1024,
    tie_embeddings=True,         # gemma ties embeddings
    embed_scale=True,
))
