"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks, d_model=2560, shared attention
block (32H kv=32) fired every 6 blocks, d_ff=10240, ssm_state=64,
vocab=32000.  [arXiv:2411.15242; hf]

long_500k RUNS for this arch: Mamba2 state is O(1); the shared-attention
firings hold sequence-sharded KV.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    block_pattern="zamba",
    attn_every=6,                # shared attn block after every 6 Mamba blocks
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    tie_embeddings=True,
))
