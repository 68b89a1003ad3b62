"""xlstm-125m [ssm]: 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304,
sLSTM + mLSTM blocks (attention-free).  [arXiv:2405.04517; unverified]

Block mix: sLSTM every 4th block, mLSTM otherwise (xLSTM[a:b]-style).
long_500k RUNS for this arch: decode state is O(1) in sequence length.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,                      # attention-free; no transformer FFN
    vocab_size=50304,
    block_pattern="xlstm",
    ssm_chunk=128,
    tie_embeddings=True,
))
