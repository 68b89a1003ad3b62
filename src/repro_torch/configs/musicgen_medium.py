"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048, decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (128-d EnCodec latent frames) entering via a trainable
projection; the transformer backbone is the assigned deliverable.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,             # EnCodec codebook size
    act="swiglu",
    rope_theta=1e4,
    frontend="audio",
    frontend_dim=128,            # EnCodec latent frame dim
    tie_embeddings=False,
))
