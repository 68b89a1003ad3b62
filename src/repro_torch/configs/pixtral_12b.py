"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (1024-d ViT patch features) entering via a trainable
projection; the transformer backbone is the assigned deliverable.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    act="swiglu",
    rope_theta=1e6,
    frontend="vision",
    frontend_dim=1024,           # ViT patch feature dim
    tie_embeddings=False,
))
