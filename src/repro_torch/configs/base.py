"""Model configuration dataclass + architecture registry (--arch <id>).

Port of ``repro.configs.base``.  The dataclass keeps every field of the
reference so configs carry over unchanged; the registry holds the
architectures of the reference, each a copy of its file: the four dense
ones (phi4-mini, gemma3-4b, gemma-7b, qwen3-32b), the two MoE ones
(mixtral-8x7b, phi3.5-moe-42b-a6.6b; served through the fixed-batch
loop), the two
recurrent ones (xlstm-125m, zamba2-2.7b; on one TP rank) and the two
frontend stubs (musicgen-medium, pixtral-12b).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    act: str = "swiglu"         # swiglu | geglu
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # attention pattern
    window: Optional[int] = None          # sliding-window size (None = full)
    local_global_ratio: int = 0           # k>0: k local layers per 1 global
    local_window: int = 1024
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    expert_shard: str = "expert"
    ep_blocks: int = 1
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0
    block_pattern: str = "transformer"    # transformer | xlstm | zamba
    # modality frontend stub
    frontend: Optional[str] = None
    frontend_dim: int = 0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    embed_scale: bool = False
    # training-time knobs
    attn_chunk: int = 512                 # query/KV chunking of attention
    remat: bool = True
    z_loss: float = 1e-4
    aux_loss_weight: float = 1e-2

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def _load_all():
    from . import (gemma3_4b, gemma_7b, mixtral_8x7b, musicgen_medium,  # noqa
                   phi35_moe, phi4_mini, pixtral_12b, qwen3_32b,
                   xlstm_125m, zamba2_2p7b)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: small layers/width,
    few experts, tiny vocab — but the SAME block pattern and features."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        attn_chunk=32,
        ssm_chunk=16,
        ssm_head_dim=16,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        remat=False,
    )
    if cfg.n_experts > 0:
        kw["n_experts"] = 4
        kw["top_k"] = 2
    if cfg.local_global_ratio > 0:
        kw["n_layers"] = cfg.local_global_ratio + 2
        kw["local_window"] = 16
    if cfg.window is not None:
        kw["window"] = 16
    if cfg.block_pattern == "zamba":
        kw["n_layers"] = 4
        kw["attn_every"] = 2
    if cfg.block_pattern == "xlstm":
        kw["n_layers"] = 5
    if cfg.frontend_dim:
        kw["frontend_dim"] = 16
    return cfg.replace(**kw)
