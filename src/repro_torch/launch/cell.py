"""The configurations the port's chip runs drive, defined once.

Train: full-width phi4-mini cut to 2 of its 32 layers, 4 DP ranks stacked
on one card, global batch 8 x 1024 tokens, the table bucket size, AdamW
with a 2-step warm-up.  ``chip_smoke.py`` and ``launch/profile_step.py``
both build their step from here, so the profiled step is the smoked one.
``hier_train_config`` stacks the same 4 ranks as two DP axes,
``("pod", "data")`` of shape ``HIER_DP`` = (2, 2), for the two-tier path.
Tensor parallelism: the same model and batch at ``TP_SHAPE`` = (dp, tp) =
(2, 2), under megatron_sp (24 heads, d_model 3072); its small
counterparts are ``tp_small_config`` (megatron_sp: d_model 1024, 8/4
heads) and ``tp_pure_sp_config`` (the reduced width, d_model 64:
pure_sp), float32.

Serve (``SERVE_CELL``): phi4-mini at full width and full depth, an 8-page
pool, a Poisson trace of 16 greedy requests at 0.5 per decode step with
prompts of 64-512 tokens and 32 new tokens each (a page of 1024 tokens).
``launch/serve.py`` takes its defaults from here and ``chip_smoke.py``
serves it, on one rank and at ``SERVE_TP_SHAPE`` = (dp, tp) = (2, 2):
the same model, weights and trace, 4 pages a DP rank, each page's 1024
slots split 512 a TP rank (megatron_sp prefill).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.data import DataConfig
from repro_torch.train.step import TrainConfig

ARCH = "phi4-mini-3.8b"
N_LAYERS = 2
N_DP = 4
#: the 4 ranks as (pods, data) for the two-tier (bine_hier) path
HIER_DP = (2, 2)
#: the 4 ranks as (dp, tp): 2 DP ranks of 2 tensor-parallel ranks each
TP_SHAPE = (2, 2)
GLOBAL_BATCH = 8
SEQ_LEN = 1024


def model_config() -> ModelConfig:
    return base.get_config(ARCH).replace(n_layers=N_LAYERS)


def tp_small_config() -> ModelConfig:
    """A small megatron_sp model (the reference's test_parallel_equiv
    cfgA widths: d_model 1024, 8/4 heads, qk_norm, an untied head),
    float32."""
    return base.get_config(ARCH).replace(
        n_layers=2, d_model=1024, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=128, attn_chunk=32, qk_norm=True,
        tie_embeddings=False, rope_theta=1e6, dtype="float32")


def tp_pure_sp_config() -> ModelConfig:
    """phi4-mini at the reduced width (d_model 64 < 1024: pure_sp),
    float32."""
    return base.reduced(base.get_config(ARCH)).replace(dtype="float32")


def data_config(cfg: ModelConfig) -> DataConfig:
    return DataConfig(global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                      vocab_size=cfg.vocab_size)


def train_config(backend: str, wire_dtype: str,
                 topology: str = "tpu_multipod") -> TrainConfig:
    return TrainConfig(backend=backend, wire_dtype=wire_dtype,
                       topology=topology,
                       adamw=AdamWConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=100))


def hier_train_config(backend: str, wire_dtype: str) -> TrainConfig:
    """``train_config`` over two DP axes: pass ``HIER_DP`` as the step's
    ``dp``."""
    return train_config(backend, wire_dtype).replace(
        dp_axes=("pod", "data"))


@dataclass(frozen=True)
class ServeCell:
    arch: str = ARCH
    slots: int = 8
    requests: int = 16
    rate: float = 0.5            # Poisson arrivals per decode step
    prompt_len_min: int = 64
    prompt_len_max: int = 512
    max_new: int = 32
    temperature: float = 0.0     # greedy
    seed: int = 0


SERVE_CELL = ServeCell()
#: the serve cell's ranks under tensor parallelism: (dp, tp)
SERVE_TP_SHAPE = (2, 2)


def serve_model_config() -> ModelConfig:
    """The serve cell's model: full depth."""
    return base.get_config(SERVE_CELL.arch)
