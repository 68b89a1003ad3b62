"""The configuration the port's chip runs drive, defined once.

Full-width phi4-mini cut to 2 of its 32 layers, 4 DP ranks stacked on one
card, global batch 8 x 1024 tokens, the table bucket size, AdamW with a
2-step warm-up.  ``chip_smoke.py`` and ``launch/profile_step.py`` both
build their step from here, so the profiled step is the smoked one.
"""

from __future__ import annotations

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.data import DataConfig
from repro_torch.train.step import TrainConfig

ARCH = "phi4-mini-3.8b"
N_LAYERS = 2
N_DP = 4
GLOBAL_BATCH = 8
SEQ_LEN = 1024


def model_config() -> ModelConfig:
    return base.get_config(ARCH).replace(n_layers=N_LAYERS)


def data_config(cfg: ModelConfig) -> DataConfig:
    return DataConfig(global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                      vocab_size=cfg.vocab_size)


def train_config(backend: str, wire_dtype: str,
                 topology: str = "tpu_multipod") -> TrainConfig:
    return TrainConfig(backend=backend, wire_dtype=wire_dtype,
                       topology=topology,
                       adamw=AdamWConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=100))
