"""The configurations the port's chip runs drive, defined once.

Train: full-width phi4-mini cut to 2 of its 32 layers, 4 DP ranks stacked
on one card, global batch 8 x 1024 tokens, the table bucket size, AdamW
with a 2-step warm-up.  ``chip_smoke.py`` and ``launch/profile_step.py``
both build their step from here, so the profiled step is the smoked one.

Serve (``SERVE_CELL``): phi4-mini at full width and full depth, an 8-page
pool, a Poisson trace of 16 greedy requests at 0.5 per decode step with
prompts of 64-512 tokens and 32 new tokens each (a page of 1024 tokens).
``launch/serve.py`` takes its defaults from here and ``chip_smoke.py``
serves it.
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


def serve_model_config() -> ModelConfig:
    """The serve cell's model: full depth."""
    return base.get_config(SERVE_CELL.arch)
