"""Deterministic synthetic LM data pipeline.

The port's copy of ``DataConfig``, ``make_batch`` and ``Prefetcher`` from
``repro.train.data`` (numpy; the same seed gives the same batch in both
packages).  Stateless per-step generation (seed ⊕ step) so restarts resume
exactly.  Token streams follow a Zipf-ish unigram mixture with
Markov bigram structure so the loss actually decreases during the
end-to-end examples, rather than pinning at ln(V).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 1234
    frontend_dim: int = 0      # >0: emit float frames instead of tokens
    n_states: int = 64         # Markov chain states (learnable structure)


def _chain(cfg: DataConfig) -> np.ndarray:
    """Fixed per-seed Markov transition table state -> 8 candidate tokens."""
    rng = np.random.RandomState(cfg.seed)
    return rng.randint(0, cfg.vocab_size, size=(cfg.n_states, 8))


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch for one step: inputs [B,T] (or [B,T,F]), targets [B,T]."""
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2**31 - 1))
    B, T = cfg.global_batch, cfg.seq_len
    table = _chain(cfg)
    state = rng.randint(0, cfg.n_states, size=(B,))
    toks = np.empty((B, T + 1), dtype=np.int32)
    for t in range(T + 1):
        choice = rng.randint(0, 8, size=(B,))
        toks[:, t] = table[state, choice]
        state = (state * 31 + toks[:, t]) % cfg.n_states
    out: Dict[str, np.ndarray] = {
        "targets": toks[:, 1:].astype(np.int32),
    }
    if cfg.frontend_dim > 0:
        # frontend stub: frames are noisy embeddings of the token ids
        emb = np.random.RandomState(cfg.seed).randn(
            cfg.vocab_size, cfg.frontend_dim).astype(np.float32)
        out["inputs"] = (emb[toks[:, :-1]]
                         + 0.1 * rng.randn(B, T, cfg.frontend_dim)
                         ).astype(np.float32)
    else:
        out["inputs"] = toks[:, :-1].astype(np.int32)
    return out


class Prefetcher:
    """Background-thread prefetch of make_batch results."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            b = make_batch(self.cfg, s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2)
