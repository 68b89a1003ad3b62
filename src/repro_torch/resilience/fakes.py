"""The resilience suite's *replay-consistent* deterministic fake engine.

Port of ``repro.resilience.fakes``.  A fake engine whose insert logits
were ``onehot(length)`` would be fine for drain/respawn (un-admitted
requests replay with the original prompt) but wrong for CRASH replay,
where ``eject_all`` folds the generated prefix into the prompt: the
replay insert then sees length ``L + g`` and would emit ``L + g`` where
the fault-free run emitted ``L + g - 1``.  The real engine computes insert
logits at the LAST prompt position (``length - 1``) — exactly the property
that makes crash replay byte-identical — so this fake mirrors it.
Closed-form greedy stream for prompt length ``L``::

    (L - 1), L, L + 1, ...   (mod V)

with or without crashes mid-stream.  The logits are float32 tensors on
the CPU, which the port's sampler takes as it takes the engine's.
"""

import numpy as np
import torch

V = 32


class ReplayFakeFns:
    """Deterministic fake engine whose insert logits sit at the last
    prompt position (``length - 1``), matching the real engine's replay
    semantics across ``crash()``/``eject_all`` prompt folding.  It has
    the ``serve.engine.ServeFns`` attributes the scheduler reads."""

    def __init__(self, n_slots):
        self.n_slots = n_slots
        self.plan = {}
        self.insert = self._insert
        self.decode_slots = self._decode
        self.evict = self._evict

    def init_pool(self):
        return {"pos": torch.zeros(self.n_slots, dtype=torch.int64)}

    @staticmethod
    def _onehot(idx):
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
        out = torch.zeros((len(idx), V), dtype=torch.float32)
        out[torch.arange(len(idx)), idx % V] = 1.0
        return out

    def _insert(self, params, pool, tokens, length, slot):
        pool["pos"][int(slot)] = int(length)
        return self._onehot([int(length) - 1]), pool

    def _decode(self, params, pool, tokens, active):
        logits = self._onehot(pool["pos"])
        pool["pos"] += torch.as_tensor(np.asarray(active), dtype=torch.int64)
        return logits, pool

    def _evict(self, pool, slot):
        pool["pos"][int(slot)] = 0
        return pool


class FakeTimer:
    """Deterministic perf_counter stand-in: each call advances by
    ``step_s`` so every scheduler step 'measures' a fixed latency."""

    def __init__(self, step_s=1e-3):
        self.step_s = step_s
        self.t = 0.0

    def __call__(self):
        self.t += self.step_s
        return self.t


def expected_stream(L, n):
    """The replay-consistent fake engine's greedy stream for prompt
    length L (the closed form every crash-free AND crashed run must
    reproduce)."""
    return [(L - 1 + i) % V for i in range(n)]
