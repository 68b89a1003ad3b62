"""Batched token sampling over the decode logits.

Port of ``repro.serve.sampling``.  One sampler covers greedy, temperature,
top-k and top-p per *slot*: greedy is ``temperature == 0`` elementwise,
so a pool mixing greedy and sampled requests runs one function.  Filtering
is computed as the reference does (``sampling.py:69-98``): the pool-global
``top_k`` masks logits below the k-th largest, temperature scales, and the
pool-global nucleus cut keeps the smallest prefix of the sorted
distribution whose mass reaches ``top_p`` (the argmax always kept).

Randomness: each sampled slot draws from its own ``torch.Generator``,
seeded from ``(seed, rid, step)`` — injective in ``(rid, step)`` for a
seed — so a draw never depends on which other requests share the batch.
The draw is a Gumbel-max over the filtered, scaled logits (a categorical
draw, as ``jax.random.categorical`` makes).  ``jax.random``'s bits cannot
be reproduced, so sampled streams match the reference only in
distribution; greedy streams and the kept sets match it exactly.

Under tensor parallelism the engine's logits are the TP ranks' vocab
blocks ``[tp, B, ceil(V/tp)]``; the sampler gathers them
(:func:`gather_vocab`: ``stacked.all_gather`` over the ranks, the padded
columns dropped) before any reduction.  The reference takes the serving
collective plan and, where it names ``logits_allgather``, pins GSPMD's
re-assembly before sampling; without a plan GSPMD reduces over the
sharded vocab instead.  The ranks here are stacked on one device, where
a reduction over the stacked blocks is a gather followed by the
reduction, so the port gathers with or without a plan: ``plan`` is taken
for the reference's signature and changes no token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.collectives import stacked

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (host-side; batched into arrays).

    ``temperature`` is per request.  ``top_k`` and ``top_p`` are
    *pool-global*: the scheduler rejects a request whose nonzero value
    differs from the pool's, as the reference does.
    """
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => pool default / full vocab
    top_p: float = 0.0         # 0 => pool default / no nucleus cut


def stream_seed(seed: int, rid: int, step: int) -> int:
    """The generator seed of request ``rid``'s token ``step``: the pair
    packed into 64 bits (each below 2**32), XORed with a mix of ``seed``
    (splitmix64) — injective in ``(rid, step)`` for one seed."""
    if not (0 <= rid < 2 ** 32 and 0 <= step < 2 ** 32):
        raise ValueError(f"rid {rid} and step {step} must lie in "
                         f"[0, 2**32)")
    z = (int(seed) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    return ((rid << 32) | step) ^ z


def filter_logits(logits, temperature, top_k: int = 0, top_p: float = 0.0):
    """``logits [B, V]``, ``temperature [B]`` -> the temperature-scaled
    float32 logits with every token outside the kept set at ``-inf``."""
    logits = logits.to(torch.float32)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.full((), -torch.inf, device=logits.device),
                             logits)
    scaled = logits / torch.clamp(temperature[:, None], min=1e-6)
    if 0.0 < top_p < 1.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        kept = before < top_p
        thr = torch.amin(torch.where(kept, srt, torch.full(
            (), torch.inf, device=srt.device)), dim=-1, keepdim=True)
        scaled = torch.where(scaled < thr, torch.full(
            (), -torch.inf, device=scaled.device), scaled)
    return scaled


def gather_vocab(logits, vocab_size: Optional[int] = None):
    """The TP ranks' vocab blocks ``[tp, B, Vl]`` -> ``[B, V]``: the blocks
    all-gathered over the ranks (rank 0's copy), the padded columns past
    ``vocab_size`` dropped.  Whole logits ``[B, V]`` come back as they
    are."""
    if logits.dim() != 3:
        return logits
    full = stacked.all_gather(logits, -1)[0]
    return full if vocab_size is None else full[..., :vocab_size]


def make_sampler(top_k: int = 0, top_p: float = 0.0,
                 plan: Optional[Dict[str, str]] = None,
                 vocab_size: Optional[int] = None):
    """A pooled sampler ``(logits [B,V] or [tp,B,Vl], temperature [B],
    rids [B], steps [B], seed) -> tokens [B]`` (int32 numpy).

    ``top_k`` and ``top_p`` are pool-global (see :class:`SamplingParams`);
    per-slot ``temperature`` and the stream ids are per call.  Vocab
    blocks are gathered first (:func:`gather_vocab`, ``vocab_size`` the
    model's), whatever ``plan`` says (see the module docstring).
    """
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")

    def sample(logits, temperature, rids, steps, seed: int):
        logits = gather_vocab(torch.as_tensor(logits), vocab_size)
        temps = np.asarray(temperature, np.float32).reshape(-1)
        greedy = torch.argmax(logits.to(torch.float32), dim=-1)
        hot = np.flatnonzero(temps > 0.0)
        if hot.size == 0:
            return greedy.to(torch.int32).cpu().numpy()
        t = torch.as_tensor(temps, device=logits.device)
        scaled = filter_logits(logits, t, top_k, top_p)
        out = greedy.clone()
        for b in hot:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(stream_seed(seed, int(rids[b]), int(steps[b])))
            u = torch.rand(scaled.shape[-1], generator=gen,
                           device=logits.device)
            gumbel = -torch.log(-torch.log(
                torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
            out[b] = torch.argmax(scaled[b] + gumbel)
        return out.to(torch.int32).cpu().numpy()

    return sample
