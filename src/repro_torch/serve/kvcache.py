"""Paged/slotted KV pool for continuous batching.

Port of ``repro.serve.kvcache``.  The pool is the model's decode state with
the batch axis reinterpreted as ``n_slots`` fixed-size *pages*: one page =
one request's entire cache (KV runs for attention layers, ring buffers
bounded by the window for sliding-window layers).  A per-slot ``pos``
vector (``[n_slots]`` int32) replaces the legacy scalar position so every
page advances independently.

Device-side primitives, updating the pool IN PLACE (the reference returns
new arrays; here the pool is the largest buffer of a server, and a copy
per request would move all of it):

  * :func:`init_pool_state`  — the zeroed pool;
  * :func:`write_slot`       — copy a single-request (B=1) state into a page;
  * :func:`reset_slot`       — retire a page (position back to 0).

Under tensor parallelism (``layout``: one ``models.sharding.KVLayout`` a
segment) the pool is rank-stacked: a leaf is ``[n_layers, rows, B_local,
W_local, nkv_local, hd]``, row ``r * rtp + t`` holding DP rank r's pages
and TP rank t's slots or KV heads, a leaf that does not split held once.
:func:`pool_to_global` and :func:`pool_from_global` convert it to and
from the reference's global pool ``[n_layers, B, W, nkv, hd]``;
:func:`state_from_global` and :func:`state_to_global` do the same for the
fixed-batch loop's decode state, whose recurrent segments split over the
TP ranks by heads or units (``transformer.split_state``).

Host-side bookkeeping lives in :class:`SlotAllocator`: a FIFO free list
plus occupancy accounting, free of torch, so the scheduler's admission
logic is unit-testable without a device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T


def init_pool_state(model_cfg, n_slots: int, max_seq_len: int,
                    device="cuda", layout=None) -> dict:
    """Zeroed pool: per-segment stacked caches + per-slot positions; with
    a ``layout``, each segment's leaves rank-stacked by it."""
    if layout is None:
        state = T.init_decode_state(model_cfg, n_slots, max_seq_len, device)
    else:
        dev = resolve_device(device)
        meta = T.init_decode_state(model_cfg, n_slots, max_seq_len, "meta")
        state = {"segments": [
            {k: torch.zeros(_stacked_shape(x.shape, lay), dtype=x.dtype,
                            device=dev) for k, x in seg.items()}
            for seg, lay in zip(meta["segments"], layout)],
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    state["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                               device=state["pos"].device)
    return state


def write_slot(pool: dict, one: dict, slot, layout=None) -> dict:
    """Install a single-request decode state (batch 1) into page ``slot``.

    ``one`` is a ``prefill``/``init_decode_state`` state with B=1 and a
    0-dim ``pos``; cache leaves are ``[n_layers, 1, ...]`` and land at
    ``pool_leaf[:, slot]``, or with a ``layout`` split over the rows of
    the DP rank holding the page.  ``slot`` may be an int or a 0-dim
    tensor."""
    slot = _check_slot(pool, slot)
    for i, (dseg, sseg) in enumerate(zip(pool["segments"], one["segments"])):
        for k, dst in dseg.items():
            src = sseg[k][:, 0].to(dst.dtype)
            if layout is None:
                dst[:, slot] = src
                continue
            lay = layout[i]
            Bl = dst.shape[2]
            r, rt = slot // Bl, lay.rtp
            dst[:, r * rt:(r + 1) * rt, slot % Bl] = _split(src, lay)
    pool["pos"][slot] = torch.as_tensor(one["pos"]).to(torch.int32)
    return pool


def reset_slot(pool: dict, slot) -> dict:
    """Retire page ``slot``: position back to 0 (cache bytes are left in
    place — ``write_slot`` overwrites the whole page on reuse)."""
    pool["pos"][_check_slot(pool, slot)] = 0
    return pool


def _kv_to_global(seg: dict, lay) -> dict:
    """One segment's K/V split by ``lay`` -> the global ``[n_layers, B,
    W, nkv, hd]`` (a copy)."""
    out = {}
    for k, x in seg.items():
        n, _, Bl, Wl, nl, hd = x.shape
        x = x.view(n, lay.rdp, lay.rtp, Bl, Wl, nl, hd)
        x = x.permute(0, 1, 3, 4, 2, 5, 6) if lay.kv == "heads" else \
            x.permute(0, 1, 3, 2, 4, 5, 6)
        out[k] = x.clone(memory_format=torch.contiguous_format).view(
            n, lay.rdp * Bl, lay.width, -1, hd)
    return out


def _kv_from_global(seg: dict, lay) -> dict:
    """Inverse of :func:`_kv_to_global` (a copy)."""
    out = {}
    for k, x in seg.items():
        n, B, _, _, hd = x.shape
        x = x.unflatten(1, (lay.rdp, B // lay.rdp))
        x = x.unflatten(4, (lay.rtp, -1)).permute(0, 1, 4, 2, 3, 5, 6) \
            if lay.kv == "heads" else \
            x.unflatten(3, (lay.rtp, -1)).permute(0, 1, 3, 2, 4, 5, 6)
        out[k] = x.clone(memory_format=torch.contiguous_format).view(
            (n, lay.rows) + tuple(x.shape[3:]))
    return out


def pool_to_global(pool: dict, layout) -> dict:
    """A pool -> the reference's global layout: leaves ``[n_layers, B, W,
    nkv, hd]``, a copy (the one-card pool, ``layout`` None, is returned
    as it is)."""
    if layout is None:
        return pool
    return {"segments": [_kv_to_global(seg, lay) for seg, lay in
                         zip(pool["segments"], layout)],
            "pos": pool["pos"].clone()}


def pool_from_global(pool: dict, layout) -> dict:
    """Inverse of :func:`pool_to_global`: a global pool split by
    ``layout`` (a copy)."""
    if layout is None:
        return pool
    return {"segments": [_kv_from_global(seg, lay) for seg, lay in
                         zip(pool["segments"], layout)],
            "pos": pool["pos"].clone()}


def state_from_global(model_cfg, state: dict, layout) -> dict:
    """A decode state in its global layout (``transformer.prefill_tp``'s)
    -> split by ``layout`` (``serve.engine.cache_layout``): K/V as
    :func:`pool_from_global`, a recurrent segment's states over the TP
    ranks by heads or units where its ``kv`` is ``"heads"``, else held
    once as they are."""
    segs = []
    for (block, _), seg, lay in zip(T.segments(model_cfg),
                                    state["segments"], layout):
        if block.kind not in T.RECURRENT:
            seg = _kv_from_global(seg, lay)
        elif lay.kv == "heads":
            seg = T.split_state(block.kind, seg, lay.n_tp, lead=1)
        segs.append(seg)
    return {"segments": segs, "pos": state["pos"]}


def state_to_global(model_cfg, state: dict, layout) -> dict:
    """Inverse of :func:`state_from_global`: the reference's global decode
    state."""
    segs = []
    for (block, _), seg, lay in zip(T.segments(model_cfg),
                                    state["segments"], layout):
        if block.kind not in T.RECURRENT:
            seg = _kv_to_global(seg, lay)
        elif lay.kv == "heads":
            seg = T.join_state(block.kind, seg, lead=1)
        segs.append(seg)
    return {"segments": segs, "pos": state["pos"]}


def _split(x, lay):
    """One page ``[n_layers, W, nkv, hd]`` -> its TP rows ``[n_layers,
    rtp, W_local, nkv_local, hd]``."""
    if lay.kv == "heads":
        return x.unflatten(2, (lay.rtp, -1)).movedim(2, 1)
    return x.unflatten(1, (lay.rtp, -1))


def _stacked_shape(shape, lay):
    """A global leaf's shape ``[n_layers, B, W, nkv, hd]`` -> its
    rank-stacked one."""
    n, B, _, nkv, hd = shape
    return (n, lay.rows) + lay.local_shape(B, nkv) + (hd,)


def _check_slot(pool: dict, slot) -> int:
    """The page index as an int; out of range raises (the reference's
    ``dynamic_update_slice`` would clamp it onto another page)."""
    slot, n = int(slot), pool["pos"].shape[0]
    if not 0 <= slot < n:
        raise ValueError(f"slot {slot} out of range [0, {n})")
    return slot


# ---------------------------------------------------------------------------
# Host-side slot accounting (no torch)
# ---------------------------------------------------------------------------

@dataclass
class SlotAllocator:
    """FIFO page allocator + occupancy counters for the scheduler."""

    n_slots: int
    free: List[int] = field(default_factory=list)
    #: cumulative (occupied slots summed over every decode step) — divide
    #: by ``decode_steps`` for mean occupancy
    occupancy_sum: int = 0
    decode_steps: int = 0
    peak_occupancy: int = 0
    total_inserts: int = 0

    def __post_init__(self):
        if not self.free:
            self.free = list(range(self.n_slots))

    @property
    def n_occupied(self) -> int:
        return self.n_slots - len(self.free)

    def acquire(self) -> Optional[int]:
        """Pop the oldest free page, or None when the pool is full."""
        if not self.free:
            return None
        self.total_inserts += 1
        slot = self.free.pop(0)
        self.peak_occupancy = max(self.peak_occupancy, self.n_occupied)
        return slot

    def release(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if slot in self.free:
            raise ValueError(f"slot {slot} double-freed")
        self.free.append(slot)

    def tick(self) -> None:
        """Record one decode step's occupancy."""
        self.occupancy_sum += self.n_occupied
        self.decode_steps += 1

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)
