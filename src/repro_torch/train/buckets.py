"""Gradient bucketing: pack ZeRO-sharded leaves into flat wire buckets.

Port of ``repro.train.buckets``.  A bucket is a flat vector of ``n_dp``
equal rows; row ``r`` concatenates, over the bucket's leaves, the slice
rank ``r`` owns along each leaf's ``zero_dim``.  One flat reduce-scatter
hands rank ``r`` exactly row ``r``, bitwise what the per-leaf dim-general
reduce-scatter gives it.  The plan depends only on static shapes: leaves
are numbered in ``jax.tree.flatten`` order (``repro_torch.tree``), sorted by
(size desc, index), and packed first-fit into buckets of one dtype.

Under tensor parallelism the plan is the reference's, made from the
global leaves; each TP rank packs its own shard of every leaf into its
column of the bucket (:func:`local_plan`): column t's block r holds the
elements of the reference's row r that rank t holds, in the row's
order, so each element is reduced in its reference block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import torch

from repro_torch import tree as T


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the reference's dtype names)."""
    return str(dtype).replace("torch.", "")


@dataclass(frozen=True)
class LeafSlot:
    """One leaf's position inside a bucket (all units are ELEMENTS)."""
    index: int                 # position in the flattened param tree
    shape: Tuple[int, ...]     # full (global) leaf shape
    zero_dim: int              # ZeRO dim, >= 0 for every bucketed leaf
    offset: int                # start of this leaf's span in a bucket ROW

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def row_elems(self, n_dp: int) -> int:
        return self.size // n_dp

    def shard_shape(self, n_dp: int) -> Tuple[int, ...]:
        s = list(self.shape)
        s[self.zero_dim] //= n_dp
        return tuple(s)


@dataclass(frozen=True)
class Bucket:
    """A group of leaves reduced/gathered with one flat collective."""
    bid: int
    dtype: str                 # param dtype of every member (allgather wire)
    slots: Tuple[LeafSlot, ...]
    row_elems: int             # per-rank elements = sum of slot row_elems

    def nbytes(self, itemsize: float, n_dp: int) -> int:
        """Full-vector payload in bytes of an ``itemsize``-wide wire dtype
        (fractional for int8: its scales ride along), rounded up."""
        return int(math.ceil(self.row_elems * n_dp * itemsize))


@dataclass(frozen=True)
class BucketPlan:
    n_dp: int
    capacity_bytes: int
    wire_itemsize: float
    buckets: Tuple[Bucket, ...]
    replicated: Tuple[int, ...]  # leaf indices with zero_dim < 0


def plan_buckets(params_shapes: Any, layout: Any, n_dp: int,
                 capacity_bytes: int, wire_itemsize: float) -> BucketPlan:
    """Greedy first-fit-decreasing packing of the ZeRO-sharded leaves; a
    leaf larger than the capacity opens its own (over-full) bucket."""
    flat_leaves = T.flatten(params_shapes)
    flat_zd = T.flatten(layout)
    if len(flat_leaves) != len(flat_zd):
        raise ValueError("layout must mirror params")

    replicated: List[int] = []
    sharded: List[Tuple[int, Any, int]] = []
    for i, (leaf, zd) in enumerate(zip(flat_leaves, flat_zd)):
        if zd < 0:
            replicated.append(i)
        else:
            if leaf.shape[zd] % n_dp:
                raise ValueError((tuple(leaf.shape), zd, n_dp))
            sharded.append((i, leaf, zd))

    cap_elems = int(capacity_bytes / wire_itemsize) if capacity_bytes > 0 \
        else None
    order = sorted(sharded, key=lambda t: (-math.prod(t[1].shape), t[0]))

    opened: List[list] = []   # [dtype, used_full_elems, [(i, leaf, zd)]]
    for i, leaf, zd in order:
        size = math.prod(leaf.shape)
        dt = dtype_name(leaf.dtype)
        for b in opened:
            if b[0] != dt:
                continue
            if cap_elems is not None and b[1] + size > cap_elems and b[1] > 0:
                continue
            b[1] += size
            b[2].append((i, leaf, zd))
            break
        else:
            opened.append([dt, size, [(i, leaf, zd)]])

    buckets: List[Bucket] = []
    for bid, (dt, _, members) in enumerate(opened):
        off = 0
        slots = []
        for i, leaf, zd in members:
            slots.append(LeafSlot(index=i, shape=tuple(leaf.shape),
                                  zero_dim=zd, offset=off))
            off += math.prod(leaf.shape) // n_dp
        buckets.append(Bucket(bid=bid, dtype=dt, slots=tuple(slots),
                              row_elems=off))
    return BucketPlan(n_dp=n_dp, capacity_bytes=capacity_bytes,
                      wire_itemsize=wire_itemsize, buckets=tuple(buckets),
                      replicated=tuple(replicated))


# ---------------------------------------------------------------------------
# Pack / unpack (pure layout, no arithmetic).  One rank's leaves, as in the
# reference; ``shard_views`` and ``pack_shards`` also take leading dims, so
# the stacked step runs them over all ranks' rows at once.
# ---------------------------------------------------------------------------

def _leaf_rows(x, zero_dim: int, n_dp: int, lead: int = 0):
    """[*lead, d0,..,p*k @zd,..] -> [*lead, p, size/p]: row r = flat
    slice r along zd."""
    zd = zero_dim + lead
    k = x.shape[zd] // n_dp
    split = tuple(x.shape[:zd]) + (n_dp, k) + tuple(x.shape[zd + 1:])
    return torch.movedim(x.reshape(split), zd, lead).reshape(
        tuple(x.shape[:lead]) + (n_dp, -1))


def _rows_to_leaf(rows, slot: LeafSlot, n_dp: int, lead: int = 0):
    """Inverse of ``_leaf_rows``: [*lead, p, size/p] -> the full leaf."""
    ld = tuple(rows.shape[:lead])
    seg = rows.reshape(ld + (n_dp,) + slot.shard_shape(n_dp))
    return torch.movedim(seg, lead, lead + slot.zero_dim).reshape(
        ld + slot.shape)


def pack_bucket(bucket: Bucket, leaves: Sequence[Any], n_dp: int,
                lead: int = 0):
    """Full leaves (bucket order) -> the flat bucket vector, length
    ``n_dp * bucket.row_elems``; block ``r`` is the row rank ``r`` owns.
    ``lead`` leading dims (the stacked TP ranks) are kept."""
    rows = [_leaf_rows(x, s.zero_dim, n_dp, lead)
            for x, s in zip(leaves, bucket.slots)]
    full = rows[0] if len(rows) == 1 else torch.cat(rows, dim=lead + 1)
    return full.reshape(tuple(full.shape[:lead]) + (-1,))


def shard_views(bucket: Bucket, shard, n_dp: int):
    """Reduced row(s) ``[..., row_elems]`` -> per-leaf shard views
    ``[..., *shard_shape]``."""
    lead = tuple(shard.shape[:-1])
    return [shard[..., s.offset:s.offset + s.row_elems(n_dp)]
            .reshape(lead + s.shard_shape(n_dp)) for s in bucket.slots]


def pack_shards(bucket: Bucket, shards: Sequence[Any], lead: int = 0):
    """Per-leaf shards (bucket order) -> one flat row (the AG input).
    ``lead`` leading dims (the stacked rank axis) are kept."""
    flats = [x.reshape(tuple(x.shape[:lead]) + (-1,)) for x in shards]
    if len(flats) == 1:
        return flats[0]
    return torch.cat(flats, dim=-1)


def unpack_bucket(bucket: Bucket, full, n_dp: int, lead: int = 0):
    """Flat allgather output (rank-order rows) -> full leaves, exactly.
    ``lead`` leading dims (the stacked TP ranks) are kept."""
    ld = tuple(full.shape[:lead])
    rows = full.reshape(ld + (n_dp, bucket.row_elems))
    return [_rows_to_leaf(rows[..., s.offset:s.offset + s.row_elems(n_dp)],
                          s, n_dp, lead) for s in bucket.slots]


# ---------------------------------------------------------------------------
# Tensor parallelism: each TP rank's column of the reference's buckets
# ---------------------------------------------------------------------------

def local_plan(plan: BucketPlan, local_shapes: Sequence[Tuple[int, ...]]
               ) -> BucketPlan:
    """``plan``'s buckets over one TP rank's leaves: the same slots, zero
    dims and order, each slot ``local_shapes[index]`` (the rank's shard),
    the offsets packed anew.  ``pack_bucket`` with it gives the rank's
    column of the bucket."""
    out = []
    for b in plan.buckets:
        off, slots = 0, []
        for s in b.slots:
            ls = LeafSlot(index=s.index, shape=tuple(local_shapes[s.index]),
                          zero_dim=s.zero_dim, offset=off)
            slots.append(ls)
            off += ls.row_elems(plan.n_dp)
        out.append(Bucket(bid=b.bid, dtype=b.dtype, slots=tuple(slots),
                          row_elems=off))
    return BucketPlan(n_dp=plan.n_dp, capacity_bytes=plan.capacity_bytes,
                      wire_itemsize=plan.wire_itemsize, buckets=tuple(out),
                      replicated=plan.replicated)
