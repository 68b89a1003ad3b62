"""Composable communication-schedule IR (paper Sec. 4) for every algorithm.

A ``Schedule`` is an immutable sequence of steps; each step is a tuple of
``Msg`` records ``(src, dst, blocks)`` plus a per-step *kind* telling every
consumer how the payload transforms buffer state:

  kind        src after send       dst on receive
  "reduce"    deletes the blocks   accumulates (must already hold them)
  "copy"      keeps the blocks     installs (values must agree if held)
  "move"      deletes the blocks   installs

``blocks`` is the ordered tuple of vector-block indices carried by the
message (block = 1/p of the vector for most collectives; for
broadcast/reduce "small" the whole vector is ``(BLOCK_ALL,)`` and counts
as p pseudo-blocks for byte accounting — see ``Msg.nblocks``).

Generators *produce* Schedule values:
  trees       : bine_dh | bine_dd | binomial_dh | binomial_dd
  butterflies : bine_dh | bine_dd | recdoub_dh | recdoub_dd
  linear      : ring, bruck (alltoall baseline; any rank count)

Combinators *transform* them:
  * ``compose(collective, tiers, ...)`` — arbitrary-depth hierarchical
    schedules.  Tier j (innermost first) runs the flat generator inside
    every radix-``tiers[j]`` subgroup, lifted onto the global rank/block
    digit space; ``bine_hier`` is the depth-2 special case.
  * non-pow2 adapters — proxy-rank *folding* (each extra rank folds onto
    a pow2-core proxy) and *3-2 elimination* (one rank per triple retires
    after a two-step pre-reduction, rejoining at the end) wrap any pow2
    generator so every registered (collective, algo) pair passes the
    oracle at arbitrary ``p``.

These schedules are consumed by
  * core.simulate   — numpy execution + oracle checks (kind-driven),
  * core.traffic    — per-link / global-link byte counting,
  * tuner.trace     — per-link replay counters,
  * collectives.shmap — baked in as static ppermute step tables.

The PyTorch port's own copy of ``repro.core.schedules``; in the port the
stacked executor (``collectives.stacked``) bakes them in through
``core.tables``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

from . import butterflies as bf
from . import trees as tr
from .negabinary import log2_int

BLOCK_ALL = -1  # sentinel: message carries the full vector

#: per-step kinds (see module docstring for the buffer semantics)
KIND_REDUCE = "reduce"
KIND_COPY = "copy"
KIND_MOVE = "move"
KINDS = (KIND_REDUCE, KIND_COPY, KIND_MOVE)


@dataclass(frozen=True)
class Msg:
    src: int
    dst: int
    blocks: Tuple[int, ...]  # ordered block ids; (BLOCK_ALL,) = whole vector

    def nblocks(self, p: int) -> int:
        if self.blocks == (BLOCK_ALL,):
            return p
        return len(self.blocks)


Step = List[Msg]
Sched = List[Step]  # legacy alias: anything iterable as steps-of-Msg


@dataclass(frozen=True)
class Schedule:
    """The schedule IR value: steps + per-step kinds (+ provenance).

    Behaves as a read-only sequence of steps so every pre-IR consumer
    (``for step in sched``, ``len(sched)``, ``sched[i]``) keeps working;
    ``+`` concatenates phases (reduce_scatter + allgather = allreduce).
    """

    steps: Tuple[Tuple[Msg, ...], ...]
    kinds: Tuple[str, ...]
    collective: str = ""
    p: int = 0
    root: int = 0

    def __post_init__(self):
        if len(self.steps) != len(self.kinds):
            raise ValueError(
                f"{len(self.steps)} steps but {len(self.kinds)} kinds")
        bad = set(self.kinds) - set(KINDS)
        if bad:
            raise ValueError(f"unknown step kinds {sorted(bad)}")

    def __len__(self) -> int:
        return len(self.steps)

    def __iter__(self):
        return iter(self.steps)

    def __getitem__(self, i):
        return self.steps[i]

    def __bool__(self) -> bool:
        return bool(self.steps)

    def __add__(self, other: "Schedule") -> "Schedule":
        if not isinstance(other, Schedule):
            return NotImplemented
        if self.p and other.p and self.p != other.p:
            raise ValueError(f"cannot concatenate schedules for p={self.p} "
                             f"and p={other.p}")
        return Schedule(
            steps=self.steps + other.steps,
            kinds=self.kinds + other.kinds,
            collective=(self.collective
                        if self.collective == other.collective else ""),
            p=self.p or other.p,
            root=self.root if self.root == other.root else 0)


def _sched(steps: Sequence[Sequence[Msg]], kinds, collective: str = "",
           p: int = 0, root: int = 0) -> Schedule:
    steps_t = tuple(tuple(s) for s in steps)
    if isinstance(kinds, str):
        kinds = (kinds,) * len(steps_t)
    return Schedule(steps_t, tuple(kinds), collective, p, root)


def step_kinds(sched, default: str) -> Tuple[str, ...]:
    """Per-step kinds of ``sched``; plain step lists get ``default``."""
    kinds = getattr(sched, "kinds", None)
    if kinds is None:
        kinds = (default,) * len(sched)
    return tuple(kinds)


def _is_pow2(p: int) -> bool:
    return p > 0 and p & (p - 1) == 0


def _fold_q(p: int) -> int:
    """Largest power of two <= p (the pow2 core the adapters wrap)."""
    return 1 << (p.bit_length() - 1)


# ---------------------------------------------------------------------------
# Broadcast / Reduce (small vectors): plain trees (paper Sec. 4.5)
# ---------------------------------------------------------------------------

def broadcast_sched(algo: str, p: int, root: int = 0) -> Schedule:
    tree = tr.rotate_schedule(tr.TREES[algo](p), root, p)
    return _sched([[Msg(a, b, (BLOCK_ALL,)) for a, b in step]
                   for step in tree], KIND_COPY, "broadcast", p, root)


def reduce_sched(algo: str, p: int, root: int = 0) -> Schedule:
    """Reduce = time-reversed broadcast; each edge flows child -> parent."""
    tree = tr.rotate_schedule(tr.TREES[algo](p), root, p)
    return _sched([[Msg(b, a, (BLOCK_ALL,)) for a, b in step]
                   for step in reversed(tree)], KIND_REDUCE, "reduce", p, root)


# ---------------------------------------------------------------------------
# Gather / Scatter: trees with per-subtree block sets (paper Sec. 4.1/4.2)
# ---------------------------------------------------------------------------

def gather_sched(algo: str, p: int, root: int = 0) -> Schedule:
    """Each rank forwards its whole accumulated subtree to its parent.

    Accumulated sets are replayed exactly (order preserved mod-p contiguous
    for bine_dh / binomial trees, per paper Sec. 4.1).
    """
    tree = tr.TREES[algo](p)
    held: List[List[int]] = [[r] for r in range(p)]
    steps: List[Step] = []
    for step in reversed(tree):
        msgs: Step = []
        for parent, child in step:
            msgs.append(Msg(child, parent, tuple(held[child])))
            held[parent] = _merge_mod_contig(held[parent], held[child], p)
        steps.append(msgs)
    assert sorted(held[0]) == list(range(p))
    return _rotate_msgs(_sched(steps, KIND_MOVE, "gather", p), root, p)


def scatter_sched(algo: str, p: int, root: int = 0) -> Schedule:
    """Scatter = time-reversed gather: parent sends child's subtree blocks."""
    g = gather_sched(algo, p, 0)
    steps = [[Msg(m.dst, m.src, m.blocks) for m in step]
             for step in reversed(g.steps)]
    return _rotate_msgs(_sched(steps, KIND_MOVE, "scatter", p), root, p)


def _merge_mod_contig(a: List[int], b: List[int], p: int) -> List[int]:
    """Merge two block lists, keeping mod-p contiguous order when possible."""
    if (a[-1] + 1) % p == b[0] % p:
        return a + b
    if (b[-1] + 1) % p == a[0] % p:
        return b + a
    return a + b  # non-contiguous (bine_dd subtrees) — order by arrival


def _rotate_msgs(sched: Schedule, root: int, p: int) -> Schedule:
    if root % p == 0:
        return sched
    steps = [
        [
            Msg((m.src + root) % p, (m.dst + root) % p,
                tuple((blk + root) % p for blk in m.blocks)
                if m.blocks != (BLOCK_ALL,) else m.blocks)
            for m in step
        ]
        for step in sched.steps
    ]
    return _sched(steps, sched.kinds, sched.collective, p, root)


# ---------------------------------------------------------------------------
# Reduce-scatter / Allgather: vector-halving/-doubling butterflies (Sec. 4.3)
# ---------------------------------------------------------------------------

def reduce_scatter_sched(algo: str, p: int) -> Schedule:
    """Vector-halving butterfly RS.  At step i, r sends the partial sums of
    every block in its partner's next-level cone.

    Result: rank r holds the full sum of block ``final_block(algo)[r]``
    (identity block only after the Sec. 4.3.1 contiguity permutation).
    """
    s = log2_int(p)
    tab = bf.partner_table(algo, p)
    cs = bf.cones(algo, p)
    steps: List[Step] = []
    for i in range(s):
        msgs: Step = []
        for r in range(p):
            q = int(tab[i, r])
            msgs.append(Msg(r, q, tuple(sorted(cs[i + 1][q]))))
        steps.append(msgs)
    return _sched(steps, KIND_REDUCE, "reduce_scatter", p)


def allgather_sched(algo: str, p: int) -> Schedule:
    """Vector-doubling butterfly AG: r sends every block it has accumulated."""
    s = log2_int(p)
    tab = bf.partner_table(algo, p)
    held: List[List[int]] = [[r] for r in range(p)]
    steps: List[Step] = []
    for i in range(s):
        msgs: Step = []
        snapshot = [list(x) for x in held]
        for r in range(p):
            q = int(tab[i, r])
            assert not set(snapshot[r]) & set(snapshot[q]), (
                algo, p, i, r, "allgather exchange would duplicate blocks")
            msgs.append(Msg(r, q, tuple(snapshot[r])))
        for r in range(p):
            held[r] = snapshot[r] + snapshot[int(tab[i, r])]
        steps.append(msgs)
    for r in range(p):
        assert sorted(held[r]) == list(range(p))
    return _sched(steps, KIND_COPY, "allgather", p)


def allreduce_large_sched(algo_rs: str, algo_ag: str, p: int) -> Schedule:
    """Large-vector allreduce = RS (distance-doubling) + AG (distance-halving).

    Block bookkeeping: the AG must redistribute exactly the blocks the RS
    left behind, so its per-step block sets are the RS cones replayed
    forward.  (paper Sec. 4.4)
    """
    # Block-exact view: the RS leaves rank r holding the full sum of block r
    # (message *contents* may be non-contiguous in buffer space — that is the
    # Sec. 4.3.1 permutation's job, handled positionally in collectives.shmap).
    return reduce_scatter_sched(algo_rs, p) + allgather_sched(algo_ag, p)


def allreduce_small_sched(algo: str, p: int) -> Schedule:
    """Small-vector allreduce: recursive doubling, full vector each step."""
    s = log2_int(p)
    tab = bf.partner_table(algo, p)
    steps = [
        [Msg(r, int(tab[i, r]), (BLOCK_ALL,)) for r in range(p)]
        for i in range(s)
    ]
    return _sched(steps, KIND_REDUCE, "allreduce", p)


# ---------------------------------------------------------------------------
# Alltoall: butterfly-routed (Bruck-like, paper Sec. 4.4)
# ---------------------------------------------------------------------------

def alltoall_sched(algo: str, p: int) -> Schedule:
    """Each rank starts with p blocks (one per destination).  At step i it
    forwards to its partner every block whose *destination* lies in the
    partner's next-level cone.  Every block reaches its destination after
    s steps; each step moves exactly p/2 blocks per rank (n/2 bytes).
    """
    s = log2_int(p)
    tab = bf.partner_table(algo, p)
    cs = bf.cones(algo, p)
    # held[r] = list of (dest, origin) pairs currently buffered at r
    held: List[List[Tuple[int, int]]] = [
        [(d, r) for d in range(p)] for r in range(p)
    ]
    steps: List[Step] = []
    for i in range(s):
        msgs: Step = []
        moved: List[List[Tuple[int, int]]] = [[] for _ in range(p)]
        kept: List[List[Tuple[int, int]]] = [[] for _ in range(p)]
        for r in range(p):
            q = int(tab[i, r])
            qcone = cs[i + 1][q]
            send = [x for x in held[r] if x[0] in qcone]
            keep = [x for x in held[r] if x[0] not in qcone]
            # encode (dest, origin) pairs as dest*p + origin (uniform n/p size)
            msgs.append(Msg(r, q, tuple(d * p + o for d, o in send)))
            moved[q].extend(send)
            kept[r] = keep
        for r in range(p):
            held[r] = kept[r] + moved[r]
        steps.append(msgs)
    for r in range(p):
        assert sorted(d for d, _ in held[r]) == [r] * p
        assert sorted(o for _, o in held[r]) == list(range(p))
    return _sched(steps, KIND_MOVE, "alltoall", p)


def bruck_alltoall_sched(p: int) -> Schedule:
    """Classical Bruck alltoall baseline: step i sends, to rank r - 2**i,
    every block whose relative destination distance has bit i set.

    Defined for any rank count: the remaining travel distance
    ``(r - dest) mod p`` is < p, so its ceil(log2 p) bits route every
    block — each hop of -2**i clears bit i exactly (no carries), which
    is what makes the construction rank-count agnostic.  Ranks with no
    bit-i blocks just skip step i.
    """
    s = (p - 1).bit_length()
    held: List[List[Tuple[int, int]]] = [
        [(d, r) for d in range(p)] for r in range(p)
    ]
    steps: List[Step] = []
    for i in range(s):
        msgs: Step = []
        moved: List[List[Tuple[int, int]]] = [[] for _ in range(p)]
        kept: List[List[Tuple[int, int]]] = [[] for _ in range(p)]
        for r in range(p):
            q = (r - (1 << i)) % p
            send = [x for x in held[r] if ((r - x[0]) % p) >> i & 1]
            keep = [x for x in held[r] if not ((r - x[0]) % p) >> i & 1]
            if send:
                msgs.append(Msg(r, q, tuple(d * p + o for d, o in send)))
            moved[q].extend(send)
            kept[r] = keep
        for r in range(p):
            held[r] = kept[r] + moved[r]
        if msgs:
            steps.append(msgs)
    for r in range(p):
        assert sorted(d for d, _ in held[r]) == [r] * p
    return _sched(steps, KIND_MOVE, "alltoall", p)


# ---------------------------------------------------------------------------
# Ring baselines (defined for any rank count)
# ---------------------------------------------------------------------------

def ring_reduce_scatter_sched(p: int) -> Schedule:
    """p-1 steps; step t: rank r sends partial block (r-t-1) mod p to r+1.

    Block b hops b+1 → b+2 → … → b, accumulating every contribution, so
    rank r ends holding the full sum of its own block r.
    """
    steps = [[Msg(r, (r + 1) % p, ((r - t - 1) % p,)) for r in range(p)]
             for t in range(p - 1)]
    return _sched(steps, KIND_REDUCE, "reduce_scatter", p)


def ring_allgather_sched(p: int) -> Schedule:
    steps = [[Msg(r, (r + 1) % p, ((r - t) % p,)) for r in range(p)]
             for t in range(p - 1)]
    return _sched(steps, KIND_COPY, "allgather", p)


def ring_allreduce_sched(p: int) -> Schedule:
    """Ring RS + ring AG (2(p-1) steps)."""
    return ring_reduce_scatter_sched(p) + ring_allgather_sched(p)


# ---------------------------------------------------------------------------
# Composite large-vector bcast / reduce (paper Sec. 4.5)
# ---------------------------------------------------------------------------

def broadcast_large_sched(family: str, p: int, root: int = 0) -> Schedule:
    """scatter (distance-doubling tree) + allgather (distance-halving bfly)."""
    if family == "bine":
        sc = _np2_scatter("bine_dd", p, root)
        ag = _np2_allgather("bine_dh", p)
    else:
        sc = _np2_scatter("binomial_dh", p, root)   # MPICH-style
        ag = _np2_allgather("recdoub_dd", p)
    return sc + ag


def reduce_large_sched(family: str, p: int, root: int = 0) -> Schedule:
    """reduce-scatter (distance-doubling bfly) + gather (dist-halving tree)."""
    if family == "bine":
        rs = _np2_reduce_scatter("bine_dd", p)
        ga = _np2_gather("bine_dh", p, root)
    else:
        rs = _np2_reduce_scatter("recdoub_dd", p)
        ga = _np2_gather("binomial_dh", p, root)
    return rs + ga


# ---------------------------------------------------------------------------
# Non-pow2 adapters: proxy-rank folding and 3-2 elimination
# ---------------------------------------------------------------------------
#
# Folding: extras e_k = q + k (k < rem, q = 2**floor(log2 p)) fold their
# contribution onto proxy rank k before a pow2 schedule over ranks 0..q-1,
# and receive their result afterwards.  Virtual block k expands to the real
# block set {k, q+k}; every other virtual block is itself.
#
# 3-2 elimination (butterfly collectives, needs 3*rem <= p): rank c = 3k+2
# of each triple (3k, 3k+1, 3k+2) pre-reduces one half of the vector onto
# each surviving neighbor over two steps, sits out the pow2 core over the
# q survivors, and rejoins at the end.  Max pre/post message is n/2 vs the
# fold's full-vector n.

def _fold_blocks(p: int) -> Callable[[int], Tuple[int, ...]]:
    q = _fold_q(p)
    rem = p - q
    def blocks_of(vb: int) -> Tuple[int, ...]:
        return (vb, q + vb) if vb < rem else (vb,)
    return blocks_of


def _elim_maps(p: int):
    q = _fold_q(p)
    rem = p - q
    gone = tuple(3 * k + 2 for k in range(rem))
    gset = set(gone)
    surv = tuple(r for r in range(p) if r not in gset)
    def blocks_of(w: int) -> Tuple[int, ...]:
        r = surv[w]
        if r % 3 == 0 and r // 3 < rem:
            return (r, r + 2)
        return (r,)
    return q, rem, surv, blocks_of


def _lift(sched: Schedule, rank_of: Callable[[int], int],
          blocks_of: Callable[[int], Tuple[int, ...]]):
    """Relabel a virtual schedule onto real ranks/blocks."""
    steps = []
    for step in sched.steps:
        out = []
        for m in step:
            blocks = (m.blocks if m.blocks == (BLOCK_ALL,) else
                      tuple(b for vb in m.blocks for b in blocks_of(vb)))
            out.append(Msg(rank_of(m.src), rank_of(m.dst), blocks))
        steps.append(out)
    return steps, list(sched.kinds)


def _halves(p: int):
    return tuple(range(p // 2)), tuple(range(p // 2, p))


def _fold_reduce_scatter(build, p: int) -> Schedule:
    q = _fold_q(p)
    rem = p - q
    steps, kinds = _lift(build(q), lambda r: r, _fold_blocks(p))
    pre = [Msg(q + k, k, tuple(range(p))) for k in range(rem)]
    post = [Msg(k, q + k, (q + k,)) for k in range(rem)]
    return _sched([pre] + steps + [post],
                  [KIND_REDUCE] + kinds + [KIND_MOVE], "reduce_scatter", p)


def _elim_reduce_scatter(build, p: int) -> Schedule:
    q, rem, surv, blocks_of = _elim_maps(p)
    steps, kinds = _lift(build(q), lambda w: surv[w], blocks_of)
    h1, h2 = _halves(p)
    pre1 = [Msg(3 * k + 2, 3 * k + 1, h1) for k in range(rem)]
    pre2 = [Msg(3 * k + 2, 3 * k, h2) for k in range(rem)]
    post = [Msg(3 * k, 3 * k + 2, (3 * k + 2,)) for k in range(rem)]
    return _sched([pre1, pre2] + steps + [post],
                  [KIND_REDUCE, KIND_REDUCE] + kinds + [KIND_MOVE],
                  "reduce_scatter", p)


def _fold_allgather(build, p: int) -> Schedule:
    q = _fold_q(p)
    rem = p - q
    steps, kinds = _lift(build(q), lambda r: r, _fold_blocks(p))
    pre = [Msg(q + k, k, (q + k,)) for k in range(rem)]
    post = [Msg(k, q + k, tuple(range(p))) for k in range(rem)]
    return _sched([pre] + steps + [post],
                  [KIND_COPY] + kinds + [KIND_COPY], "allgather", p)


def _elim_allgather(build, p: int) -> Schedule:
    q, rem, surv, blocks_of = _elim_maps(p)
    steps, kinds = _lift(build(q), lambda w: surv[w], blocks_of)
    h1, h2 = _halves(p)
    pre = [Msg(3 * k + 2, 3 * k, (3 * k + 2,)) for k in range(rem)]
    post1 = [Msg(3 * k + 1, 3 * k + 2, h1) for k in range(rem)]
    post2 = [Msg(3 * k, 3 * k + 2, h2) for k in range(rem)]
    return _sched([pre] + steps + [post1, post2],
                  [KIND_COPY] + kinds + [KIND_COPY, KIND_COPY],
                  "allgather", p)


def _fold_allreduce(build, p: int) -> Schedule:
    q = _fold_q(p)
    rem = p - q
    steps, kinds = _lift(build(q), lambda r: r, _fold_blocks(p))
    pre = [Msg(q + k, k, tuple(range(p))) for k in range(rem)]
    post = [Msg(k, q + k, tuple(range(p))) for k in range(rem)]
    return _sched([pre] + steps + [post],
                  [KIND_REDUCE] + kinds + [KIND_COPY], "allreduce", p)


def _elim_allreduce(build, p: int) -> Schedule:
    q, rem, surv, blocks_of = _elim_maps(p)
    steps, kinds = _lift(build(q), lambda w: surv[w], blocks_of)
    h1, h2 = _halves(p)
    pre1 = [Msg(3 * k + 2, 3 * k + 1, h1) for k in range(rem)]
    pre2 = [Msg(3 * k + 2, 3 * k, h2) for k in range(rem)]
    post1 = [Msg(3 * k + 1, 3 * k + 2, h1) for k in range(rem)]
    post2 = [Msg(3 * k, 3 * k + 2, h2) for k in range(rem)]
    return _sched([pre1, pre2] + steps + [post1, post2],
                  [KIND_REDUCE, KIND_REDUCE] + kinds
                  + [KIND_COPY, KIND_COPY], "allreduce", p)


def _adapt(fold, elim, build, p: int) -> Schedule:
    """Route a pow2 ``build`` through the cheapest applicable adapter."""
    if _is_pow2(p):
        return build(p)
    rem = p - _fold_q(p)
    if elim is not None and 3 * rem <= p:
        return elim(build, p)
    return fold(build, p)


def _np2_reduce_scatter(kind: str, p: int) -> Schedule:
    return _adapt(_fold_reduce_scatter, _elim_reduce_scatter,
                  lambda q: reduce_scatter_sched(kind, q), p)


def _np2_allgather(kind: str, p: int) -> Schedule:
    return _adapt(_fold_allgather, _elim_allgather,
                  lambda q: allgather_sched(kind, q), p)


def _np2_allreduce_large(kind_rs: str, kind_ag: str, p: int) -> Schedule:
    return _adapt(_fold_allreduce, _elim_allreduce,
                  lambda q: allreduce_large_sched(kind_rs, kind_ag, q), p)


def _np2_allreduce_small(kind: str, p: int) -> Schedule:
    if _is_pow2(p):
        return allreduce_small_sched(kind, p)
    q = _fold_q(p)
    rem = p - q
    steps, kinds = _lift(allreduce_small_sched(kind, q),
                         lambda r: r, lambda vb: (vb,))
    pre = [Msg(q + k, k, (BLOCK_ALL,)) for k in range(rem)]
    post = [Msg(k, q + k, (BLOCK_ALL,)) for k in range(rem)]
    return _sched([pre] + steps + [post],
                  [KIND_REDUCE] + kinds + [KIND_COPY], "allreduce", p)


def _np2_broadcast(kind: str, p: int, root: int) -> Schedule:
    if _is_pow2(p):
        return broadcast_sched(kind, p, root)
    q = _fold_q(p)
    rem = p - q
    base = broadcast_sched(kind, q, 0)
    post = [Msg(k, q + k, (BLOCK_ALL,)) for k in range(rem)]
    out = _sched(list(base.steps) + [post],
                 list(base.kinds) + [KIND_COPY], "broadcast", p)
    return _rotate_msgs(out, root, p)


def _np2_reduce(kind: str, p: int, root: int) -> Schedule:
    if _is_pow2(p):
        return reduce_sched(kind, p, root)
    q = _fold_q(p)
    rem = p - q
    base = reduce_sched(kind, q, 0)
    pre = [Msg(q + k, k, (BLOCK_ALL,)) for k in range(rem)]
    out = _sched([pre] + list(base.steps),
                 [KIND_REDUCE] + list(base.kinds), "reduce", p)
    return _rotate_msgs(out, root, p)


def _np2_gather(kind: str, p: int, root: int) -> Schedule:
    if _is_pow2(p):
        return gather_sched(kind, p, root)
    q = _fold_q(p)
    rem = p - q
    steps, kinds = _lift(gather_sched(kind, q, 0),
                         lambda r: r, _fold_blocks(p))
    pre = [Msg(q + k, k, (q + k,)) for k in range(rem)]
    out = _sched([pre] + steps, [KIND_MOVE] + kinds, "gather", p)
    return _rotate_msgs(out, root, p)


def _np2_scatter(kind: str, p: int, root: int) -> Schedule:
    if _is_pow2(p):
        return scatter_sched(kind, p, root)
    q = _fold_q(p)
    rem = p - q
    steps, kinds = _lift(scatter_sched(kind, q, 0),
                         lambda r: r, _fold_blocks(p))
    post = [Msg(k, q + k, (q + k,)) for k in range(rem)]
    out = _sched(steps + [post], kinds + [KIND_MOVE], "scatter", p)
    return _rotate_msgs(out, root, p)


def _np2_alltoall(kind: str, p: int) -> Schedule:
    """Fold alltoall: (dest, origin) keys lift through {v, q+v} on both
    axes; extras hand their whole buffer to the proxy first and receive
    every pair addressed to them at the end."""
    if _is_pow2(p):
        return alltoall_sched(kind, p)
    q = _fold_q(p)
    rem = p - q
    def reps(v: int) -> Tuple[int, ...]:
        return (v, q + v) if v < rem else (v,)
    virt = alltoall_sched(kind, q)
    steps = []
    for step in virt.steps:
        out = []
        for m in step:
            blocks = tuple(d * p + o for key in m.blocks
                           for d in reps(key // q) for o in reps(key % q))
            out.append(Msg(m.src, m.dst, blocks))
        steps.append(out)
    pre = [Msg(q + k, k, tuple(d * p + (q + k) for d in range(p)))
           for k in range(rem)]
    post = [Msg(k, q + k, tuple((q + k) * p + o for o in range(p)))
            for k in range(rem)]
    return _sched([pre] + steps + [post], KIND_MOVE, "alltoall", p)


# ---------------------------------------------------------------------------
# compose: arbitrary-depth hierarchical schedules (the bine_hier combinator)
# ---------------------------------------------------------------------------

#: compose-able collectives (butterfly family; rooted trees are flat)
COMPOSABLE = ("reduce_scatter", "allgather", "allreduce")


def _tier_schedule(collective: str, algo: str, pt: int) -> Schedule:
    """Flat tier schedule at radix ``pt`` (non-pow2 tiers route through
    the adapters, so mixed-radix hierarchies compose too)."""
    if collective == "reduce_scatter":
        if algo == "ring":
            return ring_reduce_scatter_sched(pt)
        return _np2_reduce_scatter(f"{algo}_dd", pt)
    if collective == "allgather":
        if algo == "ring":
            return ring_allgather_sched(pt)
        return _np2_allgather(f"{algo}_dh", pt)
    raise ValueError(f"no tier schedule for {collective!r}")


def _compose_steps(collective: str, tiers: Tuple[int, ...], algo: str):
    """Lift the flat tier-``j`` schedule onto the global digit space.

    Ranks and blocks share one mixed-radix numeral system: digit j of
    rank r has stride ``prod(tiers[:j])`` (innermost tier = digit 0, so
    consecutive ranks share the innermost subgroup).  Phase j runs the
    flat schedule over digit j inside every subgroup (= fixed assignment
    of the other digits); virtual block vb expands to every block whose
    digit j is vb, whose digits < j match the subgroup, and whose digits
    > j are free — the phases already run settled those, the later phases
    will fan the rest out.  RS runs phases innermost→outermost; AG is the
    mirror.  Each lifted step is a union of per-subgroup partial
    permutations over disjoint rank sets, so it is itself a valid step.
    """
    d = len(tiers)
    strides, acc = [], 1
    for t in tiers:
        strides.append(acc)
        acc *= t
    order = range(d) if collective == "reduce_scatter" else range(d - 1, -1, -1)
    steps, kinds = [], []
    for j in order:
        pt = tiers[j]
        if pt == 1:
            continue
        virt = _tier_schedule(collective, algo, pt)
        stride = strides[j]
        free = [0]
        for i in range(j + 1, d):
            free = [f + c * strides[i] for f in free for c in range(tiers[i])]
        # (rank offset, block low-digit offset) per subgroup
        combos = [(0, 0)]
        for i in range(d):
            if i == j:
                continue
            combos = [(tot + c * strides[i],
                       low + (c * strides[i] if i < j else 0))
                      for tot, low in combos for c in range(tiers[i])]
        for step, kind in zip(virt.steps, virt.kinds):
            real = []
            for tot, low in combos:
                for m in step:
                    assert BLOCK_ALL not in m.blocks
                    blocks = tuple(low + vb * stride + off
                                   for vb in m.blocks for off in free)
                    real.append(Msg(tot + m.src * stride,
                                    tot + m.dst * stride, blocks))
            steps.append(real)
            kinds.append(kind)
    return steps, kinds


def compose(collective: str, tiers: Sequence[int],
            algo: str = "bine") -> Schedule:
    """Hierarchical composition of flat generators over ``tiers``
    (innermost first): ``compose("allreduce", (inner, outer))`` is the
    two-level bine_hier; any depth works, and block ownership matches the
    flat schedule (rank r ends holding block r after reduce_scatter)."""
    tiers = tuple(int(t) for t in tiers)
    if not tiers or any(t < 1 for t in tiers):
        raise ValueError(f"tiers must be positive, got {tiers!r}")
    p = 1
    for t in tiers:
        p *= t
    if collective == "allreduce":
        return (compose("reduce_scatter", tiers, algo)
                + compose("allgather", tiers, algo))
    if collective not in COMPOSABLE:
        raise ValueError(
            f"compose supports {COMPOSABLE}, not {collective!r}")
    steps, kinds = _compose_steps(collective, tiers, algo)
    return _sched(steps, kinds, collective, p)


def default_tiers(p: int) -> Tuple[int, ...]:
    """Topology-agnostic balanced two-tier pow2 split, innermost first
    (p=8 → (4, 2), p=16 → (4, 4)); presets refine this via
    ``repro.topology.tier_split``."""
    s = log2_int(p)
    inner = 1 << ((s + 1) // 2)
    return tuple(t for t in (inner, p // inner) if t > 1) or (p,)


def hier_schedule(collective: str, p: int, algo: str = "bine",
                  tiers: Sequence[int] = None) -> Schedule:
    """The registered ``bine_hier`` builder: ``compose`` over ``tiers``
    (default: ``default_tiers``), with non-pow2 ``p`` handled by wrapping
    the composed pow2-core schedule in the fold/elimination adapters."""
    if collective not in COMPOSABLE:
        raise ValueError(
            f"hier_schedule supports {COMPOSABLE}, not {collective!r}")
    if tiers is not None:
        return compose(collective, tiers, algo)
    build = lambda q: compose(collective, default_tiers(q), algo)
    fold, elim = {
        "reduce_scatter": (_fold_reduce_scatter, _elim_reduce_scatter),
        "allgather": (_fold_allgather, _elim_allgather),
        "allreduce": (_fold_allreduce, _elim_allreduce),
    }[collective]
    return _adapt(fold, elim, build, p)


# ---------------------------------------------------------------------------
# Registry: collective -> {algorithm-name -> schedule builder}
# ---------------------------------------------------------------------------

#: collective -> algo -> builder(p, root).  The module-level registry lets
#: tests enumerate every (collective, algo) pair (``list_algos``) so the
#: conformance matrix covers pairs added later automatically.  Every
#: builder accepts arbitrary p: pow2 builds are the flat generators,
#: anything else routes through the fold / 3-2 elimination adapters
#: (rings and bruck are rank-count agnostic natively).
_REGISTRY: Dict[str, Dict[str, Any]] = {
    "broadcast": {
        "bine": lambda p, root: _np2_broadcast("bine_dh", p, root),
        "binomial_dh": lambda p, root: _np2_broadcast("binomial_dh", p, root),
        "binomial_dd": lambda p, root: _np2_broadcast("binomial_dd", p, root),
        "bine_large": lambda p, root: broadcast_large_sched("bine", p, root),
        "binomial_large": lambda p, root: broadcast_large_sched("binomial", p, root),
    },
    "reduce": {
        "bine": lambda p, root: _np2_reduce("bine_dh", p, root),
        "binomial_dh": lambda p, root: _np2_reduce("binomial_dh", p, root),
        "binomial_dd": lambda p, root: _np2_reduce("binomial_dd", p, root),
        "bine_large": lambda p, root: reduce_large_sched("bine", p, root),
        "binomial_large": lambda p, root: reduce_large_sched("binomial", p, root),
    },
    "gather": {
        "bine": lambda p, root: _np2_gather("bine_dh", p, root),
        "binomial": lambda p, root: _np2_gather("binomial_dh", p, root),
    },
    "scatter": {
        # standalone scatter reverses the dh gather (Sec. 4.2); the
        # dd variant exists for the composite large-vector broadcast
        "bine": lambda p, root: _np2_scatter("bine_dh", p, root),
        "bine_dd": lambda p, root: _np2_scatter("bine_dd", p, root),
        "binomial": lambda p, root: _np2_scatter("binomial_dh", p, root),
    },
    "reduce_scatter": {
        "bine": lambda p, root: _np2_reduce_scatter("bine_dd", p),
        "recdoub": lambda p, root: _np2_reduce_scatter("recdoub_dd", p),
        "ring": lambda p, root: ring_reduce_scatter_sched(p),
        "bine_hier": lambda p, root: hier_schedule("reduce_scatter", p),
    },
    "allgather": {
        "bine": lambda p, root: _np2_allgather("bine_dh", p),
        "recdoub": lambda p, root: _np2_allgather("recdoub_dh", p),
        "ring": lambda p, root: ring_allgather_sched(p),
        "bine_hier": lambda p, root: hier_schedule("allgather", p),
    },
    "allreduce": {
        "bine": lambda p, root: _np2_allreduce_large("bine_dd", "bine_dh", p),
        "bine_small": lambda p, root: _np2_allreduce_small("bine_dh", p),
        "recdoub": lambda p, root: _np2_allreduce_large("recdoub_dd", "recdoub_dh", p),
        "recdoub_small": lambda p, root: _np2_allreduce_small("recdoub_dh", p),
        "ring": lambda p, root: ring_allreduce_sched(p),
        "bine_hier": lambda p, root: hier_schedule("allreduce", p),
    },
    "alltoall": {
        # alltoall routing needs the future-cone partition → DD kinds.
        # (every step carries n/2 regardless, so DH vs DD ordering does
        # not change the per-step payload profile.)
        "bine": lambda p, root: _np2_alltoall("bine_dd", p),
        "bruck": lambda p, root: bruck_alltoall_sched(p),
        "recdoub": lambda p, root: _np2_alltoall("recdoub_dd", p),
    },
}


def get_schedule(collective: str, algo: str, p: int, root: int = 0) -> Schedule:
    """Uniform accessor used by the simulator / traffic model / benchmarks."""
    return _REGISTRY[collective][algo](p, root)


def list_algos(collective: str) -> Tuple[str, ...]:
    """Every registered algorithm name for ``collective``."""
    return tuple(_REGISTRY[collective])


COLLECTIVES = (
    "allreduce", "allgather", "reduce_scatter", "alltoall",
    "broadcast", "reduce", "gather", "scatter",
)
