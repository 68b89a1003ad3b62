"""Numpy execution of collective schedules — the correctness oracle.

Executes a schedule from ``core.schedules`` on real per-rank numpy buffers
and checks the result against the mathematical definition of the
collective.  Used by unit/property tests and (indirectly) to certify the
static tables baked into the stacked executor (``collectives.stacked``).

The PyTorch port's own copy of ``repro.core.simulate``.

Block convention: the collective vector has p blocks; ``data[r]`` is rank
r's input contribution.  Values are float64 arrays of shape ``(p, blk)``
(block-major) so reductions are exact for small integers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .schedules import BLOCK_ALL, Sched, get_schedule, step_kinds


def _exec_block_steps(held: List[Dict[int, np.ndarray]], sched: Sched,
                      kinds) -> None:
    """Kind-driven block engine (kind semantics: schedules docstring).

    reduce: src relinquishes the blocks; dst must still hold them and
            accumulates.  move: src relinquishes; dst installs (and must
            not already hold them).  copy: src keeps; dst installs,
            values must agree on overlap.
    """
    for step, kind in zip(sched, kinds):
        moves = []
        for m in step:
            payload = {}
            for b in m.blocks:
                assert b in held[m.src], (
                    f"{kind}: rank {m.src} sends block {b} it does not hold")
                payload[b] = held[m.src][b]
            moves.append((m.src, m.dst, payload))
        if kind in ("reduce", "move"):
            for src, _, payload in moves:
                for b in payload:
                    del held[src][b]
        for _, dst, payload in moves:
            for b, v in payload.items():
                if kind == "reduce":
                    assert b in held[dst], (
                        f"reduce: rank {dst} no longer accumulates block {b}")
                    held[dst][b] = held[dst][b] + v
                elif kind == "move":
                    assert b not in held[dst], (
                        f"move: rank {dst} already holds block {b}")
                    held[dst][b] = v
                else:  # copy
                    if b in held[dst]:
                        assert (held[dst][b] == v).all()
                    held[dst][b] = v


def _composite_kinds(sched: Sched, first: str, second: str):
    """Kinds for a schedule: the IR's own tags, or the legacy symmetric
    midpoint split for plain step lists."""
    kinds = getattr(sched, "kinds", None)
    if kinds is not None:
        return tuple(kinds)
    assert len(sched) % 2 == 0
    half = len(sched) // 2
    return (first,) * half + (second,) * half


def _inputs(p: int, blk: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(-8, 8, size=(p, p, blk)).astype(np.float64)


def run_broadcast(sched: Sched, p: int, root: int, blk: int = 4) -> None:
    x = _inputs(p, blk)[root]
    have: List[np.ndarray | None] = [None] * p
    have[root] = x
    for step in sched:
        incoming: Dict[int, np.ndarray] = {}
        for m in step:
            assert m.blocks == (BLOCK_ALL,)
            assert have[m.src] is not None, f"rank {m.src} sends before receiving"
            assert m.dst not in incoming, f"rank {m.dst} receives twice in a step"
            incoming[m.dst] = have[m.src]
        for dst, val in incoming.items():
            assert have[dst] is None, f"rank {dst} receives but already has data"
            have[dst] = val
    for r in range(p):
        assert have[r] is not None and (have[r] == x).all(), f"bcast wrong at {r}"


def run_reduce(sched: Sched, p: int, root: int, blk: int = 4) -> None:
    data = _inputs(p, blk)
    acc = [data[r].copy() for r in range(p)]
    done = [False] * p
    for step in sched:
        incoming: Dict[int, List[np.ndarray]] = {}
        for m in step:
            assert not done[m.src], f"rank {m.src} sends twice"
            incoming.setdefault(m.dst, []).append(acc[m.src])
            done[m.src] = True
        for dst, vals in incoming.items():
            for v in vals:
                acc[dst] = acc[dst] + v
    expect = data.sum(axis=0)
    assert (acc[root] == expect).all(), "reduce result wrong at root"


def run_gather(sched: Sched, p: int, root: int, blk: int = 4) -> None:
    data = _inputs(p, blk)
    held: List[Dict[int, np.ndarray]] = [{r: data[r][r]} for r in range(p)]
    for step in sched:
        moves = []
        for m in step:
            assert set(m.blocks) == set(held[m.src]), (
                f"gather: rank {m.src} sends {m.blocks} but holds "
                f"{sorted(held[m.src])}")
            moves.append((m.src, m.dst, {b: held[m.src][b] for b in m.blocks}))
        for src, dst, payload in moves:
            held[src] = {}
            for b, v in payload.items():
                assert b not in held[dst]
                held[dst][b] = v
    assert sorted(held[root]) == list(range(p))
    for b in range(p):
        assert (held[root][b] == data[b][b]).all()


def run_scatter(sched: Sched, p: int, root: int, blk: int = 4) -> None:
    data = _inputs(p, blk)[root]  # root holds p blocks
    held: List[Dict[int, np.ndarray]] = [{} for _ in range(p)]
    held[root] = {b: data[b] for b in range(p)}
    for step in sched:
        moves = []
        for m in step:
            for b in m.blocks:
                assert b in held[m.src], (
                    f"scatter: rank {m.src} sends block {b} it does not hold")
            moves.append((m.src, m.dst, {b: held[m.src][b] for b in m.blocks}))
        for src, dst, payload in moves:
            for b in payload:
                del held[src][b]
            held[dst].update(payload)
    for r in range(p):
        assert set(held[r]) == {r}, f"scatter: rank {r} holds {sorted(held[r])}"
        assert (held[r][r] == data[r]).all()


def run_reduce_scatter(sched: Sched, p: int, blk: int = 4) -> None:
    data = _inputs(p, blk)
    held: List[Dict[int, np.ndarray]] = [
        {b: data[r][b].copy() for b in range(p)} for r in range(p)
    ]
    _exec_block_steps(held, sched, step_kinds(sched, "reduce"))
    expect = data.sum(axis=0)
    for r in range(p):
        assert set(held[r]) == {r}, f"RS: rank {r} ends with {sorted(held[r])}"
        assert (held[r][r] == expect[r]).all(), f"RS: wrong sum at rank {r}"


def run_allgather(sched: Sched, p: int, blk: int = 4) -> None:
    data = _inputs(p, blk)
    held: List[Dict[int, np.ndarray]] = [{r: data[r][r]} for r in range(p)]
    for step in sched:
        moves = []
        for m in step:
            payload = {b: held[m.src][b] for b in m.blocks}
            assert len(payload) == len(m.blocks)
            moves.append((m.dst, payload))
        for dst, payload in moves:
            for b, v in payload.items():
                if b in held[dst]:
                    assert (held[dst][b] == v).all()
                held[dst][b] = v
    for r in range(p):
        assert sorted(held[r]) == list(range(p))
        for b in range(p):
            assert (held[r][b] == data[b][b]).all()


def run_allreduce(sched: Sched, p: int, blk: int = 4) -> None:
    """Handles both small (full-vector recursive doubling) and large (RS+AG).

    Step kinds drive the buffer semantics: "reduce" steps relinquish at
    the sender and accumulate at the receiver, "copy"/"move" steps install
    completed sums.  Plain step lists fall back to the legacy symmetric
    midpoint split (first half RS, second half AG).
    """
    data = _inputs(p, blk)
    expect = data.sum(axis=0)
    # full-vector schedule? (recursive-doubling exchanges + adapter steps)
    if all(m.blocks == (BLOCK_ALL,) for step in sched for m in step):
        acc = [data[r].copy() for r in range(p)]
        for step, kind in zip(sched, step_kinds(sched, "reduce")):
            snap = [a.copy() for a in acc]
            for m in step:
                if kind == "copy":
                    acc[m.dst] = snap[m.src].copy()
                else:
                    acc[m.dst] = acc[m.dst] + snap[m.src]
        for r in range(p):
            assert (acc[r] == expect).all(), f"allreduce wrong at rank {r}"
        return

    held: List[Dict[int, np.ndarray]] = [
        {b: data[r][b].copy() for b in range(p)} for r in range(p)
    ]
    _exec_block_steps(held, sched, _composite_kinds(sched, "reduce", "copy"))
    for r in range(p):
        assert sorted(held[r]) == list(range(p)), f"rank {r}: {sorted(held[r])}"
        for b in range(p):
            assert (held[r][b] == expect[b]).all(), f"allreduce wrong {r},{b}"


def run_broadcast_large(sched: Sched, p: int, root: int, blk: int = 4) -> None:
    """scatter + allgather composite: root's p blocks reach every rank."""
    data = _inputs(p, blk)[root]
    held: List[Dict[int, np.ndarray]] = [{} for _ in range(p)]
    held[root] = {b: data[b] for b in range(p)}
    _exec_block_steps(held, sched, _composite_kinds(sched, "move", "copy"))
    for r in range(p):
        assert sorted(held[r]) == list(range(p)), f"rank {r}: {sorted(held[r])}"
        for b in range(p):
            assert (held[r][b] == data[b]).all()


def run_reduce_large(sched: Sched, p: int, root: int, blk: int = 4) -> None:
    """reduce-scatter + gather composite: root ends with the full sum."""
    data = _inputs(p, blk)
    expect = data.sum(axis=0)
    held: List[Dict[int, np.ndarray]] = [
        {b: data[r][b].copy() for b in range(p)} for r in range(p)
    ]
    _exec_block_steps(held, sched, _composite_kinds(sched, "reduce", "move"))
    assert sorted(held[root]) == list(range(p))
    for b in range(p):
        assert (held[root][b] == expect[b]).all(), f"reduce_large wrong blk {b}"


def run_alltoall(sched: Sched, p: int, blk: int = 4) -> None:
    data = _inputs(p, blk)  # data[r][d] = block rank r sends to rank d
    held: List[Dict[int, np.ndarray]] = [
        {d * p + r: data[r][d] for d in range(p)} for r in range(p)
    ]
    for step in sched:
        moves = []
        for m in step:
            payload = {}
            for key in m.blocks:
                assert key in held[m.src], (
                    f"a2a: rank {m.src} sends (d={key//p},o={key%p}) not held")
                payload[key] = held[m.src][key]
            moves.append((m.src, m.dst, payload))
        for src, dst, payload in moves:
            for key in payload:
                del held[src][key]
        for src, dst, payload in moves:
            for key, v in payload.items():
                held[dst][key] = v
    for r in range(p):
        keys = sorted(held[r])
        assert keys == [r * p + o for o in range(p)], f"a2a: rank {r} {keys}"
        for o in range(p):
            assert (held[r][r * p + o] == data[o][r]).all()


def check(collective: str, algo: str, p: int, root: int = 0, blk: int = 4) -> None:
    """Build the schedule and verify it end-to-end.  Raises on any violation."""
    sched = get_schedule(collective, algo, p, root)
    large = algo.endswith("large")
    if collective == "broadcast":
        (run_broadcast_large if large else run_broadcast)(sched, p, root, blk)
    elif collective == "reduce":
        (run_reduce_large if large else run_reduce)(sched, p, root, blk)
    elif collective == "gather":
        run_gather(sched, p, root, blk)
    elif collective == "scatter":
        run_scatter(sched, p, root, blk)
    elif collective == "reduce_scatter":
        run_reduce_scatter(sched, p, blk)
    elif collective == "allgather":
        run_allgather(sched, p, blk)
    elif collective == "allreduce":
        run_allreduce(sched, p, blk)
    elif collective == "alltoall":
        run_alltoall(sched, p, blk)
    else:
        raise KeyError(collective)
