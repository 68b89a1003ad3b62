"""Collective-call telemetry: per-dispatch counters + link-byte attribution.

The port's copy of ``repro.obs.collect``.  Every dispatch through
``collectives.api`` (and every train wire bucket) records ``(collective,
algo, backend, wire_dtype, payload_bytes, p)`` into the metrics registry,
plus the schedule-derived local/global link bytes that dispatch would put
on the wire — the paper's headline metric, live in every run.  One card
has no links: the bytes are those of the schedule on the ``topology``
preset, not a measurement.

The attribution reuses the ``tuner.trace`` schedule replay, but cached as
*block counts*: for one ``(collective, algo, p, topology)`` the replay
runs once with ``vec_bytes = p`` so every per-message size is exactly its
integer block count, and the summed (local, global) block totals are
cached.  ``msg_bytes`` is linear in ``vec_bytes``, so for any payload::

    recorded_bytes = blocks * payload_bytes / p

which equals ``core.traffic.global_bytes(sched, p, payload, topo)``
EXACTLY for power-of-two payloads and rank counts (every term is an exact
binary float; tests/test_torch_obs.py holds it against the closed form for
every registered (collective, algo) pair).

Cost: the reference records while a shard_map body is traced, so once per
compile.  The port runs eagerly, so the API records once per CALL: one
cached lookup of the signature's label key and increments (``_dispatch``)
and four counter additions on the host, never a device sync
(``chip_smoke.py`` phase 8 times it).  ``record_bucket_plan`` runs
once per ``make_train_step``, as the reference's once per compile.
"""

from __future__ import annotations

import warnings
from functools import lru_cache
from typing import Optional, Tuple

from repro_torch.obs import metrics

#: attribution failures already warned about (one per signature per process)
_WARNED_KEYS: set = set()


@lru_cache(maxsize=4096)
def link_blocks(collective: str, algo: str, p: int, topology: str,
                root: int = 0,
                placement: Optional[Tuple[int, ...]] = None
                ) -> Tuple[int, int]:
    """(local, global) summed link *block counts* of one schedule replay.

    Replays ``get_schedule(collective, algo, p, root)`` on the preset's
    topology with ``vec_bytes = p`` (so each message weighs exactly its
    ``nblocks``) and returns the integer step totals.  Torus presets route
    dimension-ordered; their hop blocks land in the local slot and the
    global slot is 0 (a torus has no group boundary to cross).

    ``placement`` (rank -> node, a tuple so the cache can key it) defaults
    to identity — the runtime layers don't know the scheduler's node map;
    tests use it to spread ranks across groups.
    """
    from repro_torch.topology.presets import get_topology
    from repro_torch.tuner.trace import trace_collective

    topo = get_topology(topology, p)
    res = trace_collective(collective, algo, p, float(p), topo,
                           placement=placement, root=root)
    return int(round(res.local_bytes)), int(round(res.global_bytes))


def attributed_bytes(collective: str, algo: str, p: int,
                     payload_bytes: float, topology: str, root: int = 0,
                     placement: Optional[Tuple[int, ...]] = None
                     ) -> Tuple[float, float]:
    """(local, global) bytes this dispatch puts on the links.

    Exact equality with ``core.traffic.global_bytes`` for pow2
    ``payload_bytes``/``p``: the cached block totals are integers and the
    per-payload scaling ``blocks * payload / p`` distributes exactly over
    the replay's per-message sum.
    """
    loc, glo = link_blocks(collective, algo, p, topology, root, placement)
    return loc * float(payload_bytes) / p, glo * float(payload_bytes) / p


def _warn_attr_once(key: Tuple, err: BaseException) -> None:
    if key in _WARNED_KEYS:
        return
    _WARNED_KEYS.add(key)
    warnings.warn(
        f"obs: no link-byte attribution for {key} ({err!r}); the dispatch "
        f"counters still record, only the byte breakdown is skipped",
        stacklevel=3)


def record(collective: str, backend: str, p: int, payload_bytes: int,
           wire_dtype: str = "float32", topology: str = "tpu_multipod",
           small_cutoff_bytes: int = 16384, root: int = 0,
           source: str = "api") -> None:
    """Record one collective dispatch into the default registry.

    Emits, all labeled ``(collective, algo, backend, wire_dtype,
    topology, p, source)``:

      * ``collective_calls``          — dispatch count;
      * ``collective_payload_bytes``  — Σ full-vector payload;
      * ``link_local_bytes`` / ``link_global_bytes`` — schedule-replayed
        byte attribution (wire-dtype scaling applied to what actually
        crosses the links).

    Attribution maps the API backend to its schedule via
    ``topology.cost.schedule_algo`` (small/large switch, xla proxies,
    bine_hier composition included); backends it cannot price keep their
    call counters and warn once.  The label key and the four increments
    of one signature are computed once (``_dispatch``), so a repeated
    dispatch only adds to its counters.
    """
    if not metrics.enabled():
        return
    lk, items, warns = _dispatch(collective, backend, p, payload_bytes,
                                 wire_dtype, topology, small_cutoff_bytes,
                                 root, source)
    for key, err in warns:
        _warn_attr_once(key, err)
    metrics.get_registry().inc_series(lk, items)


@lru_cache(maxsize=4096)
def _dispatch(collective: str, backend: str, p: int, payload_bytes: int,
              wire_dtype: str, topology: str, small_cutoff_bytes: int,
              root: int, source: str):
    """What one dispatch adds: (sorted label key, ((counter, increment),
    ...), ((warning key, error), ...)).  Pure in its arguments."""
    from repro_torch.topology.cost import schedule_algo

    warns = []
    try:
        sched_coll, algo = schedule_algo(collective, backend, payload_bytes,
                                         small_cutoff_bytes)
    except (KeyError, ValueError) as e:
        warns.append(((collective, backend), e))
        sched_coll = algo = None

    lk = metrics._labels_key(dict(
        collective=collective, backend=backend, algo=algo or "unknown",
        wire_dtype=wire_dtype, topology=topology, p=p, source=source))
    items = [("collective_calls", 1.0),
             ("collective_payload_bytes", float(payload_bytes))]
    if algo is not None:
        try:
            loc, glo = attributed_bytes(sched_coll, algo, p,
                                        float(payload_bytes), topology, root)
        except Exception as e:  # unknown preset / non-executable p
            warns.append(((sched_coll, algo, p, topology), e))
        else:
            # the wire codec shrinks what actually crosses the links; the
            # payload counter above stays the full-vector f32 convention
            scale = _wire_scale(wire_dtype)
            items += [("link_local_bytes", loc * scale),
                      ("link_global_bytes", glo * scale)]
    return lk, tuple(items), tuple(warns)


def _wire_scale(wire_dtype: str) -> float:
    if wire_dtype == "float32":
        return 1.0
    try:
        from repro_torch.collectives.compression import wire_factor
        return wire_factor(wire_dtype)
    except Exception:
        return 1.0


def record_api(cfg, collective: str, p: int, nbytes: int,
               root: int = 0) -> None:
    """The ``collectives.api`` hook: one resolved dispatch.

    ``cfg`` is the post-``_resolve`` CollectiveConfig (concrete backend
    and wire, never "auto").  Called with host ints only, once per call.
    """
    if not metrics.enabled():
        return
    record(collective, cfg.backend, p, nbytes, cfg.wire_dtype, cfg.topology,
           cfg.small_cutoff_bytes, root, "api")


def record_bucket_plan(tcfg, plan, decisions, n_dp: int) -> None:
    """The ``train.step`` hook: the step's static per-bucket decisions.

    One reduce-scatter and one allgather record per wire bucket, at the
    exact payloads and resolved ``(backend, wire)`` the step dispatches —
    recorded once at build time (the decisions are static), as the
    reference records once per compilation of the step.
    """
    if not metrics.enabled() or plan is None or decisions is None:
        return
    import torch
    for b, (rs_b, rs_w, ag_b, ag_w) in zip(plan.buckets, decisions):
        rs_bytes = int(b.nbytes(plan.wire_itemsize, n_dp))
        ag_bytes = int(b.nbytes(getattr(torch, b.dtype).itemsize, n_dp))
        record("reduce_scatter", rs_b, n_dp, rs_bytes, wire_dtype=rs_w,
               topology=tcfg.topology,
               small_cutoff_bytes=tcfg.small_cutoff_bytes,
               source="train_bucket")
        record("allgather", ag_b, n_dp, ag_bytes, wire_dtype=ag_w,
               topology=tcfg.topology,
               small_cutoff_bytes=tcfg.small_cutoff_bytes,
               source="train_bucket")


def record_serve_plan(rows, topology: str,
                      small_cutoff_bytes: int = 16384) -> None:
    """The ``serve.engine`` hook: the decode plan's per-step collectives.

    The plan is advisory — these rows are the per-decode-step collectives
    the cost model priced when it chose each backend, recorded once at
    ``make_serve_fns`` build time (``source="serve_plan"``).  On one card
    (``n_tp = n_dp = 1``) the plan is empty and nothing records.  ``rows`` is an iterable of
    ``(collective, backend, p, nbytes)``.
    """
    if not metrics.enabled():
        return
    for collective, backend, p, nbytes in rows:
        record(collective, backend, p, int(nbytes),
               topology=topology, small_cutoff_bytes=small_cutoff_bytes,
               source="serve_plan")


def global_local_summary(reg: Optional[metrics.Registry] = None) -> dict:
    """Per-(backend, topology) global/local byte totals — the report
    CLI's "is the locality story holding" table."""
    reg = reg or metrics.get_registry()
    out: dict = {}
    for name in ("link_global_bytes", "link_local_bytes"):
        for labels, value in reg.series(name):
            key = (labels.get("backend", "?"), labels.get("topology", "?"))
            row = out.setdefault(key, {"global": 0.0, "local": 0.0})
            row["global" if name == "link_global_bytes" else "local"] += value
    return out
