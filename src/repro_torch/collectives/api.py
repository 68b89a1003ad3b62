"""Public collective API: backend dispatch over the stacked ranks.

Port of ``repro.collectives.api``.  Every collective takes the stacked
per-rank buffers ``x [p, ...]`` (row r = rank r's input, p = the DP rank
count) where the reference takes one rank's ``x`` and a mesh axis, and
returns the stacked per-rank results.

Backends
  xla          : the framework's own collectives over the rank dim
                 (``stacked.psum`` & co.: a sum over dim 0 broadcast back,
                 the sum reshaped to rows, a reshape, a transpose of the
                 rank and slot dims).  The name stays so the copied tables
                 and configs read as they are; a multi-GPU executor maps
                 it to NCCL.  Sums run in PyTorch's order, not XLA's.
  bine         : the paper's algorithms (``collectives.stacked``).
  recdoub      : classical binomial/recursive-doubling butterflies.
  ring         : bandwidth-optimal ring, any rank count.
  pallas_fused : the same schedules with every step's local work in one
                 CUDA kernel launch (``kernels.collectives.ops``), bitwise
                 equal to the stacked path; ``cfg.fused_algo`` (bine |
                 recdoub | ring) picks the family.  The rooted
                 collectives, alltoall and the small allreduce run the
                 stacked schedule of that family, as in the reference.
  auto         : the packaged decision table for ``cfg.topology`` picks
                 the backend for (collective, p, payload bytes of ONE
                 rank); ``repro_torch.topology``.
  bine_hier    : hierarchical (Sec. 6.2).  With ``cfg.dp_shape = (outer,
                 inner)`` (e.g. ``(pods, data)``; the reference's
                 ``outer_axis`` / ``inner_axis``) the p = outer * inner
                 stacked ranks are ``r = o * inner + i``: bine RS/AG over
                 the inner axis and bine across the outer one
                 (``stacked.over_axis``).  On one axis the tier stack is
                 derived from the ``cfg.topology`` preset
                 (``topology.tier_split``) and the composed schedule
                 (``core.schedules.compose``) runs through
                 ``stacked.run_schedule``.  The rooted collectives and
                 all_to_all run bine.

The allreduce switches small/large at ``small_cutoff_bytes``, inclusive.
The reference's trace-time telemetry hook (``_obs_record``) is not ported:
it comes with ``repro.obs`` (ROADMAP.md queue A item 1c).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.collectives import stacked
from repro_torch.kernels.collectives import ops as fused

#: the fused-kernel backend's name
PALLAS_FUSED_BACKEND = "pallas_fused"

#: wire dtypes CollectiveConfig accepts ("auto" resolves per call site)
WIRE_DTYPES = ("float32", "bfloat16", "int8", "auto")

#: backends with an int8 wire-codec path
WIRE_CODEC_BACKENDS = ("bine", "recdoub", PALLAS_FUSED_BACKEND)


@dataclass(frozen=True)
class CollectiveConfig:
    backend: str = "bine"             # bine | recdoub | ring | xla | bine_hier
    #                                 # | pallas_fused | auto
    small_cutoff_bytes: int = 16384   # allreduce small/large switch (inclusive)
    #: for bine_hier over two axes: (outer, inner) sizes of the stacked
    #: ranks, row-major (rank r = o * inner + i); None = one axis
    dp_shape: Optional[Tuple[int, int]] = None
    #: preset of backend="auto"'s decision table and one-axis bine_hier's
    #: tier stack
    topology: str = "tpu_multipod"
    fused_algo: str = "bine"          # schedule family pallas_fused executes
    #: decision-table provenance: "analytic" (the packaged tables);
    #: "measured" is not ported and raises at lookup
    tuning: str = "analytic"
    #: what travels on the wire for reduce_scatter/allgather: "float32",
    #: "bfloat16" (cast), "int8" (pow2-scale codec) or "auto" (joint
    #: (backend, wire) table lookup)
    wire_dtype: str = "float32"

    def __post_init__(self):
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unsupported wire_dtype {self.wire_dtype!r}; expected one "
                f"of {WIRE_DTYPES}")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


XLA = CollectiveConfig(backend="xla")
BINE = CollectiveConfig(backend="bine")
AUTO = CollectiveConfig(backend="auto")
PALLAS_FUSED = CollectiveConfig(backend=PALLAS_FUSED_BACKEND)


def _nbytes(x: torch.Tensor) -> int:
    """One rank's payload: the stacked rank dim is not payload."""
    return x[0].numel() * x.element_size()


def resolve_backend(collective: str, p: int, nbytes: int,
                    cfg: CollectiveConfig) -> str:
    """Concrete backend for this call site (identity unless backend="auto")."""
    if cfg.backend != "auto":
        return cfg.backend
    from repro_torch.topology import select_backend
    return select_backend(collective, p, nbytes, cfg.topology,
                          tuning=cfg.tuning)


def executable_at(backend: str, p: int) -> bool:
    """Whether ``backend`` can execute collectives on ``p`` ranks: ``ring``
    and ``xla`` at any count, the butterfly family (and ``auto``, which may
    resolve to it) at powers of two only."""
    if p < 1:
        raise ValueError(f"axis size must be >= 1, got {p}")
    if backend in ("ring", "xla"):
        return True
    return p & (p - 1) == 0


def _resolve(cfg: CollectiveConfig, collective: str, x: torch.Tensor,
             gathered: bool = False) -> CollectiveConfig:
    """Resolve backend="auto" / wire_dtype="auto" for this call site.

    The table is keyed on the full-vector payload of one rank; for the
    collectives whose input is one rank's block (allgather, gather),
    ``gathered=True`` scales it by p.  ``wire_dtype="auto"`` on
    reduce_scatter/allgather reads the joint ``(backend, wire)`` row; with
    an explicit backend only the wire is taken, float32 where that backend
    has no codec.  Elsewhere "auto" wire is float32."""
    auto_b = cfg.backend == "auto"
    auto_w = cfg.wire_dtype == "auto"
    if not auto_b and not auto_w:
        return cfg
    p = x.shape[0]
    nbytes = _nbytes(x) * (p if gathered else 1)
    if auto_w and collective in ("reduce_scatter", "allgather"):
        from repro_torch.topology import select_wire
        b, w = select_wire(collective, p, nbytes, cfg.topology,
                           tuning=cfg.tuning)
        if not auto_b:
            b = cfg.backend
            if b not in WIRE_CODEC_BACKENDS:
                w = "float32"
        return cfg.replace(backend=b, wire_dtype=w)
    kw = {}
    if auto_w:
        kw["wire_dtype"] = "float32"
    if auto_b:
        kw["backend"] = resolve_backend(collective, p, nbytes, cfg)
    return cfg.replace(**kw)


def allreduce_uses_small(nbytes: int, cfg: CollectiveConfig) -> bool:
    """The small/large switch: INCLUSIVE at the cutoff."""
    return nbytes <= cfg.small_cutoff_bytes


def _check_wire_plain(cfg: CollectiveConfig, collective: str) -> None:
    """Compressed wires exist for reduce_scatter/allgather only; anywhere
    else an explicit one is a config error."""
    if cfg.wire_dtype != "float32":
        raise ValueError(
            f"wire_dtype={cfg.wire_dtype!r} is not implemented for "
            f"{collective!r}; compressed wires exist for reduce_scatter "
            f"and allgather only")


def _wire_rs_ag(collective: str, x: torch.Tensor, cfg: CollectiveConfig):
    """reduce_scatter/allgather with a compressed wire, or ``None`` for the
    plain float32 path: a non-power-of-two p (which then raises in the
    butterfly, as in the reference) and a ``pallas_fused`` config pinned
    to the ring (no ring codec).  bfloat16 rides the dtype-generic paths;
    int8 the ``_q`` twins, stacked and fused decoding bit-identically."""
    b = cfg.backend
    p = x.shape[0]
    if cfg.wire_dtype == "bfloat16":
        v = x.reshape(p, -1).to(torch.bfloat16)
        f = reduce_scatter if collective == "reduce_scatter" else allgather
        return f(v, cfg.replace(wire_dtype="float32")).to(x.dtype)
    if b not in WIRE_CODEC_BACKENDS:
        raise ValueError(
            f"wire_dtype='int8' needs a codec backend "
            f"{WIRE_CODEC_BACKENDS}; got backend={b!r}")
    if p & (p - 1):
        return None
    algo = cfg.fused_algo if b == PALLAS_FUSED_BACKEND else b
    if algo not in ("bine", "recdoub"):
        return None
    mod = fused if b == PALLAS_FUSED_BACKEND else stacked
    f = (mod.reduce_scatter_q if collective == "reduce_scatter"
         else mod.allgather_q)
    return f(x.reshape(p, -1), algo).to(x.dtype)


def _butterfly_algo(b: str) -> str:
    if b not in ("bine", "recdoub"):
        raise ValueError(f"unknown backend {b!r}")
    return b


def _hier_tiers(cfg: CollectiveConfig, p: int) -> Tuple[int, ...]:
    """Tier stack for one-axis ``bine_hier``: derived from the
    ``cfg.topology`` preset's physical hierarchy (ranks/node, nodes/group)
    via ``topology.tier_split``.

    Raises ``ValueError`` naming the preset when no hierarchy can be
    derived (torus / unknown preset) or when the composed schedule cannot
    run as static steps (non-power-of-two p)."""
    from repro_torch.topology import tier_split
    try:
        tiers = tier_split(cfg.topology, p)
    except (KeyError, ValueError) as e:
        raise ValueError(
            "backend='bine_hier' on one axis derives its tier stack from "
            f"the topology preset {cfg.topology!r}: {e}") from e
    if p & (p - 1):
        raise ValueError(
            f"backend='bine_hier' needs a power-of-two rank count to execute "
            f"the composed schedule as static steps; preset "
            f"{cfg.topology!r} derived tiers {tiers} from p={p}.  Use a "
            "two-axis dp_shape or a flat backend.")
    return tiers


def _composed(collective: str, tiers: Tuple[int, ...]):
    from repro_torch.core.schedules import compose
    return compose(collective, tiers, "bine")


def _check_hier_divisible(n: int, p: int, cfg: CollectiveConfig,
                          tiers: Tuple[int, ...]) -> None:
    if n % p:
        raise ValueError(
            f"bine_hier needs the vector length divisible by the total "
            f"rank count p={p} (preset {cfg.topology!r}, tiers {tiers}); "
            f"got length {n}")


def _dp_shape(cfg: CollectiveConfig, p: int) -> Optional[Tuple[int, int]]:
    """The two-axis ``(outer, inner)`` shape of a ``bine_hier`` call, or
    None on one axis."""
    if cfg.dp_shape is None:
        return None
    shape = tuple(int(d) for d in cfg.dp_shape)
    if len(shape) != 2 or shape[0] * shape[1] != p:
        raise ValueError(f"dp_shape {cfg.dp_shape} is not the (outer, "
                         f"inner) shape of {p} stacked ranks")
    return shape


def allreduce(x: torch.Tensor, cfg: CollectiveConfig = BINE) -> torch.Tensor:
    """``x [p, ...]`` -> the rank sum on every rank, same shape."""
    cfg = _resolve(cfg, "allreduce", x)
    _check_wire_plain(cfg, "allreduce")
    b = cfg.backend
    if b == "xla":
        return stacked.psum(x)
    if b == "bine_hier":
        p = x.shape[0]
        shape = _dp_shape(cfg, p)
        if shape is not None:
            return stacked.allreduce_hierarchical(x, shape, 1, 0, "bine")
        tiers = _hier_tiers(cfg, p)
        if len(tiers) == 1:
            # degenerate split (all ranks inside one node): flat bine
            b = "bine"
        else:
            return stacked.allreduce_sched(x, _composed("allreduce", tiers))
    if b == "ring":
        return stacked.allreduce_ring(x)
    if b == PALLAS_FUSED_BACKEND:
        algo = cfg.fused_algo
        if algo != "ring" and allreduce_uses_small(_nbytes(x), cfg):
            return stacked.allreduce_small(x, algo)
        return fused.allreduce(x, algo)
    algo = _butterfly_algo(b)
    if allreduce_uses_small(_nbytes(x), cfg):
        return stacked.allreduce_small(x, algo)
    return stacked.allreduce_butterfly(x, algo)


def reduce_scatter(x: torch.Tensor,
                   cfg: CollectiveConfig = BINE) -> torch.Tensor:
    """``x [p, ...]`` (per-rank length divisible by p) -> ``[p, n/p]``:
    rank r's reduced block r.

    ``bine_hier`` over two axes (``cfg.dp_shape``) runs the Sec. 6.2
    composition: RS over the fast inner axis first (the big messages stay
    on the fast links), then over the outer axis on the 1/inner shard.
    Block ownership is inner-major: rank ``(o, i)`` ends with block
    ``i * outer + o``, which this module's two-axis ``bine_hier``
    allgather (outer first) inverts.  The one-axis composed path keeps
    the flat convention: rank r ends with block r."""
    cfg = _resolve(cfg, "reduce_scatter", x)
    if cfg.wire_dtype != "float32":
        out = _wire_rs_ag("reduce_scatter", x, cfg)
        if out is not None:
            return out
    b = cfg.backend
    p = x.shape[0]
    if b == "xla":
        return x.reshape(p, p, -1).sum(0, dtype=x.dtype)
    if b == PALLAS_FUSED_BACKEND:
        return fused.reduce_scatter(x.reshape(p, -1), cfg.fused_algo)
    if b == "bine_hier":
        v = x.reshape(p, -1)
        shape = _dp_shape(cfg, p)
        if shape is not None:
            v = stacked.over_axis(stacked.reduce_scatter, v, shape, 1,
                                  "bine")
            return stacked.over_axis(stacked.reduce_scatter, v, shape, 0,
                                     "bine")
        tiers = _hier_tiers(cfg, p)
        _check_hier_divisible(v.shape[1], p, cfg, tiers)
        if len(tiers) == 1:
            return stacked.reduce_scatter(v, "bine")
        return stacked.reduce_scatter_sched(
            v, _composed("reduce_scatter", tiers))
    if b == "ring":
        return stacked.reduce_scatter(x.reshape(p, -1), "ring")
    return stacked.reduce_scatter(x.reshape(p, -1), _butterfly_algo(b))


def allgather(x: torch.Tensor, cfg: CollectiveConfig = BINE) -> torch.Tensor:
    """``x [p, ...]`` (rank r's block) -> ``[p, p*blk]``: the blocks in rank
    order, on every rank (two-axis ``bine_hier``: inner-major, inverting
    this module's two-axis ``bine_hier`` reduce_scatter)."""
    cfg = _resolve(cfg, "allgather", x, gathered=True)
    if cfg.wire_dtype != "float32":
        out = _wire_rs_ag("allgather", x, cfg)
        if out is not None:
            return out
    b = cfg.backend
    p = x.shape[0]
    if b == "xla":
        return stacked.all_gather(x.reshape(p, -1), 0)
    if b == PALLAS_FUSED_BACKEND:
        return fused.allgather(x.reshape(p, -1), cfg.fused_algo)
    if b == "bine_hier":
        v = x.reshape(p, -1)
        shape = _dp_shape(cfg, p)
        if shape is not None:
            v = stacked.over_axis(stacked.allgather, v, shape, 0, "bine")
            return stacked.over_axis(stacked.allgather, v, shape, 1, "bine")
        tiers = _hier_tiers(cfg, p)
        if len(tiers) == 1:
            return stacked.allgather(v, "bine")
        return stacked.allgather_sched(v, _composed("allgather", tiers))
    if b == "ring":
        return stacked.allgather(x.reshape(p, -1), "ring")
    return stacked.allgather(x.reshape(p, -1), _butterfly_algo(b))


def all_to_all(x: torch.Tensor, cfg: CollectiveConfig = BINE) -> torch.Tensor:
    """``x [p, p, ...]`` (rank r's row d goes to rank d) -> rank r's row o
    came from rank o."""
    cfg = _resolve(cfg, "alltoall", x)
    _check_wire_plain(cfg, "alltoall")
    b = cfg.backend
    if b == "xla":
        return stacked.all_to_all_xla(x)
    if b == PALLAS_FUSED_BACKEND:
        b = cfg.fused_algo   # no fused alltoall kernel: the same family
    algo = {"bine": "bine", "bine_hier": "bine", "recdoub": "recdoub",
            "ring": "bruck", "bruck": "bruck"}[b]
    return stacked.all_to_all(x, algo)


def _rooted_algo(cfg: CollectiveConfig) -> str:
    """Tree family of the rooted collectives: ``pallas_fused`` runs the
    stacked tree of its ``fused_algo``; bine* -> bine, else binomial."""
    b = cfg.backend
    if b == PALLAS_FUSED_BACKEND:
        b = cfg.fused_algo
    return "bine" if b.startswith("bine") else "binomial"


def _psum_exact(dtype: torch.dtype) -> bool:
    """Masked-sum broadcast is exact only for floating and complex dtypes;
    bool and ints route through the gather."""
    return dtype.is_floating_point or dtype.is_complex


def _root_masked(x: torch.Tensor, root: int) -> torch.Tensor:
    mask = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    mask[root] = True
    mask = mask.view(-1, *([1] * (x.dim() - 1)))
    return torch.where(mask, x, torch.zeros_like(x))


def broadcast(x: torch.Tensor, root: int = 0,
              cfg: CollectiveConfig = BINE) -> torch.Tensor:
    """Rank ``root``'s ``x`` on every rank."""
    cfg = _resolve(cfg, "broadcast", x)
    _check_wire_plain(cfg, "broadcast")
    if cfg.backend == "xla":
        if _psum_exact(x.dtype):
            return stacked.psum(_root_masked(x, root))
        return x[root].expand_as(x).contiguous()
    return stacked.broadcast(x, root, _rooted_algo(cfg))


def reduce(x: torch.Tensor, root: int = 0,
           cfg: CollectiveConfig = BINE) -> torch.Tensor:
    """The rank sum at ``root`` (``xla``: on every rank)."""
    cfg = _resolve(cfg, "reduce", x)
    _check_wire_plain(cfg, "reduce")
    if cfg.backend == "xla":
        return stacked.psum(x)
    return stacked.reduce(x, root, _rooted_algo(cfg))


def gather(x: torch.Tensor, root: int = 0,
           cfg: CollectiveConfig = BINE) -> torch.Tensor:
    """``x [p, ...]`` (rank r's block) -> ``[p, p*blk]``, valid at ``root``
    (``xla``: on every rank)."""
    cfg = _resolve(cfg, "gather", x, gathered=True)
    _check_wire_plain(cfg, "gather")
    p = x.shape[0]
    if cfg.backend == "xla":
        return stacked.all_gather(x.reshape(p, -1), 0)
    return stacked.gather(x.reshape(p, -1), root, _rooted_algo(cfg))


def scatter(x: torch.Tensor, root: int = 0,
            cfg: CollectiveConfig = BINE) -> torch.Tensor:
    """``x [p, ...]`` (significant at ``root``) -> ``[p, n/p]``: rank r's
    block r of root's vector."""
    cfg = _resolve(cfg, "scatter", x)
    _check_wire_plain(cfg, "scatter")
    p = x.shape[0]
    if cfg.backend == "xla":
        if _psum_exact(x.dtype):
            v = stacked.psum(_root_masked(x, root))[0].reshape(p, -1)
        else:
            v = x[root].reshape(p, -1)
        return v.clone()
    return stacked.scatter(x.reshape(p, -1), root, _rooted_algo(cfg))
