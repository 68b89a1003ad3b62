"""Serving entry points: padded prefill + single-token decode over a paged
KV pool, on one device, optionally over ``dp x tp`` stacked ranks.

Port of ``repro.serve.engine``.  The reference compiles each entry point
once under GSPMD on a ``(data, model)`` mesh; here they are eager PyTorch
functions, their norms and prefill attention on the hand-written kernels
(``models.transformer``).  Under tensor parallelism (``tp > 1``) the DP
and TP ranks run stacked on the one device as the train side stacks them
(rows ``r * tp + t``): the pages split over DP and each KV leaf over the
model axis by the reference's ``cache_specs`` rule (:func:`cache_layout`),
prefill runs the TP layers, decode combines each page's partial softmax
over the ranks, and the logits leave as the ranks' vocab blocks, which
the sampler gathers.  The weights are held once, as the reference's serve
holds them (unsharded).  Not ported, because eager PyTorch has no
counterpart: ``trace_counts`` (the no-retrace guarantee of ``jit``; the
serve CLI prints the kernel launch counts instead).  The multi-GPU
executor is ROADMAP.md queue A item 7.  The plan's observability record
(``obs.collect.record_serve_plan``) fires where the plan prices a
collective, which on one rank (``tp = dp = 1``) it never does, as in the
reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.serve import kvcache as KV
from repro_torch.topology import table as TB


@dataclass(frozen=True)
class ServeConfig:
    #: "auto" consults the topology decision table for the serving
    #: collective plan; "xla" pins the defaults (no plan)
    backend: str = "auto"
    topology: str = "tpu_multipod"
    #: table provenance for the plan lookups: "analytic" or "measured"
    tuning: str = TB.ANALYTIC

    def __post_init__(self):
        if self.tuning not in TB.TUNINGS:
            raise ValueError(f"unknown tuning {self.tuning!r}; expected one "
                             f"of {TB.TUNINGS}")


def collective_plan(model_cfg, scfg: ServeConfig, n_tp: int, n_dp: int,
                    B: int) -> Dict[str, str]:
    """Topology-aware backend recommendations for the serving collectives
    of an ``n_tp`` x ``n_dp`` deployment at pool size ``B`` (the
    reference reads the two from its mesh): per decode-step collective,
    the backend the decision table picks at that payload.  Advisory, as in
    the reference.  On one rank (``n_tp = n_dp = 1``) the plan is empty."""
    if scfg.backend != "auto":
        return {}
    itemsize = torch.empty((), dtype=getattr(torch, model_cfg.dtype)
                           ).element_size()
    plan: Dict[str, str] = {}
    priced = []  # (collective, backend, p, nbytes) for obs attribution
    kw = dict(topology=scfg.topology, tuning=scfg.tuning)
    if n_tp > 1:
        # flash-decoding partial-softmax combine over the model axis
        attn_bytes = B * model_cfg.n_heads * model_cfg.head_dim * itemsize
        plan["decode_attn_allreduce"] = TB.select_backend(
            "allreduce", n_tp, attn_bytes, **kw)
        priced.append(("allreduce", plan["decode_attn_allreduce"], n_tp,
                       attn_bytes))
        # vocab-sharded logits re-assembly for sampling
        logit_bytes = B * model_cfg.vocab_size * 4
        plan["logits_allgather"] = TB.select_backend(
            "allgather", n_tp, logit_bytes, **kw)
        priced.append(("allgather", plan["logits_allgather"], n_tp,
                       logit_bytes))
    if n_dp > 1:
        # batched token scatter/gather between the frontend and the mesh
        tok_bytes = B * 4
        plan["token_scatter"] = TB.select_backend(
            "scatter", n_dp, tok_bytes, **kw)
        plan["token_gather"] = TB.select_backend(
            "gather", n_dp, tok_bytes, **kw)
        priced.append(("scatter", plan["token_scatter"], n_dp, tok_bytes))
        priced.append(("gather", plan["token_gather"], n_dp, tok_bytes))
    if priced:
        from repro_torch.obs import collect
        collect.record_serve_plan(priced, scfg.topology)
    return plan


@dataclass
class ServeFns:
    """The continuous-batching pool's entry points (state ``pos`` is
    ``[B]``):

      * ``init_pool() -> pool``
      * ``insert(params, pool, tokens [1,S_max], length, slot)
        -> (logits [1,V], pool)`` — padded prefill + page write
      * ``decode_slots(params, pool, tokens [B,1], active [B])
        -> (logits [B,V], pool)`` — one decode step for every page;
        inactive pages hold their position
      * ``evict(pool, slot) -> pool`` — retire a page

    Under tensor parallelism the logits are the ranks' vocab blocks
    ``[tp, B, ceil(V/tp)]`` (``sampling.gather_vocab`` joins them) and
    the pool is rank-stacked by ``layout`` (one ``sharding.KVLayout`` a
    segment; ``None`` on one TP rank, where the pool is the global one:
    with ``tp = 1`` the DP ranks' rows ``r`` hold pages ``r * B/dp ...``,
    which is the global pool's own order).  Pools are updated in place
    and returned.  ``plan`` is the serving collective plan.  The pool
    serves the dense ``attn`` configs (phi4-mini, gemma3-4b, gemma-7b,
    qwen3-32b; gemma3's local layers on ring caches), and
    :func:`make_serve_fns` raises for the ones :func:`pool_supported`
    refuses.  The reference's legacy fixed-batch pair is
    ``launch.serve.run_fixed_batch`` on ``models.transformer``'s
    ``prefill`` and ``decode_step``: it serves the recurrent, frontend
    and MoE configs.
    """
    init_pool: Callable
    insert: Callable
    decode_slots: Callable
    evict: Callable
    plan: Dict[str, str] = field(default_factory=dict)
    layout: Optional[List[SH.KVLayout]] = None


def page_len(model_cfg, prompt_max: int, max_new: int) -> int:
    """KV page size for a prompt/decode budget: ``prompt_max + max_new``
    rounded up to the attention chunk, as the reference does."""
    C = model_cfg.attn_chunk
    return ((prompt_max + max_new + C - 1) // C) * C


def cache_layout(model_cfg, B: int, S_len: int, dp=1,
                 tp: int = 1) -> List[SH.KVLayout]:
    """The counterpart of the reference's ``cache_specs``: per segment,
    whether the ``B`` pages split over the ``dp`` DP ranks (``dp`` an int
    or a DP shape; they split when ``B % n_dp == 0 and B >= n_dp``) and
    how its K/V split over the ``tp`` TP ranks, by the reference's rule in
    its order: over the page's slots (``"seq"``) when the cache width W
    divides by tp, else over the KV heads (``"heads"``) when they do, else
    not at all (``"whole"``).  A recurrent segment (the fixed-batch loop's)
    holds its decode states split over the TP ranks by heads or units
    (``"heads"``) where ``transformer.recurrent_split``, else once
    (``"whole"``); its width is 0."""
    n_dp = _ranks(dp)
    split = B % n_dp == 0 and B >= n_dp
    out = []
    for block, _ in T.segments(model_cfg):
        if block.kind in T.RECURRENT:
            kv = "heads" if T.recurrent_split(model_cfg, block.kind, tp) \
                else "whole"
            out.append(SH.KVLayout(n_dp, tp, split, kv, 0))
            continue
        W = S_len if block.window is None else min(block.window, S_len)
        if W % tp == 0:
            kv = "seq"
        elif model_cfg.n_kv_heads % tp == 0:
            kv = "heads"
        else:
            kv = "whole"
        out.append(SH.KVLayout(n_dp, tp, split, kv, W))
    return out


def pool_supported(model_cfg) -> bool:
    """Can the continuous-batching pool serve this architecture?  The
    reference's rule, which excludes, loudly rather than subtly wrong:

      * modality frontends: no token stream to schedule;
      * recurrent blocks (Mamba2/xLSTM): their state would integrate the
        prompt padding;
      * MoE: expert *capacity* dispatch couples batch rows (a token's
        keep or drop depends on what else routed to its expert), which
        breaks both padded prefill (pad tokens compete for capacity) and
        the continuous-batching equivalence guarantee.
    """
    if model_cfg.frontend is not None or model_cfg.n_experts > 0:
        return False
    return all(b.kind in ("attn", "shared_attn")
               for b, _ in T.segments(model_cfg))


def make_serve_fns(model_cfg, scfg: ServeConfig, B: int, S_len: int,
                   device="cuda", dp=1, tp: int = 1) -> ServeFns:
    """The serving entry points for a ``B``-page pool of length ``S_len``
    (page = prompt + decode budget) over ``dp`` DP ranks (an int or a DP
    shape, as ``train.step.make_train_step`` takes it) of ``tp`` TP
    ranks, stacked on one ``device``.  See :class:`ServeFns`.  Raises
    for an architecture the pool cannot serve (:func:`pool_supported`),
    which the reference serves through its fixed-batch loop instead."""
    if not pool_supported(model_cfg):
        raise NotImplementedError(
            f"{model_cfg.name}: the continuous-batching pool cannot serve "
            f"this architecture (pool_supported: MoE capacity dispatch "
            f"couples batch rows, recurrent state would integrate the "
            f"prompt padding, a frontend has no token stream); the "
            f"reference serves it through its fixed-batch loop, "
            f"launch.serve.run_fixed_batch here")
    dev = resolve_device(device)
    layout = cache_layout(model_cfg, B, S_len, dp, tp) if tp > 1 else None

    def init_pool_fn():
        return KV.init_pool_state(model_cfg, B, S_len, dev, layout)

    def insert_fn(params, pool, tokens, length, slot):
        tokens = torch.as_tensor(tokens, device=dev)
        if layout is None:
            logits, one = T.prefill(params, model_cfg, tokens,
                                    length=int(length))
        else:
            logits, one = T.prefill_tp(params, model_cfg, tokens, tp,
                                       length=int(length))
        return logits[..., 0, :], KV.write_slot(pool, one, slot, layout)

    def decode_slots_fn(params, pool, tokens, active):
        tokens = torch.as_tensor(tokens, device=dev)
        active = torch.as_tensor(active, device=dev)
        if layout is None:
            logits, pool = T.decode_step(params, model_cfg, pool, tokens,
                                         active=active)
        else:
            logits, pool = T.decode_step_tp(params, model_cfg, pool, tokens,
                                            layout, active=active)
        return logits[..., 0, :], pool

    def evict_fn(pool, slot):
        return KV.reset_slot(pool, slot)

    return ServeFns(
        init_pool=init_pool_fn, insert=insert_fn,
        decode_slots=decode_slots_fn, evict=evict_fn,
        plan=collective_plan(model_cfg, scfg, tp, _ranks(dp), B),
        layout=layout)


def _ranks(dp) -> int:
    """The DP ranks of ``dp``, an int or a DP shape."""
    return math.prod(dp) if isinstance(dp, (tuple, list)) else int(dp)
