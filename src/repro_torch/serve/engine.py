"""Serving entry points: padded prefill + single-token decode over a paged
KV pool, on one device.

Port of ``repro.serve.engine`` for one card.  The reference compiles each
entry point once under GSPMD; here they are eager PyTorch functions, and
their norms and prefill attention run on the hand-written kernels
(``models.transformer``).  Not ported, because eager PyTorch has no
counterpart: ``cache_specs`` (the pool's ``PartitionSpec``s) and
``trace_counts`` (the no-retrace guarantee of ``jit``; the serve CLI
prints the kernel launch counts instead).  Serving under tensor
parallelism and the multi-GPU executor are ROADMAP.md queue A items 3b
and 7.  The plan's
observability record (``obs.collect.record_serve_plan``) fires where the
plan prices a collective, which on one card (``n_tp = n_dp = 1``) it
never does, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from repro_torch import resolve_device
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
    the reference.  On one card (``n_tp = n_dp = 1``) the plan is empty."""
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

    Pools are updated in place and returned.  ``plan`` is the serving
    collective plan.  The reference's legacy fixed-batch pair, for the
    architectures its pool cannot serve, has no counterpart: the port
    serves dense ``attn`` models only (``models.transformer`` raises for
    the others, ROADMAP.md queue A item 5).
    """
    init_pool: Callable
    insert: Callable
    decode_slots: Callable
    evict: Callable
    plan: Dict[str, str] = field(default_factory=dict)


def page_len(model_cfg, prompt_max: int, max_new: int) -> int:
    """KV page size for a prompt/decode budget: ``prompt_max + max_new``
    rounded up to the attention chunk, as the reference does."""
    C = model_cfg.attn_chunk
    return ((prompt_max + max_new + C - 1) // C) * C


def make_serve_fns(model_cfg, scfg: ServeConfig, B: int, S_len: int,
                   device="cuda") -> ServeFns:
    """The serving entry points for a ``B``-page pool of length ``S_len``
    (page = prompt + decode budget) on one ``device``.  See
    :class:`ServeFns`."""
    dev = resolve_device(device)

    def init_pool_fn():
        return KV.init_pool_state(model_cfg, B, S_len, dev)

    def insert_fn(params, pool, tokens, length, slot):
        logits, one = T.prefill(params, model_cfg,
                                torch.as_tensor(tokens, device=dev),
                                length=int(length))
        return logits[:, 0], KV.write_slot(pool, one, slot)

    def decode_slots_fn(params, pool, tokens, active):
        logits, pool = T.decode_step(
            params, model_cfg, pool, torch.as_tensor(tokens, device=dev),
            active=torch.as_tensor(active, device=dev))
        return logits[:, 0], pool

    def evict_fn(pool, slot):
        return KV.reset_slot(pool, slot)

    return ServeFns(
        init_pool=init_pool_fn, insert=insert_fn,
        decode_slots=decode_slots_fn, evict=evict_fn,
        plan=collective_plan(model_cfg, scfg, 1, 1, B))
