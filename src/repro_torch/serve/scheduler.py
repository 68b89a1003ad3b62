"""Continuous-batching request scheduler over the paged-KV serve engine.

Port of ``repro.serve.scheduler``.  Lifecycle::

    submit() --> WAITING --admission (free page + arrived)--> RUNNING
    RUNNING  --decode step + sample--> RUNNING | FINISHED (EOS / budget)
    FINISHED --release page--> page recycled to the next WAITING request

Each scheduler iteration (:meth:`ContinuousBatchingScheduler.step`):

  1. **Admit**: while a page is free and the head of the arrival queue has
     arrived, ``insert`` the request (padded prefill) and sample its first
     token from the prompt's last-position logits.
  2. **Decode**: one ``decode_slots`` step over the whole pool — every
     RUNNING request advances one token; retired pages hold their
     position.
  3. **Sample + retire**: per-slot greedy/temperature/top-k/top-p sampling
     (a stream per (request, token-index), so draws are independent of
     batch composition), then EOS / max-token retirement frees pages.

Time is virtual: one scheduler iteration = one time unit, and request
arrivals (e.g. from :func:`poisson_trace`) are compared against that
clock, which keeps every run exactly reproducible.  Beside the virtual
times each request also records host-clock stamps (``*_wall``, seconds):
when the clock first reached its arrival, and when its first and last
tokens were sampled — the serve CLI and ``chip_smoke.py`` turn them into
milliseconds.  Each retirement records, as the reference does,
``serve_requests_retired`` (by reason) and the virtual-tick
``serve_request_ttft_ticks`` / ``serve_request_e2e_ticks`` histograms into
``obs.metrics``.

Because pages are computationally independent and sampling streams are
per request, a request's output is the same whether it runs alone in a
1-page pool or interleaved with other traffic (up to the floating-point
differences of another batch size on the card).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import sampling as S
from repro_torch.serve.kvcache import SlotAllocator


@dataclass
class Request:
    """One generation request.  ``prompt`` is a 1-D int32 token array."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float = 0.0
    sampling: S.SamplingParams = field(default_factory=S.SamplingParams)
    eos_id: Optional[int] = None
    # -- filled by the scheduler --
    generated: List[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None   # "eos" | "length"
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    #: routing affinity: requests sharing a session go to one replica in a
    #: fleet (the reference's ``fleet.router``)
    session: Optional[str] = None
    #: host-clock stamps (time.perf_counter seconds)
    arrived_wall: Optional[float] = None
    first_token_wall: Optional[float] = None
    finished_wall: Optional[float] = None


class ContinuousBatchingScheduler:
    """Drives a :class:`repro_torch.serve.engine.ServeFns` pool to
    completion."""

    def __init__(self, model_cfg, fns, params, n_slots: int,
                 max_seq_len: int, top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0):
        self.cfg = model_cfg
        self.fns = fns
        self.params = params
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.top_k = top_k
        self.top_p = top_p
        self.alloc = SlotAllocator(n_slots)
        self.pool = fns.init_pool()
        self.sampler = S.make_sampler(top_k, top_p, plan=fns.plan,
                                      vocab_size=model_cfg.vocab_size)
        self.seed = seed
        self.clock = 0.0
        self.tokens_out = 0
        self._waiting: list = []            # heap of (arrival, rid, Request)
        self._running: Dict[int, Request] = {}   # slot -> Request
        #: per-retired-request latency record (virtual ticks)
        self._latency_log: List[Dict[str, float]] = []
        # pooled per-slot sampling inputs (host mirrors)
        self._next_tok = np.zeros((n_slots, 1), np.int32)
        self._temps = np.zeros((n_slots,), np.float32)
        self._rids = np.zeros((n_slots,), np.int32)
        self._steps = np.zeros((n_slots,), np.int32)
        self._active = np.zeros((n_slots,), np.int32)

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        # final page occupancy = prompt + tokens still to generate (a
        # replayed request carries its generated prefix in the prompt)
        if (len(req.prompt) + req.max_new_tokens - len(req.generated)
                > self.max_seq_len):
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + budget "
                f"({req.max_new_tokens}) exceeds page size {self.max_seq_len}")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be >= 1")
        if req.sampling.top_k not in (0, self.top_k):
            raise ValueError(
                f"request {req.rid}: top_k={req.sampling.top_k} differs from "
                f"the pool sampler's top_k={self.top_k} (top_k is "
                f"pool-global)")
        if req.sampling.top_p not in (0.0, self.top_p):
            raise ValueError(
                f"request {req.rid}: top_p={req.sampling.top_p} differs from "
                f"the pool sampler's top_p={self.top_p} (top_p is "
                f"pool-global)")
        heapq.heappush(self._waiting, (req.arrival, req.rid, req))

    # -- internals ----------------------------------------------------------

    def _sample_one(self, logits, req: Request) -> int:
        tok = self.sampler(
            logits,
            np.asarray([req.sampling.temperature], np.float32),
            np.asarray([req.rid], np.int32),
            np.asarray([len(req.generated)], np.int32),
            self.seed)
        return int(tok[0])

    def _retire(self, slot: int, req: Request, reason: str) -> None:
        req.finished = True
        req.finish_reason = reason
        req.finished_at = self.clock
        req.finished_wall = time.perf_counter()
        self._latency_log.append({
            "rid": req.rid,
            "admission_wait": req.admitted_at - req.arrival,
            "ttft": req.first_token_at - req.arrival,
            "e2e": self.clock - req.arrival,
            "tokens": float(len(req.generated)),
        })
        if obs_metrics.enabled():
            reg = obs_metrics.get_registry()
            reg.inc("serve_requests_retired", 1.0, reason=reason)
            reg.observe("serve_request_ttft_ticks",
                        req.first_token_at - req.arrival)
            reg.observe("serve_request_e2e_ticks", self.clock - req.arrival)
        self.pool = self.fns.evict(self.pool, np.int32(slot))
        self.alloc.release(slot)
        self._active[slot] = 0
        del self._running[slot]

    def _record(self, slot: int, req: Request, tok: int) -> None:
        """Account one sampled token; retire or queue it as the next input."""
        req.generated.append(tok)
        if req.first_token_at is None:
            req.first_token_at = self.clock
            req.first_token_wall = time.perf_counter()
        self.tokens_out += 1
        if req.eos_id is not None and tok == req.eos_id:
            self._retire(slot, req, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._retire(slot, req, "length")
        else:
            self._next_tok[slot, 0] = tok

    def _stamp_arrivals(self) -> None:
        now = time.perf_counter()
        for arrival, _, req in self._waiting:
            if arrival <= self.clock and req.arrived_wall is None:
                req.arrived_wall = now

    def _admit(self) -> int:
        admitted = 0
        while (self._waiting and self._waiting[0][0] <= self.clock
               and self.alloc.free):
            _, _, req = heapq.heappop(self._waiting)
            slot = self.alloc.acquire()
            padded = np.zeros((1, self.max_seq_len), np.int32)
            padded[0, :len(req.prompt)] = req.prompt
            logits, self.pool = self.fns.insert(
                self.params, self.pool, padded,
                np.int32(len(req.prompt)), np.int32(slot))
            req.admitted_at = self.clock
            self._running[slot] = req
            self._temps[slot] = req.sampling.temperature
            self._rids[slot] = req.rid
            self._active[slot] = 1
            self._record(slot, req, self._sample_one(logits, req))
            admitted += 1
        return admitted

    # -- the loop -----------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration.  Returns False when fully drained."""
        if not self._running and self._waiting:
            # idle pool: fast-forward the clock to the next arrival
            self.clock = max(self.clock, self._waiting[0][0])
        self._stamp_arrivals()
        self._admit()
        if not self._running:
            return bool(self._waiting)
        for slot, req in self._running.items():
            self._steps[slot] = len(req.generated)
        logits, self.pool = self.fns.decode_slots(
            self.params, self.pool, self._next_tok, self._active)
        toks = self.sampler(logits, self._temps, self._rids, self._steps,
                            self.seed)
        self.alloc.tick()
        for slot, req in list(self._running.items()):
            self._record(slot, req, int(toks[slot]))
        self.clock += 1.0
        return bool(self._running or self._waiting)

    def run(self) -> dict:
        """Drain every submitted request; returns summary stats."""
        while self.step():
            pass
        return self.stats()

    # -- fleet hooks --------------------------------------------------------

    @property
    def n_running(self) -> int:
        return len(self._running)

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    def eject_waiting(self) -> List[Request]:
        """Remove and return every not-yet-admitted request (arrival
        order); in-flight requests are untouched (a fleet drain's admit
        side)."""
        out = [req for _, _, req in sorted(self._waiting)]
        self._waiting.clear()
        return out

    def eject_all(self) -> List[Request]:
        """Crash-path eject: the waiting queue AND every in-flight request,
        the latter prepared for replay by folding the generated prefix into
        the prompt (``generated`` is kept, so retirement and stats carry
        over).  The pool state is abandoned."""
        out = self.eject_waiting()
        for slot in sorted(self._running):
            req = self._running[slot]
            if req.generated:
                req.prompt = np.concatenate(
                    [req.prompt,
                     np.asarray(req.generated, np.int32)]).astype(np.int32)
            self.alloc.release(slot)
            self._active[slot] = 0
            out.append(req)
        self._running.clear()
        return sorted(out, key=lambda r: (r.arrival, r.rid))

    def request_latencies(self) -> List[Dict[str, float]]:
        """Per-retired-request latency records (virtual ticks):
        ``{rid, admission_wait, ttft, e2e, tokens}``."""
        return list(self._latency_log)

    def stats(self) -> dict:
        return {
            "decode_steps": self.alloc.decode_steps,
            "tokens_out": self.tokens_out,
            "inserts": self.alloc.total_inserts,
            "mean_occupancy": self.alloc.mean_occupancy,
            "peak_occupancy": self.alloc.peak_occupancy,
            "clock": self.clock,
            "latency": latency_summary(self._latency_log),
        }


def _pct(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = max(0, min(len(xs) - 1, int(np.ceil(q / 100.0 * len(xs))) - 1))
    return float(xs[k])


def latency_summary(log: List[Dict[str, float]]) -> Dict[str, float]:
    """p50/p99 (virtual ticks) over per-request latency records:
    admission wait (arrival -> admitted), time-to-first-token and
    end-to-end (arrival -> retirement)."""
    out: Dict[str, float] = {"n": float(len(log))}
    for metric in ("admission_wait", "ttft", "e2e"):
        vals = [r[metric] for r in log]
        out[f"{metric}_p50"] = _pct(vals, 50.0)
        out[f"{metric}_p99"] = _pct(vals, 99.0)
    return out


def wall_ttft_ms(requests: List[Request]) -> Dict[str, float]:
    """p50/p99 host-clock time to first token in milliseconds: from the
    step in which the scheduler's clock reached the request's arrival to
    its first sampled token."""
    vals = [(r.first_token_wall - r.arrived_wall) * 1e3 for r in requests
            if r.first_token_wall is not None and r.arrived_wall is not None]
    return {"ttft_ms_p50": _pct(vals, 50.0), "ttft_ms_p99": _pct(vals, 99.0)}


def poisson_trace(n_requests: int, rate: float, prompt_lens,
                  max_new_tokens: int, vocab_size: int, seed: int = 0,
                  temperature: float = 0.0,
                  eos_id: Optional[int] = None,
                  n_sessions: Optional[int] = None) -> List[Request]:
    """Poisson arrival trace: exponential inter-arrival gaps at ``rate``
    requests per scheduler step, prompt lengths uniform over
    ``prompt_lens`` (an inclusive ``(lo, hi)`` pair or explicit list).
    numpy only, so one seed gives the reference's prompts and arrivals.

    ``n_sessions`` tags requests with session ids ``"s0".."s{n-1}"``
    (drawn after the prompts, so token content is unchanged)."""
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    if isinstance(prompt_lens, tuple) and len(prompt_lens) == 2:
        lens = rng.randint(prompt_lens[0], prompt_lens[1] + 1, n_requests)
    else:
        lens = rng.choice(np.asarray(list(prompt_lens)), n_requests)
    reqs = [
        Request(
            rid=i,
            prompt=rng.randint(0, vocab_size, size=int(lens[i])).astype(np.int32),
            max_new_tokens=max_new_tokens,
            arrival=float(arrivals[i]),
            sampling=S.SamplingParams(temperature=temperature),
            eos_id=eos_id,
        )
        for i in range(n_requests)
    ]
    if n_sessions is not None:
        for req, s in zip(reqs, rng.randint(0, n_sessions, n_requests)):
            req.session = f"s{int(s)}"
    return reqs
