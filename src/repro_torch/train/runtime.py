"""Fault-tolerance runtime: failure detection, restart, elastic re-mesh,
straggler monitoring.

Port of ``repro.train.runtime``.  The failure signal is driven by an
injectable ``FailureInjector`` so the restart and elastic paths are
exercised by tests and by ``chip_smoke.py``:

  * ``TrainLoop`` — step loop with async checkpoints, catches
    ``DeviceFailure``, restores from the latest checkpoint and resumes;
  * elastic re-mesh — on "permanent" failures, rebuild the step for the
    surviving rank count (halve the data axis), and restore the global
    checkpoint into the new ZeRO layout;
  * ``StragglerMonitor`` — per-step wall-time EWMA; flags outliers.

Where the reference's ``build`` hands back steps over global JAX arrays,
the port's step works on stacked per-rank trees, so its ``build`` also
returns two functions that convert a state to the checkpoint's global
arrays and back (``train_build`` makes them from ``train.step.to_global``
/ ``from_global``).  The loop takes an integer seed where the reference
takes a JAX key.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import timeline as obs_timeline
from repro_torch.train import checkpoint as ckpt


class DeviceFailure(RuntimeError):
    """Simulated device/pod failure; ``permanent`` drives elastic re-mesh."""

    def __init__(self, msg: str, permanent: bool = False):
        super().__init__(msg)
        self.permanent = permanent


@dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: permanent?}."""
    schedule: Dict[int, bool] = field(default_factory=dict)
    fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.schedule and step not in self.fired:
            self.fired.add(step)
            raise DeviceFailure(f"injected failure at step {step}",
                                permanent=self.schedule[step])


@dataclass
class StragglerMonitor:
    """EWMA of step wall-time; flags steps slower than ratio x the mean."""
    alpha: float = 0.2
    ratio: float = 2.0
    warmup: int = 3
    ewma: Optional[float] = None
    seen: int = 0
    flagged: List[Tuple[int, float, float]] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self.seen > self.warmup and dt > self.ratio * self.ewma)
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
        # EWMA excludes flagged outliers so one straggler can't mask the next
        if not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclass
class TrainLoopConfig:
    """``ckpt_dir`` has no default (the reference's is a fixed path that
    every run would share): each loop names its own, keyword only."""
    total_steps: int
    ckpt_every: int = 10
    ckpt_dir: str = field(kw_only=True)
    keep: int = 3
    max_restarts: int = 8


class TrainLoop:
    """Restartable training loop.

    ``build`` is a factory: build(n_data_shrink: int) ->
      (step_fn, init_params_fn, init_state_fn, put_batch_fn, data_iter_fn,
       to_global_fn, from_global_fn)
    so an elastic restart can rebuild everything for fewer ranks.
    ``to_global_fn(params, state, device=None)`` gives the tree a
    checkpoint holds and ``from_global_fn(tree) -> (params, state)``
    inverts it.
    """

    def __init__(self, cfg: TrainLoopConfig, build: Callable,
                 injector: Optional[FailureInjector] = None):
        self.cfg = cfg
        self.build = build
        self.injector = injector or FailureInjector()
        self.monitor = StragglerMonitor()
        self.restarts = 0
        self.shrink = 0        # times the data axis was halved (elastic)
        self.history: List[Dict[str, float]] = []

    def run(self, seed: int = 0) -> Dict[str, Any]:
        cpr = ckpt.AsyncCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
        step_fn, init_p, init_s, put_batch, data_at, to_g, from_g = \
            self.build(self.shrink)
        params = init_p(seed)
        state = init_s(params)
        start = 0
        latest = ckpt.latest_step(self.cfg.ckpt_dir)
        if latest is not None:
            params, state = self._restore(latest, params, state, to_g, from_g)
            start = latest
        s = start
        while s < self.cfg.total_steps:
            try:
                self.injector.check(s)
                t0 = time.time()
                batch = put_batch(data_at(s))
                params, state, metrics = step_fn(params, state, batch)
                loss = float(metrics["loss"])     # waits for the device
                dt = time.time() - t0
                self.monitor.observe(s, dt)
                self.history.append({"step": s, "loss": loss, "dt": dt,
                                     "restarts": self.restarts,
                                     "shrink": self.shrink})
                if obs_metrics.enabled():
                    obs_metrics.get_registry().observe(
                        "train_step_seconds", dt, shrink=self.shrink)
                    obs_timeline.get_timeline().span(
                        "train_step", "train", t0 * 1e6, dt * 1e6,
                        step=s, loss=loss, restarts=self.restarts)
                s += 1
                if s % self.cfg.ckpt_every == 0 or s == self.cfg.total_steps:
                    cpr.save(s, to_g(params, state), extra={"step": s})
            except DeviceFailure as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                cpr.wait()
                if e.permanent:
                    self.shrink += 1  # lose half the data axis; re-mesh
                step_fn, init_p, init_s, put_batch, data_at, to_g, from_g = \
                    self.build(self.shrink)
                params = init_p(seed)
                state = init_s(params)
                latest = ckpt.latest_step(self.cfg.ckpt_dir)
                if latest is not None:
                    params, state = self._restore(latest, params, state,
                                                  to_g, from_g)
                    s = latest
                else:
                    s = 0
        cpr.wait()
        return {"history": self.history, "restarts": self.restarts,
                "shrink": self.shrink,
                "stragglers": list(self.monitor.flagged)}

    def _restore(self, step: int, params_like, state_like, to_g, from_g):
        # the global arrays land on the host, from_g stacks them on the
        # step's device
        like = to_g(params_like, state_like, device="meta")
        return from_g(ckpt.restore(self.cfg.ckpt_dir, step, like,
                                   device="cpu"))


def shrunk_dp(dp, shrink: int) -> Tuple[int, ...]:
    """The DP sizes after halving the data (last) axis ``shrink`` times."""
    shape = (int(dp),) if np.ndim(dp) == 0 else tuple(int(d) for d in dp)
    data = shape[-1] >> shrink
    if data < 1 or data << shrink != shape[-1]:
        raise ValueError(f"cannot halve the data axis of {shape} "
                         f"{shrink} times")
    return shape[:-1] + (data,)


def train_build(model_cfg, tcfg, dcfg, dp, device="cuda",
                tp: int = 1) -> Callable:
    """The port's ``build`` for :class:`TrainLoop`: the train step, init
    and global-layout functions of ``train.step`` for the DP sizes ``dp``
    with the data axis halved ``shrink`` times and the model axis ``tp``
    (each DP rank's TP ranks stacked, ``sharding.shard_params``), and the
    batches of ``make_batch(dcfg, step)``.  A checkpoint holds the global
    layout, so a restore at any (dp, tp) reads it."""
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import make_batch
    from repro_torch.train.step import (from_global, make_init_fns,
                                        make_train_step, to_global)

    shapes = TF.param_shapes(model_cfg)

    def build(shrink: int):
        dps = shrunk_dp(dp, shrink)
        step_fn, _, _ = make_train_step(model_cfg, tcfg, dps, shapes, device,
                                        tp=tp)
        init_p, init_s = make_init_fns(model_cfg, tcfg, dps, device, tp=tp)
        return (step_fn, init_p, init_s, lambda b: b,
                lambda s: make_batch(dcfg, s),
                lambda params, state, device=None: to_global(
                    model_cfg, tcfg, params, state, dps, device, tp=tp),
                lambda tree: from_global(model_cfg, tcfg, tree, dps,
                                         device, tp=tp))

    return build
