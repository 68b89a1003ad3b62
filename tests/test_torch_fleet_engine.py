"""The port's serve fleet on its real engine against one replica and
against the reference's fleet.

Reduced gemma3-4b (the reference's own fleet test config: 5:1
local:global layers, 16-slot ring caches) in float32, pages of S = 64,
the reference's trace ``poisson_trace(10, 1.0, (5, 40), 6, V, seed=5,
n_sessions=3)`` and scheduler seed 11, at (dp, tp) = (1, 1) and (2, 2)
(each replica's ranks stacked on the CPU, ``serve.engine``).  The JAX
side runs in one subprocess on 4 CPU devices under a plain
``jax.sharding.Mesh`` and ``compat.set_mesh`` (on jax 0.9
``jax.make_mesh`` gives Explicit axes) and hands over its initial
parameters (``interop.params_from_numpy``) and its streams.  Both
packages' fleets run on their ``FakeTimer``, so their routing, and with
it where the crash lands, is the same.

Cases: 3 replicas of 3 pages with drain r1@4, respawn r1@9 and drain
r2@7 give every request the greedy stream of the port's single 9-page
replica and of the reference's fleet on the same mesh shape; the
supervised fleet under the reference's schedule (crash r0@2, straggler
r1@4 x8, ``respawn_delay=2``: one crash that displaces in-flight work,
ttr 2, MTTR 2.0) gives the undisturbed fleet's streams and the
reference's supervised run's, with the same crash log.  At temperature
0.8 the port's fleet equals its single replica and its chaotic run its
undisturbed one; sampled streams match the reference only in
distribution (``serve/sampling.py``), so they are not compared across.

Bounds: float32 greedy streams are equal, token for token (as
tests/test_torch_serve_tp.py holds the scheduler's streams).
"""

import json

import numpy as np
import pytest

from repro_torch import tree as TR
from repro_torch.configs import base
from repro_torch.fleet import Fleet, FleetConfig, FleetEvent
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as TFm
from repro_torch.resilience import (ChaosSchedule, FaultEvent,
                                    FleetSupervisor, SupervisorConfig)
from repro_torch.resilience.fakes import FakeTimer
from repro_torch.serve import engine as E
from repro_torch.serve.scheduler import poisson_trace
from torch_threads import pin_threads, subproc  # noqa: F401

S, MAX_NEW, SEED = 64, 6, 11
MESHES = {"1x1": (1, 1), "2x2": (2, 2)}
EVENTS = ((4, "drain", 1), (9, "respawn", 1), (7, "drain", 2))
CHAOS = ((2, "crash", 0, 1.0), (4, "straggler", 1, 8.0))
RESPAWN_DELAY = 2

JAX_CODE = r"""
import os, json
os.environ["REPRO_OBS"] = "0"
import jax, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base
from repro.fleet import Fleet, FleetConfig, FleetEvent
from repro.models import transformer as T
from repro.resilience import (ChaosSchedule, FaultEvent, FleetSupervisor,
                              SupervisorConfig)
from repro.resilience.fakes import FakeTimer
from repro.serve.engine import ServeConfig, make_serve_fns
from repro.serve.scheduler import poisson_trace

cfg = base.reduced(base.get_config("gemma3-4b")).replace(
    dtype="float32", cache_dtype="float32")
S, MAX_NEW, SEED = {S!r}, {new!r}, {seed!r}
params = T.init_params(jax.random.key(0), cfg)
np.savez({npz!r}, *[np.asarray(x) for x in jax.tree.leaves(params)])
out = {{}}
for tag, (dp, tp) in {meshes!r}.items():
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    with set_mesh(mesh):
        fns = make_serve_fns(cfg, ServeConfig(dp_axes=("data",)), mesh, 3, S)
        for chaos in (None, ChaosSchedule([FaultEvent(*e)
                                           for e in {chaos!r}])):
            trace = poisson_trace(10, 1.0, (5, 40), MAX_NEW, cfg.vocab_size,
                                  seed=5, n_sessions=3)
            fleet = Fleet(cfg, fns, params,
                          FleetConfig(n_replicas=3, n_slots=3, seed=SEED), S,
                          timer=FakeTimer())
            fleet.submit_trace(trace)
            if chaos is None:
                fleet.run(events=[FleetEvent(*e) for e in {events!r}])
                key = tag + "_fleet"
            else:
                sup = FleetSupervisor(fleet, chaos, SupervisorConfig(
                    respawn_delay={delay!r}))
                sup.run()
                key = tag + "_chaos"
                out[tag + "_crashes"] = [
                    [c.replica, c.crash_tick, c.displaced, c.respawn_tick]
                    for c in sup.crash_log]
                out[tag + "_mttr"] = sup.mttr()
            assert all(r.finished for r in trace)
            out[key] = [[int(t) for t in r.generated] for r in trace]
with open({path!r}, "w") as f:
    json.dump(out, f)
print("JAX_OK")
"""


def _cfg():
    return base.reduced(base.get_config("gemma3-4b")).replace(
        dtype="float32", cache_dtype="float32")


@pytest.fixture(scope="module")
def jax_run(subproc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_fleet")
    out = subproc(JAX_CODE.format(
        S=S, new=MAX_NEW, seed=SEED, meshes=MESHES, chaos=CHAOS,
        events=EVENTS, delay=RESPAWN_DELAY, npz=str(tmp / "params.npz"),
        path=str(tmp / "streams.json")), 4, 600)
    assert "JAX_OK" in out
    with open(tmp / "streams.json") as f:
        res = json.load(f)
    cfg = _cfg()
    shapes = TFm.param_shapes(cfg)
    with np.load(tmp / "params.npz") as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    res["params"] = params_from_numpy(TR.unflatten(shapes, leaves), cfg,
                                      "cpu")
    return res


def _trace(temperature):
    return poisson_trace(10, 1.0, (5, 40), MAX_NEW, _cfg().vocab_size,
                         seed=5, temperature=temperature, n_sessions=3)


def _serve(params, dp, tp, n_replicas, n_slots, events=(), chaos=None,
           temperature=0.0):
    """One fleet run on the port: (streams, stats, supervisor)."""
    cfg = _cfg()
    fns = E.make_serve_fns(cfg, E.ServeConfig(), n_slots, S, "cpu",
                           dp=dp, tp=tp)
    trace = _trace(temperature)
    fleet = Fleet(cfg, fns, params, FleetConfig(
        n_replicas=n_replicas, n_slots=n_slots, seed=SEED), S,
        timer=FakeTimer())
    fleet.submit_trace(trace)
    sup = None
    if chaos is None:
        stats = fleet.run(events=[FleetEvent(*e) for e in events])
    else:
        sup = FleetSupervisor(fleet, ChaosSchedule(
            [FaultEvent(*e) for e in chaos]),
            SupervisorConfig(respawn_delay=RESPAWN_DELAY))
        stats = sup.run()
    assert all(r.finished and len(r.generated) == MAX_NEW for r in trace)
    return [[int(t) for t in r.generated] for r in trace], stats, sup


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fleet_drain_respawn_matches_single_and_jax(jax_run, mesh):
    """3 replicas x 3 pages with drains and a respawn: the port's single
    9-page replica's greedy streams and the reference's fleet's."""
    dp, tp = MESHES[mesh]
    single, _, _ = _serve(jax_run["params"], dp, tp, 1, 9)
    fleet, stats, _ = _serve(jax_run["params"], dp, tp, 3, 3, EVENTS)
    assert fleet == single
    assert fleet == jax_run[mesh + "_fleet"]
    assert stats["replicas"][1]["respawns"] == 1
    assert stats["replicas"][2]["state"] == "stopped"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_supervised_fleet_matches_calm_fleet_and_jax(jax_run, mesh):
    """Crash r0@2 and straggler r1@4: one crash that displaces in-flight
    work, recovered in 2 ticks; the undisturbed fleet's streams, the
    reference's supervised streams and crash log."""
    dp, tp = MESHES[mesh]
    calm, _, _ = _serve(jax_run["params"], dp, tp, 3, 3)
    chaotic, stats, sup = _serve(jax_run["params"], dp, tp, 3, 3,
                                 chaos=CHAOS)
    assert chaotic == calm
    assert chaotic == jax_run[mesh + "_chaos"]
    log = [[c.replica, c.crash_tick, c.displaced, c.respawn_tick]
           for c in sup.crash_log]
    assert log == jax_run[mesh + "_crashes"]
    assert len(log) == 1 and log[0][0] == 0 and log[0][2] >= 1
    assert sup.crash_log[0].ttr == 2 and sup.mttr() == 2.0 == \
        jax_run[mesh + "_mttr"]
    res = stats["resilience"]
    assert res["final_health"][0]["respawns"] == 1
    assert res["chaos_signature"] == "2:crash:0:1 4:straggler:1:8"


def test_sampled_fleet_and_chaos_match_port_runs(jax_run):
    """Temperature 0.8 at (1, 1): the fleet's streams are the single
    replica's, and the supervised chaotic run's the undisturbed fleet's."""
    params = jax_run["params"]
    single, _, _ = _serve(params, 1, 1, 1, 9, temperature=0.8)
    fleet, _, _ = _serve(params, 1, 1, 3, 3, EVENTS, temperature=0.8)
    calm, _, _ = _serve(params, 1, 1, 3, 3, temperature=0.8)
    chaotic, _, sup = _serve(params, 1, 1, 3, 3, chaos=CHAOS,
                             temperature=0.8)
    assert fleet == single
    assert chaotic == calm
    assert len(sup.crash_log) == 1 and sup.crash_log[0].displaced >= 1
    greedy, _, _ = _serve(params, 1, 1, 1, 9)
    assert single != greedy      # the draws did sample
