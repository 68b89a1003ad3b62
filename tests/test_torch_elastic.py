"""Survivor-set rescheduling on the port (``repro_torch.resilience.elastic``)
against the reference's.

Plans, in process: ``survivor_set``, ``plan_survivors`` (its
``describe()`` and its schedules at p'), ``elastic_backend``,
``elastic_train_config`` and ``replan_buckets`` (the ZeRO layout and the
bucket plan at p' on reduced phi4-mini's shapes) equal the reference's
for p in {4, 8, 12} losing 1 or 2 ranks, exactly (host logic over copies
of the same planners).

The resume, reduced phi4-mini in float32, global batch 12 x 64 (it
divides over 4 ranks and over 3): the port trains 4 stacked ranks on
``pallas_fused`` with the int8 wire for 2 steps and saves the global state
(``train.checkpoint``, the reference's format); rank 1 is lost; the
survivors resume 2 steps at p' = 3 through ``elastic_train_config``
(``ring``, float32 wire: the int8 error-feedback buffers are dropped by
``elastic_restore``).  Held: bitwise equal, params and optimizer state,
to a fresh p' = 3 run configured by hand and restored from the same
checkpoint (as the reference's tests/resilience/test_elastic_resume.py
holds itself); the loss and grad norm of both resumed steps within rtol
1e-4 of the reference's elastic run from that same checkpoint (the bound
tests/test_torch_train_step.py holds the step to: float32 gradients
differ from JAX's in rounding).  And a checkpoint the reference wrote
from its own int8 run restores by path into the port's float32-wire
state at p' = 3, dropping the ``ef`` leaves and listing the same paths
as the reference's own ``elastic_restore``.  The JAX side runs in one
subprocess on 4 CPU devices under a plain ``jax.sharding.Mesh``.  Last,
the port alone: the same resume from a p = 4 job on ``wire_dtype="auto"``
(some buckets int8, the rest float32) is bitwise the fresh restore too.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro.resilience import elastic as JE
from repro.train.step import TrainConfig as JTrainConfig
from repro_torch import tree as T
from repro_torch.configs import base
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.resilience import elastic as TE
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import (TrainConfig, from_global, make_init_fns,
                                    make_train_step, to_global)
from torch_threads import pin_threads, subproc  # noqa: F401

P, LOST, P_NEW, STEPS, TAIL, BUCKET = 4, (1,), 3, 2, 2, 1 << 16
#: (p, lost ranks) of the plan comparisons
LOSSES = [(p, lost) for p in (4, 8, 12) for lost in ((1,), (0, p - 1))]
BACKENDS = ("bine", "recdoub", "ring", "xla", "bine_hier", "pallas_fused",
            "auto")


def _outcome(fn):
    """``("ok", value)`` or ``(exception type name, message)``."""
    try:
        return "ok", fn()
    except Exception as e:      # the outcome under test
        return type(e).__name__, str(e)


def _cfg():
    return base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32")


def _tcfg(backend="pallas_fused", wire="int8"):
    return TrainConfig(backend=backend, wire_dtype=wire, bucket_bytes=BUCKET,
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,lost", LOSSES)
def test_survivor_plans_match_jax(p, lost):
    assert TE.survivor_set(p, lost) == JE.survivor_set(p, lost)
    for backend in BACKENDS:
        assert TE.elastic_backend(backend, p - len(lost)) == \
            JE.elastic_backend(backend, p - len(lost))
        for topology in ("lumi", "torus", "tpu_multipod"):
            t = TE.plan_survivors(p, lost, backend, topology)
            j = JE.plan_survivors(p, lost, backend, topology)
            assert t.describe() == j.describe()
            assert (t.degraded, t.fell_back, t.survivors) == \
                (j.degraded, j.fell_back, j.survivors)
        for coll in ("reduce_scatter", "allgather", "allreduce"):
            ts = t.schedule(coll)
            js = j.schedule(coll)
            assert [[dataclasses.astuple(m) for m in step] for step in ts] \
                == [[dataclasses.astuple(m) for m in step] for step in js]


def test_survivor_set_errors_match_jax():
    for p, lost in ((4, [4]), (4, [1, 1]), (2, [0, 1]), (0, []), (3, [-1])):
        assert _outcome(lambda: TE.survivor_set(p, lost)) == \
            _outcome(lambda: JE.survivor_set(p, lost))


@pytest.mark.parametrize("p,lost", LOSSES)
def test_elastic_train_config_and_buckets_match_jax(p, lost):
    """The survivors' config (backend, wire, or the same object at a
    still-pow2 p') and their (zero layout, bucket plan) on reduced
    phi4-mini at two capacities and two wires."""
    p_new = p - len(lost)
    for backend in ("bine", "pallas_fused", "recdoub", "ring", "auto"):
        for wire in ("float32", "bfloat16", "int8", "auto"):
            kw = dict(backend=backend, wire_dtype=wire)
            t = _outcome(lambda: TrainConfig(**kw))
            j = _outcome(lambda: JTrainConfig(**kw))
            assert t[0] == j[0], kw
            if t[0] != "ok":
                continue
            tn = TE.elastic_train_config(t[1], p_new)
            jn = JE.elastic_train_config(j[1], p_new)
            assert (tn.backend, tn.wire_dtype) == (jn.backend, jn.wire_dtype)
            assert (tn is t[1]) == (jn is j[1])
    tshapes = TF.param_shapes(_cfg())
    jcfg = jbase.reduced(jbase.get_config("phi4-mini-3.8b")).replace(
        dtype="float32")
    jshapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                             jax.random.key(0))
    for cap, item in ((1 << 16, 4.0), (1 << 20, 1.0 + 4.0 / 256)):
        tl, tp = TE.replan_buckets(_cfg(), tshapes, p_new, cap, item)
        jl, jp = JE.replan_buckets(jcfg, jshapes, p_new, cap, item)
        assert T.flatten(tl) == jax.tree.leaves(jl)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


# ---------------------------------------------------------------------------
# The resume
# ---------------------------------------------------------------------------

JAX_CODE = r"""
import os, json
os.environ["REPRO_OBS"] = "0"
import jax, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base
from repro.models import transformer as T
from repro.optim.adamw import AdamWConfig
from repro.resilience import elastic
from repro.train import checkpoint as ckpt
from repro.train.data import DataConfig, make_batch
from repro.train.step import TrainConfig, make_train_step, make_init_fns

cfg = base.reduced(base.get_config("phi4-mini-3.8b")).replace(dtype="float32")
key = jax.random.key(0)
shapes = jax.eval_shape(lambda k: T.init_params(k, cfg), key)
dcfg = DataConfig(global_batch=12, seq_len=64, vocab_size=cfg.vocab_size)
tcfg0 = TrainConfig(backend="pallas_fused", dp_axes=("data",),
                    wire_dtype="int8", bucket_bytes={bucket},
                    adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                      total_steps=100))
out = {{}}

def mesh_of(p):
    return Mesh(np.asarray(jax.devices()[:p]).reshape(p, 1),
                ("data", "model"))

def advance(step, sh, params, state, start, n, log=None):
    for s in range(start, start + n):
        b = make_batch(dcfg, s)
        batch = {{k: jax.device_put(v, sh["batch"][k]) for k, v in b.items()}}
        params, state, m = step(params, state, batch)
        if log is not None:
            log.append([float(m["loss"]), float(m["grad_norm"])])
    return params, state

# the reference's own p = 4 int8 run, saved after {steps} steps
m4 = mesh_of({p})
step4, sh4, _ = make_train_step(cfg, tcfg0, m4, shapes)
ip4, is4 = make_init_fns(cfg, tcfg0, m4, shapes)
with set_mesh(m4):
    params = ip4(key)
    params, state = advance(step4, sh4, params, is4(params), 0, {steps})
    ckpt.save({ckpt_jax!r}, {steps}, {{"params": params, "state": state}})

# the survivors at p' = {p_new}, from each checkpoint
tcfgA = elastic.elastic_train_config(tcfg0, {p_new})
m3 = mesh_of({p_new})
stepA, shA, _ = make_train_step(cfg, tcfgA, m3, shapes)
ipA, isA = make_init_fns(cfg, tcfgA, m3, shapes)
with set_mesh(m3):
    for tag, path in (("jax", {ckpt_jax!r}), ("torch", {ckpt_torch!r})):
        params = ipA(key)
        tree, info = elastic.elastic_restore(
            path, {steps}, {{"params": params, "state": isA(params)}})
        out[tag + "_info"] = info
        if tag == "torch":
            params = jax.device_put(tree["params"], shA["params"])
            state = jax.device_put(tree["state"], shA["state"])
            log = []
            advance(stepA, shA, params, state, {steps}, {tail}, log)
            out["resumed"] = log
out["backend"], out["wire"] = tcfgA.backend, tcfgA.wire_dtype
with open({path!r}, "w") as f:
    json.dump(out, f)
print("JAX_OK")
"""


def _dcfg():
    return DataConfig(global_batch=12, seq_len=64,
                      vocab_size=_cfg().vocab_size)


def _advance(step, params, state, start, n, log=None):
    for s in range(start, start + n):
        params, state, m = step(params, state, make_batch(_dcfg(), s))
        assert np.isfinite(float(m["loss"]))
        if log is not None:
            log.append([float(m["loss"]), float(m["grad_norm"])])
    return params, state


def _restore(tcfg, path, n_dp):
    """``tcfg``'s fresh state at ``n_dp`` ranks restored by path from the
    checkpoint at ``path``: (params, state, info)."""
    cfg = _cfg()
    init_p, init_s = make_init_fns(cfg, tcfg, n_dp, "cpu")
    fresh = init_p(0)
    like = to_global(cfg, tcfg, fresh, init_s(fresh), n_dp, device="meta")
    tree, info = TE.elastic_restore(path, STEPS, like, device="cpu")
    params, state = from_global(cfg, tcfg, tree, n_dp, "cpu")
    return params, state, info


@pytest.fixture(scope="module")
def resume(subproc, tmp_path_factory):
    """The port's p = 4 run and checkpoint, then the reference's runs."""
    tmp = tmp_path_factory.mktemp("elastic")
    cfg, tcfg0 = _cfg(), _tcfg()
    step4, _, _ = make_train_step(cfg, tcfg0, P, TF.param_shapes(cfg), "cpu")
    init_p, init_s = make_init_fns(cfg, tcfg0, P, "cpu")
    params = init_p(0)
    from repro_torch.kernels import build as KB
    KB.reset_launches()
    params, state = _advance(step4, params, init_s(params), 0, STEPS)
    assert "ef" in state
    ck_torch = str(tmp / "ckpt_torch")
    ckpt.save(ck_torch, STEPS, to_global(cfg, tcfg0, params, state, P))
    out = subproc(JAX_CODE.format(
        bucket=BUCKET, steps=STEPS, p=P, p_new=P_NEW, tail=TAIL,
        ckpt_jax=str(tmp / "ckpt_jax"), ckpt_torch=ck_torch,
        path=str(tmp / "jax.json")), 4, 600)
    assert "JAX_OK" in out
    with open(tmp / "jax.json") as f:
        res = json.load(f)
    res.update(ckpt_torch=ck_torch, ckpt_jax=str(tmp / "ckpt_jax"))
    return res


def test_elastic_resume_bitwise_fresh_restore_and_near_jax(resume):
    """Lose rank 1 of 4: the elastic resume at p' = 3 equals a fresh
    hand-configured p' = 3 run from the same checkpoint bit for bit, and
    its losses and grad norms the reference's within rtol 1e-4."""
    plan = TE.plan_survivors(P, LOST, backend="pallas_fused",
                             topology="lumi")
    assert plan.p_new == P_NEW and plan.backend == "ring" and plan.fell_back
    assert plan.survivors == (0, 2, 3)
    tcfgA = TE.elastic_train_config(_tcfg(), P_NEW)
    assert (tcfgA.backend, tcfgA.wire_dtype) == ("ring", "float32") == \
        (resume["backend"], resume["wire"])
    tcfgB = _tcfg("ring", "float32")
    cfg, runs = _cfg(), []
    for tcfg in (tcfgA, tcfgB):
        params, state, info = _restore(tcfg, resume["ckpt_torch"], P_NEW)
        assert info["kept_init"] == []
        assert info["dropped"] and all("['ef']" in p
                                       for p in info["dropped"])
        assert info == resume["torch_info"]
        step, _, _ = make_train_step(cfg, tcfg, P_NEW, TF.param_shapes(cfg),
                                     "cpu")
        log = []
        params, state = _advance(step, params, state, STEPS, TAIL, log)
        runs.append((to_global(cfg, tcfg, params, state, P_NEW), log))
    (ga, la), (gb, lb) = runs
    assert la == lb
    fa, fb = T.flatten_with_path(ga), T.flatten_with_path(gb)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, a), (_, b) in zip(fa, fb):
        assert torch.equal(a, b), T.keystr(path)
    np.testing.assert_allclose(np.asarray(la), np.asarray(resume["resumed"]),
                               rtol=1e-4)


def test_jax_int8_checkpoint_restores_by_path(resume):
    """The reference's own int8-wire checkpoint into the port's
    float32-wire state at p' = 3: the ``ef`` leaves dropped, the paths
    the reference's ``elastic_restore`` lists, every other leaf restored
    bit for bit."""
    tcfgA = TE.elastic_train_config(_tcfg(), P_NEW)
    params, state, info = _restore(tcfgA, resume["ckpt_jax"], P_NEW)
    assert info == resume["jax_info"]
    assert info["dropped"] and info["kept_init"] == []
    assert "ef" not in state
    d = os.path.join(resume["ckpt_jax"], f"step_{STEPS:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        paths = json.load(f)["paths"]
    back = to_global(_cfg(), tcfgA, params, state, P_NEW)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        for path, leaf in T.flatten_with_path(back):
            i = paths.index(T.keystr(path))
            np.testing.assert_array_equal(leaf.numpy(), z[f"a{i}"])


def test_elastic_resume_auto_wire_bitwise(tmp_path):
    """``wire_dtype="auto"`` at p = 4 (the joint table's per-bucket wire:
    some buckets int8 with error feedback, the rest float32): the
    survivors' resume at p' = 3 drops the int8 buckets' ``ef`` leaves and
    is bitwise the fresh hand-configured p' = 3 restore."""
    cfg, tcfg0 = _cfg(), _tcfg(wire="auto")
    step4, info, _ = make_train_step(cfg, tcfg0, P, TF.param_shapes(cfg),
                                     "cpu")
    assert {d[1] for d in info["decisions"]} == {"float32", "int8"}
    init_p, init_s = make_init_fns(cfg, tcfg0, P, "cpu")
    params = init_p(0)
    params, state = _advance(step4, params, init_s(params), 0, STEPS)
    path = str(tmp_path / "ckpt")
    ckpt.save(path, STEPS, to_global(cfg, tcfg0, params, state, P))
    tcfgA = TE.elastic_train_config(tcfg0, P_NEW)
    assert (tcfgA.backend, tcfgA.wire_dtype) == ("ring", "float32")
    runs = []
    for tcfg in (tcfgA, _tcfg("ring", "float32")):
        params, state, info = _restore(tcfg, path, P_NEW)
        assert info["dropped"] and all("['ef']" in d
                                       for d in info["dropped"])
        step, _, _ = make_train_step(cfg, tcfg, P_NEW, TF.param_shapes(cfg),
                                     "cpu")
        params, state = _advance(step, params, state, STEPS, TAIL)
        runs.append(T.flatten(to_global(cfg, tcfg, params, state, P_NEW)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_restore_into_a_wider_state_needs_its_init_values(tmp_path):
    """A float32-wire checkpoint at p = 4 restored into the int8 wire's
    state, which adds the ``ef`` leaves: with ``like`` on the meta device
    it raises ``ValueError`` naming an ``ef`` path (no value to keep);
    with ``like`` on the CPU the ``ef`` leaves keep their init values and
    are listed as ``kept_init``, every other leaf restored bit for bit.
    A leaf whose global shape differs raises ``ValueError``."""
    cfg = _cfg()
    t32, t8 = _tcfg(wire="float32"), _tcfg(wire="int8")
    ip, is_ = make_init_fns(cfg, t32, P, "cpu")
    params = ip(0)
    saved = to_global(cfg, t32, params, is_(params), P)
    path = str(tmp_path / "ckpt")
    ckpt.save(path, STEPS, saved)
    ip8, is8 = make_init_fns(cfg, t8, P, "cpu")
    fresh = ip8(1)
    like = to_global(cfg, t8, fresh, is8(fresh), P)
    meta = to_global(cfg, t8, fresh, is8(fresh), P, device="meta")
    with pytest.raises(ValueError, match=r"\['ef'\].*meta device"):
        TE.elastic_restore(path, STEPS, meta, device="cpu")
    tree, info = TE.elastic_restore(path, STEPS, like, device="cpu")
    assert info["dropped"] == []
    assert info["kept_init"] and all("['ef']" in p
                                     for p in info["kept_init"])
    kept = set(info["kept_init"])
    old = {T.keystr(p): v for p, v in T.flatten_with_path(saved)}
    init = {T.keystr(p): v for p, v in T.flatten_with_path(like)}
    for p, v in T.flatten_with_path(tree):
        k = T.keystr(p)
        assert torch.equal(v, init[k] if k in kept else old[k]), k
    bad = T.map_with_path(
        lambda p, x: x[..., :1] if T.keystr(p).endswith("['embed']") else x,
        like)
    with pytest.raises(ValueError, match="embed"):
        TE.elastic_restore(path, STEPS, bad, device="cpu")
