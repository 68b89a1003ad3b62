"""The port's two-tier collectives (``bine_hier``) against the JAX package's.

At p = 8 (320 float32 elements a rank, made from a seed with numpy):

  * the schedule-IR executor: ``stacked.reduce_scatter_sched`` /
    ``allgather_sched`` / ``allreduce_sched`` on ``compose`` of the tier
    stacks ``tier_split`` gives for tpu_multipod (4, 2) and lumi (8,),
    and of (2, 4) and (2, 2, 2), against ``shmap``'s;
  * ``stacked.allreduce_hierarchical`` and the API's ``bine_hier`` over
    two axes, (pods, data) = (2, 4) and (4, 2), against ``shmap`` and
    ``api`` with ``outer_axis="pod", inner_axis="data"`` on a
    ``("pod", "data")`` mesh;
  * every API collective under one-axis ``bine_hier`` on tpu_multipod,
    lumi and marenostrum5.

All BITWISE: each element takes the same float32 adds in the same order
(``index_add_`` lands ``block + recv`` once a block, as ``.at[].add``
does).  The error paths raise the reference's exception types: the torus
preset (named in the message), a non-power-of-two p (6), a length not
divisible by p.  The JAX side runs once in a subprocess on 8 forced host
devices and hands its outputs over as an ``.npz``.
"""

import os

import numpy as np
import pytest
import torch

from repro.collectives import shmap as jshmap
from repro.core import schedules as jsc
from repro_torch.collectives import api, stacked
from repro_torch.core import schedules as tsc
from torch_threads import pin_threads, subproc  # noqa: F401

P = 8
#: tier stacks of the executor cases: tier_split of tpu_multipod and lumi
#: at p = 8, and two more
TIERS = ((4, 2), (8,), (2, 4), (2, 2, 2))
#: (pods, data) of the two-axis cases
SHAPES = ((2, 4), (4, 2))
#: one-axis bine_hier presets of the API cases
PRESETS = ("tpu_multipod", "lumi", "marenostrum5")
COLLECTIVES = ("reduce_scatter", "allgather", "allreduce", "allreduce_small",
               "broadcast", "reduce", "gather", "scatter", "all_to_all")
ROOTED = ("broadcast", "reduce", "gather", "scatter")
ROOT = 1
#: error cases: tag -> (p, preset, collective, input key)
ERRORS = {
    "torus": (8, "torus", "reduce_scatter", "vec"),
    "nowhere": (8, "nowhere", "allgather", "blk"),
    "p6": (6, "tpu_multipod", "allreduce", "vec"),
    "odd_length": (8, "tpu_multipod", "reduce_scatter", "odd"),
}


def inputs(p: int = P):
    rng = np.random.RandomState(700 + p)
    return {"vec": rng.randn(p, p * 40).astype(np.float32),
            "blk": rng.randn(p, 40).astype(np.float32),
            "small": rng.randn(p, 5).astype(np.float32),
            "odd": rng.randn(p, p * 40 + 4).astype(np.float32),
            "a2a": rng.randn(p, p, 3).astype(np.float32)}


def key_of(coll):
    return {"allgather": "blk", "gather": "blk", "allreduce_small": "small",
            "all_to_all": "a2a"}.get(coll, "vec")


def call(mod, coll, x, cfg, *axis):
    """One API collective of either package (the JAX one takes an axis)."""
    if coll in ROOTED:
        return getattr(mod, coll)(x, *axis, ROOT, cfg)
    fn = "allreduce" if coll == "allreduce_small" else coll
    return getattr(mod, fn)(x, *axis, cfg)


JAX_CODE = r"""
import os, sys
os.environ["REPRO_OBS"] = "0"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.collectives import api, shmap
from repro.compat import shard_map
from repro.core.schedules import compose
sys.path.insert(0, {tests!r})
from test_torch_hier import (COLLECTIVES, ERRORS, PRESETS, SHAPES, TIERS,
                             call, inputs, key_of)

out = {{}}

def run(mesh, spec, fn, x):
    f = shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=(spec,),
                  out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))

xs = inputs()
flat = Mesh(np.asarray(jax.devices()[:8]), ("x",))
for tiers in TIERS:
    t = "x".join(map(str, tiers))
    for coll, key in (("reduce_scatter", "vec"), ("allgather", "blk"),
                      ("allreduce", "vec"), ("allreduce", "odd")):
        sched = compose(coll, tiers, "bine")
        fn = getattr(shmap, coll + "_sched")
        out[f"sched|{{t}}|{{coll}}|{{key}}"] = run(
            flat, P("x"), lambda v, f=fn, s=sched: f(v, "x", s), xs[key])
for shape in SHAPES:
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(shape), ("pod", "data"))
    spec = P(("pod", "data"))
    s = "x".join(map(str, shape))
    cfg = api.CollectiveConfig(backend="bine_hier", inner_axis="data",
                               outer_axis="pod")
    for coll in ("reduce_scatter", "allgather", "allreduce"):
        key = key_of(coll)
        out[f"two|{{s}}|{{coll}}"] = run(
            mesh, spec, lambda v, c=coll: call(api, c, v, cfg,
                                               ("pod", "data")), xs[key])
    for key in ("vec", "odd", "small"):
        out[f"hierarchical|{{s}}|{{key}}"] = run(
            mesh, spec, lambda v: shmap.allreduce_hierarchical(
                v, "data", "pod", "bine"), xs[key])
for preset in PRESETS:
    cfg = api.CollectiveConfig(backend="bine_hier", topology=preset)
    for coll in COLLECTIVES:
        out[f"api|{{preset}}|{{coll}}"] = run(
            flat, P("x"), lambda v, c=coll: call(api, c, v, cfg, "x"),
            xs[key_of(coll)])
for tag, (p, preset, coll, key) in ERRORS.items():
    mesh = Mesh(np.asarray(jax.devices()[:p]), ("x",))
    cfg = api.CollectiveConfig(backend="bine_hier", topology=preset)
    f = shard_map(lambda v: call(api, coll, v[0], cfg, "x")[None], mesh=mesh,
                  in_specs=(P("x"),), out_specs=P("x"), check_vma=False)
    try:
        jax.eval_shape(f, jnp.asarray(inputs(p)[key]))
        out[f"err|{{tag}}"] = np.asarray("no error")
    except Exception as e:
        out[f"err|{{tag}}"] = np.asarray(f"{{type(e).__name__}}: {{e}}")
np.savez({path!r}, **out)
print("JAX_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_hier") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    subproc(JAX_CODE.format(tests=tests, path=path), 8, 600)
    return dict(np.load(path))


def _same(got, exp, tag):
    got = got.numpy()
    exp = np.asarray(exp).reshape(got.shape)
    assert got.dtype == exp.dtype == np.float32, (tag, got.dtype, exp.dtype)
    np.testing.assert_array_equal(got.view(np.int32), exp.view(np.int32),
                                  err_msg=tag)


def _x(key, p=P):
    return torch.from_numpy(inputs(p)[key])


@pytest.mark.parametrize("tiers", TIERS, ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("coll,key", [("reduce_scatter", "vec"),
                                      ("allgather", "blk"),
                                      ("allreduce", "vec"),
                                      ("allreduce", "odd")])
def test_run_schedule_matches_jax(jax_out, coll, key, tiers):
    sched = tsc.compose(coll, tiers, "bine")
    got = getattr(stacked, coll + "_sched")(_x(key), sched)
    t = "x".join(map(str, tiers))
    _same(got, jax_out[f"sched|{t}|{coll}|{key}"], f"{t} {coll} {key}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("coll", ["reduce_scatter", "allgather", "allreduce"])
def test_two_axis_api_matches_jax(jax_out, coll, shape):
    cfg = api.CollectiveConfig(backend="bine_hier", dp_shape=shape)
    got = call(api, coll, _x(key_of(coll)), cfg)
    s = "x".join(map(str, shape))
    _same(got, jax_out[f"two|{s}|{coll}"], f"two-axis {s} {coll}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("key", ["vec", "odd", "small"])
def test_allreduce_hierarchical_matches_jax(jax_out, key, shape):
    got = stacked.allreduce_hierarchical(_x(key), shape, 1, 0, "bine")
    s = "x".join(map(str, shape))
    _same(got, jax_out[f"hierarchical|{s}|{key}"], f"hierarchical {s} {key}")


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("coll", COLLECTIVES)
def test_one_axis_api_matches_jax(jax_out, coll, preset):
    cfg = api.CollectiveConfig(backend="bine_hier", topology=preset)
    got = call(api, coll, _x(key_of(coll)), cfg)
    _same(got, jax_out[f"api|{preset}|{coll}"], f"{preset} {coll}")


@pytest.mark.parametrize("tag", sorted(ERRORS))
def test_errors_match_jax_types(jax_out, tag):
    p, preset, coll, key = ERRORS[tag]
    err = str(jax_out[f"err|{tag}"])
    assert err != "no error", tag
    etype, msg = err.split(": ", 1)
    cfg = api.CollectiveConfig(backend="bine_hier", topology=preset)
    with pytest.raises(Exception) as info:
        call(api, coll, _x(key, p), cfg)
    assert type(info.value).__name__ == etype, (tag, info.value, err)
    if preset != "tpu_multipod":      # the preset is named, in both
        assert repr(preset) in msg and repr(preset) in str(info.value)


@pytest.mark.parametrize("tiers", TIERS + ((4, 4), (2, 8), (4, 16)),
                         ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("coll", ["reduce_scatter", "allgather",
                                  "allreduce"])
def test_schedule_tables_match_jax(coll, tiers):
    """The executor's static step tables equal the reference's."""
    got = stacked._schedule_tables(tsc.compose(coll, tiers, "bine"))
    exp = jshmap._schedule_tables(jsc.compose(coll, tiers, "bine"))
    assert len(got) == len(exp)
    for (gk, gp, gs, gr), (ek, ep, es, er) in zip(got, exp):
        assert (gk, gp) == (ek, ep)
        np.testing.assert_array_equal(gs, es)
        np.testing.assert_array_equal(gr, er)


def test_two_axis_ownership_is_inner_major():
    """Rank (o, i) of a two-axis reduce-scatter holds block i * outer + o,
    and the two-axis allgather puts every block back in place."""
    x = _x("vec")
    ref = x.double().sum(0).view(P, -1)
    for outer, inner in SHAPES:
        cfg = api.CollectiveConfig(backend="bine_hier",
                                   dp_shape=(outer, inner))
        rs = api.reduce_scatter(x, cfg)
        for r in range(P):
            o, i = divmod(r, inner)
            np.testing.assert_allclose(rs[r].double(), ref[i * outer + o],
                                       rtol=0, atol=1e-5)
        ag = api.allgather(rs, cfg)
        np.testing.assert_allclose(ag.double(), x.double().sum(0).expand(
            P, -1), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="dp_shape"):
        api.allreduce(x, api.CollectiveConfig(backend="bine_hier",
                                              dp_shape=(3, 2)))


def test_over_axis_keeps_reductions_in_their_group():
    """A sum over one axis of a (2, 4) stacking adds only that axis's
    ranks: over ``data`` the 4 ranks of a pod, over ``pod`` the 2 ranks
    with one data index."""
    x = torch.arange(8, dtype=torch.float32).view(8, 1).repeat(1, 8)
    inner = stacked.over_axis(stacked.allreduce_butterfly, x, (2, 4), 1)
    outer = stacked.over_axis(stacked.allreduce_butterfly, x, (2, 4), 0)
    assert inner[:, 0].tolist() == [6.0] * 4 + [22.0] * 4
    assert outer[:, 0].tolist() == [4.0, 6.0, 8.0, 10.0] * 2
    assert stacked.axis_groups((2, 4), 0) == ((0, 4), (1, 5), (2, 6), (3, 7))
