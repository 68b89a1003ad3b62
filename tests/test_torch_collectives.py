"""Stacked and fused collectives of the port are BITWISE equal to the JAX
package's ``shmap`` and ``pallas_fused`` collectives at p in {4, 8}, and to
each other.  The JAX side runs once, on 8 forced host devices in a
subprocess, and hands its outputs over as an ``.npz``."""

import numpy as np
import pytest
import torch

from repro_torch.collectives import stacked
from repro_torch.kernels.collectives import kernel as K
from repro_torch.kernels.collectives import ops
from torch_threads import pin_threads, subproc  # noqa: F401

PS = (4, 8)


def inputs(p: int):
    """Per-rank inputs, made from a seed with numpy."""
    rng = np.random.RandomState(100 + p)
    return {
        "flat": rng.randn(p, p * 512).astype(np.float32),      # aligned
        "odd": rng.randn(p, p * 96).astype(np.float32),        # int8 fallback
        "small": rng.randn(p, 5).astype(np.float32),
        "dim": rng.randn(p, 3, p * 4, 5).astype(np.float32),
    }


JAX_CODE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.collectives import shmap
from repro.compat import shard_map
from repro.kernels import collectives as fused
sys.path.insert(0, {tests!r})
from test_torch_collectives import inputs

out = {{}}
for p in (4, 8):
    mesh = Mesh(np.asarray(jax.devices()[:p]).reshape(p), ("x",))
    def run(fn, x, tag):
        f = jax.jit(shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                              in_specs=P("x"), out_specs=P("x"),
                              check_vma=False))
        out[f"{{tag}}_p{{p}}"] = np.asarray(f(jnp.asarray(x)))
    xs = inputs(p)
    for name, mod in (("shmap", shmap), ("fused", fused)):
        run(lambda v: mod.reduce_scatter(v, "x"), xs["flat"], f"{{name}}_rs")
        run(lambda v: mod.allgather(v, "x"), xs["flat"], f"{{name}}_ag")
        run(lambda v: mod.reduce_scatter_q(v, "x"), xs["flat"],
            f"{{name}}_rsq")
        run(lambda v: mod.reduce_scatter_q(v, "x"), xs["odd"],
            f"{{name}}_rsq_odd")
        run(lambda v: mod.allgather_q(v, "x"), xs["flat"], f"{{name}}_agq")
        run(lambda v: mod.reduce_scatter_dim(v, 1, "x"), xs["dim"],
            f"{{name}}_rsd")
        run(lambda v: mod.allgather_dim(v, 1, "x"), xs["dim"], f"{{name}}_agd")
    run(lambda v: shmap.allreduce_butterfly(v, "x"), xs["flat"], "shmap_ar")
    run(lambda v: shmap.allreduce_butterfly(v, "x"), xs["small"],
        "shmap_ar_small")
    run(lambda v: fused.allreduce(v, "x"), xs["flat"], "fused_ar")
    run(lambda v: fused.allreduce(v, "x"), xs["small"], "fused_ar_small")
    run(lambda v: shmap.allreduce_small(v, "x"), xs["small"], "shmap_ars")
np.savez({path!r}, **out)
print("JAX_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    import os
    path = str(tmp_path_factory.mktemp("jax_collectives") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    subproc(JAX_CODE.format(tests=tests, path=path), devices=8, timeout=600)
    return dict(np.load(path))


def _bits(a):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, exp, tag):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == exp.shape, (tag, got.shape, exp.shape)
    np.testing.assert_array_equal(_bits(got), _bits(exp), err_msg=tag)


#: (jax tag suffix, port call, input)
CASES = {
    "rs": (lambda m, x: m.reduce_scatter(x), "flat"),
    "ag": (lambda m, x: m.allgather(x), "flat"),
    "rsq": (lambda m, x: m.reduce_scatter_q(x), "flat"),
    "rsq_odd": (lambda m, x: m.reduce_scatter_q(x), "odd"),
    "agq": (lambda m, x: m.allgather_q(x), "flat"),
    "rsd": (lambda m, x: m.reduce_scatter_dim(x, 1), "dim"),
    "agd": (lambda m, x: m.allgather_dim(x, 1), "dim"),
}


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_and_fused_match_jax(jax_out, case, p):
    fn, key = CASES[case]
    x = torch.from_numpy(inputs(p)[key])
    got_s = fn(stacked, x)
    got_f = fn(ops, x)
    # port-internally, fused == stacked bitwise (as the reference asserts)
    _same(got_f, got_s.numpy(), f"fused vs stacked {case} p{p}")
    exp_shmap = jax_out[f"shmap_{case}_p{p}"].reshape(got_s.shape)
    exp_fused = jax_out[f"fused_{case}_p{p}"].reshape(got_s.shape)
    _same(got_s, exp_shmap, f"stacked vs shmap {case} p{p}")
    _same(got_f, exp_fused, f"ops vs pallas_fused {case} p{p}")


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("key", ["flat", "small"])
def test_allreduce_matches_jax(jax_out, key, p):
    x = torch.from_numpy(inputs(p)[key])
    sfx = "" if key == "flat" else "_small"
    got_s = stacked.allreduce_butterfly(x)
    got_f = ops.allreduce(x)
    _same(got_f, got_s.numpy(), f"fused vs stacked allreduce{sfx} p{p}")
    _same(got_s, jax_out[f"shmap_ar{sfx}_p{p}"].reshape(x.shape), "shmap")
    _same(got_f, jax_out[f"fused_ar{sfx}_p{p}"].reshape(x.shape), "fused")
    if key == "small":
        _same(stacked.allreduce_small(x),
              jax_out[f"shmap_ars_p{p}"].reshape(x.shape), "allreduce_small")


def test_fused_path_goes_through_the_step_wrappers(monkeypatch):
    """The fused collectives call the kernel wrappers (counted on the card),
    the aligned int8 RS included; the unaligned one takes the stacked int8
    path, as in the reference."""
    calls = {"rs_step": 0, "ag_step": 0, "rs_step_q": 0}
    for name in calls:
        real = getattr(K, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(K, name, spy)
    xs = inputs(8)
    q = ops.reduce_scatter_q(torch.from_numpy(xs["flat"]))
    ops.allgather_q(q)
    ops.allreduce(torch.from_numpy(xs["flat"]))
    assert calls == {"rs_step": 3, "ag_step": 6, "rs_step_q": 3}
    ops.reduce_scatter_q(torch.from_numpy(xs["odd"]))
    assert calls["rs_step_q"] == 3
