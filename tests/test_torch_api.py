"""The port's one-axis collectives API against the JAX package's.

Every API collective of ``repro_torch.collectives.api`` is held, on every
rank's row (not only the root's), against ``repro.collectives.api`` on the
same per-rank inputs:

  * BITWISE for ``bine``, ``recdoub``, ``ring``, ``pallas_fused`` x
    {bine, recdoub, ring} and ``auto`` on two presets, at p in {4, 8}, the
    rooted collectives also on int32 and bool, and the bf16 and int8 wires
    of reduce_scatter and allgather;
  * within rtol = atol = 1e-5 for ``xla``: its sums run in PyTorch's order
    and not XLA's, and a sum of at most 8 float32 values of magnitude < 10
    differs by a few ulps (~1e-6) between two orders;
  * at p = 6, ``ring`` and ``xla`` give the reference's results, and every
    butterfly path (``bine``, ``auto``, the int8 wire, ...) raises the
    reference's ``ValueError``;
  * the fused matmul collectives within rtol = atol = 1e-5, as the
    reference's own test holds its kernels: the matmul sums in another
    order than the reference's tiled dot;
  * the telemetry hook: one call of each of the eight collectives under
    ``bine``, ``recdoub``, ``ring``, ``xla``, ``pallas_fused`` and
    ``bine_hier`` at p in {4, 8} leaves a metrics registry (calls,
    payload and link bytes) equal to the one the reference's API records
    while tracing the same calls.

The JAX side runs once, on 8 forced host devices in a subprocess, and
hands its outputs over as an ``.npz``.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.collectives import api
from repro_torch.collectives import stacked
from repro_torch.kernels.collectives import kernel as K
from repro_torch.kernels.collectives import ops
from torch_threads import pin_threads, subproc  # noqa: F401

ROOT = 1
PS = (4, 8)
#: configuration name -> CollectiveConfig fields (both packages)
CONFIGS = {
    "bine": {"backend": "bine"},
    "recdoub": {"backend": "recdoub"},
    "ring": {"backend": "ring"},
    "xla": {"backend": "xla"},
    "fused_bine": {"backend": "pallas_fused"},
    "fused_recdoub": {"backend": "pallas_fused", "fused_algo": "recdoub"},
    "fused_ring": {"backend": "pallas_fused", "fused_algo": "ring"},
    "auto_tpu_multipod": {"backend": "auto"},
    "auto_torus": {"backend": "auto", "topology": "torus"},
}
#: compressed wires, for reduce_scatter and allgather
WIRES = {
    "bine_bf16": {"backend": "bine", "wire_dtype": "bfloat16"},
    "ring_bf16": {"backend": "ring", "wire_dtype": "bfloat16"},
    "bine_int8": {"backend": "bine", "wire_dtype": "int8"},
    "recdoub_int8": {"backend": "recdoub", "wire_dtype": "int8"},
    "fused_int8": {"backend": "pallas_fused", "wire_dtype": "int8"},
    "fused_ring_int8": {"backend": "pallas_fused", "fused_algo": "ring",
                        "wire_dtype": "int8"},
    "auto_wire": {"backend": "auto", "wire_dtype": "auto"},
}
#: configurations run at p = 6: ring and xla execute, the rest must raise
P6 = ("ring", "xla", "bine", "fused_bine", "auto_tpu_multipod", "auto_wire",
      "bine_int8")
#: collective -> input key
COLLECTIVES = {
    "reduce_scatter": "vec", "allgather": "blk", "allreduce": "vec",
    "allreduce_small": "small", "broadcast": "vec", "reduce": "vec",
    "gather": "blk", "scatter": "vec", "all_to_all": "a2a",
}
ROOTED = ("broadcast", "reduce", "gather", "scatter")
#: the telemetry hook's runs: backends, and the eight collectives each
#: called once (allreduce on the large vector)
OBS_BACKENDS = ("bine", "recdoub", "ring", "xla", "pallas_fused",
                "bine_hier")
OBS_COLLECTIVES = ("reduce_scatter", "allgather", "allreduce", "broadcast",
                   "reduce", "gather", "scatter", "all_to_all")
#: the rooted collectives on int32 and bool, under these configurations
DTYPE_CONFIGS = ("bine", "recdoub", "xla", "fused_bine")
MATMUL_ALGOS = ("bine", "recdoub", "ring")


def inputs(p: int):
    """Per-rank inputs ``[p, ...]``, made from a seed with numpy.  ``vec``
    is above the 16 KiB small-allreduce cutoff and its blocks are whole
    int8 codec chunks; ``small`` below it."""
    rng = np.random.RandomState(300 + p)
    return {
        "vec": rng.randn(p, p * 1536).astype(np.float32),
        "blk": rng.randn(p, 1536).astype(np.float32),
        "small": rng.randn(p, 5).astype(np.float32),
        "a2a": rng.randn(p, p, 3).astype(np.float32),
        "vec_int32": rng.randint(-1000, 1000, (p, p * 8)).astype(np.int32),
        "blk_int32": rng.randint(-1000, 1000, (p, 8)).astype(np.int32),
        "vec_bool": rng.rand(p, p * 8) > 0.5,
        "blk_bool": rng.rand(p, 8) > 0.5,
        # matmul collectives: rows per rank and widths off every 128 tile
        "mm_x": rng.randn(p, 10 * p, 20).astype(np.float32),
        "mm_xb": rng.randn(p, 10, 20).astype(np.float32),
        "mm_w": rng.randn(p, 20, 12).astype(np.float32),
    }


def call(mod, name, x, cfg, *axis):
    """One API collective of either package: the JAX one takes a mesh axis
    after ``x``, the port's stacked one does not."""
    if name in ROOTED:
        return getattr(mod, name)(x, *axis, ROOT, cfg)
    fn = "allreduce" if name == "allreduce_small" else name
    return getattr(mod, fn)(x, *axis, cfg)


def cases(p):
    """``(tag, config fields, collective, input key)`` for every JAX run."""
    out = []
    cfgs = {**CONFIGS, **WIRES}
    names = P6 if p == 6 else list(CONFIGS) + list(WIRES)
    for cname in names:
        colls = (("reduce_scatter", "allgather") if cname in WIRES
                 else tuple(COLLECTIVES))
        for coll in colls:
            out.append((f"{cname}|{coll}", cfgs[cname], coll,
                        COLLECTIVES[coll]))
        if cname in DTYPE_CONFIGS and p != 6:
            for coll in ROOTED:
                for dt in ("int32", "bool"):
                    key = ("blk" if coll == "gather" else "vec") + "_" + dt
                    out.append((f"{cname}|{coll}|{dt}", cfgs[cname], coll,
                                key))
    return out


JAX_CODE = r"""
import json, os, sys
os.environ["REPRO_OBS"] = "0"
# bf16 adds round to bf16 after every op, as the reference's code says and
# the port does (XLA on the CPU otherwise keeps float32 excess precision)
os.environ["XLA_FLAGS"] += " --xla_allow_excess_precision=false"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.collectives import api
from repro.compat import shard_map
from repro.kernels import collectives as fused
from repro.obs import metrics
sys.path.insert(0, {tests!r})
from test_torch_api import (cases, call, inputs, MATMUL_ALGOS, COLLECTIVES,
                            OBS_BACKENDS, OBS_COLLECTIVES)

out = {{}}
for p in {ps!r}:
    mesh = Mesh(np.asarray(jax.devices()[:p]).reshape(p), ("x",))
    xs = inputs(p)

    def smap(fn, n_in):
        return shard_map(lambda *a: fn(*[v[0] for v in a])[None], mesh=mesh,
                         in_specs=(P("x"),) * n_in, out_specs=P("x"),
                         check_vma=False)

    runs = []
    for tag, kw, coll, key in cases(p):
        cfg = api.CollectiveConfig(**kw)
        f = smap(lambda v, c=coll, cfg=cfg: call(api, c, v, cfg, "x"), 1)
        try:
            jax.eval_shape(f, jnp.asarray(xs[key]))
        except Exception as e:          # the trace raised: record it
            out[f"err|p{{p}}|{{tag}}"] = np.asarray(
                f"{{type(e).__name__}}: {{e}}")
            continue
        runs.append((tag, f, key))
    # one jitted program per configuration
    by_cfg = {{}}
    for tag, f, key in runs:
        by_cfg.setdefault(tag.split("|")[0], []).append((tag, f, key))
    for group in by_cfg.values():
        keys = [k for _, _, k in group]
        prog = jax.jit(lambda *a, g=group: tuple(
            f(x) for (_, f, _), x in zip(g, a)))
        res = prog(*[jnp.asarray(xs[k]) for k in keys])
        for (tag, _, _), r in zip(group, res):
            out[f"p{{p}}|{{tag}}"] = np.asarray(r)
    if p == 6:
        continue
    for algo in MATMUL_ALGOS:
        rs = jax.jit(smap(lambda x, w, a=algo: fused.matmul_reduce_scatter(
            x, w, "x", a), 2))
        ag = jax.jit(smap(lambda x, w, a=algo: fused.allgather_matmul(
            x, w, "x", a), 2))
        out[f"p{{p}}|mm_rs|{{algo}}"] = np.asarray(
            rs(jnp.asarray(xs["mm_x"]), jnp.asarray(xs["mm_w"])))
        out[f"p{{p}}|mm_ag|{{algo}}"] = np.asarray(
            ag(jnp.asarray(xs["mm_xb"]), jnp.asarray(xs["mm_w"])))
    # the telemetry hook records while a call is traced: one trace each
    for b in OBS_BACKENDS:
        metrics.get_registry().reset()
        metrics.set_enabled(True)
        cfg = api.CollectiveConfig(backend=b)
        for coll in OBS_COLLECTIVES:
            key = COLLECTIVES[coll]
            jax.eval_shape(smap(lambda v, c=coll: call(api, c, v, cfg, "x"),
                                1), jnp.asarray(xs[key]))
        metrics.set_enabled(False)
        out[f"obs|p{{p}}|{{b}}"] = np.asarray(
            json.dumps(metrics.get_registry().snapshot()))
np.savez({path!r}, **out)
print("JAX_OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    """The JAX runs, in two subprocesses at once (p = 8; p = 4 and 6)."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("jax_api")
    tests = os.path.dirname(os.path.abspath(__file__))
    jobs = {str(tmp / f"out{i}.npz"): ps
            for i, ps in enumerate([(8,), (4, 6)])}
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(subproc, JAX_CODE.format(
                tests=tests, path=path, ps=ps), 8, 600)
                for path, ps in jobs.items()]:
            f.result()
    out = {}
    for path in jobs:
        out.update(np.load(path))
    return out


def _np(t):
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _same(got, exp, tag):
    got = _np(got)
    exp = np.asarray(exp).reshape(got.shape)
    assert got.dtype == exp.dtype, (tag, got.dtype, exp.dtype)
    if got.dtype == np.float32:
        got, exp = got.view(np.int32), exp.view(np.int32)
    np.testing.assert_array_equal(got, exp, err_msg=tag)


def _close(got, exp, tag, tol=1e-5):
    got = _np(got)
    np.testing.assert_allclose(got, np.asarray(exp).reshape(got.shape),
                               rtol=tol, atol=tol, err_msg=tag)


def _port(p, kw, coll, key):
    x = torch.from_numpy(inputs(p)[key])
    return call(api, coll, x, api.CollectiveConfig(**kw))


def _check_case(jax_out, p, tag, kw, coll, key):
    err = jax_out.get(f"err|p{p}|{tag}")
    if err is not None:
        etype, msg = str(err).split(": ", 1)
        with pytest.raises(Exception) as info:
            _port(p, kw, coll, key)
        assert type(info.value).__name__ == etype, (tag, info.value, err)
        assert str(info.value) == msg, (tag, info.value, err)
        return
    got = _port(p, kw, coll, key)
    exp = jax_out[f"p{p}|{tag}"]
    if kw["backend"] == "xla" and np.asarray(exp).dtype == np.float32:
        _close(got, exp, tag)
    else:
        _same(got, exp, tag)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("coll", sorted(COLLECTIVES))
def test_collective_matches_jax(jax_out, coll, cfg, p):
    _check_case(jax_out, p, f"{cfg}|{coll}", CONFIGS[cfg], coll,
                COLLECTIVES[coll])


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("cfg", DTYPE_CONFIGS)
@pytest.mark.parametrize("coll", ROOTED)
@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_rooted_int_and_bool_match_jax(jax_out, dtype, coll, cfg, p):
    key = ("blk" if coll == "gather" else "vec") + "_" + dtype
    _check_case(jax_out, p, f"{cfg}|{coll}|{dtype}", CONFIGS[cfg], coll, key)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("cfg", sorted(WIRES))
@pytest.mark.parametrize("coll", ["reduce_scatter", "allgather"])
def test_wires_match_jax(jax_out, coll, cfg, p):
    _check_case(jax_out, p, f"{cfg}|{coll}", WIRES[cfg], coll,
                COLLECTIVES[coll])


P6_CASES = {c[0]: c for c in cases(6)}


@pytest.mark.parametrize("tag", sorted(P6_CASES))
def test_p6_runs_ring_and_xla_and_raises_elsewhere(jax_out, tag):
    """At p = 6 ring and xla run; the butterfly paths raise the
    reference's ``ValueError: p=6 is not a power of two``."""
    _, kw, coll, key = P6_CASES[tag]
    err = jax_out.get(f"err|p6|{tag}")
    cfg = tag.split("|")[0]
    if cfg == "xla" or (cfg == "ring" and coll in (
            "reduce_scatter", "allgather", "allreduce", "allreduce_small")):
        assert err is None, err
    else:        # the trees and alltoall are pow2-only in every family
        assert err is not None and "is not a power of two" in str(err), err
    _check_case(jax_out, 6, tag, kw, coll, key)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("algo", MATMUL_ALGOS)
def test_matmul_collectives_match_jax(jax_out, algo, p):
    xs = inputs(p)
    w = torch.from_numpy(xs["mm_w"])
    rs = ops.matmul_reduce_scatter(torch.from_numpy(xs["mm_x"]), w, algo)
    ag = ops.allgather_matmul(torch.from_numpy(xs["mm_xb"]), w, algo)
    assert rs.shape == (p, 10, 12) and ag.shape == (p, 10 * p, 12)
    _close(rs, jax_out[f"p{p}|mm_rs|{algo}"], f"mm_rs {algo}")
    _close(ag, jax_out[f"p{p}|mm_ag|{algo}"], f"mm_ag {algo}")


@pytest.mark.parametrize("p", [4, 6, 8])
def test_fused_ring_bitwise_equal_to_stacked_ring(p):
    """As the reference holds of itself: the ring on ``ring_update`` gives
    the stacked ring's bits, and never changes the caller's input."""
    xs = inputs(p)
    x = torch.from_numpy(xs["vec"])
    before = x.clone()
    fused_ring = api.CollectiveConfig(backend="pallas_fused",
                                      fused_algo="ring")
    ring = api.CollectiveConfig(backend="ring")
    for coll, key in (("reduce_scatter", "vec"), ("allgather", "blk"),
                      ("allreduce", "vec")):
        xin = torch.from_numpy(xs[key])
        _same(call(api, coll, xin, fused_ring),
              _np(call(api, coll, xin, ring)), f"{coll} p{p}")
    assert torch.equal(x, before)
    bf = x.to(torch.bfloat16)
    _same(ops.reduce_scatter(bf, "ring"),
          _np(stacked.reduce_scatter(bf, "ring")), f"bf16 p{p}")


def test_ring_update_launches_per_collective(monkeypatch):
    """The fused ring runs one ``ring_update`` per step (p - 1 for the RS,
    p for the AG with the own block's placement); the matmul collectives
    one ``perm_matmul`` each."""
    calls = {"ring_update": 0, "perm_matmul": 0}
    for name in calls:
        real = getattr(K, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, spy)
    xs = inputs(8)
    cfg = api.CollectiveConfig(backend="pallas_fused", fused_algo="ring")
    api.reduce_scatter(torch.from_numpy(xs["vec"]), cfg)
    assert calls["ring_update"] == 7
    api.allgather(torch.from_numpy(xs["blk"]), cfg)
    assert calls["ring_update"] == 15
    w = torch.from_numpy(xs["mm_w"])
    ops.matmul_reduce_scatter(torch.from_numpy(xs["mm_x"]), w, "bine")
    ops.allgather_matmul(torch.from_numpy(xs["mm_xb"]), w, "ring")
    assert calls["perm_matmul"] == 2


@pytest.mark.parametrize("topology", ["tpu_multipod", "torus", "lumi"])
def test_dispatch_predicates_match_jax(topology):
    from repro.collectives import api as japi
    for b in ("bine", "recdoub", "ring", "xla", "pallas_fused", "auto",
              "bine_hier"):
        for p in (1, 2, 3, 4, 6, 8, 12, 16):
            assert api.executable_at(b, p) == japi.executable_at(b, p)
    for n in (16383, 16384, 16385):
        for cut in (16384, 1024):
            assert api.allreduce_uses_small(
                n, api.CollectiveConfig(small_cutoff_bytes=cut)) == \
                japi.allreduce_uses_small(
                    n, japi.CollectiveConfig(small_cutoff_bytes=cut))
    for coll in ("allreduce", "reduce_scatter", "allgather", "alltoall",
                 "broadcast", "reduce", "gather", "scatter"):
        for p in (4, 6, 8, 16):
            for nbytes in (100, 1 << 14, 1 << 20, 64 << 20, 1 << 30):
                for b in ("auto", "ring"):
                    kw = {"backend": b, "topology": topology}
                    assert api.resolve_backend(
                        coll, p, nbytes, api.CollectiveConfig(**kw)) == \
                        japi.resolve_backend(
                            coll, p, nbytes, japi.CollectiveConfig(**kw))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("backend", OBS_BACKENDS)
def test_obs_registry_matches_jax(jax_out, backend, p, monkeypatch):
    """One call of each collective records, per call, what the reference
    records per trace: the same registry snapshot, link bytes included."""
    import json
    from repro_torch.obs import metrics
    reg = metrics.Registry()
    monkeypatch.setattr(metrics, "_REGISTRY", reg)
    monkeypatch.setattr(metrics, "_ENABLED", True)
    xs = inputs(p)
    cfg = api.CollectiveConfig(backend=backend)
    for coll in OBS_COLLECTIVES:
        call(api, coll, torch.from_numpy(xs[COLLECTIVES[coll]]), cfg)
    exp = json.loads(str(jax_out[f"obs|p{p}|{backend}"]))
    assert reg.snapshot() == exp
    assert reg.series("link_local_bytes") or reg.series("link_global_bytes")


def test_unported_options_name_their_roadmap_item(tmp_path, monkeypatch):
    """``bine_hier`` runs; ``tuning="measured"`` runs and, with no measured
    table, falls back to the analytic decision with one warning; the
    ``_obs_record`` hook records every call; what is still not ported
    names its ROADMAP.md item; every architecture is registered (the last
    two, the frontends, since item 5d), and an unknown one raises
    ``KeyError``."""
    import warnings
    from repro_torch.configs import base as cfgbase
    from repro_torch.obs import metrics
    from repro_torch.topology import table
    x = torch.ones(4, 16)
    for cfg in (api.CollectiveConfig(backend="bine_hier"),
                api.CollectiveConfig(backend="bine_hier", dp_shape=(2, 2))):
        assert torch.equal(api.allreduce(x, cfg), torch.full((4, 16), 4.0))
    monkeypatch.setenv("REPRO_MEASURED_TABLE_DIR", str(tmp_path))
    monkeypatch.setattr(table, "_WARNED", set())
    monkeypatch.setattr(table, "_LOADED", {})
    measured = api.CollectiveConfig(backend="auto", tuning="measured")
    with pytest.warns(UserWarning, match="no measured table"):
        got = api.allreduce(x, measured)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # once per (topology, p, tuning)
        assert torch.equal(api.allreduce(x, measured), got)
    assert torch.equal(got, api.allreduce(x, api.AUTO))
    reg = metrics.Registry()
    monkeypatch.setattr(metrics, "_REGISTRY", reg)
    monkeypatch.setattr(metrics, "_ENABLED", True)
    api.allreduce(x, api.BINE)
    api.allreduce(x, api.BINE)
    assert reg.counter_value(
        "collective_calls", collective="allreduce", backend="bine",
        algo="bine_small", wire_dtype="float32", topology="tpu_multipod",
        p=4, source="api") == 2.0
    with metrics.disabled():
        api.allreduce(x, api.BINE)
    assert len(reg.series("collective_calls")) == 1
    assert "once per CALL" in api.__doc__
    assert cfgbase.get_config("pixtral-12b").frontend == "vision"
    with pytest.raises(KeyError):
        cfgbase.get_config("no-such-arch")
    with pytest.raises(ValueError, match="not implemented for 'allreduce'"):
        api.allreduce(x, api.CollectiveConfig(wire_dtype="int8"))
    with pytest.raises(ValueError, match="unsupported wire_dtype"):
        api.CollectiveConfig(wire_dtype="float16")
