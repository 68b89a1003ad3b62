"""The port's bucketed ZeRO-1 train step against the JAX step.

The reduced phi4-mini in float32 at p=4, ``bucket_bytes=1<<16``, 2 steps,
for ``pallas_fused`` with the float32 and the int8 wire, for ``recdoub``,
``ring`` and ``xla``, for ``auto`` on the torus preset, and for
``backend="auto", wire_dtype="auto"`` on tpu_multipod.  The JAX step runs
once per configuration in 4-device subprocesses (three at once) and hands
over its initial params, per-step metrics, final params, optimizer state
and error-feedback residuals as an ``.npz``; the port starts from the same
params and runs the same batches.  The per-bucket decisions of the full
phi4-mini equal the reference's for every preset.

Tolerances: the collectives are bitwise (test_torch_collectives), but the
model's float32 gradients differ from JAX's in rounding (test_torch_model:
rtol 1e-3).  Loss and grad-norm: rtol 1e-4.  Params and optimizer state
are held to a tight bound on all but a few elements and a loose bound on
every element, counted over all leaves: rounding differences flip a few
elements (<= 0.1%) by more — AdamW's first steps normalise each gradient
element (m / sqrt(v) ~ sign(g)), so a gradient near zero can move its
param by up to ~lr, and on the int8 wire a value at a rounding boundary
quantizes one step apart, which moves that gradient and its residual by
one quantization step (< 1e-3 here).  Bounds per quantity (tight, loose):
params and master (1e-5, 1e-3), Adam m (1e-7, 1e-4), Adam v (1e-9, 1e-7),
EF residuals (1e-6, 1e-3).
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import base
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build as KB
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import zero
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import TrainConfig, make_train_step

STEPS, N_DP, BUCKET = 2, 4, 1 << 16
WIRES = ("float32", "int8")
#: run tag -> (backend, wire_dtype, topology); the JAX subprocess groups
RUNS = {
    "float32": ("pallas_fused", "float32", "tpu_multipod"),
    "int8": ("pallas_fused", "int8", "tpu_multipod"),
    "recdoub": ("recdoub", "float32", "tpu_multipod"),
    "ring": ("ring", "float32", "tpu_multipod"),
    "xla": ("xla", "float32", "tpu_multipod"),
    "auto_torus": ("auto", "float32", "torus"),
    "wire_auto": ("auto", "auto", "tpu_multipod"),
}
GROUPS = (("float32", "int8"), ("recdoub", "ring", "xla"),
          ("auto_torus", "wire_auto"))
#: (tight, loose) absolute bounds; see the module docstring
BOUNDS = {"param": (1e-5, 1e-3), "master": (1e-5, 1e-3), "m": (1e-7, 1e-4),
          "v": (1e-9, 1e-7), "ef": (1e-6, 1e-3)}

JAX_CODE = r"""
import os
os.environ["REPRO_OBS"] = "0"
import jax, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base
from repro.models import transformer as T
from repro.optim.adamw import AdamWConfig
from repro.train.data import DataConfig, make_batch
from repro.train.step import TrainConfig, make_train_step, make_init_fns

cfg = base.reduced(base.get_config("phi4-mini-3.8b")).replace(dtype="float32")
key = jax.random.key(0)
shapes = jax.eval_shape(lambda k: T.init_params(k, cfg), key)
dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
out = {{}}
for wire, (backend, wire_dtype, topology) in {runs!r}.items():
    tcfg = TrainConfig(backend=backend, dp_axes=("data",),
                       wire_dtype=wire_dtype, topology=topology,
                       bucket_bytes={bucket},
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))
    step, sh, _ = make_train_step(cfg, tcfg, mesh, shapes)
    ip, is_ = make_init_fns(cfg, tcfg, mesh, shapes)
    with set_mesh(mesh):
        params = ip(key)
        state = is_(params)
        for i, x in enumerate(jax.tree.leaves(params)):
            out[f"{{wire}}_init_{{i}}"] = np.asarray(x)
        for s in range({steps}):
            b = make_batch(dcfg, s)
            batch = {{k: jax.device_put(v, sh["batch"][k])
                     for k, v in b.items()}}
            params, state, m = step(params, state, batch)
            out[f"{{wire}}_loss_{{s}}"] = np.asarray(m["loss"])
            out[f"{{wire}}_gnorm_{{s}}"] = np.asarray(m["grad_norm"])
        for i, x in enumerate(jax.tree.leaves(params)):
            out[f"{{wire}}_param_{{i}}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(state["opt"])):
            out[f"{{wire}}_opt_{{i}}"] = np.asarray(x)
        for bid, x in state.get("ef", {{}}).items():
            out[f"{{wire}}_ef_{{bid}}"] = np.asarray(x)
np.savez({path!r}, **out)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_run(subproc, tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("jax_train")
    jobs = {str(tmp / f"out{i}.npz"): {t: RUNS[t] for t in g}
            for i, g in enumerate(GROUPS)}
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(subproc, JAX_CODE.format(
                runs=runs, bucket=BUCKET, steps=STEPS, path=path), N_DP, 600)
                for path, runs in jobs.items()]:
            f.result()
    out = {}
    for path in jobs:
        out.update(np.load(path))
    return out


def _mostly_close(pairs, tight, loose, tag, frac=1e-3):
    """Every element within ``loose``; all but ``frac`` of them, counted
    over all the leaves, within ``tight``."""
    n = n_out = 0
    for got, exp in pairs:
        assert got.shape == exp.shape, (tag, got.shape, exp.shape)
        d = np.abs(got.astype(np.float64) - exp)
        assert d.max() <= loose, (tag, float(d.max()))
        n += d.size
        n_out += int((d > tight).sum())
    assert n_out <= frac * n, (tag, n_out, n)


def _cfg():
    return base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32")


def _run(jax_run, tag, backend=None):
    """The port's run of ``RUNS[tag]`` (``backend`` overriding its backend)
    from JAX's initial params: (metrics, params, state, layout)."""
    cfg = _cfg()
    shapes = TF.param_shapes(cfg)
    n_init = len(T.flatten(shapes))
    init = T.unflatten(shapes, [jax_run[f"{tag}_init_{i}"]
                                for i in range(n_init)])
    b, wire, topology = RUNS[tag]
    tcfg = TrainConfig(backend=backend or b, wire_dtype=wire,
                       topology=topology, bucket_bytes=BUCKET,
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))
    step, info, layout = make_train_step(cfg, tcfg, N_DP, shapes, "cpu")
    from repro_torch.train.step import init_train_state
    params = [params_from_numpy(init, cfg, "cpu") for _ in range(N_DP)]
    state = init_train_state(cfg, tcfg, params, N_DP)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    metrics = []
    for s in range(STEPS):
        params, state, m = step(params, state, make_batch(dcfg, s))
        metrics.append(m)
    return metrics, params, state, layout


@pytest.mark.parametrize("wire", WIRES)
def test_pallas_fused_step_matches_jax(jax_run, wire):
    _check_against_jax(jax_run, wire)


@pytest.mark.parametrize("tag", [t for t in RUNS if t not in WIRES])
def test_backend_step_matches_jax(jax_run, tag):
    _check_against_jax(jax_run, tag)


def _check_against_jax(jax_run, wire):
    metrics, params, state, layout = _run(jax_run, wire)
    for s, m in enumerate(metrics):
        np.testing.assert_allclose(float(m["loss"]),
                                   jax_run[f"{wire}_loss_{s}"], rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   jax_run[f"{wire}_gnorm_{s}"], rtol=1e-4)
    flat = [T.flatten(p) for p in params]
    for r in range(1, N_DP):        # every rank trains on the same values
        assert all(torch.equal(a, b) for a, b in zip(flat[0], flat[r]))
    pairs = {"param": [(x.numpy(), jax_run[f"{wire}_param_{i}"])
                       for i, x in enumerate(flat[0])],
             "master": [], "m": [], "v": []}
    # optimizer state: rank r's stacked shard is block r of the JAX leaf
    zds = T.flatten(layout)
    i = 0
    for zd, st in zip(zds, T.flatten_up_to(params[0], state["opt"])):
        for k in sorted(st):              # m, master, v: the JAX leaf order
            full = torch.cat(list(st[k]), dim=zd) if zd >= 0 else st[k][0]
            pairs[k].append((full.numpy(), jax_run[f"{wire}_opt_{i}"]))
            i += 1
    ef = {k[len(f"{wire}_ef_"):]: v for k, v in jax_run.items()
          if k.startswith(f"{wire}_ef_")}
    assert sorted(state.get("ef", {})) == sorted(ef)
    if wire in WIRES:
        assert bool(ef) == (wire == "int8")
    for bid, v in ef.items():
        assert tuple(state["ef"][bid].shape) == v.shape
    pairs["ef"] = [(state["ef"][b].numpy(), v) for b, v in ef.items()]
    for k, (tight, loose) in BOUNDS.items():
        _mostly_close(pairs[k], tight, loose, f"{wire} {k}")


def test_bine_and_pallas_fused_bitwise(jax_run):
    """The plain stacked executor and the fused kernels' path give the same
    bits, as the reference's bine and pallas_fused backends do."""
    _, pb, sb, _ = _run(jax_run, "float32", backend="bine")
    _, pf, sf, _ = _run(jax_run, "float32")
    for a, b in zip(T.flatten(pb[0]), T.flatten(pf[0])):
        assert torch.equal(a, b)
    for a, b in zip(T.flatten(sb["opt"]), T.flatten(sf["opt"])):
        assert torch.equal(a, b)


def test_unported_backends_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TrainConfig(backend="bine_hier")
    cfg = _cfg()
    shapes = TF.param_shapes(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(cfg, TrainConfig(backend="auto", tuning="measured"),
                        N_DP, shapes, "cpu")
    with pytest.raises(ValueError, match="bucket_bytes=0"):
        TrainConfig(wire_dtype="int8", bucket_bytes=0)
    with pytest.raises(ValueError, match="codec-capable backend"):
        TrainConfig(backend="ring", wire_dtype="int8")
    with pytest.raises(ValueError, match="cannot execute at non-power-of-"):
        make_train_step(cfg, TrainConfig(backend="bine"), 6, shapes, "cpu")


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("wire", ["float32", "auto"])
def test_bucket_decisions_match_jax(wire, p):
    """The full phi4-mini's per-bucket (backend, wire) decisions under
    ``auto``, for every preset, equal the reference's (its shapes from
    ``jax.eval_shape``, nothing allocated)."""
    import jax
    from repro.configs import base as jbase
    from repro.models import transformer as JT
    from repro.topology import PRESETS
    from repro.train import step as jstep
    from repro.train import zero as jzero
    from repro_torch.train import step as tstep
    jcfg = jbase.get_config("phi4-mini-3.8b")
    jshapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                             jax.random.key(0))
    tcfg_ = base.get_config("phi4-mini-3.8b")
    tshapes = TF.param_shapes(tcfg_)
    for topology in PRESETS:
        kw = dict(backend="auto", wire_dtype=wire, topology=topology)
        jt, tt = jstep.TrainConfig(**kw), TrainConfig(**kw)
        jplan = jstep.resolve_bucket_plan(
            jt, p, jshapes, jzero.zero_layout(jcfg, jshapes, p))
        tplan = tstep.resolve_bucket_plan(
            tt, p, tshapes, zero.zero_layout(tcfg_, tshapes, p))
        assert len(tplan.buckets) == len(jplan.buckets), topology
        assert tstep.bucket_decisions(tt, tplan) == \
            jstep.bucket_decisions(jt, jplan), topology


def test_table_bucket_bytes_and_per_leaf_path():
    """bucket_bytes=-1 reads the preset's 64 MiB; bucket_bytes=0 runs the
    per-leaf dim-general collectives — bitwise the bucketed result."""
    KB.reset_launches()      # earlier tests in this process may have launched
    cfg = _cfg()
    shapes = TF.param_shapes(cfg)
    _, info, _ = make_train_step(cfg, TrainConfig(), N_DP, shapes, "cpu")
    assert info["bucket_plan"].capacity_bytes == 64 << 20
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    outs = []
    for bb in (0, -1):
        tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=bb)
        step, _, _ = make_train_step(cfg, tcfg, N_DP, shapes, "cpu")
        params = [TF.init_params(cfg, 0, "cpu") for _ in range(N_DP)]
        from repro_torch.train.step import init_train_state
        state = init_train_state(cfg, tcfg, params, N_DP)
        params, state, _ = step(params, state, make_batch(dcfg, 0))
        outs.append(T.flatten(params[0]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert zero.slice_leaf(torch.arange(8).view(2, 4), 1, 4, 2).tolist() == \
        [[2], [6]]
    assert not any(KB.LAUNCHES.values())


def test_tree_walks_keep_no_leaf_alive():
    """A tree walk holds no leaf past the call: a closure that calls itself
    is a reference cycle, and kept every parameter and optimizer buffer of
    a train step alive until the next garbage collection."""
    gc.disable()
    try:
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        tree = {"b": [leaf, {"c": torch.ones(1)}], "a": torch.ones(2)}
        same = T.tree_map(lambda x: x, tree)
        assert T.flatten_up_to(tree, same)[1] is leaf
        assert T.map_with_path(lambda p, x: p, tree)["b"][0] == ("b", 0)
        del leaf, tree, same
        assert ref() is None
    finally:
        gc.enable()
