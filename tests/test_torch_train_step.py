"""The port's bucketed ZeRO-1 train step against the JAX step.

The reduced phi4-mini in float32 at p=4, ``bucket_bytes=1<<16``, 2 steps,
for ``pallas_fused`` with the float32 and the int8 wire.  The JAX step runs
once per wire in one 4-device subprocess and hands over its initial
params, per-step metrics, final params, optimizer state and error-feedback
residuals as an ``.npz``; the port starts from the same params and runs
the same batches.

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
from repro_torch.kernels.collectives import kernel as K
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import zero
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import TrainConfig, make_train_step

STEPS, N_DP, BUCKET = 2, 4, 1 << 16
WIRES = ("float32", "int8")
#: (tight, loose) absolute bounds; see the module docstring
BOUNDS = {"param": (1e-5, 1e-3), "master": (1e-5, 1e-3), "m": (1e-7, 1e-4),
          "v": (1e-9, 1e-7), "ef": (1e-6, 1e-3)}

JAX_CODE = r"""
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
for wire in {wires!r}:
    tcfg = TrainConfig(backend="pallas_fused", dp_axes=("data",),
                       wire_dtype=wire, bucket_bytes={bucket},
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
    path = str(tmp_path_factory.mktemp("jax_train") / "out.npz")
    subproc(JAX_CODE.format(wires=WIRES, bucket=BUCKET, steps=STEPS,
                            path=path), devices=N_DP, timeout=600)
    return dict(np.load(path))


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


def _run(jax_run, backend, wire):
    """The port's run from JAX's initial params: (metrics, params, state)."""
    cfg = _cfg()
    shapes = TF.param_shapes(cfg)
    n_init = len(T.flatten(shapes))
    init = T.unflatten(shapes, [jax_run[f"{wire}_init_{i}"]
                                for i in range(n_init)])
    tcfg = TrainConfig(backend=backend, wire_dtype=wire, bucket_bytes=BUCKET,
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
    metrics, params, state, layout = _run(jax_run, "pallas_fused", wire)
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
    assert bool(ef) == (wire == "int8")
    for bid, v in ef.items():
        assert tuple(state["ef"][bid].shape) == v.shape
    pairs["ef"] = [(state["ef"][b].numpy(), v) for b, v in ef.items()]
    for k, (tight, loose) in BOUNDS.items():
        _mostly_close(pairs[k], tight, loose, f"{wire} {k}")


def test_bine_and_pallas_fused_bitwise(jax_run):
    """The plain stacked executor and the fused kernels' path give the same
    bits, as the reference's bine and pallas_fused backends do."""
    _, pb, sb, _ = _run(jax_run, "bine", "float32")
    _, pf, sf, _ = _run(jax_run, "pallas_fused", "float32")
    for a, b in zip(T.flatten(pb[0]), T.flatten(pf[0])):
        assert torch.equal(a, b)
    for a, b in zip(T.flatten(sb["opt"]), T.flatten(sf["opt"])):
        assert torch.equal(a, b)


def test_unported_backends_name_their_roadmap_item():
    for b in ("auto", "recdoub", "ring", "xla", "bine_hier"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TrainConfig(backend=b)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TrainConfig(wire_dtype="auto")
    with pytest.raises(ValueError, match="bucket_bytes=0"):
        TrainConfig(wire_dtype="int8", bucket_bytes=0)


def test_table_bucket_bytes_and_per_leaf_path():
    """bucket_bytes=-1 reads the preset's 64 MiB; bucket_bytes=0 runs the
    per-leaf dim-general collectives — bitwise the bucketed result."""
    K.reset_launches()      # earlier tests in this process may have launched
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
    assert K.LAUNCHES == {"rs_step": 0, "ag_step": 0, "rs_step_q": 0}


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
