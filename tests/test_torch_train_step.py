"""The port's bucketed ZeRO-1 train step against the JAX step.

The reduced phi4-mini in float32 at p=4, ``bucket_bytes=1<<16``, 2 steps,
for ``pallas_fused`` with the float32 and the int8 wire, for ``recdoub``,
``ring`` and ``xla``, for ``auto`` on the torus preset, and for
``backend="auto", wire_dtype="auto"`` on tpu_multipod; and over two DP
axes, ``("pod", "data")`` of shape (2, 2), for ``bine_hier``, ``bine``,
``pallas_fused`` and ``pallas_fused`` on the int8 wire.  The JAX step runs
once per configuration in 4-device subprocesses (four at once) and hands
over its initial params, per-step metrics, final params, optimizer state
and error-feedback residuals as an ``.npz``; the port starts from the same
params and runs the same batches.  The per-bucket decisions of the full
phi4-mini equal the reference's for every preset.  Bitwise, as the
reference holds of itself: bucketed and per-leaf ``bine_hier``, and
two-axis ``pallas_fused`` and ``bine``.  The optimizer state is compared
as its global arrays (``interop.train_state_to_numpy``).  For the
float32, int8 and two-axis ``bine_hier`` runs the reference also saves its
state after step 2 with its ``checkpoint.save`` and takes a third step:
the port restores that checkpoint bit for bit and its third step is held
to the same bounds.

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
from repro_torch.interop import params_from_numpy, train_state_to_numpy
from repro_torch.kernels import build as KB
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import zero
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import (TrainConfig, make_train_step,
                                    shard_owner)
# the reference runs keep XLA's default CPU pool (the conftest's
# ``subproc``): single-threaded Eigen sums the int8 runs' matmuls in
# another order, which moves a parameter past the loose bound
from torch_threads import bounded, pin_threads  # noqa: F401

STEPS, N_DP, BUCKET = 2, 4, 1 << 16
#: runs whose reference state is checkpointed after STEPS steps and then
#: stepped once more: one axis f32 and int8 (error feedback), and
#: two-axis bine_hier, whose shard owners are not the stacking order
CKPT_RUNS = ("float32", "int8", "hier")
WIRES = ("float32", "int8")
#: (pods, data) of the two-axis runs
HIER = (2, 2)
#: run tag -> (backend, wire_dtype, topology, DP sizes); the JAX
#: subprocess groups
RUNS = {
    "float32": ("pallas_fused", "float32", "tpu_multipod", (N_DP,)),
    "int8": ("pallas_fused", "int8", "tpu_multipod", (N_DP,)),
    "recdoub": ("recdoub", "float32", "tpu_multipod", (N_DP,)),
    "ring": ("ring", "float32", "tpu_multipod", (N_DP,)),
    "xla": ("xla", "float32", "tpu_multipod", (N_DP,)),
    "auto_torus": ("auto", "float32", "torus", (N_DP,)),
    "wire_auto": ("auto", "auto", "tpu_multipod", (N_DP,)),
    "hier": ("bine_hier", "float32", "tpu_multipod", HIER),
    "hier_bine": ("bine", "float32", "tpu_multipod", HIER),
    "hier_fused": ("pallas_fused", "float32", "tpu_multipod", HIER),
    "hier_int8": ("pallas_fused", "int8", "tpu_multipod", HIER),
}
GROUPS = (("float32", "int8"), ("recdoub", "ring", "xla"),
          ("auto_torus", "wire_auto"), ("hier", "hier_bine"),
          ("hier_fused", "hier_int8"))
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
from repro.train import checkpoint as ckpt
from repro.train.step import TrainConfig, make_train_step, make_init_fns

cfg = base.reduced(base.get_config("phi4-mini-3.8b")).replace(dtype="float32")
key = jax.random.key(0)
shapes = jax.eval_shape(lambda k: T.init_params(k, cfg), key)
dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
out = {{}}
for wire, (backend, wire_dtype, topology, dp) in {runs!r}.items():
    axes = ("data",) if len(dp) == 1 else ("pod", "data")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(dp + (1,)),
                axes + ("model",))
    tcfg = TrainConfig(backend=backend, dp_axes=axes,
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
        if wire in {ckpt_runs!r}:
            # save the global state after the last step, then one more
            ckpt.save(os.path.join({ckpt_dir!r}, wire), {steps},
                      {{"params": params, "state": state}})
            b = make_batch(dcfg, {steps})
            batch = {{k: jax.device_put(v, sh["batch"][k])
                     for k, v in b.items()}}
            params, state, m = step(params, state, batch)
            out[f"{{wire}}_loss_{steps}"] = np.asarray(m["loss"])
            out[f"{{wire}}_gnorm_{steps}"] = np.asarray(m["grad_norm"])
            for i, x in enumerate(jax.tree.leaves(params)):
                out[f"{{wire}}_after_{{i}}"] = np.asarray(x)
np.savez({path!r}, **out)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_run(subproc, tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("jax_train")
    jobs = {str(tmp / f"out{i}.npz"): {t: RUNS[t] for t in g}
            for i, g in enumerate(GROUPS)}
    ckpt_dir = str(tmp / "ckpt")
    run = bounded(subproc)
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(run, JAX_CODE.format(
                runs=runs, bucket=BUCKET, steps=STEPS, path=path,
                ckpt_runs=CKPT_RUNS, ckpt_dir=ckpt_dir), N_DP, 600)
                for path, runs in jobs.items()]:
            f.result()
    out = {"ckpt_dir": ckpt_dir}
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


def _tcfg(tag, backend=None, bucket_bytes=BUCKET):
    b, wire, topology, dp = RUNS[tag]
    return TrainConfig(backend=backend or b, wire_dtype=wire,
                       topology=topology, bucket_bytes=bucket_bytes,
                       dp_axes=("data",) if len(dp) == 1 else ("pod", "data"),
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))


def _run(jax_run, tag, backend=None, bucket_bytes=BUCKET):
    """The port's run of ``RUNS[tag]`` (``backend`` and ``bucket_bytes``
    overriding its own) from JAX's initial params: (metrics, params,
    state, layout)."""
    cfg = _cfg()
    shapes = TF.param_shapes(cfg)
    n_init = len(T.flatten(shapes))
    init = T.unflatten(shapes, [jax_run[f"{tag}_init_{i}"]
                                for i in range(n_init)])
    dp = RUNS[tag][3]
    tcfg = _tcfg(tag, backend, bucket_bytes)
    step, info, layout = make_train_step(cfg, tcfg, dp, shapes, "cpu")
    from repro_torch.train.step import init_train_state
    params = [params_from_numpy(init, cfg, "cpu") for _ in range(N_DP)]
    state = init_train_state(cfg, tcfg, params, dp)
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
    # rank r holds ZeRO block owner[r]: the JAX leaf's block order
    order = np.argsort(shard_owner(_tcfg(wire), RUNS[wire][3]))
    for s, m in enumerate(metrics):
        np.testing.assert_allclose(float(m["loss"]),
                                   jax_run[f"{wire}_loss_{s}"], rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   jax_run[f"{wire}_gnorm_{s}"], rtol=1e-4)
    flat = [T.flatten(p) for p in params]
    for r in range(1, N_DP):        # every rank trains on the same values
        assert all(torch.equal(a, b) for a, b in zip(flat[0], flat[r]))
    # the global arrays (train.step.to_global): rank r's optimizer shard is
    # block owner[r] of the JAX leaf
    glob = train_state_to_numpy(_cfg(), _tcfg(wire), params, state,
                                RUNS[wire][3])
    pairs = {"param": [(x, jax_run[f"{wire}_param_{i}"])
                       for i, x in enumerate(T.flatten(glob["params"]))],
             "master": [], "m": [], "v": []}
    i = 0
    for st in T.flatten_up_to(glob["params"], glob["state"]["opt"]):
        for k in sorted(st):              # m, master, v: the JAX leaf order
            pairs[k].append((st[k], jax_run[f"{wire}_opt_{i}"]))
            i += 1
    ef = {k[len(f"{wire}_ef_"):]: v for k, v in jax_run.items()
          if k.startswith(f"{wire}_ef_")}
    assert sorted(state.get("ef", {})) == sorted(ef)
    if RUNS[wire][1] != "auto":
        assert bool(ef) == (RUNS[wire][1] == "int8")
    for bid, v in ef.items():
        assert tuple(state["ef"][bid].shape) == v.shape
    pairs["ef"] = [(glob["state"]["ef"][b], v) for b, v in ef.items()]
    for k, (tight, loose) in BOUNDS.items():
        _mostly_close(pairs[k], tight, loose, f"{wire} {k}")


@pytest.mark.parametrize("tag", CKPT_RUNS)
def test_jax_checkpoint_resumes_in_port(jax_run, tag):
    """The reference's state after STEPS steps, saved by its
    ``checkpoint.save``, restores in the port (``train.checkpoint`` and
    ``step.from_global``) bit for bit, and the port's next step from it
    matches the reference's next step within this file's bounds."""
    import os
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import (from_global, make_init_fns,
                                        to_global)
    cfg, dp, tcfg = _cfg(), RUNS[tag][3], _tcfg(tag)
    step, _, _ = make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg), "cpu")
    init_p, init_s = make_init_fns(cfg, tcfg, dp, "cpu")
    fresh = init_p(0)
    like = to_global(cfg, tcfg, fresh, init_s(fresh), dp, device="meta")
    tree = ckpt.restore(os.path.join(jax_run["ckpt_dir"], tag), STEPS, like,
                        device="cpu")
    for i, x in enumerate(T.flatten(tree["params"])):
        np.testing.assert_array_equal(x.numpy(), jax_run[f"{tag}_param_{i}"])
    params, state = from_global(cfg, tcfg, tree, dp, "cpu")
    back = to_global(cfg, tcfg, params, state, dp)
    assert all(torch.equal(a, b) for a, b in zip(T.flatten(back),
                                                  T.flatten(tree)))
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    params, state, m = step(params, state, make_batch(dcfg, STEPS))
    np.testing.assert_allclose(float(m["loss"]),
                               jax_run[f"{tag}_loss_{STEPS}"], rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               jax_run[f"{tag}_gnorm_{STEPS}"], rtol=1e-4)
    _mostly_close([(x.numpy(), jax_run[f"{tag}_after_{i}"])
                   for i, x in enumerate(T.flatten(params[0]))],
                  *BOUNDS["param"], f"{tag} step {STEPS} params")


def test_bine_and_pallas_fused_bitwise(jax_run):
    """The plain stacked executor and the fused kernels' path give the same
    bits, as the reference's bine and pallas_fused backends do."""
    _, pb, sb, _ = _run(jax_run, "float32", backend="bine")
    _, pf, sf, _ = _run(jax_run, "float32")
    for a, b in zip(T.flatten(pb[0]), T.flatten(pf[0])):
        assert torch.equal(a, b)
    for a, b in zip(T.flatten(sb["opt"]), T.flatten(sf["opt"])):
        assert torch.equal(a, b)


def _same_state(a, b):
    (pa, sa), (pb, sb) = a, b
    for x, y in zip(T.flatten(pa[0]), T.flatten(pb[0])):
        assert torch.equal(x, y)
    for x, y in zip(T.flatten(sa["opt"]), T.flatten(sb["opt"])):
        assert torch.equal(x, y)


def test_bine_hier_bucketed_and_per_leaf_bitwise(jax_run):
    """Bucketed and per-leaf two-axis ``bine_hier`` give the same bits: the
    bucket's data-first RS scatters rows to the ranks the per-leaf
    sequence does (``opt_dp_order``), as the reference holds of itself."""
    _, pb, sb, _ = _run(jax_run, "hier")
    _, pl, sl, _ = _run(jax_run, "hier", bucket_bytes=0)
    _same_state((pb, sb), (pl, sl))


def test_two_axis_pallas_fused_and_bine_bitwise(jax_run):
    """Over two axes the fused kernels' path gives the plain stacked
    executor's bits, as over one."""
    _, pb, sb, _ = _run(jax_run, "hier_fused", backend="bine")
    _, pf, sf, _ = _run(jax_run, "hier_fused")
    _same_state((pb, sb), (pf, sf))


def test_shard_owner_follows_opt_dp_order():
    two = TrainConfig(backend="bine_hier", dp_axes=("pod", "data"))
    assert two.opt_dp_order == ("data", "pod")
    # rank (pod, d) owns block d * pods + pod
    assert shard_owner(two, (2, 4)).tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    flat = TrainConfig(backend="bine", dp_axes=("pod", "data"))
    assert flat.opt_dp_order == ("pod", "data")
    assert shard_owner(flat, (2, 4)).tolist() == list(range(8))
    assert shard_owner(TrainConfig(backend="bine_hier"), (4,)).tolist() == \
        list(range(4))


def test_unported_backends_name_their_roadmap_item(tmp_path, monkeypatch):
    """``bine_hier`` runs over one or two DP axes; ``tuning="measured"``
    builds (with no measured table: the analytic decisions after one
    warning) and the build records its bucket plan into ``obs``; a model
    axis above 1 parses (tensor parallelism, tests/test_torch_tp.py); bad
    configurations raise."""
    from repro_torch.launch.train import parse_mesh
    from repro_torch.obs import metrics
    from repro_torch.topology import table
    cfg = _cfg()
    shapes = TF.param_shapes(cfg)
    for dp_axes, dp in ((("data",), N_DP), (("pod", "data"), HIER)):
        make_train_step(cfg, TrainConfig(backend="bine_hier",
                                         dp_axes=dp_axes), dp, shapes, "cpu")
    monkeypatch.setenv("REPRO_MEASURED_TABLE_DIR", str(tmp_path))
    monkeypatch.setattr(table, "_WARNED", set())
    monkeypatch.setattr(table, "_LOADED", {})
    reg = metrics.Registry()
    monkeypatch.setattr(metrics, "_REGISTRY", reg)
    monkeypatch.setattr(metrics, "_ENABLED", True)
    with pytest.warns(UserWarning, match="no measured table"):
        _, info, _ = make_train_step(
            cfg, TrainConfig(backend="auto", tuning="measured"), N_DP,
            shapes, "cpu")
    _, ref, _ = make_train_step(cfg, TrainConfig(backend="auto"), N_DP,
                                shapes, "cpu")
    assert info["decisions"] == ref["decisions"]
    n = len(info["bucket_plan"].buckets)
    calls = sum(v for _, v in reg.series("collective_calls"))
    assert calls == 2 * 2 * n          # an RS and an AG a bucket, 2 builds
    assert parse_mesh("1,4,2") == (("pod", "data"), (1, 4), 2)
    with pytest.raises(ValueError, match="pod,data,model"):
        parse_mesh("1,4,0")
    with pytest.raises(ValueError, match="dp_axes"):
        TrainConfig(dp_axes=("pod", "data", "x"))
    with pytest.raises(ValueError, match="do not match dp_axes"):
        make_train_step(cfg, TrainConfig(dp_axes=("pod", "data")), N_DP,
                        shapes, "cpu")
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


def test_train_cli_takes_two_dp_axes(capsys):
    """``--mesh pod,data,model`` names the DP axes as the reference's mesh
    does, and the model axis's size (tensor parallelism above 1,
    tests/test_torch_tp.py)."""
    from repro_torch.launch import train as L
    assert L.parse_mesh("2,2,1") == (("pod", "data"), (2, 2), 1)
    assert L.parse_mesh("1,4,1") == (("pod", "data"), (1, 4), 1)
    assert L.parse_mesh("4,1") == (("data",), (4,), 1)
    assert L.parse_mesh("2,2,2") == (("pod", "data"), (2, 2), 2)
    with pytest.raises(ValueError, match="pod,data,model"):
        L.parse_mesh("8")
    L.main(["--reduced", "--mesh", "2,2,1", "--backend", "bine_hier",
            "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16"])
    out = capsys.readouterr().out
    assert "dp={'pod': 2, 'data': 2} tp=1 (single) backend=bine_hier" in out
    assert "done: 2 steps" in out
