"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
JAX package's (``repro.train.checkpoint``), and the global layout of a
train state (``train.step.to_global`` / ``from_global``).

  * mirrors of the reference's own tests: round trip, bfloat16 round trip,
    gc, a shape mismatch naming the leaf's path, the async writer;
  * across the packages, both ways, bit for bit: a tree of float32,
    bfloat16, int32 and scalar leaves in nested dicts and lists that one
    package saves restores in the other, and the two write the same
    manifest (but its time);
  * a port train state (the reduced phi4-mini after one step on 4 stacked
    ranks) restores into the reference's own state structure;
  * stacked -> global -> stacked is bitwise for one-axis ``pallas_fused``
    on the float32 and int8 wires and for two-axis ``bine_hier`` (whose
    shard owners are not the stacking order), through numpy
    (``interop``) and through a checkpoint too;
    a restore at another DP size re-slices the optimizer state.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch import tree as T
from repro_torch.configs import base
from repro_torch.models import transformer as TF
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import (TrainConfig, from_global, make_init_fns,
                                    make_train_step, to_global)
from torch_threads import pin_threads  # noqa: F401

BF16 = np.dtype(ml_dtypes.bfloat16)


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(4, 8).astype(np.float32),
            "b": {"c": rng.randn(3).astype(np.float32),
                  "d": np.int32(7)}}


def test_save_restore(tmp_path):
    path = str(tmp_path)
    t = _tree()
    ckpt.save(path, 10, t)
    assert ckpt.latest_step(path) == 10
    like = {"a": np.zeros((4, 8), np.float32),
            "b": {"c": np.zeros(3, np.float32), "d": np.int32(0)}}
    out = ckpt.restore(path, 10, like)
    np.testing.assert_array_equal(out["a"], t["a"])
    np.testing.assert_array_equal(out["b"]["c"], t["b"]["c"])
    assert out["b"]["d"] == 7


def test_bfloat16_round_trips(tmp_path):
    """A bfloat16 tensor leaf is stored as the reference stores one (V2
    bytes, manifest dtype "bfloat16") and comes back bit for bit."""
    w = torch.arange(6, dtype=torch.float32).to(torch.bfloat16) / 3
    ckpt.save(str(tmp_path), 3, {"w": w})
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        assert json.load(f)["dtypes"] == ["bfloat16"]
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as data:
        assert data["a0"].dtype == np.dtype("V2")
    out = ckpt.restore(str(tmp_path), 3,
                       {"w": torch.zeros(6, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))
    with pytest.raises(TypeError, match="restores into a tensor"):
        ckpt.restore(str(tmp_path), 3, {"w": np.zeros(6, np.float32)})


def test_gc_keeps_latest(tmp_path):
    path = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(path, s, _tree(s), keep=2)
    assert ckpt.all_steps(path) == [4, 5]
    os.makedirs(tmp_path / "step_00000009.tmp")   # an unfinished save
    assert ckpt.latest_step(path) == 5


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path)
    ckpt.save(path, 1, _tree())
    like = {"a": np.zeros((4, 9), np.float32),
            "b": {"c": np.zeros(3, np.float32), "d": np.int32(0)}}
    with pytest.raises(AssertionError, match=r"\['a'\]: ckpt \(4, 8\)"):
        ckpt.restore(path, 1, like)
    like["a"] = np.zeros((4, 8), np.float32)
    like["b"]["e"] = np.zeros(1, np.float32)
    with pytest.raises(AssertionError, match="leaf count mismatch"):
        ckpt.restore(path, 1, like)


def test_async_checkpointer(tmp_path):
    """At most one save in flight; each copies its leaves to the host
    first, so updating a tensor in place after ``save`` returns leaves the
    checkpoint as it was."""
    path = str(tmp_path)
    c = ckpt.AsyncCheckpointer(path, keep=2)
    for s in (10, 20, 30):
        c.save(s, _tree(s))
    w = torch.ones(1 << 16)
    c.save(40, {"w": w})
    w.zero_()
    c.wait()
    assert ckpt.all_steps(path) == [30, 40]
    out = ckpt.restore(path, 30, _tree())
    np.testing.assert_array_equal(out["a"], _tree(30)["a"])
    out = ckpt.restore(path, 40, {"w": torch.zeros(1 << 16)})
    assert torch.equal(out["w"], torch.ones(1 << 16))
    c.save(50, {"w": w})
    c.wait()
    with pytest.raises(OSError):
        bad = ckpt.AsyncCheckpointer(str(tmp_path / "f" / "x"))
        (tmp_path / "f").write_text("a file, not a directory")
        bad.save(1, {"w": w}, block=True)


def _mixed(seed):
    """The same tree for both packages: (port tensors, reference numpy)."""
    rng = np.random.RandomState(seed)
    f32 = rng.randn(3, 5).astype(np.float32)
    bf = rng.randn(7).astype(np.float32).astype(BF16)
    i32 = rng.randint(-9, 9, (2, 2)).astype(np.int32)
    port = {"z": {"w": torch.from_numpy(f32.copy()),
                  "seg": [torch.from_numpy(bf.view(np.int16).copy()).view(
                      torch.bfloat16), torch.from_numpy(i32.copy())]},
            "a": torch.tensor(3, dtype=torch.int32)}
    ref = {"z": {"w": f32, "seg": [bf, i32]}, "a": np.asarray(3, np.int32)}
    return port, ref


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == BF16 else x


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages_bitwise(tmp_path, writer):
    port, ref = _mixed(5)
    if writer == "port":
        ckpt.save(str(tmp_path), 7, port, extra={"step": 7})
        out = jckpt.restore(str(tmp_path), 7, ref)
        for a, b in zip(T.flatten(out), T.flatten(ref)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
    else:
        jckpt.save(str(tmp_path), 7, ref, extra={"step": 7})
        like = T.tree_map(torch.zeros_like, port)
        out = ckpt.restore(str(tmp_path), 7, like)
        for a, b in zip(T.flatten(out), T.flatten(port)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_manifests_match(tmp_path):
    port, ref = _mixed(1)
    ckpt.save(str(tmp_path / "p"), 2, port, extra={"k": 1})
    jckpt.save(str(tmp_path / "j"), 2, ref, extra={"k": 1})
    man = []
    for d in ("p", "j"):
        with open(tmp_path / d / "step_00000002" / "manifest.json") as f:
            m = json.load(f)
        m.pop("time")
        man.append(m)
    assert man[0] == man[1]
    assert man[0]["paths"][1] == "['z']['seg'][0]"


def _cfg():
    return base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32")


#: (tcfg, DP sizes): one axis f32 and int8, two-axis bine_hier
LAYOUTS = {
    "fused_f32": (TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16),
                  4),
    "fused_int8": (TrainConfig(backend="pallas_fused", wire_dtype="int8",
                               bucket_bytes=1 << 16), 4),
    "hier": (TrainConfig(backend="bine_hier", dp_axes=("pod", "data"),
                         bucket_bytes=1 << 16), (2, 2)),
}


def _trained(tag, cfg=None):
    """(cfg, tcfg, dp, params, state) after one step from seed 0."""
    cfg = cfg or _cfg()
    tcfg, dp = LAYOUTS[tag]
    step, _, _ = make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg), "cpu")
    init_p, init_s = make_init_fns(cfg, tcfg, dp, "cpu")
    params = init_p(0)
    state = init_s(params)
    dcfg = DataConfig(global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    params, state, _ = step(params, state, make_batch(dcfg, 0))
    return cfg, tcfg, dp, params, state


def _equal(a, b):
    fa, fb = T.flatten(a), T.flatten(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(fa, fb))


@pytest.mark.parametrize("tag", sorted(LAYOUTS))
def test_global_layout_round_trip_bitwise(tmp_path, tag):
    """stacked -> global -> stacked, directly and through a checkpoint,
    gives the same bits; the global optimizer leaf puts stacked rank r's
    shard at block ``shard_owner[r]``."""
    from repro_torch.train import zero
    from repro_torch.train.step import shard_owner
    from repro_torch.interop import (train_state_from_numpy,
                                     train_state_to_numpy)
    cfg, tcfg, dp, params, state = _trained(tag)
    glob = to_global(cfg, tcfg, params, state, dp)
    p2, s2 = from_global(cfg, tcfg, glob, dp, "cpu")
    assert _equal(params, p2) and _equal(state, s2)
    p2, s2 = train_state_from_numpy(
        cfg, tcfg, train_state_to_numpy(cfg, tcfg, params, state, dp), dp,
        "cpu")
    assert _equal(params, p2) and _equal(state, s2)
    assert ("ef" in glob["state"]) == (tcfg.wire_dtype == "int8")
    shape = (dp,) if isinstance(dp, int) else dp
    owner = shard_owner(tcfg, shape)
    n = int(np.prod(shape))
    layout = T.flatten(zero.zero_layout(cfg, params[0], n))
    gopt = T.flatten_up_to(glob["params"], glob["state"]["opt"])
    sopt = T.flatten_up_to(params[0], state["opt"])
    assert any(zd >= 0 for zd in layout)
    for zd, g, st in zip(layout, gopt, sopt):
        for r in range(n):
            assert torch.equal(zero.slice_leaf(g["m"], zd, n, int(owner[r])),
                               st["m"][r])
    if tag == "hier":
        assert owner.tolist() != list(range(n))
    ckpt.save(str(tmp_path), 1, glob)
    like = to_global(cfg, tcfg, params, state, dp, device="meta")
    back = ckpt.restore(str(tmp_path), 1, like, device="cpu")
    p3, s3 = from_global(cfg, tcfg, back, dp, "cpu")
    assert _equal(params, p3) and _equal(state, s3)


def test_global_layout_checks_ranks_agree():
    cfg, tcfg, dp, params, state = _trained("fused_f32")
    leaf = T.flatten(params[2])[0]
    leaf.view(-1)[0] += 1
    with pytest.raises(ValueError, match="rank 2's parameter differs"):
        to_global(cfg, tcfg, params, state, dp)


def test_restore_at_another_dp_reslices(tmp_path):
    """A p = 4 checkpoint restores at p = 2 (the elastic shrink) and at
    two axes (2, 2): the global arrays are the same bits, the shards are
    cut by the new layout; an int8 state cannot move (per-rank residuals),
    and says which leaf."""
    cfg, tcfg, dp, params, state = _trained("fused_f32")
    glob = to_global(cfg, tcfg, params, state, dp)
    for new_dp, new_tcfg in ((2, tcfg),
                             ((2, 2), tcfg.replace(dp_axes=("pod", "data"),
                                                   backend="bine_hier"))):
        p2, s2 = from_global(cfg, new_tcfg, glob, new_dp, "cpu")
        assert len(p2) == int(np.prod(new_dp))
        assert _equal(to_global(cfg, new_tcfg, p2, s2, new_dp), glob)
    cfg8, tcfg8, dp8, p8, s8 = _trained("fused_int8")
    g8 = to_global(cfg8, tcfg8, p8, s8, dp8)
    with pytest.raises(ValueError, match=r"\['state'\]\['ef'\]"):
        from_global(cfg8, tcfg8, g8, 2, "cpu")


def test_port_train_state_restores_in_reference(tmp_path):
    """A port train state restores into the reference's own state tree
    (its params from ``init_params``, its optimizer leaves global), leaf
    for leaf and bit for bit, bfloat16 params included."""
    import jax
    from repro.configs import base as jbase
    from repro.models import transformer as JT
    from repro.optim.adamw import adamw_init_leaf
    cfg = base.reduced(base.get_config("phi4-mini-3.8b"))     # bf16
    _, tcfg, dp, params, state = _trained("fused_f32", cfg)
    glob = to_global(cfg, tcfg, params, state, dp)
    ckpt.save(str(tmp_path), 1, glob)
    jcfg = jbase.reduced(jbase.get_config("phi4-mini-3.8b"))
    jparams = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                             jax.random.key(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jparams)
    like = {"params": zeros,
            "state": {"opt": jax.tree.map(
                lambda x: jax.tree.map(np.asarray, adamw_init_leaf(x)),
                zeros), "step": np.zeros((), np.int32)}}
    out = jckpt.restore(str(tmp_path), 1, like)
    got, exp = jax.tree.leaves(out), T.flatten(glob)
    assert len(got) == len(exp)
    assert any(x.dtype == torch.bfloat16 for x in exp)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(_bits(a), _bits(b))
