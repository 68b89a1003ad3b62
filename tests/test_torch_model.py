"""The port's dense model, ZeRO layout and bucket plan against the JAX
package, with weights carried across as numpy.

Tolerances: the model runs in float32 on the CPU in both frameworks, but
the two sum matmuls, softmax and RoPE's cos/sin in other orders and with
other libm routines, so values agree to float32 rounding, not bitwise.
Logits and loss: rtol 1e-4, atol 1e-5 (a few ulp of rounding through two
layers).  Grads: rtol 1e-3, atol 1e-5 (backward sums over the batch and
sequence compound the rounding).  Layout, plan and pack/unpack are pure
bookkeeping and must be exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import sharding as jsh
from repro.models import transformer as JT
from repro.train import buckets as jbk
from repro.train import zero as jzero
from repro_torch import tree as T
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import transformer as TT
from repro_torch.train import buckets as tbk
from repro_torch.train import zero as tzero
from repro_torch.train.data import DataConfig, make_batch

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def _no_tp():
    # the JAX specs read a process-wide model-axis size other tests set
    jsh.set_model_parallel(1)


def _cfgs(window=None):
    j = jbase.reduced(jbase.get_config("phi4-mini-3.8b")).replace(
        dtype="float32", window=window)
    t = tbase.reduced(tbase.get_config("phi4-mini-3.8b")).replace(
        dtype="float32", window=window)
    return j, t


def test_config_copy_matches():
    j = jbase.get_config("phi4-mini-3.8b")
    t = tbase.get_config("phi4-mini-3.8b")
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in t.__dataclass_fields__}
    assert set(t.__dataclass_fields__) == set(j.__dataclass_fields__)
    assert tbase.reduced(t).__dict__ == jbase.reduced(j).__dict__


@pytest.mark.parametrize("window", [None, 16])
def test_forward_loss_grads_match(window):
    jcfg, tcfg = _cfgs(window)
    jp = JT.init_params(jax.random.key(0), jcfg)
    npp = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(npp, tcfg, device="cpu")
    assert [np.asarray(x).shape for x in jax.tree.leaves(jp)] == \
        [tuple(x.shape) for x in T.flatten(tp)]
    b = make_batch(DataConfig(global_batch=2, seq_len=64,
                              vocab_size=jcfg.vocab_size), 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    jl, _ = JT.forward(jp, jcfg, jb["inputs"])
    tl, _ = TT.forward(tp, tcfg, tb["inputs"])
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-5)

    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True)(jp)
    leaves = [x.requires_grad_(True) for x in T.flatten(tp)]
    tloss, tm = TT.loss_fn(T.unflatten(tp, leaves), tcfg, tb)
    tg = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for i, (a, e) in enumerate(zip(tg, jax.tree.leaves(jg))):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-3,
                                   atol=1e-5, err_msg=f"grad leaf {i}")


def test_params_numpy_round_trip_bf16():
    _, tcfg = _cfgs()
    tcfg = tcfg.replace(dtype="bfloat16")
    p = TT.init_params(tcfg, seed=3, device="cpu")
    back = params_from_numpy(params_to_numpy(p), tcfg, device="cpu")
    for a, b in zip(T.flatten(p), T.flatten(back)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)


def _shapes(arch_reduced: bool):
    j = jbase.get_config("phi4-mini-3.8b")
    t = tbase.get_config("phi4-mini-3.8b")
    if arch_reduced:
        j, t = jbase.reduced(j), tbase.reduced(t)
    else:   # full width, depth cut as on the card
        j, t = j.replace(n_layers=2), t.replace(n_layers=2)
    js = jax.eval_shape(lambda k: JT.init_params(k, j), jax.random.key(0))
    return j, t, js, TT.param_shapes(t)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("n_dp", [4, 8])
def test_zero_layout_and_bucket_plan_match(reduced, n_dp):
    j, t, js, ts = _shapes(reduced)
    assert [tuple(x.shape) for x in jax.tree.leaves(js)] == \
        [tuple(x.shape) for x in T.flatten(ts)]
    jl = jzero.zero_layout(j, js, n_dp)
    tl = tzero.zero_layout(t, ts, n_dp)
    assert jax.tree.leaves(jl) == T.flatten(tl)
    if not reduced:
        assert tl["embed"] == 1     # skips the vocab dim the specs mark
    for cap, item in ((1 << 16, 4.0), (64 << 20, 4.0), (64 << 20, 1 + 4 / 256),
                      (1 << 20, 2.0)):
        jp = jbk.plan_buckets(js, jl, n_dp, cap, item)
        tp = tbk.plan_buckets(ts, tl, n_dp, cap, item)
        assert tp.replicated == jp.replicated
        assert len(tp.buckets) == len(jp.buckets)
        for a, b in zip(tp.buckets, jp.buckets):
            assert (a.bid, a.dtype, a.row_elems) == (b.bid, b.dtype,
                                                     b.row_elems)
            assert [(s.index, s.shape, s.zero_dim, s.offset)
                    for s in a.slots] == \
                [(s.index, s.shape, s.zero_dim, s.offset) for s in b.slots]


def test_full_width_parameter_count():
    _, _, js, ts = _shapes(False)
    assert TT.param_count(ts) == sum(int(np.prod(x.shape))
                                     for x in jax.tree.leaves(js)) \
        == 815_938_560


@pytest.mark.parametrize("n_dp", [4, 8])
def test_pack_unpack_bitwise(n_dp):
    j, t, js, ts = _shapes(True)
    jl = jzero.zero_layout(j, js, n_dp)
    tl = tzero.zero_layout(t, ts, n_dp)
    rng = np.random.RandomState(n_dp)
    leaves = [rng.randn(*x.shape).astype(np.float32)
              for x in jax.tree.leaves(js)]
    jp = jbk.plan_buckets(js, jl, n_dp, 1 << 16, 4.0)
    tp = tbk.plan_buckets(ts, tl, n_dp, 1 << 16, 4.0)
    for jb, tb in zip(jp.buckets, tp.buckets):
        mine = [leaves[s.index] for s in tb.slots]
        jv = np.asarray(jbk.pack_bucket(jb, [jnp.asarray(x) for x in mine],
                                        n_dp))
        tv = tbk.pack_bucket(tb, [torch.from_numpy(x) for x in mine], n_dp)
        np.testing.assert_array_equal(tv.numpy(), jv)
        row = jv[: tb.row_elems]
        for a, b in zip(tbk.shard_views(tb, torch.from_numpy(row), n_dp),
                        jbk.shard_views(jb, jnp.asarray(row), n_dp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        shards = [x.numpy() for x in tbk.shard_views(
            tb, torch.from_numpy(row), n_dp)]
        np.testing.assert_array_equal(
            tbk.pack_shards(tb, [torch.from_numpy(x) for x in shards]).numpy(),
            np.asarray(jbk.pack_shards(jb, [jnp.asarray(x) for x in shards])))
        for a, b, x in zip(tbk.unpack_bucket(tb, torch.from_numpy(jv), n_dp),
                           jbk.unpack_bucket(jb, jnp.asarray(jv), n_dp), mine):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), x)
