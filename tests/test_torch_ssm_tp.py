"""Tensor parallelism of the recurrent blocks (Mamba2, mLSTM, sLSTM and
zamba2's shared attention) on the port's train path, against the JAX
package's GSPMD runs, on the CPU.

The port stacks each DP rank's TP ranks ``[tp, ...]`` on one device
(``models.transformer`` section "Tensor parallelism"): a recurrent layer
gathers the whole sequence on every rank, then under megatron_sp runs
the rank's heads (Mamba2, mLSTM) or units (sLSTM) and reduces its partial
down projection into the stream; under pure_sp every rank runs the whole
block and keeps its own sequence block.  The JAX side runs once, in four
subprocesses at once (4 CPU devices each, a plain ``Mesh`` and
``compat.set_mesh``), and hands its outputs over as ``.npz`` files.  The
train steps at (2, 2) are ``tests/test_torch_ssm_tp_steps.py``'s.

Configs (reduced, float32, cut in depth: the reference compiles a program
a segment): zamba2-2.7b at d_model 1024 with 2 Mamba2 blocks and one
shared firing (megatron_sp: Mamba2's 128 heads and the shared block's 4
over the ranks), xlstm-125m at d_model 64 with 3 mLSTM and one sLSTM
(pure_sp: 4 heads do not make it megatron_sp below 1024) and the same at
d_model 1024 (megatron_sp for mLSTM and sLSTM).  Held:

  * ``forward_tp`` logits, ``loss_fn_tp`` and every leaf's gradient
    against the reference's at the same mesh, ``(1, 2)`` for the three
    and ``(1, 4)`` for zamba2: logits within ``LOGIT_TOL`` (2e-5 of max
    |logit|, ``test_torch_tp.py``'s TP bound; xlstm at 1024 reads 1.36e-5
    and the port's ONE-rank forward 1.48e-5 of the reference's TP run,
    so ``test_torch_ssm.py``'s ``MODEL_TOL`` does not hold against it),
    the loss rtol 1e-5, the gradients within ``GRAD_TOL`` (rtol 1e-3 as
    ``test_torch_tp.py``'s, atol 3.5e-5 of the leaf's max |value|: 1.5x
    the largest reading, 2.2e-5 on xlstm's wq at 1024);
  * the specs and the (2, n) bucket plan and report equal the
    reference's, full width and reduced;
  * ``forward_tp`` against the port's own ``forward`` (tp 2 and 4, T not
    dividing tp, Mamba2 heads that do not divide tp);
  * remat on == off bitwise under TP;
  * one trap a pitfall: the cross-rank norms, the gates' partial sums,
    the column slices of replicated leaves counted once, head alignment,
    the Megatron layout of the recurrent and shared leaves, pure_sp's
    gathered recurrence.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import tree as TR
from repro_torch.collectives import stacked
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import sharding as SH
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TF
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import (TrainConfig, bucket_report,
                                    make_init_fns, make_train_step)
from torch_threads import pin_threads, subproc  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False



#: configs: tag -> (arch, replacements of its reduced config)
#: (zamba2 cut to 2 Mamba2 blocks and one shared firing, xlstm to 3 mLSTM
#: and one sLSTM: the reference compiles one program a segment)
CFGS = {"zamba2_mega": ("zamba2-2.7b", dict(d_model=1024, n_layers=2)),
        "xlstm": ("xlstm-125m", dict(n_layers=4)),
        "xlstm_mega": ("xlstm-125m", dict(d_model=1024, n_layers=4))}
#: forward/grad cases: tag -> (config, tp)
FWD = {"zamba2_mega2": ("zamba2_mega", 2), "zamba2_mega4": ("zamba2_mega", 4),
       "xlstm2": ("xlstm", 2), "xlstm_mega2": ("xlstm_mega", 2)}
B, T_FWD = 2, 32
#: the JAX subprocesses, run at once: (forward cases, train runs)
GROUPS = tuple(((t,), ()) for t in FWD)
#: logits: (rtol, atol as a share of max |logit|)
LOGIT_TOL = (0, 2e-5)
#: gradients: (rtol, atol as a share of the leaf's max |value|)
GRAD_TOL = (1e-3, 3.5e-5)

PRELUDE = r"""
import os
os.environ["REPRO_OBS"] = "0"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import base
from repro.models import sharding as sh, transformer as T
from repro.optim.adamw import AdamWConfig
from repro.train.data import DataConfig, make_batch
from repro.train.step import TrainConfig, make_train_step, make_init_fns

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

def config(tag):
    arch, kw = {cfgs!r}[tag]
    return base.reduced(base.get_config(arch)).replace(dtype="float32", **kw)

out = {{}}
for tag, (ctag, n) in {fwd!r}.items():
    cfg = config(ctag)
    sh.set_model_parallel(n)
    out[tag + "_strategy"] = np.asarray(sh.strategy(cfg))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n),
                ("data", "model"))
    params = T.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    batch = {{k: rng.integers(0, cfg.vocab_size, ({b!r}, {t!r})).astype(
        np.int32) for k in ("inputs", "targets")}}
    whole = NamedSharding(mesh, P())

    def fwd(p, b):
        return T.loss_fn(p, cfg, b)[0], T.forward(p, cfg, b["inputs"])[0]

    with set_mesh(mesh):
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            fwd, has_aux=True), out_shardings=whole)(params, batch)
    for k, v in batch.items():
        out[f"{{tag}}_{{k}}"] = v
    out[tag + "_logits"], out[tag + "_loss"] = f32(logits), f32(loss)
    for i, x in enumerate(jax.tree.leaves(params)):
        out[f"{{tag}}_init_{{i}}"] = f32(x)
    for i, x in enumerate(jax.tree.leaves(grads)):
        out[f"{{tag}}_grad_{{i}}"] = f32(x)
sh.set_model_parallel(1)
for tag in {runs!r}:
    cfg = config(tag)
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda k: T.init_params(k, cfg), key)
    dcfg = DataConfig(global_batch={gb!r}, seq_len={seq!r},
                      vocab_size=cfg.vocab_size)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    # its float32 backends give the same bits; bine compiles fastest
    tcfg = TrainConfig(backend="bine", bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr={lr!r}, warmup_steps=1,
                                         total_steps=100))
    step, shd, _ = make_train_step(cfg, tcfg, mesh, shapes)
    ip, is_ = make_init_fns(cfg, tcfg, mesh, shapes)
    with set_mesh(mesh):
        params = ip(key)
        if {init!r}:          # the initial params from a file, laid out alike
            ini = np.load({init!r})
            params = jax.tree.map(
                lambda x, v: jax.device_put(jnp.asarray(v, x.dtype),
                                            x.sharding),
                params, jax.tree.unflatten(
                    jax.tree.structure(params),
                    [ini[f"{{tag}}_{{i}}"] for i in range(len(
                        jax.tree.leaves(params)))]))
        state = is_(params)
        # laid out as the step returns them (where a leaf's spec divides
        # it): its second call reuses the first call's compile
        def put(x, s):
            try:
                return jax.device_put(x, s)
            except ValueError:
                return x
        params = jax.tree.map(put, params, shd["params"])
        state = jax.tree.map(put, state, shd["state"])
        for i, x in enumerate(jax.tree.leaves(params)):
            out[f"{{tag}}_init_{{i}}"] = f32(x)
        for s in range({steps}):
            b = make_batch(dcfg, s)
            batch = {{k: jax.device_put(v, shd["batch"][k])
                     for k, v in b.items()}}
            params, state, m = step(params, state, batch)
            for k in ("loss", "grad_norm"):
                out[f"{{tag}}_{{k}}_{{s}}"] = np.asarray(m[k])
            if s == 0:
                for i, x in enumerate(jax.tree.leaves(params)):
                    out[f"{{tag}}_param_{{i}}"] = f32(x)
                for i, x in enumerate(jax.tree.leaves(state["opt"])):
                    out[f"{{tag}}_opt_{{i}}"] = np.asarray(x)
np.savez({path!r}, **out)
print("JAX_OK")
"""


def _cfg(ctag, **kw):
    arch, rep = CFGS[ctag]
    return tbase.reduced(tbase.get_config(arch)).replace(
        dtype="float32", **rep).replace(**kw)


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_ssm_tp")
    jobs = [PRELUDE.format(cfgs=CFGS, fwd={t: FWD[t] for t in fw},
                           runs=list(runs), b=B, t=T_FWD, seq=0, gb=0, lr=0, init="",
                           steps=0, path=str(tmp / f"g{i}.npz"))
            for i, (fw, runs) in enumerate(GROUPS)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(subproc, code, 4, 600) for code in jobs]:
            f.result()
    out = {}
    for i in range(len(GROUPS)):
        out.update(np.load(tmp / f"g{i}.npz"))
    return out


def _close(got, exp, what, tol):
    """Within ``rtol`` of each value plus ``atol`` times the array's
    largest |value|."""
    rtol, atol = tol
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy(), exp, rtol=rtol,
        atol=atol * float(np.abs(exp).max()), err_msg=what)


def _init(out, tag, cfg):
    shapes = TF.param_shapes(cfg)
    return TR.unflatten(shapes, [out[f"{tag}_init_{i}"] for i in
                                 range(len(TR.flatten(shapes)))])


def _tp_grads(cfg, params, batch, n):
    """The port's TP loss and gradients of the global ``params``: the
    per-rank grads, summed over the TP ranks for the leaves every rank
    holds whole, joined into global leaves."""
    sp = SH.shard_params(cfg, params, n)
    leaves = [x.detach().requires_grad_(True) for x in TR.flatten(sp)]
    loss, _ = TF.loss_fn(TR.unflatten(sp, leaves), cfg, batch, n_model=n)
    grads = torch.autograd.grad(loss.mean(), leaves)
    mds = TR.flatten(SH.model_dims(cfg, TF.param_shapes(cfg), n))
    grads = [stacked.psum(g) if md < 0 else g for g, md in zip(grads, mds)]
    return loss.detach(), SH.unshard_params(cfg, TR.unflatten(sp, grads), n,
                                            TF.param_shapes(cfg))


def _tokens(cfg, S, seed=0, B_=B):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B_, S)))


def _max_rel(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


# ---------------------------------------------------------------------------
# The forward and its gradients against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", list(FWD))
def test_tp_forward_and_grads_match_jax(jax_out, tag):
    ctag, n = FWD[tag]
    cfg = _cfg(ctag)
    assert SH.strategy(cfg, n) == str(jax_out[f"{tag}_strategy"])
    params = params_from_numpy(_init(jax_out, tag, cfg), cfg, "cpu")
    batch = {k: torch.from_numpy(jax_out[f"{tag}_{k}"])
             for k in ("inputs", "targets")}
    # the reference's tree carried across stacked over the ranks, and back
    sp = params_from_numpy(_init(jax_out, tag, cfg), cfg, "cpu", n_model=n)
    for a, b in zip(TR.flatten(params_to_numpy(sp, cfg, n)),
                    TR.flatten(_init(jax_out, tag, cfg))):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        logits, _ = TF.forward(sp, cfg, batch["inputs"], n_model=n)
    got = torch.cat(list(logits), dim=-1)[..., :cfg.vocab_size]
    _close(got, jax_out[f"{tag}_logits"], f"{tag} logits", LOGIT_TOL)
    loss, grads = _tp_grads(cfg, params, batch, n)
    assert torch.equal(loss, loss[:1].expand(n))
    np.testing.assert_allclose(float(loss[0]), float(jax_out[f"{tag}_loss"]),
                               rtol=1e-5)
    for i, (path, g) in enumerate(TR.flatten_with_path(grads)):
        assert torch.isfinite(g).all(), (tag, path)
        _close(g, jax_out[f"{tag}_grad_{i}"], f"{tag} grad {path}",
               GRAD_TOL)


# ---------------------------------------------------------------------------
# Specs and the bucket plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_tp_specs_and_bucket_report_match_jax(n):
    """``param_specs`` at tp = n and the (2, n) bucket plan and report
    (float32 and int8 wires) equal the reference's: zamba2-2.7b and
    xlstm-125m at full width, and reduced at d_model 1024 and 64; and
    ``shard_params`` cuts each reduced leaf on the dim its spec marks."""
    import jax
    from repro.configs import base as jbase
    from repro.models import sharding as jsh
    from repro.models import transformer as JT
    from repro.train import step as jstep
    from repro.train import zero as jzero
    try:
        jsh.set_model_parallel(n)
        for arch in ("zamba2-2.7b", "xlstm-125m"):
            for kw in (None, {}, dict(d_model=1024)):
                jc, tc = jbase.get_config(arch), tbase.get_config(arch)
                if kw is not None:
                    jc = jbase.reduced(jc).replace(**kw)
                    tc = tbase.reduced(tc).replace(**kw)
                js = jax.eval_shape(lambda k: JT.init_params(k, jc),
                                    jax.random.key(0))
                jspecs = [tuple(s) + (None,) * (x.ndim - len(tuple(s)))
                          for s, x in zip(jax.tree.leaves(
                              jsh.param_specs(jc, js),
                              is_leaf=lambda s: isinstance(
                                  s, jax.sharding.PartitionSpec)),
                              jax.tree.leaves(js))]
                assert jsh.strategy(jc) == SH.strategy(tc, n)
                shapes = TF.param_shapes(tc)
                assert TR.flatten(SH.param_specs(tc, shapes, n)) == jspecs
                for wire in ("float32", "int8"):
                    k = dict(backend="auto", wire_dtype=wire)
                    jt, tt = jstep.TrainConfig(**k), TrainConfig(**k)
                    jplan = jstep.resolve_bucket_plan(
                        jt, 2, js, jzero.zero_layout(jc, js, 2))
                    plan = make_train_step(tc, tt, 2, shapes, "cpu",
                                           tp=n)[1]["bucket_plan"]
                    assert bucket_report(tt, plan) == \
                        jstep.bucket_report(jt, jplan)
                    assert [(b.dtype, [(s.index, s.zero_dim, s.offset)
                                       for s in b.slots])
                            for b in plan.buckets] == \
                        [(b.dtype, [(s.index, s.zero_dim, s.offset)
                                    for s in b.slots]) for b in jplan.buckets]
                if kw != dict(d_model=1024):
                    continue
                params = TF.init_params(tc.replace(dtype="float32"), 0, "cpu")
                sp = SH.shard_params(tc, params, n)
                for x, s, spec in zip(TR.flatten(params), TR.flatten(sp),
                                      jspecs):
                    md = SH.model_dim(spec, tuple(x.shape), n)
                    assert tuple(s.shape) == (n,) + SH.local_shape(
                        tuple(x.shape), md, n)
    finally:
        jsh.set_model_parallel(1)


# ---------------------------------------------------------------------------
# Against the port's one-rank forward; remat
# ---------------------------------------------------------------------------

def test_tp_forward_equals_single_path():
    """``forward_tp`` computes the one-rank model's function: each config
    at tp 2 and 4, T not dividing tp (the stream held whole on every
    rank), and Mamba2 heads that do not divide tp (d_model 1040: 130
    heads, whole over 4 ranks while its attention is megatron_sp), within
    2e-5 of max |logit| (the ranks' partial sums in another order)."""
    cases = [(_cfg("zamba2_mega"), 2, 32), (_cfg("zamba2_mega"), 4, 32),
             (_cfg("xlstm"), 2, 32), (_cfg("xlstm"), 4, 32),
             (_cfg("xlstm_mega"), 2, 32), (_cfg("xlstm_mega"), 4, 32),
             (_cfg("xlstm", ssm_chunk=33), 2, 33),
             (_cfg("xlstm_mega", ssm_chunk=33), 2, 33),
             (_cfg("zamba2_mega", d_model=1040), 4, 32)]
    for cfg, n, S_ in cases:
        params = TF.init_params(cfg, 0, "cpu")
        toks = _tokens(cfg, S_, seed=S_)
        with torch.no_grad():
            ref, _ = TF.forward(params, cfg, toks)
            got, _ = TF.forward(SH.shard_params(cfg, params, n), cfg, toks,
                                n_model=n)
        got = torch.cat(list(got), -1)[..., :cfg.vocab_size]
        assert _max_rel(got, ref) <= 2e-5, (cfg.d_model, n, S_)
    assert not TF.recurrent_split(_cfg("zamba2_mega", d_model=1040),
                                  "mamba2", 4)


@pytest.mark.parametrize("ctag", list(CFGS))
def test_remat_on_equals_off_under_tp(ctag):
    """``cfg.remat`` recomputes each layer of ``forward_tp`` in the
    backward: the loss and every gradient bitwise the run without."""
    cfg = _cfg(ctag)
    params = TF.init_params(cfg, 0, "cpu")
    batch = {k: _tokens(cfg, 16, seed=i) for i, k in
             enumerate(("inputs", "targets"))}
    runs = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        sp = SH.shard_params(c, params, 2)
        leaves = [x.detach().requires_grad_(True) for x in TR.flatten(sp)]
        loss, _ = TF.loss_fn(TR.unflatten(sp, leaves), c, batch, n_model=2)
        runs.append([loss] + list(torch.autograd.grad(loss.mean(), leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------------
# The traps
# ---------------------------------------------------------------------------

def _tp_gap(cfg, n=2, S_=32):
    params = TF.init_params(cfg, 0, "cpu")
    toks = _tokens(cfg, S_)
    with torch.no_grad():
        ref, _ = TF.forward(params, cfg, toks)
        got, _ = TF.forward(SH.shard_params(cfg, params, n), cfg, toks,
                            n_model=n)
    return _max_rel(torch.cat(list(got), -1)[..., :cfg.vocab_size], ref)


def test_trap_cross_rank_norms(monkeypatch):
    """Mamba2's gated norm over d_inner, mLSTM's over its inner dim and
    sLSTM's over its units normalise a row split over the ranks: each
    rank's sum of squares is summed over them before the scale.
    ``split_rmsnorm`` of the chunks is ``layers.rmsnorm`` of the row (and
    so its gradient); a norm over the rank's own share (no reduction)
    moves every megatron_sp config far outside the bound."""
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal((3, 5, 8))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((8,)))
    ref = S.L.rmsnorm(y, w, 1e-6)
    ys = y.unflatten(-1, (2, 4)).movedim(-2, 0).flatten(0, 1)
    gs = w.view(2, 4).repeat_interleave(3, 0)[:, None, :]
    got = S.split_rmsnorm(ys, gs, 1e-6, 2)
    got = got.unflatten(0, (2, 3)).movedim(0, -2).flatten(-2)
    assert torch.allclose(got, ref, rtol=1e-6, atol=1e-6)   # float32 sums
    ct = torch.from_numpy(rng.standard_normal(ref.shape))
    assert torch.allclose(torch.autograd.grad(got, y, ct)[0],
                          torch.autograd.grad(ref, y, ct)[0], rtol=1e-5,
                          atol=1e-6)
    for ctag in ("zamba2_mega", "xlstm_mega"):
        assert _tp_gap(_cfg(ctag)) <= 2e-5
    monkeypatch.setattr(S, "split_rmsnorm", lambda y, g, eps, n:
                        S.L.rmsnorm(y, g, eps))
    for ctag in ("zamba2_mega", "xlstm_mega"):
        assert _tp_gap(_cfg(ctag)) > 1e-2, ctag


def test_trap_gate_partial_sums(monkeypatch):
    """mLSTM's input and forget gates (``wgi`` / ``wgf`` ``[di, nh]``,
    replicated) contract the split inner dim: each rank's partial product
    over its rows is summed over the ranks, each keeping its heads (a
    reduce-scatter; the all-gather of the input first would move di / nh
    = 512 times the bytes).  Summed in another order than one rank's
    product: within the bound.  A rank's own partial alone is not."""
    assert _tp_gap(_cfg("xlstm_mega")) <= 2e-5

    def own_partial(self, u, w):
        part = self._ranked(self.dense(u, w))
        return SH.rank_block(part, part.dim() - 2).flatten(0, 1)

    monkeypatch.setattr(S.Ranks, "gate", own_partial)
    assert _tp_gap(_cfg("xlstm_mega")) > 1e-3


def test_trap_replicated_column_slices_count_once():
    """Mamba2's ``m_dt`` and sLSTM's ``wi`` / ``wf`` / ``wo`` are
    replicated, but each rank reads only its heads' or units' columns
    (``_SPLIT_DIM``): a rank's gradient is zero outside them, the ranks'
    sum is the one-rank gradient, and the (2, 2) step's grad norm counts
    every element once: it equals (2, 1)'s."""
    for ctag, path in (("zamba2_mega", ("segments", 0, "mamba", "m_dt")),
                       ("xlstm_mega", ("segments", 1, "slstm", "wi")),
                       ("xlstm_mega", ("segments", 1, "slstm", "wo"))):
        cfg = _cfg(ctag)
        params = TF.init_params(cfg, 0, "cpu")
        batch = {k: _tokens(cfg, 32, seed=i) for i, k in
                 enumerate(("inputs", "targets"))}
        leaves = [x.requires_grad_(True) for x in TR.flatten(params)]
        i = [p for p, _ in TR.flatten_with_path(params)].index(path)
        loss, _ = TF.loss_fn(TR.unflatten(params, leaves), cfg, batch)
        ref = torch.autograd.grad(loss, leaves[i])[0]
        sp = SH.shard_params(cfg, params, 2)
        tl = [x.detach().requires_grad_(True) for x in TR.flatten(sp)]
        tloss, _ = TF.loss_fn(TR.unflatten(sp, tl), cfg, batch, n_model=2)
        part = torch.autograd.grad(tloss.mean(), tl[i])[0]   # [2, 1, d, c]
        assert tuple(part.shape) == (2,) + tuple(ref.shape)
        c = ref.shape[-1] // 2
        assert not part[0, ..., c:].any() and not part[1, ..., :c].any()
        assert torch.allclose(part.sum(0), ref, rtol=1e-4, atol=1e-7), path
    cfg = _cfg("zamba2_mega").replace(n_layers=2)
    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16)
    dcfg = DataConfig(global_batch=4, seq_len=16, vocab_size=cfg.vocab_size)
    gn = {}
    for tp in (1, 2):
        step, _, _ = make_train_step(cfg, tcfg, 2, TF.param_shapes(cfg),
                                     "cpu", tp=tp)
        ip, is_ = make_init_fns(cfg, tcfg, 2, "cpu", tp=tp)
        p = ip(0)
        _, _, m = step(p, is_(p), make_batch(dcfg, 0))
        gn[tp] = float(m["grad_norm"])
    np.testing.assert_allclose(gn[2], gn[1], rtol=1e-5)


def test_trap_head_alignment(monkeypatch):
    """mLSTM's block-diagonal q/k/v need each rank's slice of the inner
    dim to be whole heads, and Mamba2 splits only where its heads divide
    the ranks (``recurrent_split``).  At d_model 1040 Mamba2's 130 heads
    do not divide 4: it runs whole on every rank (the forward matches);
    forced to split, its head leaves cannot be cut."""
    cfg = _cfg("zamba2_mega", d_model=1040)
    assert TF.recurrent_split(cfg, "mamba2", 2)
    assert not TF.recurrent_split(cfg, "mamba2", 4)
    assert TF.recurrent_split(_cfg("xlstm_mega"), "mlstm", 4)
    assert _tp_gap(cfg, n=4) <= 2e-5
    monkeypatch.setattr(TF, "recurrent_split", lambda cfg, kind, n: True)
    with pytest.raises(ValueError, match="does not split"):
        _tp_gap(cfg, n=4)


def test_trap_megatron_layout_blocks_recurrent_and_shared_leaves():
    """``_megatron_layout`` gives each rank its block of every recurrent
    leaf that splits and of the shared block (``params["shared"]``,
    outside the segments): the shapes each contraction reads."""
    cfg = _cfg("zamba2_mega")
    n = 2
    sp = SH.shard_params(cfg, TF.param_shapes(cfg), n)
    lay = TF._megatron_layout(sp, cfg, TF._TP(cfg, n, 32))
    m = lay["segments"][0]["mamba"]
    d, din = cfg.d_model, cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_head_dim
    nl = TF.segments(cfg)[0][1]
    assert tuple(m["m_z"].shape) == (n, nl, d, din // n)
    assert tuple(m["m_dt"].shape) == (n, nl, d, nh // n)
    assert tuple(m["m_B"].shape) == (n, nl, d, cfg.ssm_state)
    assert tuple(m["norm"].shape) == (n, nl, din // n)
    assert tuple(m["out_proj"].shape) == (n, nl, din // n, d)
    a = lay["shared"]["attn"]
    q = cfg.n_heads * cfg.head_dim
    assert tuple(a["wq"].shape) == (n, d, q // n)
    assert tuple(a["wo"].shape) == (n, q // n, d)
    assert tuple(lay["shared"]["mlp"]["wi"].shape) == (n, d, cfg.d_ff // n)
    x = _cfg("xlstm_mega")
    lx = TF._megatron_layout(SH.shard_params(x, TF.param_shapes(x), n), x,
                             TF._TP(x, n, 32))
    ml, sl = lx["segments"][0]["mlstm"], lx["segments"][1]["slstm"]
    assert tuple(ml["wq"].shape)[2] == x.n_heads // n
    assert tuple(ml["wgi"].shape) == (n, 3, 2 * x.d_model // n, x.n_heads)
    assert tuple(sl["wi"].shape) == (n, 1, x.d_model, x.d_model // n)
    assert tuple(sl["out"].shape) == (n, 1, x.d_model // n, x.d_model)


def test_trap_pure_sp_gathered_recurrence(monkeypatch):
    """pure_sp: a recurrence over T cannot run on a sequence shard, so
    each rank gathers the whole sequence, runs the block, and keeps its
    own block; the gather's backward (a reduce-scatter) counts each
    token's gradient once (the gradients against the reference's above).
    With T % tp != 0 the stream stays whole.  Summing the ranks' outputs
    (as a split block's partial sums) instead counts each token n times."""
    cfg = _cfg("xlstm")
    assert SH.strategy(cfg, 2) == "pure_sp"
    assert _tp_gap(cfg) <= 2e-5
    assert _tp_gap(cfg.replace(ssm_chunk=33), S_=33) <= 2e-5
    monkeypatch.setattr(TF._TP, "own", TF._TP.reduce)
    assert _tp_gap(cfg) > 1e-2
