"""Tensor parallelism on the port's train path against the reference's.

The reference runs its model axis through GSPMD: one program on global
arrays, laid out by ``models.sharding``'s specs.  The port stacks each DP
rank's TP ranks ``[tp, ...]`` on one device, contracts each rank's weight
shard with plain matmuls and moves activations with the rank-dim
built-ins of ``collectives.stacked`` (``all_gather``, ``psum_scatter``,
``psum``).  The JAX side runs in subprocesses on 4 or 8 CPU devices under
a plain ``jax.sharding.Mesh`` and ``compat.set_mesh`` (on jax 0.9
``jax.make_mesh`` gives Explicit axes); both sides read the same numpy
inputs and JAX's initial parameters.

Cases: megatron_sp on test_parallel_equiv's cfgA (d_model 1024, 8/4
heads, qk_norm, untied head; float32) at tp = 2 and 4, the GQA rule at
tp = 4 with 2 KV heads, pure_sp on the reduced phi4-mini with a window
of 16 and with ``local_global_ratio=3``, both strategies at a vocab of
130 over tp = 4: logits, loss and every leaf's gradient; then 2 train
steps at (dp, tp) = (2, 2) on the float32, bfloat16 and int8 wires,
bucketed and per-leaf, ``auto`` per-leaf, megatron_sp (cfgA) on the
float32 and int8 wires, a vocab of 131 (an untied head; a tied one at
three seeds), and (pod, data, model) = (2, 2, 2) with ``bine_hier``,
with the reference's checkpoint at (2, 2) resumed.

A vocab that does not divide tp: the reference's TP step computes (GSPMD
holds the embedding and head whole and pads inside the step); only its
jitted ``init_params`` under ``constrain_params`` fails at 130 over 4
(jax 0.9 cannot name the padded sharding it chose), so the forward here
starts from an unconstrained init, as every case does.

Bounds.  Forward: logits atol 2e-5 of max |logit| ~ 1-3 (cfgA's row
parallel sums over 4 ranks round in another order than GSPMD's), loss
rtol 1e-5.  Gradients: rtol 1e-3, atol 1e-5, tests/test_torch_model.py's
(the TP ranks' partial sums add another order).  Train steps:
tests/test_torch_train_step.py's: loss and grad-norm rtol 1e-4 at every
step; params and optimizer state after the last step within a tight
bound on all but 0.1% of the elements and a loose bound on every element.

The int8 wire's state is compared after its first step, under one more
stated allowance.  At DP 2 a gradient element the reference's float32
sums put at a rounding boundary of its codec chunk quantizes one step
apart in the port (to 0 on one side, +-1 on the other), and AdamW's first
step, which normalises each element (m / sqrt(v) ~ sign(g)), moves that
master by up to lr and its int8-gathered param by lr plus one param
quantization step (<= 2^-7 for |param| < 1).  It happens at tp = 1 just
the same (the port's (2, 1) int8 run against the reference's: 1 element
of the reduced model's 164416 and 7 of cfgA's 3.4M after one step; at
(2, 2): 1 and 5), so it is no trace of TP; after a second step the moved
parameter changes every gradient a little and ~0.5% of the elements cross
such boundaries, so the int8 wire's second step is held to the loss and
grad-norm bounds only.  The bounds of a flipped element: master lr,
param lr + 2^-7, within the 0.1% of the elements allowed past the tight
bound; every other quantity keeps its bounds.

The tied head at a vocab of 131 is held after both steps, its tied
embedding's Adam m and v apart under a count of their own
(``TIED_EMBED_OUT``; see ``_tied_head``): a step-1 gradient of the
order of AdamW's eps rounds to a different first update, as the int8
codec's boundary does above.
"""

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.collectives import stacked
from repro_torch.configs import base
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 train_state_to_numpy)
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import (TrainConfig, bucket_report, from_global,
                                    make_init_fns, make_train_step, to_global)
from torch_threads import pin_threads, subproc  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False

#: the model configs, as (arch, replacements) both packages apply
CFG_A = ("phi4-mini-3.8b", dict(
    n_layers=2, d_model=1024, n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=128, attn_chunk=32, remat=False, qk_norm=True,
    tie_embeddings=False, rope_theta=1e6, dtype="float32"))
REDUCED = ("reduced", dict(dtype="float32"))
#: forward/grad cases: tag -> (config, its extra replacements, tp, B, T)
FWD = {
    "mega2": (CFG_A, {}, 2, 2, 64),
    "mega4": (CFG_A, {}, 4, 2, 64),
    "gqa4": (CFG_A, dict(n_kv_heads=2), 4, 2, 64),
    "window": (REDUCED, dict(window=16), 2, 2, 64),
    "local_global": (REDUCED, dict(local_global_ratio=3, n_layers=5,
                                   local_window=16), 2, 2, 64),
    # a vocab that does not divide tp: the reference's GSPMD step computes
    # with the embedding and head held whole; the port pads their vocab
    # block and leaves the padded logits out of the loss
    "vocab_mega4": (CFG_A, dict(vocab_size=130), 4, 2, 64),
    "vocab_pure4": (REDUCED, dict(vocab_size=130), 4, 2, 64),
}
STEPS = 2
#: train runs: tag -> (config, backend, wire, bucket_bytes, DP sizes, tp)
RUNS = {
    "f32": (REDUCED, "pallas_fused", "float32", 1 << 16, (2,), 2),
    "bf16": (REDUCED, "pallas_fused", "bfloat16", 1 << 16, (2,), 2),
    "int8": (REDUCED, "pallas_fused", "int8", 1 << 16, (2,), 2),
    "f32_leaf": (REDUCED, "pallas_fused", "float32", 0, (2,), 2),
    "bf16_leaf": (REDUCED, "pallas_fused", "bfloat16", 0, (2,), 2),
    "mega_f32": (CFG_A, "pallas_fused", "float32", 1 << 20, (2,), 2),
    "mega_int8": (CFG_A, "pallas_fused", "int8", 1 << 20, (2,), 2),
    "hier": (REDUCED, "bine_hier", "float32", 1 << 16, (2, 2), 2),
    # auto prices each leaf's collective at its global bytes, as the
    # reference does (per-leaf: one decision a leaf)
    "auto_leaf": (REDUCED, "auto", "float32", 0, (2,), 2),
    # a vocab that does not divide tp (131 at tp = 2), an untied head: the
    # embedding and the head each held whole and padded
    "vocab131": (("reduced", dict(dtype="float32", vocab_size=131,
                                  tie_embeddings=False)),
                 "pallas_fused", "float32", 1 << 16, (2,), 2),
}
#: the tied head at a vocab of 131 over tp = 2
#: (test_tp_vocab_not_dividing_tp_tied_head) at three seeds, each (the
#: init key, the first batch): the reference's (2, 2) run, which the
#: port's is held to, and its (2, 1) run beside it
TIED_131 = ("reduced", dict(dtype="float32", vocab_size=131))
TIED_SEEDS = ((0, 0), (1, 10), (2, 20))
VOCAB_TIED = {f"tied{k}_tp{tp}": (TIED_131, "pallas_fused", "float32",
                                  1 << 16, (2,), tp, (k, b0))
              for k, b0 in TIED_SEEDS for tp in (2, 1)}
#: elements of the tied embedding's ([131, 64], 8384) Adam m and v past
#: BOUNDS' tight bounds that the port's (2, 2) run may have against the
#: reference's in that test: 1.5 x the largest of the three seeds'
#: readings (m 175, 9, 0; v 381, 52, 19)
TIED_EMBED_OUT = {"m": 263, "v": 572}
ALL_RUNS = {**RUNS, **VOCAB_TIED}
#: the JAX subprocesses, run at once: the forward cases in two, then
#: (devices, train runs)
FWD_GROUPS = (("mega2", "mega4", "gqa4"), ("window", "local_global"),
              ("vocab_mega4", "vocab_pure4"))
GROUPS = ((4, ("f32", "bf16")), (4, ("f32_leaf", "vocab131")),
          (4, ("bf16_leaf", "auto_leaf")),
          (4, ("int8",)), (4, ("mega_f32",)), (4, ("mega_int8",)),
          (8, ("hier",)),
          *((4, (f"tied{k}_tp2", f"tied{k}_tp1")) for k, _ in TIED_SEEDS))
#: the run whose state the reference checkpoints after STEPS steps
CKPT_RUN = "f32"
#: (tight, loose) absolute bounds, as in tests/test_torch_train_step.py
BOUNDS = {"param": (1e-5, 1e-3), "master": (1e-5, 1e-3), "m": (1e-7, 1e-4),
          "v": (1e-9, 1e-7), "ef": (1e-6, 1e-3)}
LR = 3e-3
#: the int8 wire's state after its first step: a codec rounding flip
#: moves a master by up to one AdamW step (lr) and its int8-gathered param
#: by one more param quantization step (see the module docstring)
BOUNDS_INT8 = dict(BOUNDS, param=(1e-5, LR + 2.0 ** -7), master=(1e-5, LR))


def _state_at(tag):
    """The step after which the state is compared: the first on the int8
    wire, else the last."""
    return 1 if ALL_RUNS[tag][2] == "int8" else STEPS

JAX_PRELUDE = r"""
import os
os.environ["REPRO_OBS"] = "0"
import jax, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base

def config(spec, extra):
    arch, kw = spec
    if arch == "reduced":
        cfg = base.reduced(base.get_config("phi4-mini-3.8b"))
    else:
        cfg = base.get_config(arch)
    return cfg.replace(**kw).replace(**extra)
"""

FWD_CODE = JAX_PRELUDE + r"""
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models import transformer as T, sharding as sh
out = {{}}
for tag, (spec, extra, n, B, S) in {cases!r}.items():
    cfg = config(spec, extra)
    sh.set_model_parallel(n)
    out[tag + "_strategy"] = np.asarray(sh.strategy(cfg))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n),
                ("data", "model"))
    params = T.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    batch = {{k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("inputs", "targets")}}
    # replicated outputs: a gradient sharded as its spec says may not
    # divide over the model axis (GSPMD pads it)
    whole = NamedSharding(mesh, P())

    def fwd(p, b):            # one compile: the loss, its logits, the grads
        return T.loss_fn(p, cfg, b)[0], T.forward(p, cfg, b["inputs"])[0]

    with set_mesh(mesh):
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            fwd, has_aux=True), out_shardings=whole)(params, batch)
    for k, v in batch.items():
        out[f"{{tag}}_{{k}}"] = v
    out[tag + "_logits"] = np.asarray(logits)
    out[tag + "_loss"] = np.asarray(loss)
    for i, x in enumerate(jax.tree.leaves(params)):
        out[f"{{tag}}_init_{{i}}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(grads)):
        out[f"{{tag}}_grad_{{i}}"] = np.asarray(x)
np.savez({path!r}, **out)
print("JAX_OK")
"""

STEP_CODE = JAX_PRELUDE + r"""
from repro.models import transformer as T
from repro.optim.adamw import AdamWConfig
from repro.train.data import DataConfig, make_batch
from repro.train import checkpoint as ckpt
from repro.train.step import TrainConfig, make_train_step, make_init_fns

out = {{}}
for tag, (spec, backend, wire, bb, dp, tp, *seed) in {runs!r}.items():
    cfg = config(spec, {{}})
    k0, b0 = seed[0] if seed else (0, 0)      # the init key, first batch
    key = jax.random.key(k0)
    shapes = jax.eval_shape(lambda k: T.init_params(k, cfg), key)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    axes = ("data",) if len(dp) == 1 else ("pod", "data")
    n = int(np.prod(dp)) * tp
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(dp) + (tp,)),
                axes + ("model",))
    tcfg = TrainConfig(backend=backend, dp_axes=axes, wire_dtype=wire,
                       bucket_bytes=bb,
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))
    step, sh, _ = make_train_step(cfg, tcfg, mesh, shapes)
    ip, is_ = make_init_fns(cfg, tcfg, mesh, shapes)
    with set_mesh(mesh):
        params = ip(key)
        state = is_(params)
        for i, x in enumerate(jax.tree.leaves(params)):
            out[f"{{tag}}_init_{{i}}"] = np.asarray(x)
        for s in range({steps}):
            b = make_batch(dcfg, b0 + s)
            batch = {{k: jax.device_put(v, sh["batch"][k])
                     for k, v in b.items()}}
            params, state, m = step(params, state, batch)
            out[f"{{tag}}_loss_{{s}}"] = np.asarray(m["loss"])
            out[f"{{tag}}_gnorm_{{s}}"] = np.asarray(m["grad_norm"])
            if s + 1 == {state_at!r}[tag]:
                sfx = ""
            elif s + 1 == {also_at!r}.get(tag):    # an earlier state too
                sfx = str(s + 1)
            else:
                continue
            for i, x in enumerate(jax.tree.leaves(params)):
                out[f"{{tag}}_param{{sfx}}_{{i}}"] = np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(state["opt"])):
                out[f"{{tag}}_opt{{sfx}}_{{i}}"] = np.asarray(x)
            for bid, x in state.get("ef", {{}}).items():
                out[f"{{tag}}_ef{{sfx}}_{{bid}}"] = np.asarray(x)
        if tag == {ckpt_run!r}:
            ckpt.save({ckpt_dir!r}, {steps}, {{"params": params,
                                               "state": state}})
            b = make_batch(dcfg, {steps})
            batch = {{k: jax.device_put(v, sh["batch"][k])
                     for k, v in b.items()}}
            params, state, m = step(params, state, batch)
            out[f"{{tag}}_loss_{steps}"] = np.asarray(m["loss"])
            out[f"{{tag}}_gnorm_{steps}"] = np.asarray(m["grad_norm"])
            for i, x in enumerate(jax.tree.leaves(params)):
                out[f"{{tag}}_after_{{i}}"] = np.asarray(x)
np.savez({path!r}, **out)
print("JAX_OK")
"""


def _cfg(spec, **extra):
    arch, kw = spec
    if arch == "reduced":
        cfg = base.reduced(base.get_config("phi4-mini-3.8b"))
    else:
        cfg = base.get_config(arch)
    return cfg.replace(**kw).replace(**extra)


@pytest.fixture(scope="module")
def jax_run(subproc, tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("jax_tp")
    ckpt_dir = str(tmp / "ckpt")
    jobs = [(FWD_CODE.format(cases={t: FWD[t] for t in g},
                             path=str(tmp / f"fwd{i}.npz")), 4)
            for i, g in enumerate(FWD_GROUPS)]
    for i, (devices, runs) in enumerate(GROUPS):
        jobs.append((STEP_CODE.format(
            runs={t: ALL_RUNS[t] for t in runs}, steps=STEPS,
            ckpt_run=CKPT_RUN,
            state_at={t: _state_at(t) for t in runs},
            also_at={t: 1 for t in runs if t in VOCAB_TIED},
            ckpt_dir=ckpt_dir, path=str(tmp / f"step{i}.npz")), devices))
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(subproc, code, dev, 600) for code, dev in jobs]:
            f.result()
    out = {"ckpt_dir": ckpt_dir}
    for f in [f"fwd{i}.npz" for i in range(len(FWD_GROUPS))] + \
            [f"step{i}.npz" for i in range(len(GROUPS))]:
        out.update(np.load(tmp / f))
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


def _leaf_index(tree, path):
    return [p for p, _ in T.flatten_with_path(tree)].index(path)


def _init(jax_run, tag, cfg):
    shapes = TF.param_shapes(cfg)
    n = len(T.flatten(shapes))
    return T.unflatten(shapes, [jax_run[f"{tag}_init_{i}"] for i in range(n)])


# ---------------------------------------------------------------------------
# The forward and its gradients
# ---------------------------------------------------------------------------

def _tp_grads(cfg, params, batch, n):
    """The port's TP loss and gradients of the global ``params``: the
    per-rank grads, summed over the TP ranks for the leaves every rank
    holds whole, joined into global leaves."""
    sp = SH.shard_params(cfg, params, n)
    leaves = [x.detach().requires_grad_(True) for x in T.flatten(sp)]
    loss, _ = TF.loss_fn(T.unflatten(sp, leaves), cfg, batch, n_model=n)
    grads = torch.autograd.grad(loss.mean(), leaves)
    mds = T.flatten(SH.model_dims(cfg, TF.param_shapes(cfg), n))
    grads = [stacked.psum(g) if md < 0 else g for g, md in zip(grads, mds)]
    return loss.detach(), SH.unshard_params(cfg, T.unflatten(sp, grads), n,
                                            TF.param_shapes(cfg))


@pytest.mark.parametrize("tag", list(FWD))
def test_tp_forward_and_grads_match_jax(jax_run, tag):
    spec, extra, n, _, _ = FWD[tag]
    cfg = _cfg(spec, **extra)
    assert SH.strategy(cfg, n) == str(jax_run[f"{tag}_strategy"])
    params = params_from_numpy(_init(jax_run, tag, cfg), cfg, "cpu")
    batch = {k: torch.from_numpy(jax_run[f"{tag}_{k}"])
             for k in ("inputs", "targets")}
    sp = params_from_numpy(_init(jax_run, tag, cfg), cfg, "cpu", n_model=n)
    for a, b in zip(T.flatten(params_to_numpy(sp, cfg, n)),
                    T.flatten(_init(jax_run, tag, cfg))):
        np.testing.assert_array_equal(a, b)              # and back, exactly
    logits, _ = TF.forward(sp, cfg, batch["inputs"], n_model=n)
    got = torch.cat(list(logits), dim=-1)              # the vocab shards
    # the padding of a vocab that does not divide n: zeros past V
    V = cfg.vocab_size
    assert got.shape[-1] == -(-V // n) * n
    assert not bool(got[..., V:].any())
    got = got[..., :V].numpy()
    exp = jax_run[f"{tag}_logits"]
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=2e-5 * np.abs(exp).max())
    loss, grads = _tp_grads(cfg, params, batch, n)
    assert torch.equal(loss, loss[:1].expand(n))       # the same on every rank
    np.testing.assert_allclose(float(loss[0]), float(jax_run[f"{tag}_loss"]),
                               rtol=1e-5)
    for i, g in enumerate(T.flatten(grads)):
        np.testing.assert_allclose(g.numpy(), jax_run[f"{tag}_grad_{i}"],
                                   rtol=1e-3, atol=1e-5,
                                   err_msg=f"{tag} grad leaf {i}")


def test_tp_forward_equals_single_path_float32():
    """The TP forward computes the unsharded model's function: megatron_sp
    and pure_sp at tp = 2 and 4 against the port's single path on the
    same weights, and T % tp != 0, where the residual stream stays whole
    on every rank and pure_sp's attention falls through to the single
    path, as the reference's does (``layers.py:140``); a vocab that does
    not divide tp (130 at 4, 131 at 2 with a tied head)."""
    a = _cfg(CFG_A)
    r = _cfg(REDUCED)
    cases = [(a, 2, 64), (a, 4, 64), (r, 2, 64), (r, 4, 32),
             (r, 2, 96),                       # nC = 3: the Cq growth
             (r.replace(attn_chunk=64), 2, 33),   # T % tp != 0
             (a.replace(attn_chunk=64), 2, 33),
             (a.replace(vocab_size=130), 4, 64),   # V % tp != 0: padded
             (r.replace(vocab_size=131, tie_embeddings=True), 2, 64)]
    for cfg, n, S in cases:
        params = TF.init_params(cfg, 0, "cpu")
        toks = torch.from_numpy(np.random.default_rng(S).integers(
            0, cfg.vocab_size, (2, S)))
        ref, _ = TF.forward(params, cfg, toks)
        got, _ = TF.forward(SH.shard_params(cfg, params, n), cfg, toks,
                            n_model=n)
        got = torch.cat(list(got), dim=-1)[..., :cfg.vocab_size]
        assert float((got - ref).abs().max()) <= 2e-5 * float(
            ref.abs().max()), (SH.strategy(cfg, n), n, S)


# ---------------------------------------------------------------------------
# The traps
# ---------------------------------------------------------------------------

def test_trap_collectives_autograd():
    """The rank-dim built-ins are plain tensor ops: the backward of the
    all-gather is a reduce-scatter of the cotangents, and the backward of
    the reduce-scatter an all-gather; psum's backward is a psum."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 3, 8))).requires_grad_()
    ct = torch.from_numpy(rng.standard_normal((4, 3, 32)))
    (g,) = torch.autograd.grad(SH.seq_gather(x, 1), x, ct)
    assert torch.allclose(g, stacked.psum_scatter(ct, 1), rtol=1e-12)
    y = torch.from_numpy(rng.standard_normal((4, 3, 32))).requires_grad_()
    ct2 = torch.from_numpy(rng.standard_normal((4, 3, 8)))
    (g2,) = torch.autograd.grad(SH.seq_reduce_scatter(y, 1), y, ct2)
    assert torch.equal(g2, stacked.all_gather(ct2, 1))
    (g3,) = torch.autograd.grad(stacked.psum(y), y, y.detach())
    assert torch.allclose(g3, stacked.psum(y.detach()), rtol=1e-12)


def test_trap_replicated_leaves_sum_over_tp_and_count_once():
    """Norm weights (and, under pure_sp, every non-embedding weight) are
    held whole by every TP rank, each of which sees only its sequence
    shard: a rank's gradient is partial, and only their sum over the TP
    ranks is the leaf's gradient.  The step's grad-norm counts each
    element once: (2, 2) equals (2, 1)."""
    r = _cfg(REDUCED)
    params = TF.init_params(r, 0, "cpu")
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, r.vocab_size, (2, 64)))
             for k in ("inputs", "targets")}
    leaves = [x.requires_grad_(True) for x in T.flatten(params)]
    loss, _ = TF.loss_fn(T.unflatten(params, leaves), r, batch)
    ref = torch.autograd.grad(loss, leaves)
    sp = SH.shard_params(r, params, 2)
    tl = [x.detach().requires_grad_(True) for x in T.flatten(sp)]
    tloss, _ = TF.loss_fn(T.unflatten(sp, tl), r, batch, n_model=2)
    per_rank = torch.autograd.grad(tloss.mean(), tl)
    ln1 = _leaf_index(params, ("segments", 0, "ln1"))
    part = per_rank[ln1]
    assert not torch.allclose(part[0], ref[ln1], rtol=1e-3)   # partial
    assert torch.allclose(part.sum(0), ref[ln1], rtol=1e-4, atol=1e-6)
    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=r.vocab_size)
    gn = {}
    for tp in (1, 2):
        step, _, _ = make_train_step(r, tcfg, 2, TF.param_shapes(r), "cpu",
                                     tp=tp)
        ip, is_ = make_init_fns(r, tcfg, 2, "cpu", tp=tp)
        p = ip(0)
        _, _, m = step(p, is_(p), make_batch(dcfg, 0))
        gn[tp] = float(m["grad_norm"])
    np.testing.assert_allclose(gn[2], gn[1], rtol=1e-5)


@pytest.mark.parametrize("arch", ["full", "reduced"])
def test_trap_int8_bucket_report_equal_at_tp1_and_tp2(arch):
    """The int8 codec scales each chunk of a bucket: under TP the bucket
    covers the reference's global leaves in the reference's order, so
    the plan and its report are those of tp = 1 (megatron_sp keeps every
    spec; pure_sp moves zero dims, as the reference's does — its report
    is checked against the reference's in test_tp_specs_match_jax)."""
    cfg = base.get_config("phi4-mini-3.8b").replace(n_layers=2) \
        if arch == "full" else _cfg(REDUCED)
    tcfg = TrainConfig(backend="pallas_fused", wire_dtype="int8")
    infos = [make_train_step(cfg, tcfg, 2, TF.param_shapes(cfg), "cpu",
                             tp=tp)[1] for tp in (1, 2)]
    if arch == "full":
        assert bucket_report(tcfg, infos[0]["bucket_plan"]) == \
            bucket_report(tcfg, infos[1]["bucket_plan"])
    lay = infos[1]["layout"]
    # every TP column of every bucket: its own shards, 1/tp of the sharded
    for b, lb in zip(lay.plan.buckets, lay.local_plan.buckets):
        assert [s.index for s in b.slots] == [s.index for s in lb.slots]
        assert lb.row_elems < b.row_elems


def test_trap_pure_sp_sequence_split():
    """pure_sp needs T % tp == 0 for the sequence split and the q-chunk
    grid to split over the ranks, else chunks grow to T / tp
    (``Cq``); with T % tp != 0 the reference falls through to the single
    path.  All three agree with the single strategy (float32)."""
    r = _cfg(REDUCED)
    params = TF.init_params(r, 0, "cpu")
    for n, S, chunk in ((2, 64, 32), (4, 32, 32), (2, 96, 32), (2, 33, 64)):
        cfg = r.replace(attn_chunk=chunk)
        toks = torch.from_numpy(np.random.default_rng(S).integers(
            0, cfg.vocab_size, (2, S)))
        ref, _ = TF.forward(params, cfg, toks)
        got, _ = TF.forward(SH.shard_params(cfg, params, n), cfg, toks,
                            n_model=n)
        assert SH.strategy(cfg, n) == "pure_sp"
        assert torch.allclose(torch.cat(list(got), -1), ref, atol=1e-5)


def test_trap_memory_per_rank_shards():
    """Memory: at full width the card holds (2, 2)'s ranks as (2, 1)'s
    would hold half a model each — every TP rank stores only its shard of
    the sharded leaves, and the optimizer state 1/(dp * tp) of those
    (meta shapes: nothing allocated)."""
    cfg = base.get_config("phi4-mini-3.8b").replace(n_layers=2)
    shapes = TF.param_shapes(cfg)
    tcfg = TrainConfig(backend="pallas_fused")
    lay = make_train_step(cfg, tcfg, 2, shapes, "cpu", tp=2)[1]["layout"]
    full = sum(int(np.prod(x.shape)) for x in T.flatten(shapes))
    held = sum(int(np.prod(s)) for s in lay.local_shapes)
    assert full * 0.5 <= held <= full * 0.52      # the norms stay whole
    embed = _leaf_index(shapes, ("embed",))
    assert lay.local_shapes[embed] == (cfg.vocab_size // 2, cfg.d_model)


# ---------------------------------------------------------------------------
# Specs and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_tp_specs_match_jax(n):
    """``param_specs`` equal the reference's at tp = 2 and 4 (full
    phi4-mini: megatron_sp; the reduced one: pure_sp; cfgA with 2 KV
    heads at tp = 4: the GQA rule), and ``shard_params`` cuts each leaf on
    the dim its spec marks."""
    import jax
    from repro.configs import base as jbase
    from repro.models import sharding as jsh
    from repro.models import transformer as JT
    try:
        for arch, kw in (("phi4-mini-3.8b", dict(n_layers=2)),
                         ("reduced", {}), CFG_A,
                         (CFG_A[0], dict(CFG_A[1], n_kv_heads=2))):
            if arch == "reduced":
                jc = jbase.reduced(jbase.get_config("phi4-mini-3.8b"))
                tc = base.reduced(base.get_config("phi4-mini-3.8b"))
            else:
                jc = jbase.get_config(arch).replace(**kw)
                tc = base.get_config(arch).replace(**kw)
            jsh.set_model_parallel(n)
            js = jax.eval_shape(lambda k: JT.init_params(k, jc),
                                jax.random.key(0))
            jspecs = [tuple(s) + (None,) * (x.ndim - len(tuple(s)))
                      for s, x in zip(jax.tree.leaves(
                          jsh.param_specs(jc, js),
                          is_leaf=lambda s: isinstance(s, jax.sharding.
                                                       PartitionSpec)),
                          jax.tree.leaves(js))]
            assert jsh.strategy(jc) == SH.strategy(tc, n)
            shapes = TF.param_shapes(tc)
            assert T.flatten(SH.param_specs(tc, shapes, n)) == jspecs
            if TF.param_count(shapes) > 1e7:
                continue          # the full width: specs only
            params = TF.init_params(tc.replace(dtype="float32"), 0, "cpu")
            sp = SH.shard_params(tc, params, n)
            for x, s, spec in zip(T.flatten(params), T.flatten(sp), jspecs):
                md = SH.model_dim(spec, tuple(x.shape), n)
                assert tuple(s.shape) == (n,) + SH.local_shape(
                    tuple(x.shape), md, n)
                if md >= 0:
                    assert torch.equal(s[1], x.chunk(n, md)[1])
            back = SH.unshard_params(tc, sp, n, shapes)
            assert all(torch.equal(a, b) for a, b in zip(T.flatten(back),
                                                          T.flatten(params)))
    finally:
        jsh.set_model_parallel(1)


def test_tp_bucket_report_matches_jax():
    """The (2, 2) bucket plan and report equal the reference's at
    model axis 2, for megatron_sp and pure_sp (their zero dims differ)."""
    import jax
    from repro.configs import base as jbase
    from repro.models import sharding as jsh
    from repro.models import transformer as JT
    from repro.train import step as jstep
    from repro.train import zero as jzero
    try:
        jsh.set_model_parallel(2)
        for red in (False, True):
            jc = jbase.get_config("phi4-mini-3.8b").replace(n_layers=2)
            tc = base.get_config("phi4-mini-3.8b").replace(n_layers=2)
            if red:
                jc, tc = jbase.reduced(jc), base.reduced(tc)
            js = jax.eval_shape(lambda k: JT.init_params(k, jc),
                                jax.random.key(0))
            for wire in ("float32", "int8"):
                kw = dict(backend="auto", wire_dtype=wire)
                jt = jstep.TrainConfig(**kw)
                jplan = jstep.resolve_bucket_plan(
                    jt, 2, js, jzero.zero_layout(jc, js, 2))
                tt = TrainConfig(**kw)
                info = make_train_step(tc, tt, 2, TF.param_shapes(tc), "cpu",
                                       tp=2)[1]
                assert bucket_report(tt, info["bucket_plan"]) == \
                    jstep.bucket_report(jt, jplan)
                assert [[(s.index, s.zero_dim, s.offset) for s in b.slots]
                        for b in info["bucket_plan"].buckets] == \
                    [[(s.index, s.zero_dim, s.offset) for s in b.slots]
                     for b in jplan.buckets]
    finally:
        jsh.set_model_parallel(1)


# ---------------------------------------------------------------------------
# Train steps against the reference
# ---------------------------------------------------------------------------

def _seed(tag):
    """The run's (init key, first batch): (0, 0) unless it names one."""
    return ALL_RUNS[tag][6] if len(ALL_RUNS[tag]) > 6 else (0, 0)


def _tcfg(tag):
    _, backend, wire, bb, dp = ALL_RUNS[tag][:5]
    return TrainConfig(backend=backend, wire_dtype=wire, bucket_bytes=bb,
                       dp_axes=("data",) if len(dp) == 1 else ("pod", "data"),
                       adamw=AdamWConfig(lr=LR, warmup_steps=1,
                                         total_steps=100))


def _run(jax_run, tag, steps=STEPS, globs=None):
    """The port's run of ``ALL_RUNS[tag]`` from JAX's initial params: (metrics,
    params, state, the global numpy state after ``_state_at(tag)``).
    ``globs``, a dict, gets the global numpy state after every step."""
    spec, _, _, _, dp, tp = ALL_RUNS[tag][:6]
    cfg, tcfg = _cfg(spec), _tcfg(tag)
    step, _, _ = make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg), "cpu",
                                 tp=tp)
    one = params_from_numpy(_init(jax_run, tag, cfg), cfg, "cpu", n_model=tp)
    params = [T.tree_map(torch.clone, one) for _ in range(int(np.prod(dp)))]
    _, init_s = make_init_fns(cfg, tcfg, dp, "cpu", tp=tp)
    state = init_s(params)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    metrics, glob = [], None
    for s in range(steps):
        params, state, m = step(params, state,
                                make_batch(dcfg, _seed(tag)[1] + s))
        metrics.append(m)
        if s + 1 == _state_at(tag) or globs is not None:
            g = train_state_to_numpy(cfg, tcfg, params, state, dp, tp=tp)
            glob = g if s + 1 == _state_at(tag) else glob
            if globs is not None:
                globs[s + 1] = g
    return metrics, params, state, glob


def _check_state(glob, jax_run, tag, apart=None, at=""):
    """The port's global state of run ``tag`` against the reference's
    (after step ``at`` where given, else after ``_state_at(tag)``) within
    BOUNDS (BOUNDS_INT8 on the int8 wire).  ``apart``: (kind, leaf
    path) -> the count of that leaf's elements allowed past the tight
    bound; such a leaf is held to it alone, out of the shared count.
    Returns each such leaf's count."""
    pairs = {"param": [(x, jax_run[f"{tag}_param{at}_{i}"])
                       for i, x in enumerate(T.flatten(glob["params"]))],
             "master": [], "m": [], "v": []}
    i = 0
    for st in T.flatten_up_to(glob["params"], glob["state"]["opt"]):
        for k in sorted(st):              # m, master, v: the JAX leaf order
            pairs[k].append((st[k], jax_run[f"{tag}_opt{at}_{i}"]))
            i += 1
    ef = {k[len(f"{tag}_ef{at}_"):]: v for k, v in jax_run.items()
          if k.startswith(f"{tag}_ef{at}_")}
    assert sorted(glob["state"].get("ef", {})) == sorted(ef)
    assert bool(ef) == (ALL_RUNS[tag][2] == "int8")
    pairs["ef"] = [(glob["state"]["ef"][b], v) for b, v in ef.items()]
    bounds = BOUNDS_INT8 if ALL_RUNS[tag][2] == "int8" else BOUNDS
    counts = {}
    for (k, path), n_out in (apart or {}).items():
        tight, loose = bounds[k]
        got, exp = pairs[k].pop(_leaf_index(glob["params"], path))
        d = np.abs(got.astype(np.float64) - exp)
        assert d.max() <= loose, (tag, k, path, float(d.max()))
        counts[k, path] = int((d > tight).sum())
        assert counts[k, path] <= n_out, (tag, k, path, counts[k, path])
    for k, (tight, loose) in bounds.items():
        _mostly_close(pairs[k], tight, loose, f"{tag} {k}")
    return counts


@pytest.mark.parametrize("tag", list(RUNS))
def test_tp_train_steps_match_jax(jax_run, tag):
    metrics, _, _, glob = _run(jax_run, tag)
    for s, m in enumerate(metrics):
        np.testing.assert_allclose(float(m["loss"]),
                                   jax_run[f"{tag}_loss_{s}"], rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   jax_run[f"{tag}_gnorm_{s}"], rtol=1e-4)
    _check_state(glob, jax_run, tag)


def test_tp_vocab_not_dividing_tp_tied_head(jax_run):
    """``_tied_head`` at the first of ``TIED_SEEDS``."""
    _tied_head(jax_run, TIED_SEEDS[0][0])


@pytest.mark.parametrize("key", [k for k, _ in TIED_SEEDS[1:]])
def test_tp_vocab_not_dividing_tp_tied_head_at_seed(jax_run, key):
    """``_tied_head`` at the other seeds of ``TIED_SEEDS``."""
    _tied_head(jax_run, key)


def _tied_head(jax_run, key):
    """The tied head at a vocab of 131 over tp = 2, the port's (2, 2) run
    against the reference's, at seed ``key``: the loss and grad norm of
    both steps (rtol 1e-4); the whole state after step 1 within BOUNDS;
    after step 2 within BOUNDS, where the tied embedding's Adam m and v
    are held apart, each to ``TIED_EMBED_OUT`` elements past its tight
    bound (every one within the loose bound).

    Why apart: the weights that differ past the tight bound after step 1
    all have a step-1 gradient below 100 x AdamW's eps (asserted).  At
    that size rounding moves a gradient by a large share of itself, and
    the first update ``lr g / (|g| + eps)`` with it.  Step 2's gradients
    then differ a little everywhere; the tied embedding, which sums every
    position's head and lookup gradients, shows it most.  The reference's
    own (2, 2) and (2, 1) runs differ so too: the test prints their
    counts beside the port's."""
    tag = f"tied{key}_tp2"
    globs = {}
    metrics, _, _, glob = _run(jax_run, tag, globs=globs)
    for s, m in enumerate(metrics):
        np.testing.assert_allclose(float(m["loss"]),
                                   jax_run[f"{tag}_loss_{s}"], rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   jax_run[f"{tag}_gnorm_{s}"], rtol=1e-4)
    _check_state(globs[1], jax_run, tag, at="1")
    adamw = _tcfg(tag).adamw
    p1 = globs[1]["params"]
    g1 = []          # |step-1 gradient| of each weight past the tight bound
    for i, (x, st) in enumerate(zip(T.flatten(p1), T.flatten_up_to(
            p1, globs[1]["state"]["opt"]))):
        d = np.abs(x.astype(np.float64) - jax_run[f"{tag}_param1_{i}"])
        g1 += (np.abs(st["m"][d > BOUNDS["param"][0]]) /
               (1 - adamw.b1)).tolist()
    assert max(g1, default=0.0) < 100 * adamw.eps, (key, max(g1))
    print(f"seed {key}: after step 1, {len(g1)} weights past "
          f"{BOUNDS['param'][0]:g}, step-1 |gradient| at most "
          f"{max(g1, default=0.0):.2e}")
    counts = _check_state(glob, jax_run, tag, apart={
        (k, ("embed",)): n for k, n in TIED_EMBED_OUT.items()})
    e = _leaf_index(glob["params"], ("embed",))
    for j, k in ((0, "m"), (2, "v")):      # m, master, v: the JAX order
        a, b = (jax_run[f"tied{key}_tp{t}_opt_{3 * e + j}"] for t in (2, 1))
        own = int((np.abs(a.astype(np.float64) - b) > BOUNDS[k][0]).sum())
        print(f"seed {key}: tied embedding {k} past {BOUNDS[k][0]:g} after "
              f"step 2: port (2, 2) vs reference (2, 2) "
              f"{counts[k, ('embed',)]}, reference (2, 2) vs (2, 1) {own}")


def test_tp_bucketed_and_per_leaf_bitwise(jax_run):
    """At (2, 2) the bucketed and the per-leaf step give the same bits, as
    at tp = 1: each element is reduced in its reference block."""
    _, pb, sb, _ = _run(jax_run, "f32")
    _, pl, sl, _ = _run(jax_run, "f32_leaf")
    for a, b in zip(T.flatten(pb[0]), T.flatten(pl[0])):
        assert torch.equal(a, b)
    for a, b in zip(T.flatten(sb["opt"]), T.flatten(sl["opt"])):
        assert torch.equal(a, b)


def test_tp_global_layout_round_trip():
    """``to_global`` of a (2, 2) state restores at (4, 1) and back, and
    the global trees agree bitwise (int8 wire: the residuals too; their
    rows are per DP rank, so the DP size stays 2 there)."""
    r = _cfg(REDUCED)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=r.vocab_size)
    for wire, other in (("float32", (4, 1)), ("int8", (2, 1))):
        tcfg = TrainConfig(backend="pallas_fused", wire_dtype=wire,
                           bucket_bytes=1 << 16)
        step, _, _ = make_train_step(r, tcfg, 2, TF.param_shapes(r), "cpu",
                                     tp=2)
        ip, is_ = make_init_fns(r, tcfg, 2, "cpu", tp=2)
        p = ip(0)
        p, s, _ = step(p, is_(p), make_batch(dcfg, 0))
        glob = to_global(r, tcfg, p, s, 2, tp=2)
        p1, s1 = from_global(r, tcfg, glob, other[0], "cpu", tp=other[1])
        back1 = to_global(r, tcfg, p1, s1, other[0], tp=other[1])
        p2, s2 = from_global(r, tcfg, back1, 2, "cpu", tp=2)
        back2 = to_global(r, tcfg, p2, s2, 2, tp=2)
        for a, b, c in zip(T.flatten(glob), T.flatten(back1),
                           T.flatten(back2)):
            assert torch.equal(a, b) and torch.equal(a, c)
        # both continue alike: the restored (2, 2) step is the original's
        _, _, m_a = step(p, s, make_batch(dcfg, 1))
        _, _, m_b = step(p2, s2, make_batch(dcfg, 1))
        assert float(m_a["loss"]) == float(m_b["loss"])


def test_jax_tp_checkpoint_resumes_in_port(jax_run):
    """The reference's (2, 2) state after STEPS steps, saved by its
    ``checkpoint.save`` (global arrays), restores in the port at (2, 2)
    bit for bit, and the port's next step matches the reference's."""
    from repro_torch.train import checkpoint as ckpt
    spec, _, _, _, dp, tp = ALL_RUNS[CKPT_RUN]
    cfg, tcfg = _cfg(spec), _tcfg(CKPT_RUN)
    step, _, _ = make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg), "cpu",
                                 tp=tp)
    init_p, init_s = make_init_fns(cfg, tcfg, dp, "cpu", tp=tp)
    fresh = init_p(0)
    like = to_global(cfg, tcfg, fresh, init_s(fresh), dp, device="meta",
                     tp=tp)
    tree = ckpt.restore(jax_run["ckpt_dir"], STEPS, like, device="cpu")
    for i, x in enumerate(T.flatten(tree["params"])):
        np.testing.assert_array_equal(x.numpy(),
                                      jax_run[f"{CKPT_RUN}_param_{i}"])
    params, state = from_global(cfg, tcfg, tree, dp, "cpu", tp=tp)
    back = to_global(cfg, tcfg, params, state, dp, tp=tp)
    assert all(torch.equal(a, b) for a, b in zip(T.flatten(back),
                                                  T.flatten(tree)))
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    params, state, m = step(params, state, make_batch(dcfg, STEPS))
    np.testing.assert_allclose(float(m["loss"]),
                               jax_run[f"{CKPT_RUN}_loss_{STEPS}"], rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               jax_run[f"{CKPT_RUN}_gnorm_{STEPS}"], rtol=1e-4)
    glob = to_global(cfg, tcfg, params, state, dp, tp=tp)
    _mostly_close([(x.numpy(), jax_run[f"{CKPT_RUN}_after_{i}"])
                   for i, x in enumerate(T.flatten(glob["params"]))],
                  *BOUNDS["param"], f"step {STEPS} params")


def test_train_cli_runs_tensor_parallel(capsys):
    """``--mesh 2,2`` (data 2, model 2) and ``--mesh 2,2,2`` run on the
    CPU; the strategy is printed."""
    from repro_torch.launch import train as L
    assert L.parse_mesh("2,2") == (("data",), (2,), 2)
    assert L.parse_mesh("2,2,2") == (("pod", "data"), (2, 2), 2)
    L.main(["--reduced", "--mesh", "2,2", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--backend", "pallas_fused"])
    out = capsys.readouterr().out
    assert "tp=2 (pure_sp)" in out and "done: 2 steps" in out
    L.main(["--reduced", "--mesh", "2,2,2", "--device", "cpu", "--steps",
            "1", "--batch", "4", "--seq", "16", "--backend", "bine_hier"])
    out = capsys.readouterr().out
    assert "dp={'pod': 2, 'data': 2}" in out and "done: 1 steps" in out
