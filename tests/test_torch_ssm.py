"""The recurrent blocks (Mamba2, mLSTM, sLSTM) and the two recurrent
configs (xlstm-125m, zamba2-2.7b) on the port, against the JAX package,
on the CPU.

The JAX side runs in three subprocesses at once (one CPU device for the
blocks, the models and the fixed-batch loop; two of 4 for the train
steps) and hands its outputs over as ``.npz`` files; weights cross
through ``interop`` (each leaf in the reference's dtype), inputs are
numpy arrays from a seed.  Held against ``repro``, float32:

  * ``models.ssm``'s ``mamba2``, ``mlstm`` and ``slstm`` on reduced
    widths (d_model 64) over 3 chunks of 16 (48 steps for sLSTM): the
    output, the final states and the gradients of ``sum(out * w)`` with
    respect to every weight and the input, within ``UNIT_TOL``; then
    two single decode steps from the state of a 32-token prefill;
  * reduced xlstm-125m and zamba2-2.7b (5 and 4+2 blocks): the forward,
    the loss and its gradients (``MODEL_TOL``), ``prefill`` of 16 tokens
    and 4 ``decode_step``s, with the caches in bf16 (the reference's
    default ``cache_dtype``; zamba2's within ``CACHE_BF16_TOL``) and, for
    zamba2, in float32;
  * the reference's fault of the fixed-batch path that zamba2's shared
    attention meets (ROADMAP.md section C): its prefill leaves each
    full-attention cache exactly T long, so the first decode step's
    ``dynamic_update_slice`` clamps position T's K/V into slot T-1.  The
    port's decode equals the reference's clamped one, and the same decode
    from caches zero-padded by 8 slots equals ``forward`` within 1e-5;
  * ``launch.serve.run_fixed_batch``'s greedy tokens equal those of the
    reference's loop (and its printed sample ids the reference's
    ``run_fixed_batch``'s);
  * two train steps at p = 2 and 4 (``pallas_fused``, 64 KiB buckets),
    loss and grad norm rtol 1e-4 (step 2's grad norm from the reference's
    own step-1 state; the port's step within 5e-3), the state after the
    first step within
    ``tests/test_torch_tp.py``'s ``BOUNDS`` (with ``test_torch_moe.py``'s
    allowance for gradients of the order of AdamW's eps), ``bine``
    bitwise ``pallas_fused``; the bucket plan and report equal the reference's
    (bf16 configs, full width and reduced: Mamba2's float32 ``A_log``,
    ``D`` and ``dt_bias`` in float32 buckets beside the bf16 ones);
  * every full-width leaf's shape and dtype against
    ``jax.eval_shape(init_params)``, and the parameter counts.

Over TP ranks (since item 5f), the forward, the loss, the TP prefill,
the train step and both CLIs run these configs and agree with one rank
(their tests against the reference: ``tests/test_torch_ssm_tp.py``,
``tests/test_torch_ssm_tp_steps.py``, ``tests/test_torch_fixed_batch_tp.py``).
"""

import contextlib
import io
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro_torch import tree as TR
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy, train_state_to_numpy
from repro_torch.models import sharding as SH
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import (TrainConfig, bucket_report,
                                    make_init_fns, make_train_step)
from test_torch_tp import BOUNDS, _mostly_close
from torch_threads import pin_threads, subproc  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False



ARCHS = ["xlstm-125m", "zamba2-2.7b"]
#: full-size parameter counts (the port's and the reference's)
N_PARAMS = {"xlstm-125m": 95_402_496, "zamba2-2.7b": 2_340_466_848}
#: the blocks: (kind, the arch whose reduced config sizes it)
UNITS = (("mamba2", "zamba2-2.7b"), ("mlstm", "xlstm-125m"),
         ("slstm", "xlstm-125m"))
B_UNIT, T_UNIT, T_PRE = 2, 48, 32
#: float32 block outputs, states and gradients (rtol, atol; the atol
#: scaled by the array's largest |value| where that is above 1, see
#: ``_close``)
UNIT_TOL = (1e-4, 1e-5)
#: float32 models: logits, loss and gradients (rtol, atol as UNIT_TOL's)
MODEL_TOL = (1e-4, 1e-5)
#: logits after a prefill into bf16 caches: a cache entry one bf16 ulp
#: apart (a rounding flip of nearly equal float32 values) moves a logit
#: by ~1e-3 of its 0.3-0.6 scale
CACHE_BF16_TOL = (0, 5e-3)
T_MODEL, T_PROMPT, N_DECODE = 32, 16, 4
#: the fixed-batch loop: batch, prompt length (T_PROMPT: the loop's
#: compiled prefill serves the decode tests too), new tokens, seed
FIXED = (B_UNIT, T_PROMPT, 6, 3)
STEPS = 2
LR = 3e-3
#: the port's step-2 grad norm against the reference's (see
#: ``test_train_steps_match_jax``): xlstm read 1.7e-3
STEP2_GNORM_RTOL = 5e-3
#: train runs: tag -> (arch, DP ranks)
RUNS = {"zamba2_2": ("zamba2-2.7b", 2), "zamba2_4": ("zamba2-2.7b", 4),
        "xlstm_2": ("xlstm-125m", 2), "xlstm_4": ("xlstm-125m", 4)}
#: the JAX train subprocesses, run at once: (devices, runs)
STEP_GROUPS = ((4, ("zamba2_2", "xlstm_4")), (4, ("zamba2_4", "xlstm_2")))

PRELUDE = r"""
import os
os.environ["REPRO_OBS"] = "0"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import base

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

def red(arch, **kw):
    return base.reduced(base.get_config(arch)).replace(dtype="float32", **kw)

out = {{}}
"""

FWD_CODE = PRELUDE + r"""
import contextlib, io
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.models import ssm as S, transformer as T

rng = np.random.default_rng(0)
B, TU, TP = {b!r}, {tu!r}, {tp!r}
for i, (kind, arch) in enumerate({units!r}):
    cfg = red(arch)
    p = getattr(S, "init_" + kind)(jax.random.key(i), cfg)
    fn = getattr(S, kind)
    x = jnp.asarray(rng.standard_normal((B, TU, cfg.d_model)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((B, TU, cfg.d_model)), jnp.float32)

    def obj(p, x):
        y, st = fn(p, cfg, x, return_state=True)
        return jnp.sum(y * w), (y, st)

    (_, (y, st)), (gp, gx) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(p, x)
    out[kind + "_x"], out[kind + "_w"] = f32(x), f32(w)
    out[kind + "_y"], out[kind + "_gx"] = f32(y), f32(gx)
    for k in p:
        out[f"{{kind}}_p_{{k}}"] = f32(p[k])
        out[f"{{kind}}_gp_{{k}}"] = f32(gp[k])
    for j, leaf in enumerate(jax.tree.leaves(st)):
        out[f"{{kind}}_st_{{j}}"] = f32(leaf)
    _, st = jax.jit(lambda p, x: fn(p, cfg, x, return_state=True))(
        p, x[:, :TP])
    step = jax.jit(lambda p, x, st: fn(p, cfg, x, state=st,
                                       return_state=True))
    for s in range(2):
        y1, st = step(p, x[:, TP + s:TP + s + 1], st)
        out[f"{{kind}}_dec{{s}}"] = f32(y1)
        for j, leaf in enumerate(jax.tree.leaves(st)):
            out[f"{{kind}}_dec{{s}}_st_{{j}}"] = f32(leaf)

TM, TPR, ND = {tm!r}, {tpr!r}, {nd!r}
Bf, Lf, NEW, SEED = {fixed!r}
from repro.launch.serve import run_fixed_batch
from repro.serve.engine import ServeConfig, make_serve_fns
mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def decode_run(tag, prefill, decode, params, toks):
    with set_mesh(mesh):
        lg, st = prefill(params, jnp.asarray(toks[:, :TPR]))
        out[tag + "_prefill"] = f32(lg)
        for s in range(ND):
            lg, st = decode(params, st,
                            jnp.asarray(toks[:, TPR + s:TPR + s + 1]))
            out[f"{{tag}}_decode_{{s}}"] = f32(lg)


for arch in {archs!r}:
    cfg = red(arch)                      # caches in bf16 (the default)
    init = jax.jit(lambda k: T.init_params(k, cfg))
    params = init(jax.random.key(1))
    toks = rng.integers(0, cfg.vocab_size, (B, TM)).astype(np.int32)
    out[arch + "_tokens"] = toks
    for j, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{{arch}}_param_{{j}}"] = f32(leaf)
    batch = {{"inputs": jnp.asarray(toks),
             "targets": jnp.asarray(np.roll(toks, -1, 1))}}

    def loss_logits(p):
        (loss, _), g = jax.value_and_grad(
            lambda p: T.loss_fn(p, cfg, batch), has_aux=True)(p)
        return loss, g, T.forward(p, cfg, batch["inputs"])[0]

    loss, g, logits = jax.jit(loss_logits)(params)
    out[arch + "_loss"], out[arch + "_logits"] = f32(loss), f32(logits)
    for j, leaf in enumerate(jax.tree.leaves(g)):
        out[f"{{arch}}_grad_{{j}}"] = f32(leaf)
    # the serve fns' prefill / decode (the fixed-batch loop's, compiled
    # once for [Bf, Lf] prompts)
    fns = make_serve_fns(cfg, ServeConfig(), mesh, Bf, Lf + NEW)
    decode_run(arch + "_bfloat16", fns.prefill, fns.decode, params, toks)
    if arch == "zamba2-2.7b":            # float32 caches: the fault test
        c32 = red(arch, cache_dtype="float32")
        decode_run(arch + "_float32",
                   jax.jit(lambda p, t: T.prefill(p, c32, t)),
                   jax.jit(lambda p, s, t: T.decode_step(p, c32, s, t)),
                   params, toks)
    # the fixed-batch loop: its tokens, then run_fixed_batch's own lines
    fparams = init(jax.random.key(2))
    for j, leaf in enumerate(jax.tree.leaves(fparams)):
        out[f"{{arch}}_fixed_param_{{j}}"] = f32(leaf)
    r = np.random.RandomState(SEED)
    prompt = jnp.asarray(r.randint(0, cfg.vocab_size, size=(Bf, Lf)),
                         jnp.int32)
    with set_mesh(mesh):
        lg, st = fns.prefill(fparams, prompt)
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(nxt)]
        for _ in range(NEW - 1):
            lg, st = fns.decode(fparams, st, nxt)
            nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            outs.append(np.asarray(nxt))
    out[arch + "_fixed_tokens"] = np.concatenate(outs, axis=1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_fixed_batch(cfg, fns, fparams, mesh, Bf, Lf, NEW, seed=SEED)
    line = [l for l in buf.getvalue().splitlines() if "sample token" in l]
    out[arch + "_fixed_line"] = np.asarray(line[0].split(":", 1)[1].strip())
np.savez({path!r}, **out)
print("JAX_OK")
"""

STEP_CODE = PRELUDE + r"""
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.models import transformer as T
from repro.optim.adamw import AdamWConfig
from repro.train.data import DataConfig, make_batch
from repro.train.step import TrainConfig, make_train_step, make_init_fns

for tag, (arch, n) in {runs!r}.items():
    cfg = red(arch)
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda k: T.init_params(k, cfg), key)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1),
                ("data", "model"))
    # its float32 backends give the same bits; bine compiles fastest
    tcfg = TrainConfig(backend="bine", bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr={lr!r}, warmup_steps=1,
                                         total_steps=100))
    step, sh, _ = make_train_step(cfg, tcfg, mesh, shapes)
    ip, is_ = make_init_fns(cfg, tcfg, mesh, shapes)
    with set_mesh(mesh):
        params = ip(key)
        state = is_(params)
        for i, x in enumerate(jax.tree.leaves(params)):
            out[f"{{tag}}_init_{{i}}"] = f32(x)
        for s in range({steps}):
            b = make_batch(dcfg, s)
            batch = {{k: jax.device_put(v, sh["batch"][k])
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


def _red(arch, **kw):
    return tbase.reduced(tbase.get_config(arch)).replace(dtype="float32",
                                                          **kw)


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_ssm")
    jobs = [(FWD_CODE.format(b=B_UNIT, tu=T_UNIT, tp=T_PRE, units=UNITS,
                             archs=ARCHS, tm=T_MODEL, tpr=T_PROMPT,
                             nd=N_DECODE, fixed=FIXED,
                             path=str(tmp / "fwd.npz")), 1)]
    for i, (dev, tags) in enumerate(STEP_GROUPS):
        jobs.append((STEP_CODE.format(runs={t: RUNS[t] for t in tags},
                                      lr=LR, steps=STEPS,
                                      path=str(tmp / f"step{i}.npz")), dev))
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(subproc, code, dev, 600) for code, dev in jobs]:
            f.result()
    out = dict(np.load(tmp / "fwd.npz"))
    for i in range(len(STEP_GROUPS)):
        out.update(np.load(tmp / f"step{i}.npz"))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, exp, tol, what):
    """Within ``rtol`` of each value plus ``atol`` times the array's
    largest |value| (float32 sums in another order)."""
    rtol, atol = tol
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), exp,
                               rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(exp).max())),
                               err_msg=what)


def _model_params(out, prefix, cfg):
    shapes = TF.param_shapes(cfg)
    n = len(TR.flatten(shapes))
    return params_from_numpy(TR.unflatten(shapes, [out[f"{prefix}{i}"]
                                                   for i in range(n)]),
                             cfg, "cpu")


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

def _unit(out, kind):
    p = {k[len(f"{kind}_p_"):]: _t(v) for k, v in out.items()
         if k.startswith(f"{kind}_p_")}
    return p, _t(out[kind + "_x"]), _t(out[kind + "_w"])


@pytest.mark.parametrize("kind,arch", UNITS, ids=[u[0] for u in UNITS])
def test_block_forward_states_grads_match_jax(jax_out, kind, arch):
    """Each block over 3 chunks (48 steps): output, final states and the
    gradients of ``sum(out * w)`` w.r.t. every weight and the input."""
    cfg = _red(arch)
    p, x, w = _unit(jax_out, kind)
    fn = getattr(S, kind)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xi = x.clone().requires_grad_(True)
    y, st = fn(leaves, cfg, xi, return_state=True)
    _close(y, jax_out[kind + "_y"], UNIT_TOL, f"{kind} out")
    for j, leaf in enumerate(TR.flatten(st)):
        _close(leaf, jax_out[f"{kind}_st_{j}"], UNIT_TOL, f"{kind} state {j}")
    names = sorted(leaves)
    grads = torch.autograd.grad(fn(leaves, cfg, xi).mul(w).sum(),
                                [leaves[k] for k in names] + [xi])
    for k, g in zip(names + ["x"], grads):
        exp = jax_out[f"{kind}_gx"] if k == "x" else jax_out[f"{kind}_gp_{k}"]
        assert torch.isfinite(g).all(), (kind, k)
        _close(g, exp, UNIT_TOL, f"{kind} grad {k}")


@pytest.mark.parametrize("kind,arch", UNITS, ids=[u[0] for u in UNITS])
def test_block_decode_from_prefill_matches_jax(jax_out, kind, arch):
    """Two single steps from the state a 32-token prefill leaves: the
    outputs and every state leaf."""
    cfg = _red(arch)
    p, x, _ = _unit(jax_out, kind)
    fn = getattr(S, kind)
    with torch.no_grad():
        _, st = fn(p, cfg, x[:, :T_PRE], return_state=True)
        for s in range(2):
            y1, st = fn(p, cfg, x[:, T_PRE + s:T_PRE + s + 1], state=st,
                        return_state=True)
            _close(y1, jax_out[f"{kind}_dec{s}"], UNIT_TOL, f"{kind} dec{s}")
            for j, leaf in enumerate(TR.flatten(st)):
                _close(leaf, jax_out[f"{kind}_dec{s}_st_{j}"], UNIT_TOL,
                       f"{kind} dec{s} state {j}")


def test_tie_gradients_split_like_jax():
    """At ties ``jnp.maximum`` splits the gradient evenly; so do
    ``torch.maximum`` and ``torch.amax``, which the blocks use (sLSTM's
    normaliser is exactly 1 after its first step: the tie is met)."""
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    b = torch.tensor([1.0, 1.0], requires_grad=True)
    ga, gb = torch.autograd.grad(torch.maximum(a, b).sum(), [a, b])
    assert ga.tolist() == [0.5, 1.0] and gb.tolist() == [0.5, 0.0]
    m = torch.tensor([[3.0, 3.0, 1.0]], requires_grad=True)
    (g,) = torch.autograd.grad(torch.amax(m, dim=1).sum(), [m])
    assert g.tolist() == [[0.5, 0.5, 0.0]]


def test_full_length_mamba2_gradients_finite():
    """At zamba2's chunk of 128 a chunk's decays pass exp's float32 range
    (cum_i - cum_j ~ 100 above the diagonal): masking before ``exp``
    keeps every gradient finite."""
    cfg = tbase.get_config("zamba2-2.7b").replace(
        d_model=64, ssm_head_dim=16, ssm_state=8, dtype="float32")
    gen = torch.Generator().manual_seed(0)

    def make(shape, init, dtype=None):
        if init[0] in ("zeros", "ones"):
            return (torch.zeros if init[0] == "zeros" else torch.ones)(shape)
        return torch.randn(shape, generator=gen) * init[1]

    p = {k: v.requires_grad_(True) for k, v in S.init_mamba2(cfg,
                                                           make).items()}
    p["dt_bias"] = torch.full((8,), 3.0, requires_grad=True)  # dt ~ 3
    x = torch.randn((1, 128, 64), generator=gen)
    grads = torch.autograd.grad(S.mamba2(p, cfg, x).square().sum(),
                                list(p.values()))
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# The models: forward, loss, gradients, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_forward_loss_grads_match_jax(jax_out, arch):
    cfg = _red(arch)
    params = _model_params(jax_out, f"{arch}_param_", cfg)
    toks = _t(jax_out[f"{arch}_tokens"])
    batch = {"inputs": toks, "targets": torch.roll(toks, -1, 1)}
    logits, _ = TF.forward(params, cfg, toks)
    _close(logits, jax_out[arch + "_logits"], MODEL_TOL, "logits")
    leaves = [x.requires_grad_(True) for x in TR.flatten(params)]
    loss, _ = TF.loss_fn(TR.unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax_out[arch + "_loss"]), rtol=1e-5)
    for i, g in enumerate(grads):
        _close(g, jax_out[f"{arch}_grad_{i}"], MODEL_TOL, f"grad {i}")


@pytest.mark.parametrize("arch,cdt", [("xlstm-125m", "bfloat16"),
                                      ("zamba2-2.7b", "bfloat16"),
                                      ("zamba2-2.7b", "float32")])
def test_model_prefill_decode_match_jax(jax_out, arch, cdt):
    """``prefill`` of 16 tokens and 4 ``decode_step``s (zamba2's shared
    attention with the reference's clamped first write: the same
    function), with the reference's default bf16 ``cache_dtype`` (the
    reference's side through its serve fns, the fixed-batch loop's) and,
    for zamba2, float32 caches.  xlstm's states are float32 whatever the
    cache dtype, so it is held to MODEL_TOL; zamba2's bf16 K/V and conv
    state to CACHE_BF16_TOL."""
    cfg = _red(arch, cache_dtype=cdt)
    params = _model_params(jax_out, f"{arch}_param_", cfg)
    tag = f"{arch}_{cdt}"
    toks = _t(jax_out[arch + "_tokens"])
    tol = CACHE_BF16_TOL if tag == "zamba2-2.7b_bfloat16" else MODEL_TOL
    with torch.no_grad():
        lg, st = TF.prefill(params, cfg, toks[:, :T_PROMPT])
        _close(lg, jax_out[tag + "_prefill"], MODEL_TOL, "prefill")
        for s in range(N_DECODE):
            lg, st = TF.decode_step(params, cfg, st,
                                    toks[:, T_PROMPT + s:T_PROMPT + s + 1])
            _close(lg, jax_out[f"{tag}_decode_{s}"], tol, f"decode {s}")
    assert int(st["pos"]) == T_PROMPT + N_DECODE


def test_reference_fault_clamped_first_decode_write(jax_out):
    """The fault (ROADMAP.md section C): after ``prefill`` of T tokens a
    full-attention cache holds exactly T slots, and the first decode
    step's write of position T lands in slot T-1 (the reference's
    ``dynamic_update_slice`` clamps it; the port's scalar path clamps
    alike).  The reference's decode then differs from its forward; the
    port's equals the reference's (``test_model_prefill_decode_match_jax``
    holds every step within MODEL_TOL, here the first) and, from caches
    zero-padded by 8 slots, equals ``forward`` within 1e-5."""
    arch = "zamba2-2.7b"
    cfg = _red(arch, cache_dtype="float32")
    tag = f"{arch}_float32"
    fwd = jax_out[arch + "_logits"]
    ref0 = jax_out[tag + "_decode_0"][:, 0]
    assert np.abs(ref0 - fwd[:, T_PROMPT]).max() > 1e-2     # the fault
    params = _model_params(jax_out, f"{arch}_param_", cfg)
    toks = _t(jax_out[arch + "_tokens"])
    with torch.no_grad():
        _, st = TF.prefill(params, cfg, toks[:, :T_PROMPT])
        lg, _ = TF.decode_step(params, cfg, st,
                               toks[:, T_PROMPT:T_PROMPT + 1])
        _close(lg[:, 0], ref0, MODEL_TOL, "clamped decode")
        _, st = TF.prefill(params, cfg, toks[:, :T_PROMPT])
        for (block, _), seg in zip(TF.segments(cfg), st["segments"]):
            if block.kind == "shared_attn":
                for k in ("k", "v"):
                    seg[k] = torch.nn.functional.pad(seg[k],
                                                     (0, 0, 0, 0, 0, 8))
        for s in range(N_DECODE):
            lg, st = TF.decode_step(params, cfg, st,
                                    toks[:, T_PROMPT + s:T_PROMPT + s + 1])
            np.testing.assert_allclose(lg[:, 0].numpy(),
                                       fwd[:, T_PROMPT + s], rtol=0,
                                       atol=1e-5, err_msg=f"padded {s}")


@pytest.mark.parametrize("arch", ARCHS)
def test_run_fixed_batch_tokens_match_jax(jax_out, arch, capsys):
    from repro_torch.launch.serve import run_fixed_batch
    cfg = _red(arch)
    params = _model_params(jax_out, f"{arch}_fixed_param_", cfg)
    Bf, Lf, new, seed = FIXED
    toks, nums = run_fixed_batch(cfg, params, Bf, Lf, new, seed=seed,
                                 device="cpu")
    np.testing.assert_array_equal(toks, jax_out[arch + "_fixed_tokens"])
    line = [l for l in capsys.readouterr().out.splitlines()
            if "sample token ids" in l]
    assert line[0].split(":", 1)[1].strip() == \
        str(jax_out[arch + "_fixed_line"])
    assert nums["decode_tokens_per_s"] > 0


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def _tcfg(backend, wire="float32"):
    return TrainConfig(backend=backend, wire_dtype=wire, bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr=LR, warmup_steps=1,
                                         total_steps=100))


def _run(jax_out, tag, backend):
    """The port's run of ``RUNS[tag]`` from JAX's initial params: (the
    metrics of each step, the global numpy state after step 1, rank 0's
    params after the last step)."""
    arch, n = RUNS[tag]
    cfg, tcfg = _red(arch), _tcfg(backend)
    shapes = TF.param_shapes(cfg)
    init = TR.unflatten(shapes, [jax_out[f"{tag}_init_{i}"] for i in
                                 range(len(TR.flatten(shapes)))])
    step, info, _ = make_train_step(cfg, tcfg, n, shapes, "cpu")
    assert info["bucket_plan"] is not None
    one = params_from_numpy(init, cfg, "cpu")
    params = [TR.tree_map(torch.clone, one) for _ in range(n)]
    state = make_init_fns(cfg, tcfg, n, "cpu")[1](params)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    metrics, glob = [], None
    for s in range(STEPS):
        params, state, m = step(params, state, make_batch(dcfg, s))
        metrics.append(m)
        if s == 0:
            glob = train_state_to_numpy(cfg, tcfg, params, state, n)
    return metrics, glob, TR.flatten(params[0])


def _check_state(glob, jax_out, tag):
    """The global state after step 1 within BOUNDS, with the allowance
    ``tests/test_torch_moe.py`` states: a weight whose step-1 gradient is
    of the order of AdamW's eps (below 100 eps, by the port's m) takes a
    first update ``lr g / (|g| + eps)`` that float32 rounding of g moves
    by a large share of itself, so its param and master are held to one
    AdamW step, lr, in place of the loose bound; they still count toward
    the 0.1% past the tight bound."""
    pairs = {"param": [(x, jax_out[f"{tag}_param_{i}"])
                       for i, x in enumerate(TR.flatten(glob["params"]))],
             "master": [], "m": [], "v": []}
    i = 0
    opt = TR.flatten_up_to(glob["params"], glob["state"]["opt"])
    for st in opt:
        for k in sorted(st):              # m, master, v: the JAX leaf order
            pairs[k].append((st[k], jax_out[f"{tag}_opt_{i}"]))
            i += 1
    adamw = _tcfg("pallas_fused").adamw
    tiny = [np.abs(st["m"]) / (1 - adamw.b1) < 100 * adamw.eps for st in opt]
    for k, (tight, loose) in BOUNDS.items():
        if k not in pairs:
            continue
        if k not in ("param", "master"):
            _mostly_close(pairs[k], tight, loose, f"{tag} {k}")
            continue
        n = n_out = 0
        for (got, exp), t in zip(pairs[k], tiny):
            d = np.abs(got.astype(np.float64) - exp)
            assert d[~t].max(initial=0.0) <= loose, (tag, k, float(d.max()))
            assert d[t].max(initial=0.0) <= max(loose, LR), (tag, k)
            n += d.size
            n_out += int((d > tight).sum())
        assert n_out <= 1e-3 * n, (tag, k, n_out, n)


@pytest.mark.parametrize("tag", list(RUNS))
def test_train_steps_match_jax(jax_out, tag):
    """Two pallas_fused steps against the reference's (the losses and
    step 1's grad norm rtol 1e-4, the state after step 1 within BOUNDS,
    see ``_check_state``; step 2's grad norm as stated below), then a
    bine run bitwise the pallas_fused one; the shared block's tied
    gradient sums over its firings (autograd's sum for a reused leaf)."""
    metrics, glob, last = _run(jax_out, tag, "pallas_fused")
    for s, m in enumerate(metrics):
        for k in ("loss", "grad_norm"):
            if (s, k) == (1, "grad_norm"):
                continue
            np.testing.assert_allclose(float(m[k]),
                                       jax_out[f"{tag}_{k}_{s}"], rtol=1e-4,
                                       err_msg=f"{tag} step {s} {k}")
    _check_state(glob, jax_out, tag)
    # step 2's grad norm: from the reference's own state after step 1
    # within rtol 1e-4; the port's step within STEP2_GNORM_RTOL, since the
    # few weights of _check_state's allowance enter step 2 up to 2 lr
    # apart and the exponential gates amplify that (xlstm: 1.7e-3)
    arch, n = RUNS[tag]
    cfg = _red(arch)
    shapes = TF.param_shapes(cfg)
    at = params_from_numpy(TR.unflatten(shapes, [
        jax_out[f"{tag}_param_{i}"] for i in range(len(TR.flatten(shapes)))]),
        cfg, "cpu")
    batch = make_batch(DataConfig(global_batch=8, seq_len=64,
                                  vocab_size=cfg.vocab_size), 1)
    grads = None
    for r in range(n):
        leaves = [x.clone().requires_grad_(True) for x in TR.flatten(at)]
        shard = {k: torch.as_tensor(v).chunk(n)[r] for k, v in batch.items()}
        loss, _ = TF.loss_fn(TR.unflatten(at, leaves), cfg, shard)
        g = torch.autograd.grad(loss, leaves)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    gnorm = float(torch.sqrt(sum((g / n).square().sum() for g in grads)))
    exp = float(jax_out[f"{tag}_grad_norm_1"])
    np.testing.assert_allclose(gnorm, exp, rtol=1e-4, err_msg=tag)
    np.testing.assert_allclose(float(metrics[1]["grad_norm"]), exp,
                               rtol=STEP2_GNORM_RTOL, err_msg=tag)
    _, _, blast = _run(jax_out, tag, "bine")
    assert all(torch.equal(a, b) for a, b in zip(blast, last)), tag


@pytest.mark.parametrize("n_dp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_plan_and_report_match_jax(arch, n_dp):
    """bf16 configs, full width and reduced, float32 and int8 wires: the
    plan (slots, zero dims, offsets, dtypes) and the report equal the
    reference's; zamba2's float32 leaves ride float32 buckets where they
    shard (n_dp = 2; at 4 they are replicated, as the reference's)."""
    from repro.train import step as jstep
    from repro.train import zero as jzero
    for red in (False, True):
        jc, tc = jbase.get_config(arch), tbase.get_config(arch)
        if red:
            jc, tc = jbase.reduced(jc), tbase.reduced(tc)
        js = jax.eval_shape(lambda k: JT.init_params(k, jc),
                            jax.random.key(0))
        for wire in ("float32", "int8"):
            kw = dict(backend="auto", wire_dtype=wire)
            jt = jstep.TrainConfig(**kw)
            jplan = jstep.resolve_bucket_plan(
                jt, n_dp, js, jzero.zero_layout(jc, js, n_dp))
            tt = TrainConfig(**kw)
            info = make_train_step(tc, tt, n_dp, TF.param_shapes(tc),
                                   "cpu")[1]
            plan = info["bucket_plan"]
            assert bucket_report(tt, plan) == jstep.bucket_report(jt, jplan)
            assert [(b.dtype, [(s.index, s.zero_dim, s.offset)
                               for s in b.slots]) for b in plan.buckets] == \
                [(b.dtype, [(s.index, s.zero_dim, s.offset)
                            for s in b.slots]) for b in jplan.buckets]
            # A_log/D/dt_bias [L, nh]: the layer dim (6 at full width, 2
            # reduced) shards at n_dp = 2, in float32 buckets
            dts = {b.dtype for b in plan.buckets}
            assert dts == ({"bfloat16", "float32"} if
                           (arch, n_dp) == ("zamba2-2.7b", 2)
                           else {"bfloat16"}), dts


# ---------------------------------------------------------------------------
# Configs, shapes, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_and_full_width_shapes_match(arch):
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in t.__dataclass_fields__}
    assert tbase.reduced(t).__dict__ == jbase.reduced(j).__dict__
    js = jax.eval_shape(lambda k: JT.init_params(k, j), jax.random.key(0))
    jl = jax.tree_util.tree_flatten_with_path(js)[0]
    tl = TR.flatten_with_path(TF.param_shapes(t))
    assert len(jl) == len(tl)
    for (jp, jx), (tp, tx) in zip(jl, tl):
        assert jax.tree_util.keystr(jp) == TR.keystr(tp)
        assert tuple(jx.shape) == tuple(tx.shape), TR.keystr(tp)
        assert jx.dtype.name == str(tx.dtype).replace("torch.", ""), \
            TR.keystr(tp)
    assert TF.param_count(TF.param_shapes(t)) == N_PARAMS[arch] == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(js))
    assert [b.kind for b in TF.layer_pattern(t)] == \
        [b.kind for b in JT.layer_pattern(j)]


def test_init_params_keeps_the_float32_leaves():
    cfg = tbase.reduced(tbase.get_config("zamba2-2.7b"))
    p = TF.init_params(cfg, 0, "cpu")
    m = p["segments"][0]["mamba"]
    assert cfg.dtype == "bfloat16" and m["m_z"].dtype == torch.bfloat16
    for k, fill in (("A_log", 0.0), ("D", 1.0), ("dt_bias", 0.0)):
        assert m[k].dtype == torch.float32 and bool((m[k] == fill).all())
    assert p["segments"][1] == {} and "shared" in p


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallelism_raises_naming_5f(arch, capsys):
    """Named for the refusal it pinned until item 5f was ported: the same
    calls over 2 TP ranks now run and agree with one rank (float32,
    pure_sp at these widths): the forward's logits and the loss within
    2e-5 of max |logit| and rtol 1e-5, the TP prefill's logits and its
    state (float32 caches), one train step's loss at (2, 2) against (2,
    1), and the CLIs' sample tokens and first loss against one rank's."""
    cfg = _red(arch)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 16))).to(torch.int32)
    params = TF.init_params(cfg, 0, "cpu")
    sp = SH.shard_params(cfg, params, 2)
    batch = {"inputs": toks, "targets": toks}
    with torch.no_grad():
        ref, _ = TF.forward(params, cfg, toks)
        got, _ = TF.forward(sp, cfg, toks, n_model=2)
        got = torch.cat(list(got), dim=-1)[..., :cfg.vocab_size]
        assert float((got - ref).abs().max()) <= 2e-5 * float(
            ref.abs().max())
        loss1, _ = TF.loss_fn(params, cfg, batch)
        loss2, _ = TF.loss_fn(sp, cfg, batch, n_model=2)
        np.testing.assert_allclose(loss2.numpy(), float(loss1), rtol=1e-5)
        c32 = cfg.replace(cache_dtype="float32")    # no bf16 rounding flip
        lg1, st1 = TF.prefill(params, c32, toks)
        blocks, st2 = TF.prefill_tp(params, c32, toks, 2)
        _close(TF.vocab_logits(blocks, cfg.vocab_size), lg1.numpy(),
               MODEL_TOL, "prefill_tp")
        for a, b in zip(TR.flatten(st2), TR.flatten(st1)):
            _close(a, b.to(torch.float32).numpy(), MODEL_TOL,
                   "prefill_tp state")
    losses = {}
    dcfg = DataConfig(global_batch=4, seq_len=16, vocab_size=cfg.vocab_size)
    for tp in (1, 2):
        step, _, _ = make_train_step(cfg, _tcfg("bine"), 2,
                                     TF.param_shapes(cfg), "cpu", tp=tp)
        ip, is_ = make_init_fns(cfg, _tcfg("bine"), 2, "cpu", tp=tp)
        p = ip(0)
        losses[tp] = float(step(p, is_(p), make_batch(dcfg, 0))[2]["loss"])
    np.testing.assert_allclose(losses[2], losses[1], rtol=1e-5)
    from repro_torch.launch import serve, train
    outs = {}
    for mesh in ("1,1", "1,2"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--mesh", mesh, "--slots", "2", "--prompt-len-max",
                    "16", "--max-new", "3"])
        outs[mesh] = [l for l in capsys.readouterr().out.splitlines()
                      if "sample token ids" in l]
    assert outs["1,2"] == outs["1,1"] and outs["1,1"]
    for mesh in ("2,1", "2,2"):
        train.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--mesh", mesh, "--steps", "1", "--batch", "4", "--seq",
                    "16", "--log-every", "1"])
        outs[mesh] = [l.split()[3] for l in capsys.readouterr().out
                      .splitlines() if l.startswith("step     0")]
    assert outs["2,2"] == outs["2,1"] and outs["2,1"]


def test_padded_prefill_raises_for_recurrent_blocks():
    cfg = _red("xlstm-125m")
    params = TF.init_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="padding"):
        TF.prefill(params, cfg, torch.zeros((1, 16), dtype=torch.int32),
                   length=8)


def test_serve_cli_runs_the_fixed_batch_loop(capsys):
    """The serve CLI sends the recurrent configs to the fixed-batch loop
    (the pool refuses them, as the reference's does); MoE goes there too
    since item 5e, and over a model axis since item 5g (a data axis above
    1 raises: the loop runs one DP rank)."""
    from repro_torch.launch import serve
    from repro_torch.serve import engine as E
    for arch in ARCHS:
        assert not E.pool_supported(tbase.get_config(arch))
    serve.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                "--slots", "2", "--prompt-len-max", "32", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "legacy fixed-batch loop" in out and "sample token ids" in out
    serve.main(["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu",
                "--mesh", "1,2", "--slots", "2", "--prompt-len-max", "32",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "legacy fixed-batch loop over 2 TP ranks" in out
    assert "sample token ids" in out
    with pytest.raises(ValueError, match="one DP rank"):
        serve.main(["--arch", "mixtral-8x7b", "--reduced", "--device",
                    "cpu", "--mesh", "2,2"])
