"""The frontend configs (musicgen-medium, pixtral-12b) on the port, against
the JAX package, on the CPU.

The reference's frontend is a stub: float ``[B, T, frontend_dim]`` frames
enter through a trainable ``frontend_proj``, int tokens through
``embed``.  Float32 frames times a bf16 model's weights promote to
float32 (``jnp.einsum``), so such a model runs its stream, Q/K/V and
logits in float32; the port's ``layers.dense`` promotes alike.

The JAX side runs in three subprocesses at once (one CPU device for the
models and the fixed-batch loop; two of 4 for the train steps) and hands
its outputs over as ``.npz`` files; weights cross through ``interop``,
inputs are numpy arrays from a seed.  Held against ``repro``, on reduced
pixtral-12b and musicgen-medium (frontend_dim 16):

  * the config copies field for field, the registry whole, every
    full-width leaf's shape, dtype and place in the flatten order;
  * the forward's logits, the loss and every gradient on frames in
    float32 (``F32_TOL``), on frames with bf16 params (float32 logits,
    as the reference's; ``BF16_PARAM_TOL``) and on tokens (float32,
    ``TOKENS_TOL``);
  * ``prefill`` of 16 frames and 4 ``decode_step``s on frames, with
    float32 caches (``F32_TOL``) and the reference's default bf16 ones
    (``CACHE_BF16_TOL``), every norm handing the fused RMSNorm its gain in
    the stream's dtype (the card's kernel takes one dtype);
  * ``launch.serve.run_fixed_batch``'s greedy tokens on random frames
    equal the reference's loop's (and its printed sample ids the
    reference's ``run_fixed_batch``'s), float32;
  * two train steps at p = 2 with tp = 1 (pixtral, GQA) and tp = 2
    (musicgen pure_sp, and musicgen at d_model 1024: megatron_sp, the
    replicated ``frontend_proj`` projecting each TP rank's sequence
    shard), ``pallas_fused``, 64 KiB buckets: loss and grad norm rtol
    1e-4, the state after step 2 within ``tests/test_torch_tp.py``'s
    ``BOUNDS``; the bucket plan and report equal the reference's;
  * the pool refuses frontends; ``prefill_tp``, ``decode_step_tp`` and
    the serve CLI with a model axis serve them (since item 5g: against the
    reference in tests/test_torch_fixed_batch_tp.py) and agree with one
    rank; a data axis above 1 in the fixed-batch loop raises.
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
from repro_torch.kernels.rmsnorm import ops as RO
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import (TrainConfig, bucket_report,
                                    make_init_fns, make_train_step)
from test_torch_tp import BOUNDS, _mostly_close

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["pixtral-12b", "musicgen-medium"]
#: full-size parameter counts (the port's and the reference's)
N_PARAMS = {"pixtral-12b": 12_777_313_280, "musicgen-medium": 1_818_576_384}
B, T_MODEL, T_PROMPT, N_DECODE = 2, 32, 16, 4
#: float32 logits, loss and gradients (rtol; atol times the array's
#: largest |value| where that is above 1, see ``_close``)
F32_TOL = (1e-5, 1e-6)
#: bf16 params fed float32 frames: the logits are float32 (as the
#: reference's) and run in float32 on both sides, so they agree as
#: float32 sums do (F32_TOL); each bf16 gradient is the float32 one cast
#: once, so a cast of two float32 values either side of a rounding
#: boundary flips one bf16 ulp (2**-8 of the value)
BF16_PARAM_TOL = (2.0 ** -7, 1e-6)
#: token inputs, float32: the embedding's gradient sums each token's rows
#: in another order than the reference's scatter-add (one element of 16384
#: read 3.5e-5 relative, 2.1e-6 absolute), so tests/test_torch_ssm.py's
#: MODEL_TOL holds it
TOKENS_TOL = (1e-4, 1e-5)
#: logits after a prefill into bf16 caches: a cache entry one bf16 ulp
#: apart (a rounding flip of nearly equal float32 values) moves a logit
#: by ~1e-3 of its scale, as in tests/test_torch_ssm.py
CACHE_BF16_TOL = (0, 5e-3)
#: the fixed-batch loop: batch, prompt length, new tokens, seed
FIXED = (2, 16, 6, 3)
STEPS = 2
LR = 3e-3
#: train runs: tag -> (arch, config overrides, DP ranks, TP ranks); the
#: megatron_sp run takes musicgen to d_model 1024 (8 heads of 32)
RUNS = {"pixtral_tp1": ("pixtral-12b", {}, 2, 1),
        "musicgen_tp2": ("musicgen-medium", {}, 2, 2),
        "musicgen_mega_tp2": ("musicgen-medium",
                              {"d_model": 1024, "n_heads": 8,
                               "n_kv_heads": 8, "head_dim": 32,
                               "d_ff": 256}, 2, 2)}
#: the JAX train subprocesses, run at once: (devices, runs)
STEP_GROUPS = ((2, ("pixtral_tp1",)),
               (4, ("musicgen_tp2", "musicgen_mega_tp2")))

PRELUDE = r"""
import os
os.environ["REPRO_OBS"] = "0"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base
from repro.models import transformer as T

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

def red(arch, **kw):
    return base.reduced(base.get_config(arch)).replace(dtype="float32", **kw)

out = {{}}
"""

FWD_CODE = PRELUDE + r"""
import contextlib, io
rng = np.random.default_rng(0)
B, TM, TPR, ND = {b!r}, {tm!r}, {tpr!r}, {nd!r}
Bf, Lf, NEW, SEED = {fixed!r}
from repro.launch.serve import run_fixed_batch
from repro.serve.engine import ServeConfig, make_serve_fns
mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def grads_run(tag, cfg, params, batch):
    def loss_logits(p):
        (loss, _), g = jax.value_and_grad(
            lambda p: T.loss_fn(p, cfg, batch), has_aux=True)(p)
        return loss, g, T.forward(p, cfg, batch["inputs"])[0]

    loss, g, logits = jax.jit(loss_logits)(params)
    out[tag + "_loss"], out[tag + "_logits"] = f32(loss), f32(logits)
    out[tag + "_logits_dtype"] = np.asarray(str(logits.dtype))
    for j, leaf in enumerate(jax.tree.leaves(g)):
        out[f"{{tag}}_grad_{{j}}"] = f32(leaf)


for arch in {archs!r}:
    cfg = red(arch)
    F = cfg.frontend_dim
    params = jax.jit(lambda k: T.init_params(k, cfg))(jax.random.key(1))
    for j, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{{arch}}_param_{{j}}"] = f32(leaf)
    frames = rng.standard_normal((B, TM, F)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, TM)).astype(np.int32)
    out[arch + "_frames"], out[arch + "_tokens"] = frames, toks
    tgt = jnp.asarray(np.roll(toks, -1, 1))
    grads_run(arch + "_frames", cfg, params,
              {{"inputs": jnp.asarray(frames), "targets": tgt}})
    grads_run(arch + "_tokens", cfg, params,
              {{"inputs": jnp.asarray(toks), "targets": tgt}})
    # bf16 params (the config's own dtype) fed float32 frames
    c16 = base.reduced(base.get_config(arch))
    p16 = jax.jit(lambda k: T.init_params(k, c16))(jax.random.key(4))
    for j, leaf in enumerate(jax.tree.leaves(p16)):
        out[f"{{arch}}_p16_{{j}}"] = f32(leaf)
    grads_run(arch + "_bf16", c16, p16,
              {{"inputs": jnp.asarray(frames), "targets": tgt}})
    # prefill of TPR frames and ND decode steps on frames
    for cdt in ("float32", "bfloat16"):
        cc = red(arch, cache_dtype=cdt)
        lg, st = jax.jit(lambda p, x: T.prefill(p, cc, x))(
            params, jnp.asarray(frames[:, :TPR]))
        tag = f"{{arch}}_{{cdt}}"
        out[tag + "_prefill"] = f32(lg)
        dec = jax.jit(lambda p, s, x: T.decode_step(p, cc, s, x))
        for s in range(ND):
            lg, st = dec(params, st,
                         jnp.asarray(frames[:, TPR + s:TPR + s + 1]))
            out[f"{{tag}}_decode_{{s}}"] = f32(lg)
    # the fixed-batch loop: its tokens, then run_fixed_batch's own lines
    fparams = jax.jit(lambda k: T.init_params(k, cfg))(jax.random.key(2))
    for j, leaf in enumerate(jax.tree.leaves(fparams)):
        out[f"{{arch}}_fixed_param_{{j}}"] = f32(leaf)
    fns = make_serve_fns(cfg, ServeConfig(), mesh, Bf, Lf + NEW)
    r = np.random.RandomState(SEED)
    prompt = jnp.asarray(r.randn(Bf, Lf, F), jnp.float32)
    with set_mesh(mesh):
        lg, st = fns.prefill(fparams, prompt)
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(nxt)]
        for _ in range(NEW - 1):
            lg, st = fns.decode(fparams, st,
                                jnp.asarray(r.randn(Bf, 1, F), jnp.float32))
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
from repro.optim.adamw import AdamWConfig
from repro.train.data import DataConfig, make_batch
from repro.train.step import TrainConfig, make_train_step, make_init_fns

for tag, (arch, kw, dp, tp) in {runs!r}.items():
    cfg = red(arch, **kw)
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda k: T.init_params(k, cfg), key)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size,
                      frontend_dim=cfg.frontend_dim)
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
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
    tmp = tmp_path_factory.mktemp("jax_frontend")
    jobs = [(FWD_CODE.format(b=B, tm=T_MODEL, tpr=T_PROMPT, nd=N_DECODE,
                             fixed=FIXED, archs=ARCHS,
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


def _params(out, prefix, cfg):
    shapes = TF.param_shapes(cfg)
    n = len(TR.flatten(shapes))
    return params_from_numpy(TR.unflatten(shapes, [out[f"{prefix}{i}"]
                                                   for i in range(n)]),
                             cfg, "cpu")


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_and_full_width_shapes_match(arch):
    """The copies field for field (reduced too: frontend_dim 16); every
    full-width leaf's path, shape and dtype in the reference's flatten
    order, ``frontend_proj [frontend_dim, d_model]`` beside ``embed``; the
    parameter counts."""
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in j.__dataclass_fields__}
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
    assert tuple(TF.param_shapes(t)["frontend_proj"].shape) == \
        (t.frontend_dim, t.d_model)
    assert TF.param_count(TF.param_shapes(t)) == N_PARAMS[arch] == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(js))


def test_registry_holds_every_reference_config():
    """Every config of the reference is registered; an unknown name raises
    ``KeyError``, as the reference's ``get_config`` does."""
    tbase.get_config("phi4-mini-3.8b")        # loads the registry
    assert sorted(tbase._REGISTRY) == jbase.list_configs()
    for arch in ARCHS:
        assert tbase.get_config(arch).frontend is not None
    with pytest.raises(KeyError):
        tbase.get_config("no-such-arch")
    with pytest.raises(KeyError):
        jbase.get_config("no-such-arch")


def test_init_params_draws_frontend_proj():
    """``frontend_proj`` in the config's dtype, its std 1/sqrt(F)."""
    cfg = tbase.get_config("musicgen-medium").replace(n_layers=1)
    p = TF.init_params(cfg, 0, "cpu")
    w = p["frontend_proj"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (128, 1536)
    assert abs(float(w.float().std()) * np.sqrt(128) - 1.0) < 0.02
    assert "embed" in p and "lm_head" in p


# ---------------------------------------------------------------------------
# Forward, loss and gradients
# ---------------------------------------------------------------------------

#: (inputs, params) of each forward case
FWD_CASES = {"frames": ("frames", "param_"), "tokens": ("tokens", "param_"),
             "bf16": ("frames", "p16_")}


@pytest.mark.parametrize("case", list(FWD_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_match_jax(jax_out, arch, case):
    """Logits, loss and every gradient: frames on float32 params
    (F32_TOL), tokens too (their gradients within TOKENS_TOL); frames on
    bf16 params (float32 logits, as the reference's; bf16 gradients within
    BF16_PARAM_TOL)."""
    inp, prefix = FWD_CASES[case]
    cfg = tbase.reduced(tbase.get_config(arch)) if case == "bf16" \
        else _red(arch)
    params = _params(jax_out, f"{arch}_{prefix}", cfg)
    x = _t(jax_out[f"{arch}_{inp}"])
    toks = _t(jax_out[arch + "_tokens"])
    batch = {"inputs": x, "targets": torch.roll(toks, -1, 1)}
    tag = f"{arch}_{case}"
    logits, _ = TF.forward(params, cfg, x)
    assert str(logits.dtype).replace("torch.", "") == \
        str(jax_out[tag + "_logits_dtype"])
    assert logits.dtype == (torch.float32 if inp == "frames" or
                            cfg.dtype == "float32" else torch.bfloat16)
    _close(logits, jax_out[tag + "_logits"], F32_TOL, "logits")
    leaves = [v.requires_grad_(True) for v in TR.flatten(params)]
    loss, _ = TF.loss_fn(TR.unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax_out[tag + "_loss"]), rtol=1e-5)
    tol = {"bf16": BF16_PARAM_TOL, "tokens": TOKENS_TOL}.get(case, F32_TOL)
    for i, (g, v) in enumerate(zip(grads, leaves)):
        assert g.dtype == v.dtype, i
        _close(g, jax_out[f"{tag}_grad_{i}"], tol, f"grad {i}")
    # frames reach frontend_proj, tokens embed; never both
    flat = dict(zip([TR.keystr(p) for p, _ in TR.flatten_with_path(params)],
                    grads))
    fed = "['frontend_proj']" if inp == "frames" else "['embed']"
    idle = "['embed']" if inp == "frames" else "['frontend_proj']"
    assert float(flat[fed].abs().max()) > 0
    assert float(flat[idle].abs().max()) == 0


# ---------------------------------------------------------------------------
# Serving: prefill, decode and the fixed-batch loop on frames
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _gains_in_stream_dtype():
    """Every fused RMSNorm call hands the kernel ``x`` and ``w`` of one
    dtype (the card's kernel raises otherwise; the plain version would
    not); yields the dtypes seen."""
    real, seen = RO.rmsnorm_kernel, set()

    def recorded(x, w, eps):
        assert x.dtype == w.dtype, (x.dtype, w.dtype)
        seen.add(x.dtype)
        return real(x, w, eps)
    RO.rmsnorm_kernel = recorded
    try:
        yield seen
    finally:
        RO.rmsnorm_kernel = real


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_on_frames_match_jax(jax_out, arch, cdt):
    """``prefill`` of 16 frames and 4 ``decode_step``s on ``[B, 1, F]``
    frames, float32 params: float32 caches within F32_TOL, the reference's
    default bf16 ones within CACHE_BF16_TOL.  Each norm gives the fused
    RMSNorm its gain in the float32 stream's dtype."""
    cfg = _red(arch, cache_dtype=cdt)
    params = _params(jax_out, f"{arch}_param_", cfg)
    frames = _t(jax_out[arch + "_frames"])
    tag = f"{arch}_{cdt}"
    tol = F32_TOL if cdt == "float32" else CACHE_BF16_TOL
    with torch.no_grad(), _gains_in_stream_dtype() as seen:
        lg, st = TF.prefill(params, cfg, frames[:, :T_PROMPT])
        assert lg.dtype == torch.float32
        _close(lg, jax_out[tag + "_prefill"], F32_TOL, "prefill")
        for s in range(N_DECODE):
            lg, st = TF.decode_step(
                params, cfg, st, frames[:, T_PROMPT + s:T_PROMPT + s + 1])
            _close(lg, jax_out[f"{tag}_decode_{s}"], tol, f"decode {s}")
    assert seen == {torch.float32}
    assert int(st["pos"]) == T_PROMPT + N_DECODE
    assert st["segments"][0]["k"].dtype == getattr(torch, cdt)


def test_bf16_frames_prefill_norm_gains_cast():
    """A bf16 model fed float32 frames: each serving norm's bf16 gain
    reaches the kernel cast to float32 (exact), and the logits are
    float32."""
    cfg = tbase.reduced(tbase.get_config("pixtral-12b"))
    params = TF.init_params(cfg, 0, "cpu")
    frames = torch.randn(2, 16, cfg.frontend_dim)
    with torch.no_grad(), _gains_in_stream_dtype() as seen:
        lg, st = TF.prefill(params, cfg, frames)
        lg2, _ = TF.decode_step(params, cfg, st, frames[:, :1])
    assert seen == {torch.float32}
    assert lg.dtype == lg2.dtype == torch.float32
    ref, _ = TF.forward(params, cfg, frames)
    np.testing.assert_allclose(lg[:, 0].numpy(), ref[:, -1].detach().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_fixed_batch_tokens_match_jax(jax_out, arch, capsys):
    """The fixed-batch loop on random float32 frames (the prompt and each
    step's input from one RandomState, in the reference's order): the
    greedy tokens equal the reference's loop's, its printed sample ids
    the reference's ``run_fixed_batch``'s."""
    from repro_torch.launch.serve import run_fixed_batch
    cfg = _red(arch)
    params = _params(jax_out, f"{arch}_fixed_param_", cfg)
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

def _tcfg(backend="pallas_fused", wire="float32"):
    return TrainConfig(backend=backend, wire_dtype=wire, bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr=LR, warmup_steps=1,
                                         total_steps=100))


@pytest.mark.parametrize("tag", list(RUNS))
def test_train_steps_match_jax(jax_out, tag):
    """Two pallas_fused steps on frames from the reference's initial
    params: loss and grad norm of each within rtol 1e-4 of the
    reference's, the global state after step 2 within BOUNDS."""
    arch, kw, dp, tp = RUNS[tag]
    cfg, tcfg = _red(arch, **kw), _tcfg()
    shapes = TF.param_shapes(cfg)
    init = TR.unflatten(shapes, [jax_out[f"{tag}_init_{i}"] for i in
                                 range(len(TR.flatten(shapes)))])
    step, info, _ = make_train_step(cfg, tcfg, dp, shapes, "cpu", tp=tp)
    assert info["bucket_plan"] is not None
    one = params_from_numpy(init, cfg, "cpu", n_model=tp)
    params = [TR.tree_map(torch.clone, one) for _ in range(dp)]
    state = make_init_fns(cfg, tcfg, dp, "cpu", tp=tp)[1](params)
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size,
                      frontend_dim=cfg.frontend_dim)
    for s in range(STEPS):
        batch = make_batch(dcfg, s)
        assert batch["inputs"].dtype == np.float32
        params, state, m = step(params, state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), jax_out[f"{tag}_{k}_{s}"],
                                       rtol=1e-4,
                                       err_msg=f"{tag} step {s} {k}")
    glob = train_state_to_numpy(cfg, tcfg, params, state, dp, tp=tp)
    pairs = {"param": [(x, jax_out[f"{tag}_param_{i}"])
                       for i, x in enumerate(TR.flatten(glob["params"]))],
             "master": [], "m": [], "v": []}
    i = 0
    for st in TR.flatten_up_to(glob["params"], glob["state"]["opt"]):
        for k in sorted(st):              # m, master, v: the JAX leaf order
            pairs[k].append((st[k], jax_out[f"{tag}_opt_{i}"]))
            i += 1
    for k, (tight, loose) in BOUNDS.items():
        if k in pairs:
            _mostly_close(pairs[k], tight, loose, f"{tag} {k}")


@pytest.mark.parametrize("n_dp,tp", [(2, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_plan_and_report_match_jax(arch, n_dp, tp):
    """bf16 configs, full width and reduced, float32 and int8 wires: the
    plan (slots, zero dims, offsets, dtypes) and the report equal the
    reference's, ``frontend_proj`` among the bucketed leaves."""
    from repro.models import sharding as jsh
    from repro.train import step as jstep
    from repro.train import zero as jzero
    try:
        jsh.set_model_parallel(tp)
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
                plan = make_train_step(tc, tt, n_dp, TF.param_shapes(tc),
                                       "cpu", tp=tp)[1]["bucket_plan"]
                assert bucket_report(tt, plan) == \
                    jstep.bucket_report(jt, jplan)
                assert [(b.dtype, [(s.index, s.zero_dim, s.offset)
                                   for s in b.slots])
                        for b in plan.buckets] == \
                    [(b.dtype, [(s.index, s.zero_dim, s.offset)
                                for s in b.slots]) for b in jplan.buckets]
    finally:
        jsh.set_model_parallel(1)


# ---------------------------------------------------------------------------
# The CLIs and the refusals
# ---------------------------------------------------------------------------

def test_serve_refuses_frontends_over_tp_naming_5g(capsys):
    """Named for the refusal it pinned until item 5g was ported: the pool
    refuses frontends (no token stream), as the reference's does; over 2
    TP ranks ``prefill_tp`` and ``decode_step_tp`` on frames (float32
    caches, the state laid out by ``engine.cache_layout``) now give the
    one-rank logits within F32_TOL, and the serve CLI's fixed-batch branch
    with a model axis the one-rank sample tokens; a data axis above 1
    raises (the loop runs one DP rank)."""
    from repro_torch.launch import serve
    from repro_torch.serve import engine as E
    from repro_torch.serve import kvcache as KV
    cfg = _red("musicgen-medium", cache_dtype="float32")
    for arch in ARCHS:
        assert not E.pool_supported(tbase.get_config(arch))
    with pytest.raises(NotImplementedError, match="frontend"):
        E.make_serve_fns(cfg, E.ServeConfig(), 2, 32, "cpu")
    params = TF.init_params(cfg, 0, "cpu")
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 17, cfg.frontend_dim)).astype(np.float32))
    lay = E.cache_layout(cfg, 1, 16, 1, 2)
    with torch.no_grad():
        ref, st1 = TF.prefill(params, cfg, frames[:, :16])
        blocks, st = TF.prefill_tp(params, cfg, frames[:, :16], 2)
        _close(TF.vocab_logits(blocks, cfg.vocab_size), ref.numpy(), F32_TOL,
               "prefill_tp")
        ref, _ = TF.decode_step(params, cfg, st1, frames[:, 16:])
        blocks, _ = TF.decode_step_tp(params, cfg,
                                      KV.state_from_global(cfg, st, lay),
                                      frames[:, 16:], lay)
        _close(TF.vocab_logits(blocks, cfg.vocab_size), ref.numpy(), F32_TOL,
               "decode_step_tp")
    outs = {}
    for mesh in ("1,1", "1,2", "1,1,2"):
        serve.main(["--arch", "musicgen-medium", "--reduced", "--device",
                    "cpu", "--mesh", mesh, "--slots", "2",
                    "--prompt-len-max", "16", "--max-new", "3"])
        outs[mesh] = [l for l in capsys.readouterr().out.splitlines()
                      if "sample token ids" in l]
    assert outs["1,2"] == outs["1,1"] == outs["1,1,2"] and outs["1,1"]
    with pytest.raises(ValueError, match="one DP rank"):
        serve.main(["--arch", "musicgen-medium", "--reduced", "--device",
                    "cpu", "--mesh", "2,2"])


def test_clis_run_the_frontends_on_frames(capsys):
    """The serve CLI sends a frontend model to the fixed-batch loop on one
    rank, naming the reason; the train CLI trains one on frames."""
    from repro_torch.launch import serve, train
    serve.main(["--arch", "pixtral-12b", "--reduced", "--device", "cpu",
                "--slots", "2", "--prompt-len-max", "32", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "pool unsupported (a modality frontend)" in out
    assert "sample token ids" in out
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "musicgen-medium", "--reduced", "--device",
                    "cpu", "--mesh", "2,1", "--steps", "2", "--batch", "4",
                    "--seq", "32", "--log-every", "1"])
    out = buf.getvalue()
    assert "arch=musicgen-medium" in out
    losses = [float(l.split("loss")[1].split()[0]) for l in out.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
