"""MoE serving on the port: ``prefill`` and ``decode_step`` through the
``moe`` blocks (one TP rank, the capacity dispatch of ``moe._moe_dense``
over the call's tokens) and the fixed-batch loop, against the JAX
package, on the CPU.

The JAX side runs in one subprocess (one CPU device, the reference's
serve fns on a (1, 1) mesh, as its fixed-batch loop runs them) and hands
its outputs over as an ``.npz`` file; weights cross through ``interop``.
Reduced mixtral-8x7b (4 experts of 2 blocks, a 16-token window, so the
24-token prompt leaves ring caches) and phi3.5-moe (4 experts, full
attention, so the reference's clamped decode write of ROADMAP.md section
C), float32 weights, held against ``repro``:

  * ``prefill`` of 24 tokens and 3 ``decode_step``s for a batch of 3:
    the logits within ``MODEL_TOL`` (float32 caches) or ``CACHE_BF16_TOL``
    (the reference's default bf16 caches, decode), as
    ``tests/test_torch_ssm.py`` and ``tests/test_torch_frontend.py`` hold
    theirs; the caches after the prefill and after the last step within
    ``MODEL_TOL`` (float32) or, bf16, ``MODEL_TOL`` plus one bf16 ulp of
    the reference's value (the two round float32 values that close);
  * in decode the batch's 3 tokens are the dispatch's N, so each expert
    holds ``ceil(3 * 2 / 4 * 1.25) = 2`` slots and a token whose expert
    three tokens chose is dropped: the decode steps drop tokens, and the
    logits still equal the reference's;
  * ``launch.serve.run_fixed_batch``'s greedy tokens equal those of the
    reference's loop (and its printed sample ids the reference's
    ``run_fixed_batch``'s).
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch import tree as TR
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe as M
from repro_torch.models import transformer as TF
from torch_threads import pin_threads, subproc  # noqa: F401



ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
CDTS = ["float32", "bfloat16"]
B, T_PROMPT, N_DECODE = 3, 24, 3
#: float32 logits and caches (rtol, atol; the atol scaled by the array's
#: largest |value| where that is above 1, see ``_close``)
MODEL_TOL = (1e-4, 1e-5)
#: decode logits over bf16 caches: a cache entry one bf16 ulp apart (a
#: rounding flip of nearly equal float32 values) moves a logit by ~1e-3
#: of its scale
CACHE_BF16_TOL = (0, 5e-3)
#: the fixed-batch loop: batch, prompt length, new tokens, seed
FIXED = (B, T_PROMPT, 6, 3)

CODE = r"""
import contextlib, io, os
os.environ["REPRO_OBS"] = "0"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base
from repro.launch.serve import run_fixed_batch
from repro.models import transformer as T
from repro.serve.engine import ServeConfig, make_serve_fns


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def red(arch, **kw):
    return base.reduced(base.get_config(arch)).replace(dtype="float32", **kw)


out = {{}}
B, TP, ND = {b!r}, {tp!r}, {nd!r}
Bf, Lf, NEW, SEED = {fixed!r}
mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
rng = np.random.default_rng(0)


def caches(tag, st):
    for i, seg in enumerate(st["segments"]):
        for k in ("k", "v"):
            out[f"{{tag}}_{{k}}_{{i}}"] = f32(seg[k])
    out[tag + "_pos"] = np.asarray(st["pos"])


for arch in {archs!r}:
    params = jax.jit(lambda k: T.init_params(k, red(arch)))(
        jax.random.key(1))
    for j, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{{arch}}_param_{{j}}"] = f32(leaf)
    toks = rng.integers(0, red(arch).vocab_size, (B, TP + ND)).astype(
        np.int32)
    out[arch + "_tokens"] = toks
    for cdt in {cdts!r}:
        cfg = red(arch, cache_dtype=cdt)
        tag = f"{{arch}}_{{cdt}}"
        fns = make_serve_fns(cfg, ServeConfig(), mesh, B, TP + ND)
        with set_mesh(mesh):
            lg, st = fns.prefill(params, jnp.asarray(toks[:, :TP]))
            out[tag + "_prefill"] = f32(lg)
            caches(tag + "_pre", st)
            for s in range(ND):
                lg, st = fns.decode(params, st,
                                    jnp.asarray(toks[:, TP + s:TP + s + 1]))
                out[f"{{tag}}_decode_{{s}}"] = f32(lg)
            caches(tag + "_dec", st)
    # the fixed-batch loop: its tokens, then run_fixed_batch's own lines
    cfg = red(arch)
    fns = make_serve_fns(cfg, ServeConfig(), mesh, Bf, Lf + NEW)
    fparams = jax.jit(lambda k: T.init_params(k, cfg))(jax.random.key(2))
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


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_moe_serve") / "serve.npz"
    subproc(CODE.format(b=B, tp=T_PROMPT, nd=N_DECODE, fixed=FIXED,
                        archs=ARCHS, cdts=CDTS, path=str(path)), 1, 600)
    return dict(np.load(path))


def _red(arch, **kw):
    return tbase.reduced(tbase.get_config(arch)).replace(dtype="float32",
                                                          **kw)


def _params(out, prefix, cfg):
    shapes = TF.param_shapes(cfg)
    n = len(TR.flatten(shapes))
    return params_from_numpy(TR.unflatten(shapes, [out[f"{prefix}{i}"]
                                                   for i in range(n)]),
                             cfg, "cpu")


def _close(got, exp, tol, what):
    """Within ``rtol`` of each value plus ``atol`` times the array's
    largest |value| (float32 sums in another order)."""
    rtol, atol = tol
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), exp,
                               rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(exp).max())),
                               err_msg=what)


def _within_one_bf16_ulp(got, exp, what):
    """bf16 cache entries: the reference's float32 values and the port's
    lie within ``MODEL_TOL`` of each other before each rounds to bf16, so
    within that plus one bf16 ulp of the reference's value after (an
    entry near zero, where the float32 sums cancel, reads the atol)."""
    rtol, atol = MODEL_TOL
    got = got.to(torch.float32).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exp), 2.0 ** -126)))
                  - 7)
    lim = ulp + rtol * np.abs(exp) + atol * max(1.0, float(np.abs(exp).max()))
    assert (np.abs(got - exp) <= lim).all(), (
        what, float(np.abs(got - exp).max()))


def _check_caches(out, tag, st, cdt):
    assert int(st["pos"]) == int(out[tag + "_pos"])
    for i, seg in enumerate(st["segments"]):
        for k in ("k", "v"):
            assert seg[k].dtype == getattr(torch, cdt)
            exp = out[f"{tag}_{k}_{i}"]
            assert tuple(seg[k].shape) == exp.shape
            if cdt == "float32":
                _close(seg[k], exp, MODEL_TOL, f"{tag} {k} {i}")
            else:
                _within_one_bf16_ulp(seg[k], exp, f"{tag} {k} {i}")


@contextlib.contextmanager
def _drops():
    """Record each capacity dispatch of the dense path: (items, slots an
    expert, items dropped)."""
    seen, real = [], M._slots

    def rec(dest, n_dest, cap):
        slot, keep, src = real(dest, n_dest, cap)
        seen.append((dest.numel(), cap, int((~keep).sum())))
        return slot, keep, src
    M._slots = rec
    try:
        yield seen
    finally:
        M._slots = real


def _serve(out, arch, cdt):
    """The port's prefill and decode steps of the test's tokens: (prefill
    logits, its caches (cloned: decode writes in place), each decode
    step's logits, the state after the last, the decode steps'
    dispatches)."""
    cfg = _red(arch, cache_dtype=cdt)
    params = _params(out, f"{arch}_param_", cfg)
    toks = torch.from_numpy(out[arch + "_tokens"])
    with torch.no_grad():
        lg0, st = TF.prefill(params, cfg, toks[:, :T_PROMPT])
        pre = TR.tree_map(torch.clone, st)
        logits = []
        with _drops() as seen:
            for s in range(N_DECODE):
                lg, st = TF.decode_step(
                    params, cfg, st, toks[:, T_PROMPT + s:T_PROMPT + s + 1])
                logits.append(lg)
    return lg0, pre, logits, st, seen


@pytest.mark.parametrize("cdt", CDTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_jax(jax_out, arch, cdt):
    """``prefill`` of 24 tokens, its caches, 3 ``decode_step``s and the
    caches after them against the reference's serve fns."""
    tag = f"{arch}_{cdt}"
    lg0, pre, logits, st, _ = _serve(jax_out, arch, cdt)
    _close(lg0, jax_out[tag + "_prefill"], MODEL_TOL, "prefill")
    _check_caches(jax_out, tag + "_pre", pre, cdt)
    tol = MODEL_TOL if cdt == "float32" else CACHE_BF16_TOL
    for s, lg in enumerate(logits):
        _close(lg, jax_out[f"{tag}_decode_{s}"], tol, f"decode {s}")
    _check_caches(jax_out, tag + "_dec", st, cdt)
    assert int(st["pos"]) == T_PROMPT + N_DECODE


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_drops_tokens_at_capacity(jax_out, arch):
    """Every decode dispatch sees the batch's 3 tokens (6 items, 2 slots
    an expert) and at least one drops a token, the logits of those steps
    still the reference's (float32 caches): the drops are the
    reference's."""
    tag = f"{arch}_float32"
    cfg = _red(arch)
    _, _, logits, _, seen = _serve(jax_out, arch, "float32")
    want = (B * cfg.top_k, 2)
    assert seen and all((n, cap) == want for n, cap, _ in seen), seen
    assert sum(d for *_, d in seen) > 0, seen
    for s, lg in enumerate(logits):
        _close(lg, jax_out[f"{tag}_decode_{s}"], MODEL_TOL, f"decode {s}")


@pytest.mark.parametrize("arch", ARCHS)
def test_run_fixed_batch_tokens_match_jax(jax_out, arch, capsys):
    """The fixed-batch loop's greedy tokens (float32) and its printed
    sample ids equal the reference's."""
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
