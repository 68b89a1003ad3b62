"""The three dense configs (gemma3-4b, gemma-7b, qwen3-32b) on the port,
against the JAX package, on the CPU.

Each config is the reference's copy (``repro_torch/configs/``).  The
reduced configs run in float32 (and a float32 cache) in both packages,
the JAX package's weights carried across with
``interop.params_from_numpy`` and every input made from a numpy seed.
The JAX side runs in subprocesses (one CPU device, or four for the
tensor-parallel serve) and hands its outputs over as ``.npz`` files.
Held against ``repro``:

  * each config's fields and its ``reduced()``; the layer pattern (kinds
    and windows) at full size and reduced; the full-size parameter count;
  * forward logits, loss and metrics: rtol 1e-4, atol 1e-5; every
    gradient leaf: rtol 1e-3, atol 1e-5 (tests/test_torch_model.py's
    bounds: float32 sums in other orders, compounded by backward);
  * reduced gemma3-4b (5 local layers of window 16, 1 global, in pages of
    64 slots): prefill of a full page against the reference's forward at
    its last position and its own prefill; padded prefills of 37 tokens
    (the 16-slot rings wrapped) and 10 (not yet full), then 12 decode
    steps token by token, logits and caches at each prefill and after the
    last step: rtol 1e-4, atol 1e-5, positions exactly;
  * the pool's continuous batching on reduced gemma3-4b (five requests of
    5-40 tokens, crossing the window, through 3 pages; the reference's
    tests/serve/test_scheduler.py equivalence case): greedy streams and
    the scheduler's counts exactly, and each request alone in a 1-page
    pool gives its pooled stream;
  * ``zero_layout`` and the bucket plan on qwen3-32b's full-size
    ``param_shapes`` (meta tensors): exactly;
  * serving under TP at (dp, tp) = (2, 2), one case per config: gemma-7b
    and qwen3-32b at the reduced width (pure_sp), gemma3-4b widened to
    d_model 1024 with 8/4 heads (megatron_sp, as on the card: its flash
    prefill and its 16-slot rings split over the TP ranks); two inserts
    and three decode steps, the logits and the global pool within atol
    2e-5 of their largest magnitude (tests/test_torch_serve_tp.py's
    float32 bound), positions exactly;
  * the CLIs' ``--arch`` with ``--reduced`` on the CPU.

The flash kernel's plain version at head_dim 256 is held against the
reference's kernel in interpret mode by the head_dim-256 rows of
``FLASH_CASES`` in tests/test_torch_serve_kernels.py (both dtypes, g = 1,
2 and 8, causal and windowed), which also run on the card.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import sharding as jsh
from repro.models import transformer as JT
from repro.train import buckets as jbk
from repro.train import zero as jzero
from repro_torch import tree as TR
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as E
from repro_torch.serve import kvcache as KV
from repro_torch.serve import sampling as SP
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.train import buckets as tbk
from repro_torch.train import zero as tzero
from torch_threads import pin_threads, subproc  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["gemma3-4b", "gemma-7b", "qwen3-32b"]
#: full-size parameter counts (the port's and the reference's)
N_PARAMS = {"gemma3-4b": 3_879_925_248, "gemma-7b": 8_537_680_896,
            "qwen3-32b": 32_762_123_264}
#: gemma3's page: longer than the reduced local window (16)
T_PAGE = 64
#: padded prompts' real lengths: past the window (the rings wrap) and short
LENGTHS = (37, 10)
N_DEC = 12
#: the scheduler case: (prompt length, arrival) a request
SCHED = ((5, 0.0), (23, 0.0), (11, 1.5), (40, 3.0), (17, 6.0))
SCHED_NEW = 6
#: serving under TP: (prompt length, page) of the inserts, active masks
TP_B = 4
TP_INSERTS = ((37, 1), (10, 3))
TP_ACTIVES = ((1, 1, 0, 1), (0, 1, 1, 1), (1, 1, 1, 1))
F32_REL = 2e-5
#: each TP case's replacements of the reduced config, and its strategy
TP_CASES = {
    "gemma3-4b": (dict(d_model=1024, n_heads=8, n_kv_heads=4, head_dim=32,
                       d_ff=256), "megatron_sp"),
    "gemma-7b": ({}, "pure_sp"),
    "qwen3-32b": ({}, "pure_sp"),
}


def _cfg(arch):
    return tbase.reduced(tbase.get_config(arch)).replace(
        dtype="float32", cache_dtype="float32")


PRELUDE = r"""
import os
os.environ["REPRO_OBS"] = "0"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base
from repro.models import sharding as jsh
from repro.models import transformer as T

def cfg_of(arch):
    return base.reduced(base.get_config(arch)).replace(
        dtype="float32", cache_dtype="float32")

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

out = {{}}
"""

FWD_CODE = PRELUDE + r"""
jsh.set_model_parallel(1)
for a, arch in enumerate({archs!r}):
    full = base.get_config(arch)
    pat = T.layer_pattern(full) + T.layer_pattern(base.reduced(full))
    out[f"{{arch}}_pattern"] = np.asarray(
        [(b.kind, -1 if b.window is None else b.window) for b in pat],
        dtype=str)
    cfg = cfg_of(arch)
    params = T.init_params(jax.random.key(0), cfg)
    for i, x in enumerate(jax.tree.leaves(params)):
        out[f"{{arch}}_param_{{i}}"] = np.asarray(x)
    rng = np.random.RandomState(100 + a)
    batch = {{k: rng.randint(0, cfg.vocab_size, (2, 64)).astype(np.int32)
             for k in ("inputs", "targets")}}
    for k, v in batch.items():
        out[f"{{arch}}_{{k}}"] = v

    def fwd(p, b):            # one compile: the loss, its logits, the grads
        loss, m = T.loss_fn(p, cfg, b)
        return loss, (m, T.forward(p, cfg, b["inputs"])[0])

    (loss, (m, logits)), grads = jax.jit(jax.value_and_grad(
        fwd, has_aux=True))(params, batch)
    out[f"{{arch}}_logits"] = np.asarray(logits)
    out[f"{{arch}}_loss"] = np.asarray(loss)
    for k, v in m.items():
        out[f"{{arch}}_metric_{{k}}"] = np.asarray(v)
    for i, x in enumerate(jax.tree.leaves(grads)):
        out[f"{{arch}}_grad_{{i}}"] = np.asarray(x)
np.savez({path!r}, **out)
print("JAX_OK")
"""

SERVE_CODE = PRELUDE + r"""
from repro.serve.engine import ServeConfig, make_serve_fns
from repro.serve.scheduler import ContinuousBatchingScheduler, Request
jsh.set_model_parallel(1)
cfg = cfg_of("gemma3-4b")
TP = {t_page!r}
params = T.init_params(jax.random.key(0), cfg)
for i, x in enumerate(jax.tree.leaves(params)):
    out[f"param_{{i}}"] = np.asarray(x)

def put(tag, logits, state):
    out[tag + "_logits"] = np.asarray(logits)
    out[tag + "_pos"] = np.asarray(state["pos"])
    for si, seg in enumerate(state["segments"]):
        out[f"{{tag}}_k{{si}}"] = np.asarray(seg["k"])
        out[f"{{tag}}_v{{si}}"] = np.asarray(seg["v"])

rng = np.random.RandomState(7)
full_in = rng.randint(0, cfg.vocab_size, (2, TP)).astype(np.int32)
pad_in = rng.randint(0, cfg.vocab_size, (1, TP)).astype(np.int32)
steps = rng.randint(0, cfg.vocab_size, ({n_dec!r}, 1, 1)).astype(np.int32)
out["full_in"], out["pad_in"], out["steps"] = full_in, pad_in, steps
out["forward"] = np.asarray(jax.jit(lambda p, x: T.forward(p, cfg, x))(
    params, full_in)[0])
lg, st = jax.jit(lambda p, x: T.prefill(p, cfg, x))(params, full_in)
put("full", lg, st)
prel = jax.jit(lambda p, x, L: T.prefill(p, cfg, x, length=L))
dec = jax.jit(lambda p, s, t: T.decode_step(p, cfg, s, t))
for L in {lengths!r}:
    lg, st = prel(params, pad_in, jnp.int32(L))
    put(f"pad{{L}}", lg, st)
    for t in range({n_dec!r}):
        lg, st = dec(params, st, steps[t])
        out[f"dec{{L}}_{{t}}"] = np.asarray(lg)
    put(f"dec{{L}}", lg, st)

# the reference's continuous-batching case, on one device
mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
fns = make_serve_fns(cfg, ServeConfig(dp_axes=("data",)), mesh, 3, TP)
rng = np.random.RandomState(5)
reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, L).astype(
            np.int32), max_new_tokens={new!r}, arrival=arr)
        for i, (L, arr) in enumerate({sched!r})]
with set_mesh(mesh):
    sched = ContinuousBatchingScheduler(cfg, fns, params, 3, TP, seed=11)
    for r in reqs:
        sched.submit(r)
    stats = sched.run()
out["sched_prompts"] = np.concatenate([r.prompt for r in reqs])
out["sched_streams"] = np.asarray([r.generated for r in reqs])
out["sched_stats"] = np.asarray([stats["decode_steps"], stats["inserts"],
                                 stats["peak_occupancy"]])
np.savez({path!r}, **out)
print("JAX_OK")
"""

TP_CODE = PRELUDE + r"""
from repro.serve.engine import ServeConfig, make_serve_fns
B, S = {B!r}, {S!r}
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
for a, (arch, (extra, _)) in enumerate({cases!r}.items()):
    cfg = cfg_of(arch).replace(**extra)
    params = T.init_params(jax.random.key(1), cfg)
    for i, x in enumerate(jax.tree.leaves(params)):
        out[f"{{arch}}_init_{{i}}"] = np.asarray(x)
    fns = make_serve_fns(cfg, ServeConfig(dp_axes=("data",)), mesh, B, S)
    rng = np.random.RandomState(30 + a)
    with set_mesh(mesh):
        pool = fns.init_pool()
        for i, (L, slot) in enumerate({inserts!r}):
            toks = np.zeros((1, S), np.int32)
            toks[0, :L] = rng.randint(0, cfg.vocab_size, L)
            out[f"{{arch}}_ins_tokens_{{i}}"] = toks
            lg, pool = fns.insert(params, pool, toks, jnp.int32(L),
                                  jnp.int32(slot))
            out[f"{{arch}}_ins_logits_{{i}}"] = f32(lg)
        for t, active in enumerate({actives!r}):
            toks = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            out[f"{{arch}}_dec_tokens_{{t}}"] = toks
            lg, pool = fns.decode_slots(params, pool, toks,
                                        jnp.asarray(active, jnp.int32))
            out[f"{{arch}}_dec_logits_{{t}}"] = f32(lg)
        out[f"{{arch}}_pool_pos"] = np.asarray(pool["pos"])
        for si, seg in enumerate(pool["segments"]):
            for k in ("k", "v"):
                out[f"{{arch}}_pool_{{k}}{{si}}"] = f32(seg[k])
np.savez({path!r}, **out)
print("JAX_OK")
"""


@pytest.fixture(autouse=True)
def _no_tp():
    # the JAX specs read a process-wide model-axis size other tests set
    jsh.set_model_parallel(1)


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("jax_dense")
    jobs = [
        (FWD_CODE.format(archs=ARCHS, path=str(tmp / "fwd.npz")), 1),
        (SERVE_CODE.format(t_page=T_PAGE, n_dec=N_DEC, lengths=LENGTHS,
                           new=SCHED_NEW, sched=SCHED,
                           path=str(tmp / "serve.npz")), 1),
        (TP_CODE.format(cases=TP_CASES, B=TP_B, S=T_PAGE, inserts=TP_INSERTS,
                        actives=TP_ACTIVES, path=str(tmp / "tp.npz")), 4),
    ]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(subproc, code, dev, 600) for code, dev in jobs]:
            assert "JAX_OK" in f.result()
    out = {}
    for name in ("fwd", "serve", "tp"):
        out[name] = dict(np.load(tmp / f"{name}.npz"))
    return out


def _params(npz, prefix, cfg):
    shapes = TT.param_shapes(cfg)
    n = len(TR.flatten(shapes))
    assert f"{prefix}{n}" not in npz
    tree = TR.unflatten(shapes, [npz[f"{prefix}{i}"] for i in range(n)])
    return params_from_numpy(tree, cfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# The configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches(arch):
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    assert set(t.__dataclass_fields__) == set(j.__dataclass_fields__)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in t.__dataclass_fields__}
    assert tbase.reduced(t).__dict__ == jbase.reduced(j).__dict__


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_pattern_matches(jax_out, arch):
    """Kinds and windows layer by layer, full size and reduced (gemma3:
    34 layers of which 5 global, the reduced 7 of which 1 global)."""
    full = tbase.get_config(arch)
    pat = TT.layer_pattern(full) + TT.layer_pattern(tbase.reduced(full))
    got = [(b.kind, str(-1 if b.window is None else b.window)) for b in pat]
    assert got == [tuple(x) for x in jax_out["fwd"][f"{arch}_pattern"]]
    if arch == "gemma3-4b":
        assert len(TT.layer_pattern(full)) == 34
        assert sum(b.window is None for b in TT.layer_pattern(full)) == 5
        assert [b.window for b in TT.layer_pattern(tbase.reduced(full))] \
            == [16] * 5 + [None, 16]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameter_count(arch):
    t = tbase.get_config(arch)
    js = jax.eval_shape(lambda k: JT.init_params(k, jbase.get_config(arch)),
                        jax.random.key(0))
    assert TT.param_count(TT.param_shapes(t)) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(js)) == N_PARAMS[arch]


def test_registry_lists_the_dense_configs():
    for arch in ARCHS + ["phi4-mini-3.8b"]:
        assert tbase.get_config(arch).family == "dense"
    # pixtral-12b is registered (the frontend slice); an unknown name
    # raises KeyError, as the reference's get_config does
    assert tbase.get_config("pixtral-12b").family == "vlm"
    with pytest.raises(KeyError):
        tbase.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# Forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_match(jax_out, arch):
    out = jax_out["fwd"]
    cfg = tbase.reduced(tbase.get_config(arch)).replace(dtype="float32")
    params = _params(out, f"{arch}_param_", cfg)
    batch = {k: _t(out[f"{arch}_{k}"]) for k in ("inputs", "targets")}
    logits, _ = TT.forward(params, cfg, batch["inputs"])
    np.testing.assert_allclose(logits.detach().numpy(), out[f"{arch}_logits"],
                               rtol=1e-4, atol=1e-5)
    leaves = [x.requires_grad_(True) for x in TR.flatten(params)]
    loss, m = TT.loss_fn(TR.unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()),
                               float(out[f"{arch}_loss"]), rtol=1e-4,
                               atol=1e-5)
    for k in m:
        np.testing.assert_allclose(float(m[k].detach()),
                                   float(out[f"{arch}_metric_{k}"]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(g.numpy(), out[f"{arch}_grad_{i}"],
                                   rtol=1e-3, atol=1e-5,
                                   err_msg=f"{arch} grad leaf {i}")


# ---------------------------------------------------------------------------
# gemma3's serving path: prefill, decode over wrapped rings, the pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def g3(jax_out):
    cfg = _cfg("gemma3-4b")
    return cfg, _params(jax_out["serve"], "param_", cfg)


def _same_state(out, tag, logits, state):
    np.testing.assert_allclose(logits.numpy(), out[tag + "_logits"],
                               rtol=1e-4, atol=1e-5, err_msg=tag)
    np.testing.assert_array_equal(state["pos"].numpy(), out[tag + "_pos"])
    for si, seg in enumerate(state["segments"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(seg[k].numpy(), out[f"{tag}_{k}{si}"],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{tag} {k}{si}")


def test_gemma3_prefill_matches_forward(jax_out, g3):
    """A full page's prefill (the static ring roll of the local layers):
    its logits are the forward's at the last position, the reference's
    and the port's own, and its caches the reference's prefill's."""
    out = jax_out["serve"]
    cfg, params = g3
    logits, state = TT.prefill(params, cfg, _t(out["full_in"]))
    _same_state(out, "full", logits, state)
    np.testing.assert_allclose(logits[:, 0].numpy(), out["forward"][:, -1],
                               rtol=1e-4, atol=1e-5)
    mine, _ = TT.forward(params, cfg, _t(out["full_in"]))
    np.testing.assert_allclose(logits[:, 0].numpy(), mine[:, -1].numpy(),
                               rtol=1e-4, atol=1e-5)
    # the local layers hold rings of 16 slots, the global one the page
    assert [seg["k"].shape[2] for seg in state["segments"]] == [16, T_PAGE,
                                                                16]


@pytest.mark.parametrize("L", LENGTHS)
def test_gemma3_decode_token_by_token_matches_jax(jax_out, g3, L):
    """A padded prefill of ``L`` tokens (37: every local ring wrapped; 10:
    not yet full), then 12 decode steps, each step's logits against the
    reference's decode, the caches after the prefill and the last step."""
    out = jax_out["serve"]
    cfg, params = g3
    logits, state = TT.prefill(params, cfg, _t(out["pad_in"]), length=L)
    _same_state(out, f"pad{L}", logits, state)
    for t in range(N_DEC):
        logits, state = TT.decode_step(params, cfg, state,
                                       _t(out["steps"][t]))
        np.testing.assert_allclose(logits.numpy(), out[f"dec{L}_{t}"],
                                   rtol=1e-4, atol=1e-5, err_msg=f"step {t}")
    _same_state(out, f"dec{L}", logits, state)


def _sched_reqs(out, cfg):
    prompts = np.split(out["sched_prompts"],
                       np.cumsum([L for L, _ in SCHED])[:-1])
    return [Request(rid=i, prompt=p, max_new_tokens=SCHED_NEW, arrival=arr)
            for i, (p, (_, arr)) in enumerate(zip(prompts, SCHED))]


def _serve(cfg, params, reqs, n_slots):
    fns = E.make_serve_fns(cfg, E.ServeConfig(), n_slots, T_PAGE, "cpu")
    sched = ContinuousBatchingScheduler(cfg, fns, params, n_slots, T_PAGE,
                                        seed=11)
    for r in reqs:
        sched.submit(r)
    return sched.run()


def test_gemma3_continuous_batching_matches_jax(jax_out, g3):
    """Five requests of 5-40 tokens (crossing the 16-token window) with
    staggered arrivals through 3 pages: the greedy streams and the
    scheduler's counts equal the reference's, and each request served
    alone in a 1-page pool gives its pooled stream."""
    out = jax_out["serve"]
    cfg, params = g3
    reqs = _sched_reqs(out, cfg)
    stats = _serve(cfg, params, reqs, 3)
    assert all(r.finished for r in reqs)
    np.testing.assert_array_equal([r.generated for r in reqs],
                                  out["sched_streams"])
    np.testing.assert_array_equal(
        [stats["decode_steps"], stats["inserts"], stats["peak_occupancy"]],
        out["sched_stats"])
    assert stats["peak_occupancy"] == 3
    for r in reqs:
        solo = Request(rid=r.rid, prompt=r.prompt, max_new_tokens=SCHED_NEW)
        _serve(cfg, params, [solo], 1)
        assert solo.generated == r.generated, r.rid


# ---------------------------------------------------------------------------
# qwen3-32b's ZeRO layout and bucket plan at full size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dp", [4, 8])
def test_qwen3_full_size_zero_layout_and_bucket_plan_match(n_dp):
    j, t = jbase.get_config("qwen3-32b"), tbase.get_config("qwen3-32b")
    js = jax.eval_shape(lambda k: JT.init_params(k, j), jax.random.key(0))
    ts = TT.param_shapes(t)
    assert all(x.device.type == "meta" for x in TR.flatten(ts))
    assert [tuple(x.shape) for x in jax.tree.leaves(js)] == \
        [tuple(x.shape) for x in TR.flatten(ts)]
    jl = jzero.zero_layout(j, js, n_dp)
    tl = tzero.zero_layout(t, ts, n_dp)
    assert jax.tree.leaves(jl) == TR.flatten(tl)
    for cap, item in ((64 << 20, 4.0), (64 << 20, 1 + 4 / 256),
                      (1 << 30, 2.0)):
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


# ---------------------------------------------------------------------------
# Serving under TP at (dp, tp) = (2, 2)
# ---------------------------------------------------------------------------

def _close(got, exp, what):
    got = got.to(torch.float32).numpy() if torch.is_tensor(got) else got
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=F32_REL * float(np.abs(exp).max()),
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_serve_matches_jax(jax_out, arch):
    """Two inserts and three decode steps (inactive pages) at (2, 2): the
    logits (the ranks' vocab blocks gathered) and the global pool against
    the reference's GSPMD serve."""
    out = jax_out["tp"]
    extra, strat = TP_CASES[arch]
    cfg = _cfg(arch).replace(**extra)
    assert SH.strategy(cfg, 2) == strat
    params = _params(out, f"{arch}_init_", cfg)
    fns = E.make_serve_fns(cfg, E.ServeConfig(), TP_B, T_PAGE, "cpu", dp=2,
                           tp=2)
    pool = fns.init_pool()
    for i, (L, slot) in enumerate(TP_INSERTS):
        lg, pool = fns.insert(params, pool, out[f"{arch}_ins_tokens_{i}"], L,
                              slot)
        _close(SP.gather_vocab(lg, cfg.vocab_size),
               out[f"{arch}_ins_logits_{i}"], f"{arch} insert {i}")
    for t, active in enumerate(TP_ACTIVES):
        lg, pool = fns.decode_slots(params, pool,
                                    out[f"{arch}_dec_tokens_{t}"],
                                    np.asarray(active, np.int32))
        _close(SP.gather_vocab(lg, cfg.vocab_size),
               out[f"{arch}_dec_logits_{t}"], f"{arch} decode {t}")
    assert all(x.kv == "seq" for x in fns.layout)
    g = KV.pool_to_global(pool, fns.layout)
    np.testing.assert_array_equal(g["pos"].numpy(), out[f"{arch}_pool_pos"])
    for si, seg in enumerate(g["segments"]):
        for k in "kv":
            _close(seg[k], out[f"{arch}_pool_{k}{si}"], f"{arch} {k}{si}")


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis_take_the_arch(capsys, arch):
    from repro_torch.launch import serve, train
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "3", "--prompt-len-min", "8",
                "--prompt-len-max", "40", "--max-new", "3", "--slots", "2"])
    out = capsys.readouterr().out
    assert f"{arch} (" in out and "finished 3/3" in out
    train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                "1", "--batch", "4", "--seq", "16", "--backend",
                "pallas_fused"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "done: 1 steps" in out
