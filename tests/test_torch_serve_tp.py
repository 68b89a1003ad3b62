"""Serving under tensor parallelism on the port against the reference's.

The reference serves on a ``(data, model)`` mesh through GSPMD: the pages
over DP, each KV leaf by ``cache_specs`` (its page's slots over the model
axis where the width divides it, else its KV heads, else whole), prefill
by the model's strategy, decode's partial softmax combined over the model
axis, and vocab-sharded logits.  The port stacks the DP and TP ranks on
one device (rows ``r * tp + t``, ``serve.kvcache``), holds the weights
once and runs ``models.transformer.prefill_tp`` / ``decode_step_tp``.
The JAX side runs in subprocesses on 4 CPU devices under a plain
``jax.sharding.Mesh`` and ``compat.set_mesh`` (on jax 0.9
``jax.make_mesh`` gives Explicit axes); both sides read the same numpy
prompts and tokens and JAX's initial parameters.

Cases (``CASES``): the reduced phi4-mini (pure_sp) at (dp, tp) = (2, 2)
in float32 and in bfloat16; test_torch_tp's cfgA (megatron_sp) at (1, 4)
and (2, 2); a window of 16 and the 3:1 local:global pattern (ring caches)
at (1, 2); a ``heads`` layout (cfgA, window 6, tp 4: 6 slots do not split
over 4 ranks, 4 KV heads do) and a ``whole`` one (the reduced model,
window 6, tp 4: neither its 6 slots nor its 2 KV heads split).  Each
inserts three padded prompts into a 4-page pool, puts one page past its
end (its decode writes dropped), decodes 6 steps with inactive pages and
evicts a page; the scheduler serves 5 greedy requests through 3 pages
(3 pages do not split over 2 DP ranks: the un-split batch).

Compared: the insert and decode logits, the global pool
(``kvcache.pool_to_global``) after the inserts and after the decode
steps, the positions after ``evict``, the collective plan, the greedy
streams and the layout against ``cache_specs``.

Bounds.  float32: logits and pool within atol 2e-5 of their largest
magnitude, as tests/test_torch_tp.py holds the TP forward (the ranks'
partial sums and the combined softmax add in other orders than GSPMD's),
greedy streams equal.  bfloat16: within 3 bf16 ulps of the largest
magnitude (the reference's own GSPMD prefill differs from its
single-device one by about 2 ulps at phi4-mini's width, 0.0156 at
max |logit| 1.70), and every request's first token equal (later greedy
tokens move with near-ties).  Readings: the float32 cases within 0.11 of
their bound; the bf16 case at 3.0 ulps on its last decode step, where
the port's one-rank serve lands exactly as far from the reference (the
two frameworks round bf16 at other points; ROADMAP.md §C).
"""

import numpy as np
import pytest
import torch

from repro_torch import tree as TR
from repro_torch.configs import base
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build as KB
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TF
from repro_torch.serve import engine as E
from repro_torch.serve import kvcache as KV
from repro_torch.serve import sampling as SP
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         poisson_trace)

#: the model configs, as (arch, replacements) both packages apply
CFG_A = ("phi4-mini-3.8b", dict(
    n_layers=2, d_model=1024, n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=128, attn_chunk=32, remat=False, qk_norm=True,
    tie_embeddings=False, rope_theta=1e6, dtype="float32",
    cache_dtype="float32"))
REDUCED = ("reduced", dict(dtype="float32", cache_dtype="float32"))
#: tag -> (config, its extra replacements, dp, tp)
CASES = {
    "pure22": (REDUCED, {}, 2, 2),
    "pure22_bf16": (REDUCED, dict(dtype="bfloat16",
                                  cache_dtype="bfloat16"), 2, 2),
    "mega14": (CFG_A, {}, 1, 4),
    "mega22": (CFG_A, {}, 2, 2),
    "w16": (REDUCED, dict(window=16), 1, 2),
    "local_global": (REDUCED, dict(local_global_ratio=3, n_layers=5,
                                   local_window=16), 1, 2),
    "heads": (CFG_A, dict(window=6), 1, 4),
    "whole": (REDUCED, dict(window=6), 1, 4),
}
#: each case's layout of its first segment, by the reference's rule
KV_RULE = {"pure22": "seq", "pure22_bf16": "seq", "mega14": "seq",
           "mega22": "seq", "w16": "seq", "local_global": "seq",
           "heads": "heads", "whole": "whole"}
#: the JAX subprocesses, run at once
GROUPS = (("pure22", "mega14", "whole"), ("pure22_bf16", "mega22"),
          ("w16", "local_global", "heads"))
B, S = 4, 64
#: (prompt length, page) of the three inserts
INSERTS = ((37, 1), (10, 3), (50, 0))
#: the page put past its end before decoding
PAST = 2
#: the decode steps' active masks
ACTIVES = ((1, 1, 1, 1), (1, 1, 0, 1), (1, 1, 1, 0), (0, 1, 1, 1),
           (1, 0, 1, 1), (1, 1, 1, 1))
EVICT = 3
#: the scheduler: requests through SCHED_PAGES pages, new tokens each
SCHED_N, SCHED_PAGES, SCHED_NEW = 5, 3, 6
F32_REL = 2e-5
BF16_ULPS = 3

JAX_CODE = r"""
import os
os.environ["REPRO_OBS"] = "0"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base
from repro.models import transformer as T
from repro.serve.engine import ServeConfig, make_serve_fns
from repro.serve.scheduler import ContinuousBatchingScheduler, poisson_trace

def config(spec, extra):
    arch, kw = spec
    if arch == "reduced":
        cfg = base.reduced(base.get_config("phi4-mini-3.8b"))
    else:
        cfg = base.get_config(arch)
    return cfg.replace(**kw).replace(**extra)

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

out = {{}}
B, S = {B!r}, {S!r}
for tag, (spec, extra, dp, tp) in {cases!r}.items():
    cfg = config(spec, extra)
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    scfg = ServeConfig(dp_axes=("data",))
    params = T.init_params(jax.random.key(0), cfg)
    for i, x in enumerate(jax.tree.leaves(params)):    # bf16 widened exactly
        out[f"{{tag}}_init_{{i}}"] = f32(x)
    fns = make_serve_fns(cfg, scfg, mesh, B, S)
    out[tag + "_plan"] = np.asarray(sorted(fns.shardings["plan"].items()),
                                    dtype=str).reshape(-1, 2)

    def put_pool(name, pool):
        out[f"{{tag}}_{{name}}_pos"] = np.asarray(pool["pos"])
        for si, seg in enumerate(pool["segments"]):
            for k in ("k", "v"):
                out[f"{{tag}}_{{name}}_{{k}}{{si}}"] = f32(seg[k])

    rng = np.random.RandomState(7)
    with set_mesh(mesh):
        pool = fns.init_pool()
        for i, (L, slot) in enumerate({inserts!r}):
            toks = np.zeros((1, S), np.int32)
            toks[0, :L] = rng.randint(0, cfg.vocab_size, L)
            out[f"{{tag}}_ins_tokens_{{i}}"] = toks
            lg, pool = fns.insert(params, pool, toks, jnp.int32(L),
                                  jnp.int32(slot))
            out[f"{{tag}}_ins_logits_{{i}}"] = f32(lg)
        put_pool("inserted", pool)
        pool["pos"] = pool["pos"].at[{past!r}].set(S)
        for t, active in enumerate({actives!r}):
            toks = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            out[f"{{tag}}_dec_tokens_{{t}}"] = toks
            lg, pool = fns.decode_slots(params, pool, toks,
                                        jnp.asarray(active, jnp.int32))
            out[f"{{tag}}_dec_logits_{{t}}"] = f32(lg)
        put_pool("decoded", pool)
        pool = fns.evict(pool, jnp.int32({evict!r}))
        out[f"{{tag}}_evicted_pos"] = np.asarray(pool["pos"])
        sfns = make_serve_fns(cfg, scfg, mesh, {pages!r}, S)
        reqs = poisson_trace({n_req!r}, rate=0.8, prompt_lens=(5, 40),
                             max_new_tokens={new!r},
                             vocab_size=cfg.vocab_size, seed=5)
        sched = ContinuousBatchingScheduler(cfg, sfns, params, {pages!r}, S,
                                            seed=11)
        for r in reqs:
            sched.submit(r)
        sched.run()
    out[f"{{tag}}_streams"] = np.asarray([r.generated for r in reqs])
np.savez({path!r}, **out)
print("JAX_OK")
"""


def _cfg(tag):
    (arch, kw), extra, _, _ = CASES[tag]
    if arch == "reduced":
        cfg = base.reduced(base.get_config("phi4-mini-3.8b"))
    else:
        cfg = base.get_config(arch)
    return cfg.replace(**kw).replace(**extra)


@pytest.fixture(scope="module")
def jax_run(subproc, tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("jax_serve_tp")
    codes = [JAX_CODE.format(
        cases={t: CASES[t] for t in g}, B=B, S=S, inserts=INSERTS,
        past=PAST, actives=ACTIVES, evict=EVICT, pages=SCHED_PAGES,
        n_req=SCHED_N, new=SCHED_NEW, path=str(tmp / f"serve{i}.npz"))
        for i, g in enumerate(GROUPS)]
    with ThreadPoolExecutor(len(codes)) as pool:
        for f in [pool.submit(subproc, code, 4, 600) for code in codes]:
            assert "JAX_OK" in f.result()
    out = {}
    for i in range(len(GROUPS)):
        out.update(np.load(tmp / f"serve{i}.npz"))
    return out


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's run of every case on the JAX side's inputs (CPU)."""
    return {tag: _port_case(jax_run, tag) for tag in CASES}


def _params(jax_run, tag, cfg):
    shapes = TF.param_shapes(cfg)
    n = len(TR.flatten(shapes))
    tree = TR.unflatten(shapes, [jax_run[f"{tag}_init_{i}"]
                                 for i in range(n)])
    return params_from_numpy(tree, cfg, "cpu")


def _global(pool, layout):
    g = KV.pool_to_global(pool, layout)
    return {"pos": g["pos"].numpy(),
            "segments": [{k: seg[k].to(torch.float32).numpy() for k in "kv"}
                         for seg in g["segments"]]}


def _port_case(jax_run, tag):
    _, _, dp, tp = CASES[tag]
    cfg = _cfg(tag)
    params = _params(jax_run, tag, cfg)
    fns = E.make_serve_fns(cfg, E.ServeConfig(), B, S, "cpu", dp=dp, tp=tp)
    out = {"plan": fns.plan, "layout": fns.layout, "ins": [], "dec": []}
    pool = fns.init_pool()
    for i, (L, slot) in enumerate(INSERTS):
        lg, pool = fns.insert(params, pool, jax_run[f"{tag}_ins_tokens_{i}"],
                              L, slot)
        out["ins"].append(lg)
    out["inserted"] = _global(pool, fns.layout)
    pool["pos"][PAST] = S
    for t, active in enumerate(ACTIVES):
        lg, pool = fns.decode_slots(params, pool,
                                    jax_run[f"{tag}_dec_tokens_{t}"],
                                    np.asarray(active, np.int32))
        out["dec"].append(lg)
    out["decoded"] = _global(pool, fns.layout)
    out["evicted_pos"] = fns.evict(pool, EVICT)["pos"].numpy().copy()
    out["streams"] = _streams(cfg, params, dp, tp)
    return out


def _streams(cfg, params, dp, tp, backend="auto"):
    fns = E.make_serve_fns(cfg, E.ServeConfig(backend=backend), SCHED_PAGES,
                           S, "cpu", dp=dp, tp=tp)
    reqs = poisson_trace(SCHED_N, rate=0.8, prompt_lens=(5, 40),
                         max_new_tokens=SCHED_NEW, vocab_size=cfg.vocab_size,
                         seed=5)
    sched = ContinuousBatchingScheduler(cfg, fns, params, SCHED_PAGES, S,
                                        seed=11)
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert all(r.finished for r in reqs)
    return np.asarray([r.generated for r in reqs])


def _bound(cfg, exp):
    """The stated bound for values of the largest magnitude of ``exp``."""
    m = float(np.abs(exp).max())
    if cfg.dtype == "float32":
        return F32_REL * m
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(m)) - 7)


def _close(cfg, got, exp, what):
    got = got.to(torch.float32).numpy() if torch.is_tensor(got) else got
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    np.testing.assert_allclose(got, exp, rtol=0, atol=_bound(cfg, exp),
                               err_msg=what)


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", list(CASES))
def test_tp_insert_and_decode_logits_match_jax(jax_run, port_run, tag):
    """Three inserts and six decode steps (inactive pages, one page past
    its end): each call's logits, the TP ranks' vocab blocks gathered."""
    cfg = _cfg(tag)
    _, _, dp, tp = CASES[tag]
    run = port_run[tag]
    Vl = -(-cfg.vocab_size // tp)
    for i, lg in enumerate(run["ins"]):
        assert lg.shape == (tp, 1, Vl)
        _close(cfg, SP.gather_vocab(lg, cfg.vocab_size),
               jax_run[f"{tag}_ins_logits_{i}"], f"{tag} insert {i}")
    for t, lg in enumerate(run["dec"]):
        assert lg.shape == (tp, B, Vl)
        _close(cfg, SP.gather_vocab(lg, cfg.vocab_size),
               jax_run[f"{tag}_dec_logits_{t}"], f"{tag} decode {t}")


@pytest.mark.parametrize("tag", list(CASES))
def test_tp_pool_matches_jax(jax_run, port_run, tag):
    """The global pool after the three inserts and after the decode steps,
    positions exactly; the positions after ``evict``; the layout is the
    one the reference's ``cache_specs`` gives the case."""
    cfg = _cfg(tag)
    run = port_run[tag]
    assert run["layout"][0].kv == KV_RULE[tag]
    for name in ("inserted", "decoded"):
        got = run[name]
        np.testing.assert_array_equal(got["pos"], jax_run[f"{tag}_{name}_pos"])
        for si, seg in enumerate(got["segments"]):
            for k in "kv":
                _close(cfg, seg[k], jax_run[f"{tag}_{name}_{k}{si}"],
                       f"{tag} {name} {k}{si}")
    np.testing.assert_array_equal(run["evicted_pos"],
                                  jax_run[f"{tag}_evicted_pos"])


@pytest.mark.parametrize("tag", list(CASES))
def test_tp_plan_and_streams_match_jax(jax_run, port_run, tag):
    """The collective plan; the scheduler's greedy streams through 3
    pages, equal in float32, each request's first token equal in
    bfloat16."""
    cfg = _cfg(tag)
    run = port_run[tag]
    exp = {k: v for k, v in jax_run[f"{tag}_plan"].reshape(-1, 2)}
    assert run["plan"] == exp and "decode_attn_allreduce" in exp
    got, want = run["streams"], jax_run[f"{tag}_streams"]
    if cfg.dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

def test_cache_layout_matches_cache_specs():
    """``cache_layout`` against the reference's ``cache_specs`` on stub
    meshes: whether the pages split over DP and which of seq / heads /
    whole each segment's K/V take, over page widths, windows and meshes
    that reach every rule."""
    from types import SimpleNamespace
    from repro.serve import engine as JE
    red = base.reduced(base.get_config("phi4-mini-3.8b"))
    cfgs = [red, red.replace(window=6), red.replace(n_kv_heads=4, window=6),
            red.replace(local_global_ratio=3, n_layers=5, local_window=6)]
    for cfg in cfgs:
        for n_b, s_len, dp, tp in ((4, 64, 2, 2), (3, 64, 2, 2),
                                   (4, 64, 1, 4), (4, 66, 1, 4),
                                   (8, 64, 4, 2), (1, 64, 2, 1)):
            mesh = SimpleNamespace(shape={"data": dp, "model": tp})
            specs = JE.cache_specs(cfg, JE.ServeConfig(), n_b, s_len, mesh)
            lay = E.cache_layout(cfg, n_b, s_len, dp, tp)
            for seg, l in zip(specs["segments"], lay):
                spec = tuple(seg["k"])
                assert (spec[1] == "data") == l.batch_split
                kv = ("seq" if spec[2] == "model" else
                      "heads" if spec[3] == "model" else "whole")
                assert kv == l.kv, (cfg, n_b, s_len, dp, tp, spec)


@pytest.mark.parametrize("tag", ["pure22", "mega22", "heads", "whole"])
def test_pool_to_global_round_trip(tag):
    """``pool_from_global`` inverts ``pool_to_global`` exactly; the
    stacked pool holds no more elements than the global one (a leaf that
    does not split is held once); ``write_slot`` puts a page where
    ``pool_from_global`` does."""
    cfg = _cfg(tag)
    _, _, dp, tp = CASES[tag]
    lay = E.cache_layout(cfg, B, S, dp, tp)
    pool = KV.init_pool_state(cfg, B, S, "cpu", lay)
    gen = torch.Generator().manual_seed(0)
    for seg in pool["segments"]:
        for x in seg.values():
            x.copy_(torch.randn(x.shape, generator=gen))
    g = KV.pool_to_global(pool, lay)
    one = KV.init_pool_state(cfg, B, S, "cpu")
    for a, b in zip(one["segments"], pool["segments"]):
        assert a["k"].numel() == b["k"].numel()
    back = KV.pool_from_global(g, lay)
    for a, b in zip(back["segments"], pool["segments"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    page = {"segments": [{k: x[:, 1:2] + 1 for k, x in seg.items()}
                         for seg in g["segments"]],
            "pos": torch.tensor(5, dtype=torch.int32)}
    KV.write_slot(pool, page, 1, lay)
    for seg_g, seg in zip(KV.pool_to_global(pool, lay)["segments"],
                          g["segments"]):
        for k in "kv":
            assert torch.equal(seg_g[k][:, 1], seg[k][:, 1] + 1)
            assert torch.equal(seg_g[k][:, 0], seg[k][:, 0])


@pytest.mark.parametrize("tag", ["pure22", "mega22", "local_global",
                                 "heads", "whole"])
def test_tp_serve_equals_one_card_serve(tag):
    """The port's TP serve computes its one-rank serve's function: on the
    same (port-initialised) weights the float32 greedy streams are
    equal."""
    cfg = _cfg(tag)
    _, _, dp, tp = CASES[tag]
    params = TF.init_params(cfg, 1, "cpu")
    np.testing.assert_array_equal(_streams(cfg, params, dp, tp),
                                  _streams(cfg, params, 1, 1))


def test_sampler_with_and_without_plan_same_tokens():
    """Vocab blocks (the last one padded) give the sampler's greedy and
    sampled tokens of the whole logits, with the plan's
    ``logits_allgather`` and without a plan (``--backend xla``)."""
    V, tp = 131, 4
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((5, V), generator=gen)
    blocks = TF._vocab_blocks(logits, tp)
    assert blocks.shape == (tp, 5, 33) and not bool(blocks[-1, :, 32:].any())
    temps = np.asarray([0.0, 0.7, 1.0, 0.0, 1.3], np.float32)
    plan = E.collective_plan(_cfg("pure22"), E.ServeConfig(), tp, 1, 5)
    assert "logits_allgather" in plan
    for top_k, top_p in ((0, 0.0), (8, 0.0), (0, 0.9)):
        want = SP.make_sampler(top_k, top_p)(logits, temps, np.arange(5),
                                             np.zeros(5), 9)
        for p in (plan, None):
            got = SP.make_sampler(top_k, top_p, plan=p, vocab_size=V)(
                blocks, temps, np.arange(5), np.zeros(5), 9)
            np.testing.assert_array_equal(got, want)


def test_tp_serve_takes_the_kernels(monkeypatch):
    """Prefill under megatron_sp puts its norms on the RMSNorm kernel's op
    (2 L + 1 an insert, the TP ranks' rows with the one gain) and its
    attention on the flash kernel's (one call a layer, the ranks in its
    batch); decode's norms too (2 L + 1 a step).  Under pure_sp prefill
    attention runs ``layers._attn_seq_parallel`` and no flash call."""
    calls = {"rms": 0, "flash": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            if key == "flash":
                assert a[0].shape[0] == 2 * 1     # tp x B
            else:
                assert a[1].dim() == 1            # one gain
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TF, "fused_rmsnorm", count("rms", TF.fused_rmsnorm))
    monkeypatch.setattr(TF, "flash_attention",
                        count("flash", TF.flash_attention))
    for tag, flash in (("mega22", 1), ("pure22", 0)):
        cfg = _cfg(tag)
        L = cfg.n_layers
        fns = E.make_serve_fns(cfg, E.ServeConfig(), B, S, "cpu", dp=2, tp=2)
        params = TF.init_params(cfg, 0, "cpu")
        pool = fns.init_pool()
        calls.update(rms=0, flash=0)
        _, pool = fns.insert(params, pool, np.zeros((1, S), np.int32), 5, 0)
        assert calls == {"rms": 2 * L + 1, "flash": flash * L}, tag
        fns.decode_slots(params, pool, np.zeros((B, 1), np.int32),
                         np.ones(B, np.int32))
        assert calls == {"rms": 2 * (2 * L + 1), "flash": flash * L}, tag
    assert not any(KB.LAUNCHES.values())        # the CPU runs plain versions


def test_serve_cli_mesh_and_backend(capsys):
    """``--mesh 2,2`` prints the plan the reference's CLI prints at that
    mesh (its ``collective_plan`` on a (2, 2) mesh), ``--backend xla``
    none, and both serve the same greedy tokens."""
    from types import SimpleNamespace
    from repro.serve import engine as JE
    from repro_torch.launch import serve
    args = ["--reduced", "--device", "cpu", "--requests", "3",
            "--prompt-len-min", "8", "--prompt-len-max", "40", "--max-new",
            "4", "--slots", "2", "--mesh", "2,2"]
    outs = {}
    for backend in ("auto", "xla"):
        serve.main(args + ["--backend", backend])
        outs[backend] = capsys.readouterr().out
    cfg = base.reduced(base.get_config("phi4-mini-3.8b"))
    plan = JE.collective_plan(cfg, JE.ServeConfig(), SimpleNamespace(
        shape={"data": 2, "model": 2}), 2)
    lines = [f"[serve]   {k:24s} -> {v}" for k, v in sorted(plan.items())]
    assert all(line in outs["auto"] for line in lines) and len(plan) == 4
    assert "collective plan" not in outs["xla"]
    toks = [o.split("sample request 0 ids:")[1] for o in outs.values()]
    assert "finished 3/3" in outs["xla"] and toks[0] == toks[1]


def test_kv_layout_shapes():
    """``KVLayout``'s rows and local shapes for each split, and the rank
    views of a weight held once."""
    lay = SH.KVLayout(2, 4, True, "seq", 64)
    assert (lay.rows, lay.local_shape(8, 2)) == (8, (4, 16, 2))
    lay = SH.KVLayout(2, 4, False, "heads", 6)
    assert (lay.rows, lay.local_shape(3, 8)) == (4, (3, 6, 2))
    lay = SH.KVLayout(2, 4, True, "whole", 6)
    assert (lay.rows, lay.local_shape(8, 2)) == (2, (4, 6, 2))
    with pytest.raises(ValueError, match="unknown KV split"):
        SH.KVLayout(1, 2, True, "pages", 8)
    w = torch.arange(24.).reshape(4, 6)
    v = SH.rank_view(w, 1, 3)
    assert v.shape == (3, 4, 2) and v.data_ptr() == w.data_ptr()
    assert torch.equal(v, SH.rank_block(w.expand(3, 4, 6), 1))
    with pytest.raises(ValueError, match="does not split"):
        SH.rank_view(w, 0, 3)
