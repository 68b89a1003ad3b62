"""The port's serving path against the JAX package's, on the CPU.

Reduced phi4-mini in float32 (4 layers, d_model 64, vocab 256) with a
float32 KV cache, the JAX package's weights carried across with
``interop.params_from_numpy``; full attention and ``window=16`` (the ring
caches).  Held against ``repro``:

  * ``prefill`` (full and padded ``length``), ``decode_step`` (0-dim and
    ``[B]`` ``pos``, ``active``, the clamped write of a full cache and the
    dropped write of a slot past its page), ``write_slot`` / ``reset_slot``:
    logits and caches rtol 1e-4 atol 1e-5 — the two frameworks sum
    matmuls, softmax and RoPE's cos/sin in other orders, so values agree to
    float32 rounding through four layers (a few ulp per layer), not
    bitwise; positions exactly;
  * the sampler's greedy tokens exactly and its top-k / top-p kept sets
    exactly (the reference's draws all land in the port's kept set);
  * ``collective_plan`` over (n_tp, n_dp) in {1, 2, 4}^2 and
    ``poisson_trace`` exactly;
  * the scheduler's greedy token streams on one trace, exactly.

The JAX side runs once, in a subprocess, and hands its outputs over as an
``.npz``.  Beside those, the reference's fake-engine scheduler tests and
the continuous-batching equivalence property run on the port alone.
"""

import numpy as np
import pytest
import torch

from repro_torch import tree as TR
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build as KB
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as E
from repro_torch.serve import kvcache as KV
from repro_torch.serve import sampling as SP
from repro_torch.serve.kvcache import SlotAllocator
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler, Request,
                                         _pct, latency_summary, poisson_trace)
from torch_threads import pin_threads, subproc  # noqa: F401

WINDOWS = {"full": None, "w16": 16}
#: the padded prompts' real lengths: past and short of the 16-token window
LENGTHS = (37, 10)
T_PAGE = 64
SPLITS = [(t, d) for t in (1, 2, 4) for d in (1, 2, 4)]
#: (top_k, top_p) of the kept-set cases
KEPT = [(8, 0.0), (0, 0.9), (8, 0.5), (0, 0.3)]
SCHED_S, SCHED_NEW = 64, 6


def _cfg(window):
    return tbase.reduced(tbase.get_config("phi4-mini-3.8b")).replace(
        dtype="float32", cache_dtype="float32", window=window)


JAX_CODE = r"""
import jax, jax.numpy as jnp, numpy as np
from types import SimpleNamespace
from repro.compat import set_mesh
from repro.configs import base
from repro.models import sharding as jsh
from repro.models import transformer as T
from repro.serve import kvcache as KV
from repro.serve.engine import ServeConfig, collective_plan, make_serve_fns
from repro.serve.sampling import make_sampler
from repro.serve.scheduler import ContinuousBatchingScheduler, poisson_trace

jsh.set_model_parallel(1)
out = {{}}
WINDOWS, LENGTHS, TP = {windows!r}, {lengths!r}, {t_page!r}

def cfg_of(window):
    return base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32", cache_dtype="float32", window=window)

params = T.init_params(jax.random.key(0), cfg_of(None))
for i, leaf in enumerate(jax.tree.leaves(params)):
    out[f"param_{{i}}"] = np.asarray(leaf)

def put(tag, logits, state):
    out[tag + "_logits"] = np.asarray(logits)
    out[tag + "_pos"] = np.asarray(state["pos"])
    for si, seg in enumerate(state["segments"]):
        out[f"{{tag}}_k{{si}}"] = np.asarray(seg["k"])
        out[f"{{tag}}_v{{si}}"] = np.asarray(seg["v"])

rng = np.random.RandomState(7)
full_in = rng.randint(0, 256, (2, TP)).astype(np.int32)
pad_in = rng.randint(0, 256, (1, TP)).astype(np.int32)
steps = rng.randint(0, 256, (3, 3, 1)).astype(np.int32)
out["full_in"], out["pad_in"], out["steps"] = full_in, pad_in, steps
for wtag, window in WINDOWS.items():
    cfg = cfg_of(window)
    pre = jax.jit(lambda p, x: T.prefill(p, cfg, x))
    prel = jax.jit(lambda p, x, L: T.prefill(p, cfg, x, length=L))
    dec = jax.jit(lambda p, s, t: T.decode_step(p, cfg, s, t))
    deca = jax.jit(lambda p, s, t, a: T.decode_step(p, cfg, s, t, active=a))
    # full prefill; then decode from its full cache (the clamped write)
    lg, st = pre(params, full_in)
    put(f"{{wtag}}_full", lg, st)
    lg, st = dec(params, st, steps[0, :2])
    put(f"{{wtag}}_clamp", lg, st)
    for L in LENGTHS:
        lg, st = prel(params, pad_in, jnp.int32(L))
        put(f"{{wtag}}_pad{{L}}", lg, st)
        # scalar pos decode from the padded prefill
        s1 = st
        for t in range(2):
            lg, s1 = dec(params, s1, steps[t, :1])
        put(f"{{wtag}}_dec{{L}}", lg, s1)
    # a 3-page pool: two inserts, one slot past its page (pos = TP)
    pool = KV.init_pool_state(cfg, 3, TP)
    _, one = prel(params, pad_in, jnp.int32(LENGTHS[0]))
    pool = KV.write_slot(pool, one, 2)
    _, one = prel(params, pad_in, jnp.int32(LENGTHS[1]))
    pool = KV.write_slot(pool, one, 0)
    pool["pos"] = pool["pos"].at[1].set(TP)
    put(f"{{wtag}}_pool", jnp.zeros(()), pool)
    active = jnp.asarray([1, 1, 1], jnp.int32)
    for t in range(3):
        lg, pool = deca(params, pool, steps[t], active)
        active = jnp.asarray([1, 0, 1], jnp.int32)
    put(f"{{wtag}}_slots", lg, pool)
    put(f"{{wtag}}_reset", jnp.zeros(()), KV.reset_slot(pool, 2))

# sampler: greedy tokens, and kept sets by the reference's own filtering
logits = rng.randn(4, 256).astype(np.float32)
logits[1, 3] = logits[1, 5] = logits[1].max() + 1.0     # a tie: first wins
temps = np.asarray([0.0, 0.7, 1.0, 1.3], np.float32)
out["samp_logits"], out["samp_temps"] = logits, temps
greedy = make_sampler()(jnp.asarray(logits), jnp.zeros(4, jnp.float32),
                        jnp.arange(4, dtype=jnp.int32),
                        jnp.zeros(4, jnp.int32), jax.random.key(0))
out["samp_greedy"] = np.asarray(greedy)
for top_k, top_p in {kept!r}:
    lg = jnp.asarray(logits)
    if top_k > 0:
        kth = jax.lax.top_k(lg, top_k)[0][..., -1:]
        lg = jnp.where(lg < kth, -jnp.inf, lg)
    scaled = lg / jnp.maximum(jnp.asarray(temps)[:, None], 1e-6)
    if 0.0 < top_p < 1.0:
        srt = jnp.sort(scaled, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(srt, axis=-1)
        before = jnp.cumsum(probs, axis=-1) - probs
        thr = jnp.min(jnp.where(before < top_p, srt, jnp.inf), axis=-1,
                      keepdims=True)
        scaled = jnp.where(scaled < thr, -jnp.inf, scaled)
    out[f"kept_{{top_k}}_{{top_p}}"] = np.isfinite(np.asarray(scaled))
    sampler = make_sampler(top_k, top_p)
    hot = jnp.asarray(np.where(temps > 0, temps, 1.0), jnp.float32)
    draws = [np.asarray(sampler(jnp.asarray(logits), hot,
                                jnp.arange(4, dtype=jnp.int32),
                                jnp.full(4, s, jnp.int32),
                                jax.random.key(1))) for s in range(64)]
    out[f"draws_{{top_k}}_{{top_p}}"] = np.stack(draws)

# collective plans on stub meshes
for n_tp, n_dp in {splits!r}:
    plan = collective_plan(cfg_of(None), ServeConfig(dp_axes=("data",)),
                           SimpleNamespace(shape={{"data": n_dp,
                                                   "model": n_tp}}), B=8)
    out[f"plan_{{n_tp}}_{{n_dp}}"] = np.asarray(sorted(plan.items()), dtype=str)

trace = poisson_trace(12, rate=0.7, prompt_lens=(4, 40), max_new_tokens=5,
                      vocab_size=256, seed=3, n_sessions=3)
out["trace_arrivals"] = np.asarray([r.arrival for r in trace])
out["trace_prompts"] = np.concatenate([r.prompt for r in trace])
out["trace_lens"] = np.asarray([len(r.prompt) for r in trace])
out["trace_sessions"] = np.asarray([r.session for r in trace], dtype=str)

# the scheduler's greedy streams: 6 requests through 3 pages
cfg = cfg_of(None)
mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
fns = make_serve_fns(cfg, ServeConfig(dp_axes=("data",)), mesh, 3,
                     {sched_s!r})
reqs = poisson_trace(6, rate=0.8, prompt_lens=(5, 40),
                     max_new_tokens={sched_new!r}, vocab_size=256, seed=5)
with set_mesh(mesh):
    sched = ContinuousBatchingScheduler(cfg, fns, params, 3, {sched_s!r},
                                        seed=11)
    for r in reqs:
        sched.submit(r)
    stats = sched.run()
out["sched_streams"] = np.asarray([r.generated for r in reqs])
out["sched_stats"] = np.asarray([stats["decode_steps"], stats["inserts"],
                                 stats["peak_occupancy"]])
np.savez({path!r}, **out)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_serve") / "out.npz")
    out = subproc(JAX_CODE.format(
        windows=WINDOWS, lengths=LENGTHS, t_page=T_PAGE, kept=KEPT,
        splits=SPLITS, sched_s=SCHED_S, sched_new=SCHED_NEW, path=path),
        devices=1, timeout=600)
    assert "JAX_OK" in out
    return dict(np.load(path))


@pytest.fixture(scope="module")
def params(jax_out):
    cfg = _cfg(None)
    shapes = TT.param_shapes(cfg)
    n = len(TR.flatten(shapes))
    leaves = [jax_out[f"param_{i}"] for i in range(n)]
    assert f"param_{n}" not in jax_out
    return params_from_numpy(TR.unflatten(shapes, leaves), cfg, device="cpu")


def _same_state(jax_out, tag, logits, state, logits_too=True):
    if logits_too:
        np.testing.assert_allclose(logits.numpy(), jax_out[tag + "_logits"],
                                   rtol=1e-4, atol=1e-5, err_msg=tag)
    np.testing.assert_array_equal(state["pos"].numpy(), jax_out[tag + "_pos"])
    for si, seg in enumerate(state["segments"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(
                seg[k].numpy(), jax_out[f"{tag}_{k}{si}"], rtol=1e-4,
                atol=1e-5, err_msg=f"{tag} {k}{si}")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Model: prefill and decode against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wtag", list(WINDOWS))
def test_prefill_full_and_clamped_decode_match_jax(jax_out, params, wtag):
    """Full-length prefill (the static ring roll under a window), then a
    0-dim-``pos`` decode step from its full cache: the write lands on the
    last slot, as ``lax.dynamic_update_slice`` clamps it."""
    cfg = _cfg(WINDOWS[wtag])
    logits, state = TT.prefill(params, cfg, _t(jax_out["full_in"]))
    _same_state(jax_out, f"{wtag}_full", logits, state)
    logits, state = TT.decode_step(params, cfg, state,
                                   _t(jax_out["steps"][0, :2]))
    _same_state(jax_out, f"{wtag}_clamp", logits, state)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("wtag", list(WINDOWS))
def test_prefill_padded_and_scalar_decode_match_jax(jax_out, params, wtag, L):
    """Right-padded prefill with ``length`` (the dynamic-length ring layout
    under a window, short prompts leaving zero slots), then two decode
    steps at a 0-dim ``pos``."""
    cfg = _cfg(WINDOWS[wtag])
    logits, state = TT.prefill(params, cfg, _t(jax_out["pad_in"]), length=L)
    _same_state(jax_out, f"{wtag}_pad{L}", logits, state)
    for t in range(2):
        logits, state = TT.decode_step(params, cfg, state,
                                       _t(jax_out["steps"][t, :1]))
    _same_state(jax_out, f"{wtag}_dec{L}", logits, state)


@pytest.mark.parametrize("wtag", list(WINDOWS))
def test_pool_write_decode_slots_and_reset_match_jax(jax_out, params, wtag):
    """A 3-page pool: ``write_slot`` of two padded prefills, one slot past
    its page (its write dropped), three ``[B]``-``pos`` decode steps with
    an ``active`` mask that freezes slot 1, then ``reset_slot``."""
    cfg = _cfg(WINDOWS[wtag])
    pool = KV.init_pool_state(cfg, 3, T_PAGE, device="cpu")
    for L, slot in ((LENGTHS[0], 2), (LENGTHS[1], 0)):
        _, one = TT.prefill(params, cfg, _t(jax_out["pad_in"]), length=L)
        pool = KV.write_slot(pool, one, slot)
    pool["pos"][1] = T_PAGE
    _same_state(jax_out, f"{wtag}_pool", None, pool, logits_too=False)
    active = torch.tensor([1, 1, 1], dtype=torch.int32)
    for t in range(3):
        logits, pool = TT.decode_step(params, cfg, pool,
                                      _t(jax_out["steps"][t]), active=active)
        active = torch.tensor([1, 0, 1], dtype=torch.int32)
    _same_state(jax_out, f"{wtag}_slots", logits, pool)
    _same_state(jax_out, f"{wtag}_reset", None, KV.reset_slot(pool, 2),
                logits_too=False)
    with pytest.raises(ValueError, match="out of range"):
        KV.reset_slot(pool, 3)


def test_serving_norms_and_attention_take_the_kernels(params, monkeypatch):
    """Every norm of prefill and decode goes through the RMSNorm kernel's
    op (2 L + 1 per call) and prefill's attention through the flash
    kernel's (one a layer); on the CPU both run their plain versions."""
    calls = {"rms": 0, "flash": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TT, "fused_rmsnorm", count("rms", TT.fused_rmsnorm))
    monkeypatch.setattr(TT, "flash_attention",
                        count("flash", TT.flash_attention))
    cfg = _cfg(None)
    L = cfg.n_layers
    tok = torch.zeros((1, 32), dtype=torch.int32)
    _, st = TT.prefill(params, cfg, tok, length=5)
    assert calls == {"rms": 2 * L + 1, "flash": L}
    TT.decode_step(params, cfg, st, tok[:, :1])
    assert calls == {"rms": 2 * (2 * L + 1), "flash": L}


# ---------------------------------------------------------------------------
# Sampler, plan, trace, scheduler against JAX
# ---------------------------------------------------------------------------

def test_sampler_greedy_matches_jax(jax_out):
    logits = _t(jax_out["samp_logits"])
    for top_k, top_p in [(0, 0.0)] + KEPT:
        toks = SP.make_sampler(top_k, top_p)(
            logits, np.zeros(4, np.float32), np.arange(4), np.zeros(4), 0)
        np.testing.assert_array_equal(toks, jax_out["samp_greedy"])
    assert toks.dtype == np.int32 and toks[1] == 3   # a tie: the first


@pytest.mark.parametrize("top_k,top_p", KEPT)
def test_sampler_kept_sets_match_jax(jax_out, top_k, top_p):
    logits = _t(jax_out["samp_logits"])
    temps = _t(jax_out["samp_temps"])
    kept = torch.isfinite(SP.filter_logits(logits, temps, top_k, top_p))
    np.testing.assert_array_equal(kept.numpy(),
                                  jax_out[f"kept_{top_k}_{top_p}"])
    # every draw of the reference's sampler lands in the port's kept set
    hot = torch.where(temps > 0, temps, torch.ones(()))
    hot_kept = torch.isfinite(SP.filter_logits(logits, hot, top_k, top_p))
    draws = jax_out[f"draws_{top_k}_{top_p}"]
    assert hot_kept.numpy()[np.arange(4)[None, :], draws].all()
    # and so does every draw of the port's
    sampler = SP.make_sampler(top_k, top_p)
    for s in range(64):
        toks = sampler(logits, hot.numpy(), np.arange(4), np.full(4, s), 1)
        assert hot_kept.numpy()[np.arange(4), toks].all()


@pytest.mark.parametrize("n_tp,n_dp", SPLITS)
def test_collective_plan_matches_jax(jax_out, n_tp, n_dp):
    plan = E.collective_plan(_cfg(None), E.ServeConfig(), n_tp, n_dp, B=8)
    exp = {k: v for k, v in jax_out[f"plan_{n_tp}_{n_dp}"].reshape(-1, 2)}
    assert plan == exp
    assert E.collective_plan(_cfg(None), E.ServeConfig(backend="xla"), n_tp,
                             n_dp, B=8) == {}


def test_poisson_trace_matches_jax(jax_out):
    trace = poisson_trace(12, rate=0.7, prompt_lens=(4, 40),
                          max_new_tokens=5, vocab_size=256, seed=3,
                          n_sessions=3)
    np.testing.assert_array_equal([r.arrival for r in trace],
                                  jax_out["trace_arrivals"])
    np.testing.assert_array_equal([len(r.prompt) for r in trace],
                                  jax_out["trace_lens"])
    np.testing.assert_array_equal(np.concatenate([r.prompt for r in trace]),
                                  jax_out["trace_prompts"])
    assert [r.session for r in trace] == list(jax_out["trace_sessions"])


def test_scheduler_greedy_streams_match_jax(jax_out, params):
    cfg = _cfg(None)
    fns = E.make_serve_fns(cfg, E.ServeConfig(), 3, SCHED_S, device="cpu")
    reqs = poisson_trace(6, rate=0.8, prompt_lens=(5, 40),
                         max_new_tokens=SCHED_NEW, vocab_size=256, seed=5)
    sched = ContinuousBatchingScheduler(cfg, fns, params, 3, SCHED_S,
                                        seed=11)
    for r in reqs:
        sched.submit(r)
    stats = sched.run()
    np.testing.assert_array_equal([r.generated for r in reqs],
                                  jax_out["sched_streams"])
    np.testing.assert_array_equal(
        [stats["decode_steps"], stats["inserts"], stats["peak_occupancy"]],
        jax_out["sched_stats"])


def test_serve_config_measured_raises(tmp_path, monkeypatch):
    """``tuning="measured"`` is accepted: a deployment's plan (n_tp = 4,
    n_dp = 2) and its observability record equal the reference's, with
    the reference tuner's measured table and, without one, as the
    analytic plan after one warning; on one card nothing is priced or
    recorded, as in the reference.  An unknown tuning raises."""
    from types import SimpleNamespace
    from repro.obs import metrics as jm
    from repro.serve import engine as JE
    from repro.topology import table as jtable
    from repro_torch.obs import metrics
    from repro_torch.topology import table
    from test_torch_tables import measured_table
    monkeypatch.setenv("REPRO_MEASURED_TABLE_DIR", str(tmp_path))
    for mod in (table, jtable):
        monkeypatch.setattr(mod, "_WARNED", set())
        monkeypatch.setattr(mod, "_LOADED", {})
    regs = (metrics.Registry(), jm.Registry())
    for mod, reg in zip((metrics, jm), regs):
        monkeypatch.setattr(mod, "_REGISTRY", reg)
        monkeypatch.setattr(mod, "_ENABLED", True)
    cfg = tbase.reduced(tbase.get_config("phi4-mini-3.8b"))
    mesh = SimpleNamespace(shape={"data": 2, "model": 4})
    scfg, jscfg = (E.ServeConfig(tuning="measured"),
                   JE.ServeConfig(tuning="measured"))
    with pytest.warns(UserWarning, match="no measured table"):
        plan = E.collective_plan(cfg, scfg, 4, 2, 8)
    assert plan == E.collective_plan(cfg, E.ServeConfig(), 4, 2, 8)
    measured_table("tpu_multipod", seed=3).save(
        table.measured_table_path("tpu_multipod"))
    table.invalidate_tables()
    regs[0].reset()
    assert E.collective_plan(cfg, scfg, 4, 2, 8) == \
        JE.collective_plan(cfg, jscfg, mesh, 8)
    assert regs[0].snapshot() == regs[1].snapshot()
    rows = {lab["collective"]: lab for lab, _ in regs[0].series(
        "collective_calls")}
    assert sorted(rows) == ["allgather", "allreduce", "gather", "scatter"]
    assert all(lab["source"] == "serve_plan" for lab in rows.values())
    regs[0].reset()
    assert E.collective_plan(cfg, scfg, 1, 1, 8) == {}
    E.make_serve_fns(cfg, scfg, 2, 64, device="cpu")
    assert regs[0].counters == {}
    with pytest.raises(ValueError, match="unknown tuning"):
        E.ServeConfig(tuning="guess")


# ---------------------------------------------------------------------------
# The continuous-batching equivalence property, on the port
# ---------------------------------------------------------------------------

def _run(cfg, params, reqs, n_slots, S=SCHED_S):
    fns = E.make_serve_fns(cfg, E.ServeConfig(), n_slots, S, device="cpu")
    sched = ContinuousBatchingScheduler(cfg, fns, params, n_slots, S,
                                        seed=11)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched


@pytest.mark.parametrize("wtag", list(WINDOWS))
def test_continuous_batching_equivalence(params, wtag):
    """Mixed prompt lengths (crossing the 16-token window) and staggered
    arrivals through 3 pages give each request the stream it gets alone in
    a 1-page pool, greedy and sampled; EOS retires a replay where its
    token falls; no kernel is launched on the CPU."""
    cfg = _cfg(WINDOWS[wtag])
    rng = np.random.RandomState(5)
    KB.reset_launches()

    def mk(rid, L, arrival, sampling=SamplingParams()):
        return Request(rid=rid, prompt=rng.randint(0, 256, L).astype(np.int32),
                       max_new_tokens=SCHED_NEW, arrival=arrival,
                       sampling=sampling)

    reqs = [mk(0, 5, 0.0), mk(1, 23, 0.0), mk(2, 11, 1.5), mk(3, 40, 3.0),
            mk(4, 17, 6.0)]
    sched = _run(cfg, params, reqs, 3)
    assert all(r.finished for r in reqs)
    assert sched.alloc.total_inserts == 5 and sched.alloc.peak_occupancy == 3
    for r in reqs:
        solo = Request(rid=r.rid, prompt=r.prompt, max_new_tokens=SCHED_NEW)
        _run(cfg, params, [solo], 1)
        assert solo.generated == r.generated, r.rid
    hot = SamplingParams(temperature=0.8)
    treqs = [Request(rid=20 + i, prompt=reqs[i].prompt,
                     max_new_tokens=SCHED_NEW, arrival=float(i), sampling=hot)
             for i in range(3)]
    _run(cfg, params, treqs, 3)
    for r in treqs:
        solo = Request(rid=r.rid, prompt=r.prompt, max_new_tokens=SCHED_NEW,
                       sampling=hot)
        _run(cfg, params, [solo], 1)
        assert solo.generated == r.generated, r.rid
    tgt = reqs[1].generated[2]
    replay = Request(rid=99, prompt=reqs[1].prompt, max_new_tokens=SCHED_NEW,
                     eos_id=int(tgt))
    _run(cfg, params, [replay], 1)
    cut = reqs[1].generated.index(tgt) + 1
    assert replay.generated == reqs[1].generated[:cut]
    assert replay.finish_reason == ("eos" if cut < SCHED_NEW else "length")
    assert not any(KB.LAUNCHES.values())


def test_sampled_streams_are_per_request():
    """Seeds are injective in (rid, step), and a draw depends on its own
    stream only: the same (rid, step) draws the same token in any batch."""
    seeds = {SP.stream_seed(3, r, s) for r in range(50) for s in range(50)}
    assert len(seeds) == 2500
    assert SP.stream_seed(3, 1, 2) != SP.stream_seed(4, 1, 2)
    logits = torch.from_numpy(np.random.RandomState(0).randn(3, 64)
                              .astype(np.float32))
    sampler = SP.make_sampler()
    temps = np.full(3, 1.0, np.float32)
    batch = sampler(logits, temps, np.array([4, 5, 6]), np.array([1, 1, 1]), 9)
    for b in range(3):
        alone = sampler(logits[b:b + 1], temps[:1], np.array([4 + b]),
                        np.array([1]), 9)
        assert alone[0] == batch[b]


# ---------------------------------------------------------------------------
# Host-side logic against a fake engine (the reference's
# tests/serve/test_scheduler.py:22-224, ported)
# ---------------------------------------------------------------------------

_V = 32


class _FakeFns:
    """Deterministic stand-in engine: logits are a one-hot of pos % V, so
    a request admitted with prompt length L greedily generates
    L, L, L+1, L+2, ... (mod V) regardless of batch composition."""

    def __init__(self, n_slots):
        self.n_slots = n_slots
        self.plan = {}
        self.insert = self._insert
        self.decode_slots = self._decode
        self.evict = self._evict

    def init_pool(self):
        return {"pos": np.zeros(self.n_slots, np.int64)}

    @staticmethod
    def _onehot(idx):
        out = np.zeros((len(idx), _V), np.float32)
        out[np.arange(len(idx)), np.asarray(idx) % _V] = 1.0
        return torch.from_numpy(out)

    def _insert(self, params, pool, tokens, length, slot):
        pool["pos"][slot] = int(length)
        return self._onehot([int(length)]), pool

    def _decode(self, params, pool, tokens, active):
        logits = self._onehot(pool["pos"])
        pool["pos"] += np.asarray(active, np.int64)
        return logits, pool

    def _evict(self, pool, slot):
        pool["pos"][slot] = 0
        return pool


def _fake_sched(n_slots, max_seq_len=64, top_p=0.0):
    cfg = _cfg(None)
    return ContinuousBatchingScheduler(
        cfg, _FakeFns(n_slots), params=None, n_slots=n_slots,
        max_seq_len=max_seq_len, top_p=top_p)


def _expected(L, n):
    """The fake engine's greedy stream for prompt length L."""
    return [L % _V] + [(L + i) % _V for i in range(n - 1)]


def test_fake_engine_streams_and_recycling():
    sched = _fake_sched(n_slots=2)
    reqs = [Request(rid=i, prompt=np.zeros(L, np.int32), max_new_tokens=5,
                    arrival=float(a))
            for i, (L, a) in enumerate([(3, 0.0), (7, 0.0), (11, 1.0),
                                        (20, 9.0)])]
    for r in reqs:
        sched.submit(r)
    stats = sched.run()
    for r in reqs:
        assert r.finished and r.finish_reason == "length"
        assert r.generated == _expected(len(r.prompt), 5), r.rid
    assert stats["inserts"] == 4
    assert stats["peak_occupancy"] == 2
    assert 0 < stats["mean_occupancy"] <= 2
    # arrival at t=9 with an idle pool: clock fast-forwards, not spins
    assert reqs[3].admitted_at == 9.0
    assert all(r.arrived_wall <= r.first_token_wall <= r.finished_wall
               for r in reqs)


def test_fake_engine_eos_retirement():
    sched = _fake_sched(n_slots=1)
    req = Request(rid=0, prompt=np.zeros(6, np.int32), max_new_tokens=50,
                  eos_id=8)
    sched.submit(req)
    sched.run()
    assert req.finish_reason == "eos"
    assert req.generated == [6, 6, 7, 8]
    sched2 = _fake_sched(n_slots=1)
    req2 = Request(rid=1, prompt=np.zeros(9, np.int32), max_new_tokens=50,
                   eos_id=9)
    sched2.submit(req2)
    sched2.run()
    assert req2.generated == [9] and req2.finish_reason == "eos"


def test_submit_validation():
    sched = _fake_sched(n_slots=1, max_seq_len=16)
    with pytest.raises(ValueError, match="exceeds page size"):
        sched.submit(Request(rid=0, prompt=np.zeros(10, np.int32),
                             max_new_tokens=7))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(Request(rid=1, prompt=np.zeros(4, np.int32),
                             max_new_tokens=0))
    with pytest.raises(ValueError, match="top_k"):
        sched.submit(Request(rid=2, prompt=np.zeros(4, np.int32),
                             max_new_tokens=2,
                             sampling=SamplingParams(top_k=8)))
    with pytest.raises(ValueError, match="top_p"):
        sched.submit(Request(rid=3, prompt=np.zeros(4, np.int32),
                             max_new_tokens=2,
                             sampling=SamplingParams(top_p=0.9)))


def test_top_p_pool_admission_and_streams():
    sched = _fake_sched(n_slots=2, top_p=0.9)
    ok = Request(rid=0, prompt=np.zeros(5, np.int32), max_new_tokens=4,
                 sampling=SamplingParams(top_p=0.9))
    default = Request(rid=1, prompt=np.zeros(7, np.int32), max_new_tokens=4)
    sched.submit(ok)
    sched.submit(default)
    with pytest.raises(ValueError, match="top_p"):
        sched.submit(Request(rid=2, prompt=np.zeros(3, np.int32),
                             max_new_tokens=2,
                             sampling=SamplingParams(top_p=0.5)))
    sched.run()
    assert ok.generated == _expected(5, 4)
    assert default.generated == _expected(7, 4)


def test_slot_allocator_contract():
    al = SlotAllocator(3)
    a, b = al.acquire(), al.acquire()
    assert (a, b) == (0, 1) and al.n_occupied == 2
    al.release(a)
    with pytest.raises(ValueError, match="double-freed"):
        al.release(a)
    assert al.acquire() == 2 and al.acquire() == 0 and al.acquire() is None


def test_poisson_trace_shape_and_sessions():
    plain = poisson_trace(10, rate=0.5, prompt_lens=(4, 12),
                          max_new_tokens=8, vocab_size=100, seed=3)
    arr = [r.arrival for r in plain]
    assert arr == sorted(arr) and all(a > 0 for a in arr)
    assert all(4 <= len(r.prompt) <= 12 for r in plain)
    assert len({r.rid for r in plain}) == 10
    tagged = poisson_trace(10, rate=0.5, prompt_lens=(4, 12),
                           max_new_tokens=8, vocab_size=100, seed=3,
                           n_sessions=3)
    assert all(r.session is None for r in plain)
    assert all(r.session in {"s0", "s1", "s2"} for r in tagged)
    for a, b in zip(plain, tagged):
        assert (a.prompt == b.prompt).all() and a.arrival == b.arrival


def test_per_request_latency_stats():
    sched = _fake_sched(n_slots=1)
    r0 = Request(rid=0, prompt=np.zeros(3, np.int32), max_new_tokens=4)
    r1 = Request(rid=1, prompt=np.zeros(5, np.int32), max_new_tokens=4)
    sched.submit(r0)
    sched.submit(r1)
    stats = sched.run()
    recs = {r["rid"]: r for r in sched.request_latencies()}
    assert set(recs) == {0, 1}
    assert recs[0]["admission_wait"] == 0.0
    assert recs[1]["admission_wait"] > 0.0
    for r in recs.values():
        assert r["ttft"] == r["admission_wait"]
        assert r["e2e"] >= r["ttft"] and r["tokens"] == 4
    lat = stats["latency"]
    assert lat["n"] == 2
    assert lat["admission_wait_p50"] == 0.0
    assert lat["admission_wait_p99"] == recs[1]["admission_wait"]
    assert lat["e2e_p50"] <= lat["e2e_p99"]
    assert _pct([], 50.0) == 0.0
    assert _pct([3.0, 1.0, 2.0], 50.0) == 2.0
    assert _pct([3.0, 1.0, 2.0], 99.0) == 3.0
    assert latency_summary([])["n"] == 0.0


def test_fleet_hooks_eject():
    """``eject_waiting`` hands back the un-admitted queue; ``eject_all``
    also the in-flight requests, each with its generated prefix folded
    into the prompt, so a replay continues the stream."""
    sched = _fake_sched(n_slots=1)
    reqs = [Request(rid=i, prompt=np.zeros(3 + i, np.int32),
                    max_new_tokens=6) for i in range(3)]
    for r in reqs:
        sched.submit(r)
    sched.step()
    sched.step()
    assert sched.n_running == 1 and sched.n_waiting == 2
    assert [r.rid for r in sched.eject_waiting()] == [1, 2]
    out = sched.eject_all()
    assert [r.rid for r in out] == [0] and sched.n_running == 0
    assert len(out[0].prompt) == 3 + len(out[0].generated)
    replay = _fake_sched(n_slots=1)
    replay.submit(out[0])
    replay.run()
    assert out[0].finished and len(out[0].generated) == 6


def test_serve_cli_on_cpu_and_refuses_without_cuda(capsys):
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                "--prompt-len-min", "8", "--prompt-len-max", "40", "--max-new",
                "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "finished 3/3" in out and "kernel launches" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--reduced", "--requests", "1"])
