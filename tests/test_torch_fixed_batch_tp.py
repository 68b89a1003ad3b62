"""The fixed-batch serving loop over TP ranks (``launch.serve``'s
``fixed_batch_steps`` / ``run_fixed_batch`` with ``tp > 1``:
``transformer.prefill_tp`` and ``decode_step_tp`` on a state laid out by
``serve.engine.cache_layout``) against the JAX package's serve functions
under a ``(1, 2)`` mesh, on the CPU.

The JAX side runs once, in two subprocesses at once (2 CPU devices each,
a plain ``Mesh`` of ``("data", "model")`` = ``(1, 2)``, as the
reference's fixed-batch loop runs ``make_serve_fns``' ``prefill`` and
``decode`` under its mesh) and hands its outputs over as ``.npz`` files;
weights cross through ``interop``.  The configs are the reduced ones,
float32 weights and float32 caches (so no bf16 rounding flip of a cache
entry blurs a comparison):

  * zamba2-2.7b, xlstm-125m and musicgen-medium (frames) at d_model 64:
    pure_sp, every recurrent layer run once on the gathered sequence;
  * zamba2-2.7b and xlstm-125m at d_model 1024: megatron_sp, Mamba2's
    heads, mLSTM's heads and sLSTM's units split over the 2 ranks, their
    decode states so split;
  * phi3.5-moe: a prefill of 32 tokens over 2 ranks takes expert
    parallelism (``moe._moe_ep``), as the reference's does
    (``moe.py:108``), and decode (T = 1) the dense path.  At the config's
    capacity factor EP drops other tokens than the one-rank dense path
    (its capacity is per source and destination rank), in the reference
    as in the port, so its one-rank comparisons run out of the drop
    regime (capacity factor 8: no token dropped either way).

Held: ``prefill`` of 32 tokens and 3 decode steps (each step's input the
reference's greedy token, or its frames): the logits and the decode
state in the global layout, after the prefill and after the last step,
within ``MODEL_TOL``; the port's one-rank run of the same inputs within
``MODEL_TOL`` of its TP run; ``run_fixed_batch``'s greedy tokens at tp 2
equal to the reference's loop and to the port's one-rank loop.  The
reference's first decode write lands clamped in the page's last slot
(ROADMAP.md section C): the TP decode writes there too.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import tree as TR
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as LS
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TF
from repro_torch.serve import engine as E
from repro_torch.serve import kvcache as KV


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread for this module, restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: tag -> (arch, replacements of its reduced config)
CASES = {
    "zamba2": ("zamba2-2.7b", {}),
    "zamba2_mega": ("zamba2-2.7b", dict(d_model=1024)),
    "xlstm": ("xlstm-125m", {}),
    "xlstm_mega": ("xlstm-125m", dict(d_model=1024)),
    "phi35moe": ("phi3.5-moe-42b-a6.6b", {}),
    "musicgen": ("musicgen-medium", {}),
}
#: the two JAX subprocesses, run at once
GROUPS = (("zamba2", "zamba2_mega", "musicgen"),
          ("xlstm", "xlstm_mega", "phi35moe"))
TP = 2
#: batch, prompt length, decode steps, the prompt's seed
B, T_PROMPT, N_DECODE, SEED = 2, 32, 3, 3
#: float32 logits and states (rtol, atol; the atol scaled by the array's
#: largest |value| where that is above 1, see ``_close``)
MODEL_TOL = (1e-4, 1e-5)

CODE = r"""
import os
os.environ["REPRO_OBS"] = "0"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import base
from repro.models import transformer as T
from repro.serve.engine import ServeConfig, make_serve_fns

out = {{}}
B, L, ND, SEED, TP = {b!r}, {t!r}, {nd!r}, {seed!r}, {tp!r}
mesh = Mesh(np.asarray(jax.devices()[:TP]).reshape(1, TP), ("data", "model"))


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def state(tag, st):
    for j, leaf in enumerate(jax.tree.leaves(st["segments"])):
        out[f"{{tag}}_{{j}}"] = f32(leaf)


for i, (tag, (arch, kw)) in enumerate({cases!r}.items()):
    cfg = base.reduced(base.get_config(arch)).replace(
        dtype="float32", cache_dtype="float32", **kw)
    params = jax.jit(lambda k: T.init_params(k, cfg))(jax.random.key(i))
    for j, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{{tag}}_param_{{j}}"] = f32(leaf)
    fns = make_serve_fns(cfg, ServeConfig(), mesh, B, L + ND)
    r = np.random.RandomState(SEED)        # run_fixed_batch's draws
    if cfg.frontend:
        prompt = np.asarray(r.randn(B, L, cfg.frontend_dim), np.float32)
    else:
        prompt = r.randint(0, cfg.vocab_size, size=(B, L)).astype(np.int32)
    out[tag + "_prompt"] = prompt
    with set_mesh(mesh):
        lg, st = fns.prefill(params, jnp.asarray(prompt))
        out[tag + "_prefill"] = f32(lg)
        state(tag + "_st_pre", st)
        toks = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        outs = [np.asarray(toks)]
        for s in range(ND):
            step_in = (jnp.asarray(r.randn(B, 1, cfg.frontend_dim),
                                   jnp.float32) if cfg.frontend else toks)
            out[f"{{tag}}_in_{{s}}"] = np.asarray(step_in)
            lg, st = fns.decode(params, st, step_in)
            out[f"{{tag}}_decode_{{s}}"] = f32(lg)
            toks = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            outs.append(np.asarray(toks))
        state(tag + "_st_dec", st)
    out[tag + "_tokens"] = np.concatenate(outs, axis=1)
np.savez({path!r}, **out)
print("JAX_OK")
"""


def _cfg(tag):
    arch, kw = CASES[tag]
    return tbase.reduced(tbase.get_config(arch)).replace(
        dtype="float32", cache_dtype="float32", **kw)


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_fixed_tp")
    jobs = [CODE.format(b=B, t=T_PROMPT, nd=N_DECODE, seed=SEED, tp=TP,
                        cases={t: CASES[t] for t in g},
                        path=str(tmp / f"g{i}.npz"))
            for i, g in enumerate(GROUPS)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(subproc, code, 2, 600) for code in jobs]:
            f.result()
    out = {}
    for i in range(len(GROUPS)):
        out.update(np.load(tmp / f"g{i}.npz"))
    return out


def _params(out, tag, cfg):
    shapes = TF.param_shapes(cfg)
    n = len(TR.flatten(shapes))
    return params_from_numpy(TR.unflatten(
        shapes, [out[f"{tag}_param_{i}"] for i in range(n)]), cfg, "cpu")


def _close(got, exp, what, tol=MODEL_TOL):
    rtol, atol = tol
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy(), exp, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(exp).max())), err_msg=what)


def _close_state(st, out, key, what):
    leaves = TR.flatten(st["segments"])
    assert len(leaves) == len([k for k in out if k.startswith(key + "_")])
    for j, leaf in enumerate(leaves):
        _close(leaf, out[f"{key}_{j}"], f"{what} leaf {j}")


def _runs(out, tag):
    """The port's TP run and one-rank run of the reference's inputs: each
    a list of logits (prefill, then every decode step) and the TP run's
    global states after the prefill and after the last step."""
    cfg = _cfg(tag)
    params = _params(out, tag, cfg)
    prompt = torch.from_numpy(out[tag + "_prompt"])
    ins = [torch.from_numpy(out[f"{tag}_in_{s}"]) for s in range(N_DECODE)]
    lay = E.cache_layout(cfg, B, T_PROMPT, 1, TP)
    with torch.no_grad():
        blocks, g = TF.prefill_tp(params, cfg, prompt, TP)
        tp_logits = [TF.vocab_logits(blocks, cfg.vocab_size)]
        pre = {"segments": TR.tree_map(torch.clone, g["segments"])}
        st = KV.state_from_global(cfg, g, lay)
        for x in ins:
            blocks, st = TF.decode_step_tp(params, cfg, st, x, lay)
            tp_logits.append(TF.vocab_logits(blocks, cfg.vocab_size))
        dec = KV.state_to_global(cfg, st, lay)
        lg, st1 = TF.prefill(params, cfg, prompt)
        one = [lg]
        for x in ins:
            lg, st1 = TF.decode_step(params, cfg, st1, x)
            one.append(lg)
    return tp_logits, one, pre, dec, st, lay


@pytest.mark.parametrize("tag", list(CASES))
def test_prefill_decode_match_jax(jax_out, tag):
    """Prefill of 32 tokens (frames) and 3 decode steps over 2 TP ranks:
    logits and the global decode state against the reference's (1, 2)
    serve functions; the port's one-rank run within the same tolerance."""
    cfg = _cfg(tag)
    tp_logits, one, pre, dec, _, _ = _runs(jax_out, tag)
    keys = ["prefill"] + [f"decode_{s}" for s in range(N_DECODE)]
    for k, got, ref in zip(keys, tp_logits, one):
        _close(got, jax_out[f"{tag}_{k}"], f"{tag} {k}")
        if not cfg.n_experts:   # (MoE: test_moe_tp_equals_one_rank_...)
            _close(got, ref.numpy(), f"{tag} {k} against one rank")
    _close_state(pre, jax_out, f"{tag}_st_pre", f"{tag} prefill state")
    _close_state(dec, jax_out, f"{tag}_st_dec", f"{tag} decode state")


@pytest.mark.parametrize("tag", list(CASES))
def test_run_fixed_batch_tokens_match_jax_and_one_rank(jax_out, tag):
    """``run_fixed_batch`` at tp 2: its greedy tokens equal the
    reference's loop under its (1, 2) mesh and the port's one-rank
    loop's."""
    cfg = _cfg(tag)
    params = _params(jax_out, tag, cfg)
    got = {tp: LS.run_fixed_batch(cfg, params, B, T_PROMPT, N_DECODE + 1,
                                  seed=SEED, device="cpu", tp=tp)[0]
           for tp in (TP, 1)}
    np.testing.assert_array_equal(got[TP], jax_out[tag + "_tokens"])
    if not cfg.n_experts:       # (MoE: test_moe_tp_equals_one_rank_...)
        np.testing.assert_array_equal(got[TP], got[1])


def test_moe_tp_equals_one_rank_out_of_the_drop_regime(jax_out):
    """phi3.5-moe with a capacity factor of 8 (no token dropped by either
    path): the EP prefill over 2 ranks and the decode steps give the
    one-rank run's logits, and ``run_fixed_batch`` its tokens."""
    cfg = _cfg("phi35moe").replace(capacity_factor=8.0)
    params = _params(jax_out, "phi35moe", cfg)
    prompt = torch.from_numpy(jax_out["phi35moe_prompt"])
    lay = E.cache_layout(cfg, B, T_PROMPT, 1, TP)
    with torch.no_grad():
        blocks, g = TF.prefill_tp(params, cfg, prompt, TP)
        lg, st1 = TF.prefill(params, cfg, prompt)
        _close(TF.vocab_logits(blocks, cfg.vocab_size), lg.numpy(), "prefill")
        st = KV.state_from_global(cfg, g, lay)
        tok = torch.argmax(lg, dim=-1)
        for s in range(N_DECODE):
            blocks, st = TF.decode_step_tp(params, cfg, st, tok, lay)
            lg, st1 = TF.decode_step(params, cfg, st1, tok)
            _close(TF.vocab_logits(blocks, cfg.vocab_size), lg.numpy(),
                   f"decode {s}")
            tok = torch.argmax(lg, dim=-1)
    got = [LS.run_fixed_batch(cfg, params, B, T_PROMPT, N_DECODE + 1,
                              seed=SEED, device="cpu", tp=tp)[0]
           for tp in (TP, 1)]
    np.testing.assert_array_equal(got[0], got[1])


def test_decode_states_split_over_the_ranks(jax_out):
    """The decode state's layout over 2 TP ranks: megatron_sp splits
    Mamba2's conv ``x`` ``[B, K-1, din/n]`` and state ``[B, nh/n, hd,
    ds]`` (conv ``B``/``C`` whole on every rank), mLSTM's ``C``/``n``/``m``
    by heads and sLSTM's ``c``/``n``/``h``/``m`` by units; pure_sp holds
    them whole, once; the shared attention's K/V split over the page's
    slots.  ``state_to_global`` inverts ``state_from_global``."""
    for tag in ("zamba2_mega", "xlstm_mega", "xlstm"):
        cfg = _cfg(tag)
        *_, st, lay = _runs(jax_out, tag)
        for (block, nl), seg, l in zip(TF.segments(cfg), st["segments"],
                                       lay):
            d, n = cfg.d_model, TP
            if block.kind == "mamba2":
                din = cfg.ssm_expand * d
                nh = din // cfg.ssm_head_dim
                assert l.kv == "heads"
                assert seg["conv"]["x"].shape == (nl, n, B,
                                                  cfg.ssm_conv - 1, din // n)
                assert seg["conv"]["B"].shape == (nl, n, B, cfg.ssm_conv - 1,
                                                  cfg.ssm_state)
                assert torch.equal(seg["conv"]["B"][:, 0],
                                   seg["conv"]["B"][:, 1])
                assert seg["ssm"].shape == (nl, n, B, nh // n,
                                            cfg.ssm_head_dim, cfg.ssm_state)
            elif block.kind == "mlstm":
                nh, hd = cfg.n_heads, 2 * d // cfg.n_heads
                want = (nl, n, B, nh // n, hd, hd) if l.kv == "heads" else \
                    (nl, B, nh, hd, hd)
                assert seg["C"].shape == want, tag
                assert seg["m"].shape == want[:-2]
            elif block.kind == "slstm":
                want = (nl, n, B, d // n) if l.kv == "heads" else (nl, B, d)
                assert all(seg[k].shape == want for k in "cnhm"), tag
            else:
                assert l.kv == "seq" and seg["k"].shape[1] == n
                continue
            assert (l.kv == "heads") == (SH.strategy(cfg, n) ==
                                         "megatron_sp"), (tag, block)
        back = KV.state_from_global(cfg, KV.state_to_global(cfg, st, lay),
                                    lay)
        assert all(torch.equal(a, b) for a, b in zip(
            TR.flatten(back["segments"]), TR.flatten(st["segments"])))


def test_serve_cli_runs_the_fixed_batch_loop_over_tp(capsys):
    """``--mesh 1,2`` sends a fixed-batch arch over 2 TP ranks and prints
    its strategy; a data axis above 1 still raises (the loop runs one DP
    rank)."""
    LS.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
             "--mesh", "1,2", "--slots", "2", "--prompt-len-max", "32",
             "--max-new", "3"])
    out = capsys.readouterr().out
    assert "legacy fixed-batch loop over 2 TP ranks (pure_sp)" in out
    assert "sample token ids" in out
    with pytest.raises(ValueError, match="one DP rank"):
        LS.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                 "--mesh", "2,2"])
