"""Remat (``cfg.remat``) on the port: each layer of ``forward`` and
``forward_tp`` rematerialized as the reference's ``jax.checkpoint(body)``
(``models/transformer.py`` ``_remat``), on the CPU.

  * Two train steps (``pallas_fused``, float32, 64 KiB buckets) with remat
    on and off from the same start give the same bits: the loss and grad
    norm of each step, rank 0's gradients of the first step and the whole
    state after the second.  Cases: reduced phi4-mini at tp 1 and the
    megatron_sp width at (2, 2), mixtral at (2, 2) with expert
    parallelism, zamba2 (Mamba2 and the shared block, whose firings stay
    outside the checkpoint), xlstm (mLSTM and sLSTM) and musicgen on
    frames.  ``reduced`` turns remat off, so each case sets it.
  * The obs registry after the two steps is the same with remat on and
    off: a layer's recompute records no collective a second time (the EP
    all_to_all among them).
  * The bytes autograd saves for the backward of one rank's loss are
    fewer with remat: it acts.
  * The port with remat against the reference with remat (reduced
    phi4-mini, in process) within ``tests/test_torch_model.py``'s bounds.
  * ``launch/profile_step.py``'s MoE split keeps the recompute apart from
    the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import sharding as jsh
from repro.models import transformer as JT
from repro_torch import tree as TR
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy
from repro_torch.launch import cell
from repro_torch.launch import profile_step as PS
from repro_torch.models import moe as M
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TF
from repro_torch.obs import metrics as OM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as ST
from repro_torch.train.data import DataConfig, make_batch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops (the recurrent loops, the MoE dispatch): one
    intra-op thread for this module, as tests/test_torch_moe.py and
    tests/test_torch_ssm.py run, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _red(arch):
    return tbase.reduced(tbase.get_config(arch)).replace(dtype="float32")


#: case -> (model config without remat, DP ranks, TP ranks)
CASES = {
    "phi4_tp1": (_red("phi4-mini-3.8b"), 2, 1),
    "phi4_megatron_22": (cell.tp_small_config(), 2, 2),
    "mixtral_ep_22": (_red("mixtral-8x7b"), 2, 2),
    "zamba2": (_red("zamba2-2.7b"), 2, 1),
    "xlstm": (_red("xlstm-125m"), 2, 1),
    "musicgen_frames": (_red("musicgen-medium"), 2, 1),
}
STEPS = 2
BATCH, SEQ = 4, 32


def _cfg(case, remat):
    cfg, dp, tp = CASES[case]
    return cfg.replace(remat=remat), dp, tp


def _dcfg(cfg):
    return DataConfig(global_batch=BATCH, seq_len=SEQ,
                      vocab_size=cfg.vocab_size,
                      frontend_dim=cfg.frontend_dim if cfg.frontend else 0)


def _tcfg():
    return ST.TrainConfig(backend="pallas_fused", wire_dtype="float32",
                          bucket_bytes=1 << 16,
                          adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                            total_steps=100))


def _batch(cfg, s, rows=None):
    b = {k: torch.from_numpy(v) for k, v in make_batch(_dcfg(cfg), s).items()}
    return b if rows is None else {k: v[:rows] for k, v in b.items()}


def _tensors(x):
    """Every tensor of a nested state, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _run(case, remat):
    """Two steps of ``case``: (the metrics of each step, rank 0's
    gradients on its shard of the first batch, every tensor of the params
    and state after the last step, the obs registry's snapshot)."""
    cfg, dp, tp = _cfg(case, remat)
    tcfg = _tcfg()
    prev = OM.set_enabled(True)
    OM.get_registry().reset()
    try:
        step, _, _ = ST.make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg),
                                        "cpu", tp=tp)
        init_p, init_s = ST.make_init_fns(cfg, tcfg, dp, "cpu", tp=tp)
        params = init_p(0)
        state = init_s(params)
        grads, _ = ST._rank_grads(cfg, tcfg, params[0],
                                  _batch(cfg, 0, BATCH // dp), tp)
        metrics = []
        for s in range(STEPS):
            params, state, m = step(params, state, _batch(cfg, s))
            metrics.append({k: m[k] for k in ("loss", "grad_norm")})
        snap = OM.get_registry().snapshot()
    finally:
        OM.get_registry().reset()
        OM.set_enabled(prev)
    return metrics, grads, _tensors(params) + _tensors(state), snap


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_is_bitwise(case):
    """Remat on and off: the same bits for each step's loss and grad
    norm, rank 0's step-1 gradients and the state after step 2, and the
    same obs registry."""
    cfg, _, tp = _cfg(case, True)
    if case == "phi4_megatron_22":
        assert SH.strategy(cfg, tp) == "megatron_sp"
    if case == "mixtral_ep_22":
        assert M.use_ep(cfg, tp, SEQ)
    off, on = _run(case, False), _run(case, True)
    for s, (a, b) in enumerate(zip(off[0], on[0])):
        for k in a:
            assert torch.equal(a[k], b[k]), (case, s, k, a[k], b[k])
    assert len(off[1]) == len(on[1])
    for i, (a, b) in enumerate(zip(off[1], on[1])):
        assert torch.equal(a, b), (case, "grad", i)
    assert len(off[2]) == len(on[2])
    for i, (a, b) in enumerate(zip(off[2], on[2])):
        assert torch.equal(a, b), (case, "state", i)
    assert off[3] == on[3]
    if case == "mixtral_ep_22":
        calls = [r["value"] for r in on[3]["counters"]
                 if r["name"] == "collective_calls" and
                 r["labels"].get("collective") == "alltoall"]
        # the dispatch, its block ids and the combine, a layer, each DP
        # rank of each step and rank 0's gradients
        assert sum(calls) == 3 * cfg.n_layers * (2 * STEPS + 1)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_saves_fewer_bytes_for_backward(case):
    """One DP rank's loss: autograd saves fewer bytes with remat on, for
    every layer's activations are recomputed in place of kept."""
    cfg, dp, tp = _cfg(case, False)
    params = TF.init_params(cfg, 0, "cpu")
    if tp > 1:
        params = SH.shard_params(cfg, params, tp)
    batch = _batch(cfg, 0, BATCH // dp)
    off = PS.saved_for_backward(cfg, params, batch, tp)
    on = PS.saved_for_backward(cfg.replace(remat=True), params, batch, tp)
    assert 0 < on < off, (case, on, off)


def test_remat_matches_the_reference_with_remat():
    """Reduced phi4-mini with remat on in both packages (the reference's
    ``jax.checkpoint`` over its scan): logits and loss within rtol 1e-4,
    atol 1e-5, gradients within rtol 1e-3, atol 1e-5, the bounds of
    tests/test_torch_model.py."""
    jsh.set_model_parallel(1)
    jcfg = jbase.reduced(jbase.get_config("phi4-mini-3.8b")).replace(
        dtype="float32", remat=True)
    tcfg = _red("phi4-mini-3.8b").replace(remat=True)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    b = make_batch(DataConfig(global_batch=2, seq_len=64,
                              vocab_size=jcfg.vocab_size), 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    leaves = [x.requires_grad_(True) for x in TR.flatten(tp)]
    tree = TR.unflatten(tp, leaves)
    tloss, _ = TF.loss_fn(tree, tcfg, tb)
    tg = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-5)
    for a, b_ in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-3,
                                   atol=1e-5)
    with torch.no_grad():
        tl = TF.forward(tp, tcfg, tb["inputs"])[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(
        JT.forward(jp, jcfg, jb["inputs"])[0]), rtol=1e-4, atol=1e-5)


def test_moe_split_keeps_the_recompute_apart():
    """``profile_step.moe_split`` on a CPU profile of one EP loss and its
    backward (mixtral at (2, 2)): with remat every phase's forward reads
    as without it, and the recompute, run inside the backward, has its own
    keys."""
    cfg, dp, tp = _cfg("mixtral_ep_22", False)
    params = SH.shard_params(cfg, TF.init_params(cfg, 0, "cpu"), tp)
    batch = _batch(cfg, 0, BATCH // dp)
    split = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        leaves = [x.detach().requires_grad_(True)
                  for x in TR.flatten(params)]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            loss, _ = TF.loss_fn(TR.unflatten(params, leaves), c, batch,
                                 n_model=tp)
            torch.autograd.grad(loss.mean(), leaves, allow_unused=True)
        split[remat] = PS.moe_split(prof.events(), "cpu_time_total")
    fwd = {r: {n for n in split[r] if n.endswith(" fwd")}
           for r in (False, True)}
    assert fwd[False] == fwd[True] == {f"{p} fwd" for p in M.PHASES}
    assert not any(n.endswith(" recompute") for n in split[False])
    assert f"{M.PHASES[0]} recompute" in split[True], split[True]
