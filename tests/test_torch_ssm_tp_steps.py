"""Train steps of the recurrent configs over TP ranks: two ``pallas_fused``
steps at (dp, tp) = (2, 2) on the port against the JAX package's GSPMD
step, on the CPU.

The configs are ``tests/test_torch_ssm_tp.py``'s (reduced, float32, cut in
depth): zamba2-2.7b at d_model 1024 (megatron_sp), xlstm-125m at 64
(pure_sp) and at 1024 (megatron_sp).  Both packages start from the port's
``init_params`` (seed 0).  The JAX side runs once, in three subprocesses
(4 CPU devices each, a plain ``Mesh``), each the reference's ``bine`` step
(its float32 backends give the same bits), handing its outputs over as
``.npz`` files; the port's runs go meanwhile.  Held:

  * step 1's loss and grad norm rtol 1e-4;
  * the state after step 1 within ``tests/test_torch_tp.py``'s
    ``BOUNDS`` (all but 0.1% of the elements within the tight bound),
    with the allowance of ROADMAP.md section C for xlstm: a weight whose
    step-1 gradient is of the order of AdamW's eps (below 100 eps, by the
    port's m) takes a first update ``lr g / (|g| + eps)`` that float32
    rounding of g moves by a large share of itself, up to its sign, so
    its param and master are held to two AdamW steps, 2 lr (xlstm at
    1024 reads 1.10 lr), in place of the loose bound;
  * step 2's loss and grad norm from the reference's own step-1 state
    rtol 1e-4, and the port's own step 2: its loss rtol 1e-4, its grad
    norm within ``test_torch_ssm.py``'s ``STEP2_GNORM_RTOL`` (the
    allowance's weights enter step 2 apart and the exponential gates
    amplify that), xlstm at 1024 within ``STEP2_GNORM_WIDE``;
  * ``bine`` bitwise ``pallas_fused`` after a step (zamba2 and xlstm at
    64: the wire's property, whatever the model's width).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import tree as TR
from repro_torch.interop import params_from_numpy, train_state_to_numpy
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import TrainConfig, make_init_fns, make_train_step
from test_torch_ssm import STEP2_GNORM_RTOL
from test_torch_ssm_tp import CFGS, PRELUDE, _cfg, _tp_grads
from test_torch_tp import BOUNDS, _mostly_close

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread for this module, restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: train runs at (2, 2), each the config of its name; each its subprocess
RUNS = ("zamba2_mega", "xlstm", "xlstm_mega")
#: (32 tokens: at 16, from the reference's own initial params, xlstm's
#: 1024-wide step 2 read a grad norm of ~1.2e3, where the port's one-rank
#: float32 gradient was 3e-3 and its TP one 1e-2 from float64: no float32
#: order matches another there)
STEPS, LR, SEQ, GB = 2, 3e-3, 32, 4
#: the port's own step-2 grad norm against the reference's at 1024 wide,
#: rtol: xlstm reads 1.1e-2 there (its allowance's weights through
#: 1024-wide exponential gates: the port's own (2, 1) and (2, 2) runs
#: from one start read step-2 grad norms 0.7% apart); about 1.5x that
STEP2_GNORM_WIDE = {"xlstm_mega": 1.7e-2}


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """The reference's runs (``.npz`` contents) and the port's: each run's
    (pallas_fused, bine) results of :func:`_run`, bine None at 1024."""
    tmp = tmp_path_factory.mktemp("jax_ssm_tp_steps")
    init = {tag: TF.init_params(_cfg(tag), 0, "cpu") for tag in RUNS}
    np.savez(tmp / "init.npz", **{f"{tag}_{i}": x.numpy() for tag in RUNS
                                  for i, x in enumerate(TR.flatten(
                                      init[tag]))})
    jobs = [PRELUDE.format(cfgs=CFGS, fwd={}, runs=[tag], b=0, t=0, seq=SEQ,
                           gb=GB, lr=LR, steps=STEPS,
                           init=str(tmp / "init.npz"),
                           path=str(tmp / f"{tag}.npz")) for tag in RUNS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = [pool.submit(subproc, code, 4, 600) for code in jobs]
        port = {tag: (_run(init[tag], tag, "pallas_fused"),
                      None if tag == "xlstm_mega" else
                      _run(init[tag], tag, "bine", steps=1))
                for tag in RUNS}
        for f in futs:
            f.result()
    out = {}
    for tag in RUNS:
        out.update(np.load(tmp / f"{tag}.npz"))
    return out, port


def _tcfg(backend):
    return TrainConfig(backend=backend, bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr=LR, warmup_steps=1,
                                         total_steps=100))


def _run(init, tag, backend, steps=STEPS):
    """The port's (2, 2) run from the global params ``init``: (the
    metrics of each step, the global numpy state after step 1)."""
    cfg, tcfg = _cfg(tag), _tcfg(backend)
    step, info, _ = make_train_step(cfg, tcfg, 2, TF.param_shapes(cfg), "cpu",
                                    tp=2)
    assert info["bucket_plan"] is not None
    one = SH.shard_params(cfg, init, 2)
    params = [TR.tree_map(torch.clone, one) for _ in range(2)]
    state = make_init_fns(cfg, tcfg, 2, "cpu", tp=2)[1](params)
    dcfg = DataConfig(global_batch=GB, seq_len=SEQ, vocab_size=cfg.vocab_size)
    metrics, glob = [], None
    for s in range(steps):
        params, state, m = step(params, state, make_batch(dcfg, s))
        metrics.append(m)
        if s == 0:
            glob = train_state_to_numpy(cfg, tcfg, params, state, 2, tp=2)
    return metrics, glob


def _check_state(glob, jax_out, tag):
    """The global state after step 1 within BOUNDS, a weight with a step-1
    gradient below 100 AdamW eps held to 2 lr (the module docstring)."""
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
            assert d[t].max(initial=0.0) <= max(loose, 2 * LR), (tag, k)
            n += d.size
            n_out += int((d > tight).sum())
        assert n_out <= 1e-3 * n, (tag, k, n_out, n)


@pytest.mark.parametrize("tag", RUNS)
def test_tp_train_steps_match_jax(runs, tag):
    """Two pallas_fused steps at (2, 2) against the reference's (the
    module docstring); ``bine`` bitwise ``pallas_fused`` after a step
    (but at 1024 wide)."""
    jax_out, port = runs
    (metrics, glob), bine = port[tag]
    for s, m in enumerate(metrics):
        for k in ("loss", "grad_norm"):
            rtol = STEP2_GNORM_WIDE.get(tag, STEP2_GNORM_RTOL) \
                if (s, k) == (1, "grad_norm") else 1e-4
            np.testing.assert_allclose(float(m[k]), jax_out[f"{tag}_{k}_{s}"],
                                       rtol=rtol, err_msg=f"{tag} {s} {k}")
    _check_state(glob, jax_out, tag)
    cfg = _cfg(tag)
    shapes = TF.param_shapes(cfg)
    at = params_from_numpy(TR.unflatten(shapes, [
        jax_out[f"{tag}_param_{i}"] for i in range(len(TR.flatten(shapes)))]),
        cfg, "cpu")
    batch = make_batch(DataConfig(global_batch=GB, seq_len=SEQ,
                                  vocab_size=cfg.vocab_size), 1)
    grads, loss = None, 0.0
    for r in range(2):        # each DP rank's shard, its TP group's grads
        shard = {k: torch.as_tensor(v).chunk(2)[r] for k, v in batch.items()}
        lr_, g = _tp_grads(cfg, at, shard, 2)
        g = TR.flatten(g)
        loss += float(lr_[0]) / 2
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    gnorm = float(torch.sqrt(sum((g / 2).square().sum() for g in grads)))
    np.testing.assert_allclose(loss, jax_out[f"{tag}_loss_1"], rtol=1e-4,
                               err_msg=tag)
    np.testing.assert_allclose(gnorm, jax_out[f"{tag}_grad_norm_1"],
                               rtol=1e-4, err_msg=tag)
    if bine is None:
        return
    for a, b in zip(TR.flatten(bine[1]["params"]), TR.flatten(glob["params"])):
        np.testing.assert_array_equal(a, b)
