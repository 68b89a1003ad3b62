"""The port's restartable train loop (``repro_torch.train.runtime``), its
``Prefetcher`` and the train CLI's checkpoint flags.

  * mirrors of the reference's tests: the straggler monitor, restart after
    a failure, the elastic re-mesh on a permanent one, too many restarts
    (``tests/train/test_runtime.py``), the prefetcher's order
    (``tests/train/test_data.py``), and the loop's step histogram and
    spans (``tests/obs/test_runtime_integration.py``), on the same toy
    builder, with the reference's loop run beside the port's: the same
    histories;
  * the port's trainer (reduced phi4-mini, float32, 4 stacked ranks,
    ``pallas_fused`` on the CPU): a transient failure resumes bitwise
    equal to an uninterrupted run; a permanent one halves p from 4 to 2
    and its later losses are those of a fresh p = 2 run restored from
    the same checkpoint;
  * ``launch/train.py --ckpt-dir D --ckpt-every 2 --steps 4`` then
    ``--resume --steps 6`` continues from step 4 with the losses of an
    uninterrupted 6-step run.
"""

import contextlib
import io

import numpy as np
import pytest

from repro.obs import metrics as jmetrics
from repro.train import data as jdata
from repro.train import runtime as jrt
from repro_torch.configs import base
from repro_torch.obs import metrics, timeline
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, Prefetcher, make_batch
from repro_torch.train.runtime import (DeviceFailure, FailureInjector,
                                       StragglerMonitor, TrainLoop,
                                       TrainLoopConfig, shrunk_dp,
                                       train_build)
from repro_torch.train.step import TrainConfig
from torch_threads import pin_threads  # noqa: F401


@pytest.fixture
def fresh_obs(monkeypatch):
    """An empty, enabled default registry and timeline (restored after)."""
    reg, tl = metrics.Registry(), timeline.Timeline()
    monkeypatch.setattr(metrics, "_REGISTRY", reg)
    monkeypatch.setattr(timeline, "_TIMELINE", tl)
    monkeypatch.setattr(metrics, "_ENABLED", True)
    return reg, tl


def test_straggler_monitor():
    m = StragglerMonitor(alpha=0.5, ratio=2.0, warmup=2)
    for s in range(6):
        assert not m.observe(s, 0.1)
    assert m.observe(6, 0.5)            # 5x the EWMA -> flagged
    assert not m.observe(7, 0.1)
    assert len(m.flagged) == 1
    a = StragglerMonitor(alpha=0.3, ratio=1.5, warmup=1)
    j = jrt.StragglerMonitor(alpha=0.3, ratio=1.5, warmup=1)
    for s, dt in enumerate(np.random.RandomState(0).exponential(0.1, 50)):
        assert a.observe(s, float(dt)) == j.observe(s, float(dt))
    assert a.flagged == j.flagged and a.ewma == j.ewma


class _ToyBuilder:
    """Quadratic toy model: deterministic, mesh-free, exercises the loop
    (the reference test's builder).  For the port's loop (``port``) it
    adds the global-layout pair, here the identity: the toy's state is
    already global."""

    def __init__(self, port=True):
        self.builds = 0
        self.port = port

    def __call__(self, shrink):
        self.builds += 1
        lr = 0.1

        def step(params, state, batch):
            x, y = batch
            w = params["w"]
            grad = 2 * (w * x - y) * x
            w2 = w - lr * grad.mean()
            return ({"w": w2}, {"step": state["step"] + 1},
                    {"loss": ((w * x - y) ** 2).mean()})

        def init_p(key):
            return {"w": np.float32(0.0)}

        def init_s(params):
            return {"step": np.int32(0)}

        def data_at(s):
            rng = np.random.RandomState(s)
            x = rng.randn(32).astype(np.float32)
            return x, 3.0 * x

        fns = (step, init_p, init_s, lambda b: b, data_at)
        if not self.port:
            return fns
        return fns + (
            lambda params, state, device=None: {"params": params,
                                                "state": state},
            lambda tree: (tree["params"], tree["state"]))


def _both(tmp_path, loop_cfg, schedule):
    """The port's loop and the reference's on the toy, same schedule."""
    outs = []
    for pkg, Loop, Cfg, Inj, seed in (
            ("port", TrainLoop, TrainLoopConfig, FailureInjector, 0),
            ("ref", jrt.TrainLoop, jrt.TrainLoopConfig,
             jrt.FailureInjector, None)):
        build = _ToyBuilder(port=pkg == "port")
        loop = Loop(Cfg(ckpt_dir=str(tmp_path / pkg), **loop_cfg), build,
                    Inj(schedule=dict(schedule)))
        with jmetrics.disabled():
            out = loop.run(seed)
        outs.append((out, build.builds))
    (a, na), (b, nb) = outs
    strip = [{k: v for k, v in h.items() if k != "dt"} for h in a["history"]]
    assert strip == [{k: v for k, v in h.items() if k != "dt"}
                     for h in b["history"]]
    assert (a["restarts"], a["shrink"], na) == (b["restarts"], b["shrink"],
                                                nb)
    return a, na


def test_restart_after_failure(tmp_path):
    out, _ = _both(tmp_path, dict(total_steps=15, ckpt_every=5), {7: False})
    assert out["restarts"] == 1
    steps = [h["step"] for h in out["history"]]
    assert steps.count(5) == 2 or steps.count(6) == 2, \
        "should replay from the last checkpoint"
    assert out["history"][-1]["step"] == 14
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]


def test_elastic_remesh_on_permanent_failure(tmp_path):
    out, builds = _both(tmp_path, dict(total_steps=12, ckpt_every=4),
                        {6: True})
    assert out["shrink"] == 1
    assert builds == 2                               # re-built, fewer ranks
    assert out["history"][-1]["step"] == 11


def test_too_many_restarts_raises(tmp_path):
    inj = FailureInjector(schedule={i: False for i in range(1, 12)})
    loop = TrainLoop(TrainLoopConfig(total_steps=10, ckpt_every=100,
                                     ckpt_dir=str(tmp_path), max_restarts=3),
                     _ToyBuilder(), inj)
    with pytest.raises(DeviceFailure):
        loop.run(0)


def test_ckpt_dir_is_required():
    """The port's loop has no shared default checkpoint directory."""
    with pytest.raises(TypeError, match="ckpt_dir"):
        TrainLoopConfig(total_steps=2)
    assert TrainLoopConfig(4, 2, ckpt_dir="d").ckpt_every == 2


def test_prefetcher_order():
    cfg = DataConfig(global_batch=2, seq_len=8, vocab_size=32)
    pf = Prefetcher(cfg, start_step=5)
    try:
        s0, b0 = pf.next()
        s1, b1 = pf.next()
        assert (s0, s1) == (5, 6)
        np.testing.assert_array_equal(b0["inputs"],
                                      make_batch(cfg, 5)["inputs"])
        jb = jdata.make_batch(jdata.DataConfig(global_batch=2, seq_len=8,
                                               vocab_size=32), 6)
        for k in ("inputs", "targets"):
            np.testing.assert_array_equal(b1[k], jb[k])
    finally:
        pf.close()
    assert not pf._t.is_alive()


def test_train_loop_records_step_histogram_and_spans(tmp_path, fresh_obs):
    reg, tl = fresh_obs
    loop = TrainLoop(TrainLoopConfig(total_steps=2, ckpt_every=100,
                                     ckpt_dir=str(tmp_path)), _ToyBuilder())
    loop.run(0)
    hist = reg.histograms[("train_step_seconds", (("shrink", "0"),))]
    assert hist.count == 2
    spans = [e for e in tl.events if e.name == "train_step"]
    assert len(spans) == 2
    assert all(e.lane == "train" and e.dur_us is not None for e in spans)
    assert spans[0].args["step"] == 0 and spans[1].args["step"] == 1


def test_train_loop_obs_disabled_records_nothing(tmp_path, fresh_obs):
    reg, tl = fresh_obs
    loop = TrainLoop(TrainLoopConfig(total_steps=2, ckpt_every=100,
                                     ckpt_dir=str(tmp_path)), _ToyBuilder())
    with metrics.disabled():
        out = loop.run(0)
    assert out["history"][-1]["step"] == 1   # the run itself is unchanged
    assert reg.histograms == {}
    assert len(tl) == 0


# ---------------------------------------------------------------------------
# The port's trainer in the loop
# ---------------------------------------------------------------------------

def _trainer(dp=4):
    cfg = base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32")
    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16)
    dcfg = DataConfig(global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    return train_build(cfg, tcfg, dcfg, dp, device="cpu")


def _losses(out):
    return [(h["step"], h["loss"]) for h in out["history"]]


def test_transient_failure_resumes_bitwise(tmp_path):
    """A failure at step 3 restores step 2's checkpoint and replays step 2:
    every loss and the final checkpoint equal an uninterrupted run's."""
    build = _trainer()
    clean = TrainLoop(TrainLoopConfig(total_steps=5, ckpt_every=2,
                                      ckpt_dir=str(tmp_path / "a")),
                      build).run(0)
    hit = TrainLoop(TrainLoopConfig(total_steps=5, ckpt_every=2,
                                    ckpt_dir=str(tmp_path / "b")),
                    build, FailureInjector({3: False})).run(0)
    assert hit["restarts"] == 1 and hit["shrink"] == 0
    want = dict(_losses(clean))
    assert [s for s, _ in _losses(hit)] == [0, 1, 2, 2, 3, 4]
    assert all(loss == want[s] for s, loss in _losses(hit))
    for d in "ab":
        assert ckpt.latest_step(str(tmp_path / d)) == 5
    fn = tmp_path / "{}" / "step_00000005" / "arrays.npz"
    with np.load(str(fn).format("a")) as a, np.load(str(fn).format("b")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_permanent_failure_halves_p(tmp_path):
    """A permanent failure at step 3 rebuilds the step at p = 2 from step
    2's p = 4 checkpoint; the later losses are those of a fresh p = 2 run
    restored from that same checkpoint."""
    build = _trainer()
    out = TrainLoop(TrainLoopConfig(total_steps=5, ckpt_every=2, keep=5,
                                    ckpt_dir=str(tmp_path / "a")),
                    build, FailureInjector({3: True})).run(0)
    assert out["shrink"] == 1 and out["restarts"] == 1
    late = [(s, loss) for s, loss in _losses(out)[3:]]
    assert [s for s, _ in late] == [2, 3, 4]
    # a fresh p = 2 run restored from the same step-2 checkpoint
    fresh = tmp_path / "b"
    fresh.mkdir()
    import shutil
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    fresh / "step_00000002")
    ref = TrainLoop(TrainLoopConfig(total_steps=5, ckpt_every=2,
                                    ckpt_dir=str(fresh)),
                    _trainer(dp=2)).run(0)
    assert _losses(ref) == late
    assert shrunk_dp(4, 1) == (2,) and shrunk_dp((2, 4), 2) == (2, 1)
    with pytest.raises(ValueError, match="cannot halve"):
        shrunk_dp(2, 2)


def test_transient_failure_resumes_bitwise_under_tp(tmp_path):
    """``train_build`` at (dp, tp) = (2, 2) on ``cell.tp_small_config()``
    (megatron_sp): a failure at step 3 restores step 2's global
    checkpoint into the stacked TP ranks and replays step 2; every loss
    equals the uninterrupted loop's, bit for bit."""
    from repro_torch.launch import cell
    from repro_torch.models import sharding as SH

    cfg = cell.tp_small_config()
    assert SH.strategy(cfg, 2) == "megatron_sp"
    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 20)
    dcfg = DataConfig(global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    build = train_build(cfg, tcfg, dcfg, 2, device="cpu", tp=2)
    # each DP rank's tree is stacked over its 2 TP ranks: the vocab split
    emb = build(0)[1](0)[0]["embed"]
    assert tuple(emb.shape) == (2, cfg.vocab_size // 2, cfg.d_model)
    clean = TrainLoop(TrainLoopConfig(total_steps=4, ckpt_every=2,
                                      ckpt_dir=str(tmp_path / "a")),
                      build).run(0)
    hit = TrainLoop(TrainLoopConfig(total_steps=4, ckpt_every=2,
                                    ckpt_dir=str(tmp_path / "b")),
                    build, FailureInjector({3: False})).run(0)
    assert hit["restarts"] == 1 and hit["shrink"] == 0
    want = dict(_losses(clean))
    assert [s for s, _ in _losses(hit)] == [0, 1, 2, 2, 3]
    assert all(loss == want[s] for s, loss in _losses(hit))
    # the checkpoint is the global layout: whole leaves, no model axis
    with np.load(str(tmp_path / "b" / "step_00000004" / "arrays.npz")) as z:
        assert any(z[k].shape == (cfg.vocab_size, cfg.d_model)
                   for k in z.files)


def _cli(argv):
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    return buf.getvalue()


def test_train_cli_resumes_from_checkpoint(tmp_path):
    """``--ckpt-dir --ckpt-every 2`` saves steps 2 and 4 (the final save
    included); ``--resume --steps 6`` says so and continues with the
    losses of an uninterrupted 6-step run."""
    common = ["--reduced", "--mesh", "4,1", "--batch", "8", "--seq", "32",
              "--backend", "pallas_fused", "--device", "cpu",
              "--log-every", "1"]
    d = str(tmp_path / "ck")
    first = _cli(common + ["--steps", "4", "--ckpt-dir", d,
                           "--ckpt-every", "2"])
    assert ckpt.all_steps(d) == [2, 4]
    second = _cli(common + ["--steps", "6", "--ckpt-dir", d,
                            "--ckpt-every", "2", "--resume"])
    assert "[train] resumed from step 4" in second
    assert ckpt.latest_step(d) == 6
    whole = _cli(common + ["--steps", "6"])

    def losses(text):
        return [line.split()[1] + " " + line.split()[3]
                for line in text.splitlines() if line.startswith("step ")]
    assert losses(first) + losses(second) == losses(whole)
    assert "stragglers flagged" in second
