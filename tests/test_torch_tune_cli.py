"""The port's tune and report CLIs end to end on the CPU
(``repro_torch.launch.tune``, ``repro_torch.launch.report``).

Mirrors the reference's ``tests/tuner/test_tune_e2e.py`` (probe the tiny
grid, write the measured table, a ``tuning="measured"`` train step
dispatches from it) and ``tests/launch/test_report_cli.py`` (greppable
decision-table lines, the drift table with its RETUNE marker, the prom
and trace side outputs, ``tune --hints`` on the same drift store).  The
tiny grid is probed once for the module; its table equals the
reference's refresh of the same measurements, and the report prints what
the reference's report prints on the same artifact and drift store.
"""

import contextlib
import dataclasses
import io
import json
import math
import os

import pytest

from repro.tuner import refresh as jrefresh
from repro.tuner import store as jstore
from repro_torch.launch import report as R
from repro_torch.launch import tune as TU
from repro_torch.obs import drift as D
from repro_torch.obs import metrics
from repro_torch.topology import load_table, measured_table_path
from repro_torch.tuner import load_all_measurements
from torch_threads import pin_threads  # noqa: F401


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()



@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    """``tune --grid tiny --device cpu`` once, into the module's own
    store, drift store and measured-table directories."""
    tmp = tmp_path_factory.mktemp("tune")
    dirs = {k: str(tmp / k) for k in ("measurements", "drift", "tables")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_MEASURE_DIR", dirs["measurements"])
        mp.setenv("REPRO_DRIFT_DIR", dirs["drift"])
        mp.setenv("REPRO_MEASURED_TABLE_DIR", dirs["tables"])
        rc, out = _run(TU.main, ["--grid", "tiny", "--topology",
                                 "tpu_multipod", "--device", "cpu",
                                 "--timestamp", "e2e"])
    return rc, out, dirs


@pytest.fixture()
def tuned_env(tuned, monkeypatch):
    rc, out, dirs = tuned
    monkeypatch.setenv("REPRO_MEASURE_DIR", dirs["measurements"])
    monkeypatch.setenv("REPRO_DRIFT_DIR", dirs["drift"])
    monkeypatch.setenv("REPRO_MEASURED_TABLE_DIR", dirs["tables"])
    from repro_torch.topology import invalidate_tables
    invalidate_tables()
    yield rc, out, dirs
    invalidate_tables()


def test_tune_writes_store_drift_and_table(tuned_env):
    rc, out, dirs = tuned_env
    assert rc == 0
    closing = json.loads(out.strip().splitlines()[-1])
    assert closing["grid"] == "tiny" and closing["topology"] == \
        "tpu_multipod"
    # 3 collectives x 3 tiny-grid size buckets
    assert closing["measured_cells"] == 9
    assert closing["table"] == measured_table_path("tpu_multipod")
    table = load_table("tpu_multipod", tuning="measured")
    assert table.measured_cell_count() == 9
    assert closing["total_cells"] == sum(
        len(row) for per_p in table.entries.values()
        for row in per_p.values())
    assert closing["analytic_overrides"] == table.overrides_vs(
        load_table("tpu_multipod"))
    (ms,) = load_all_measurements(topology="tpu_multipod")
    assert ms.provenance["grid"] == "tiny"
    assert ms.provenance["timestamp"] == "e2e"
    assert ms.provenance["platform"] == "cpu" and ms.device_kind == "cpu"
    # 3 colls x 5 candidates x 3 sizes = 45 float32 cells, plus the codec
    # pairs on RS/AG: 2 colls x (3 codec backends x 2 wires) x 3 sizes = 36
    assert len(ms.measurements) == 81
    assert all(m.time_s > 0 and math.isfinite(m.time_s)
               for m in ms.measurements)
    (ds,) = D.load_all_drift(topology="tpu_multipod")
    assert len(ds.cells) == 9 and all(c.n > 0 for c in ds.cells.values())
    assert f"-> {dirs['drift']}" in out


def test_tune_table_equals_reference_refresh(tuned_env):
    """The measured table the port's CLI wrote is the reference's refresh
    of the same store, byte for byte."""
    rc, out, dirs = tuned_env
    (ms,) = load_all_measurements(topology="tpu_multipod")
    exp = jrefresh.refresh_table("tpu_multipod", [
        jstore.Measurement(**dataclasses.asdict(m))
        for m in ms.measurements])
    with open(measured_table_path("tpu_multipod")) as f:
        assert f.read() == json.dumps(exp.to_json_dict(), indent=1,
                                      sort_keys=True) + "\n"
    # and the reference's store reader takes the port's store
    (jms,) = jstore.load_all_measurements(topology="tpu_multipod",
                                          dir=dirs["measurements"])
    assert len(jms.measurements) == 81


def test_measured_train_step_dispatches_from_the_table(tuned_env):
    """A ``tuning="measured"`` train step resolves its bucket collectives
    from the table the CLI wrote, and steps."""
    from repro_torch.configs import base
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.step import (TrainConfig, bucket_report,
                                        make_init_fns, make_train_step)
    table = load_table("tpu_multipod", tuning="measured")
    cfg = base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32")
    tcfg = TrainConfig(backend="auto", tuning="measured",
                       bucket_bytes=1 << 16)
    step, info, _ = make_train_step(cfg, tcfg, 4, TF.param_shapes(cfg),
                                    "cpu")
    report = bucket_report(tcfg, info["bucket_plan"])
    assert report
    assert any(r["rs_provenance"] == "measured" for r in report), report
    for r in report:
        assert r["rs_backend"] == table.lookup("reduce_scatter", 4,
                                               r["rs_bytes"]), r
        assert r["ag_backend"] == table.lookup("allgather", 4,
                                               r["ag_bytes"]), r
    assert all(r["rs_provenance"] == "analytic" for r in bucket_report(
        tcfg.replace(tuning="analytic"), info["bucket_plan"]))
    assert all(r["rs_provenance"] == "fixed" for r in bucket_report(
        tcfg.replace(backend="bine"), info["bucket_plan"]))
    init_p, init_s = make_init_fns(cfg, tcfg, 4, "cpu")
    params = init_p(0)
    dcfg = DataConfig(global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    _, _, m = step(params, init_s(params), make_batch(dcfg, 0))
    assert math.isfinite(float(m["loss"]))


def _mispriced_drift(tmp_path, p=4, topology="tpu_multipod"):
    """One healthy cell + one 5x-mispriced cell."""
    ds = D.DriftSet(device_kind="cpu", topology=topology, p=p,
                    provenance={"timestamp": "t0", "source": "test"})
    pred = D.predicted_time("allreduce", "bine", p, 1 << 12, topology)
    D.observe(ds, "allreduce", "bine", 1 << 12, pred)
    pred = D.predicted_time("allreduce", "bine", p, 1 << 20, topology)
    for _ in range(5):
        D.observe(ds, "allreduce", "bine", 1 << 20, pred * 5.0)
    d = str(tmp_path / "drift")
    assert D.save_drift(ds, dir=d) is not None
    return d


def test_tune_hints_probes_only_the_drifted_axes(tmp_path):
    ddir = _mispriced_drift(tmp_path)
    store = str(tmp_path / "m")
    rc, out = _run(TU.main, [
        "--grid", "tiny", "--topology", "tpu_multipod", "--hints",
        "--drift-dir", ddir, "--device", "cpu", "--store-dir", store,
        "--table-out", str(tmp_path / "t.json")])
    assert rc == 0
    assert "drift hint: allreduce p=4" in out
    want = D.bucket_bytes(D.payload_bucket(1 << 20))
    (ms,) = load_all_measurements(dir=store)
    assert ms.provenance["grid"] == "tiny+hints"
    assert {(m.collective, m.p, m.nbytes) for m in ms.measurements} == \
        {("allreduce", 4, want)}
    assert {m.backend for m in ms.measurements} == {
        "bine", "recdoub", "ring", "pallas_fused", "bine_hier"}
    assert json.loads(out.strip().splitlines()[-1])["measured_cells"] == 1


def test_tune_hints_dry_lists_only_the_drifted_axes(tmp_path):
    ddir = _mispriced_drift(tmp_path, p=8, topology="lumi")
    rc, out = _run(TU.main, ["--grid", "tiny", "--topology", "lumi",
                             "--hints", "--drift-dir", ddir, "--dry"])
    assert rc == 0
    assert "drift hint: allreduce p=8" in out
    assert "measured/predicted=" in out
    grid = [ln for ln in out.splitlines() if ln.endswith("B")
            and not ln.startswith("[tune]")]
    want = D.bucket_bytes(D.payload_bucket(1 << 20))
    assert len(grid) == 5
    assert all(ln.startswith("allreduce ") and "p=8" in ln
               and ln.endswith(f" {want}B") for ln in grid)


def test_tune_hints_no_drift_exits_clean(tmp_path):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    rc, out = _run(TU.main, ["--grid", "tiny", "--topology", "lumi",
                             "--hints", "--drift-dir", empty, "--dry"])
    assert rc == 0
    assert "no drifted cells" in out


def test_tune_dry_lists_the_probed_cells():
    rc, out = _run(TU.main, ["--grid", "small", "--topology", "torus",
                             "--dry"])
    assert rc == 0
    lines = out.strip().splitlines()
    # torus: no bine_hier; 2 ps x 3 sizes x (4 + 10 + 10) cells
    assert len(lines) == 2 * 3 * 24
    assert not any("bine_hier" in ln for ln in lines)


@pytest.mark.parametrize("argv", [["--grid", "huge"],
                                  ["--topology", "nowhere"],
                                  ["--device", "tpu"]])
def test_tune_rejects_unknown_choices(argv, capsys):
    with pytest.raises(SystemExit):
        TU.main(argv + ["--dry"])


def _artifact(tmp_path):
    reg = metrics.Registry()
    reg.inc("collective_calls", 1.0, collective="allreduce",
            backend="bine", algo="bine", wire_dtype="float32",
            topology="lumi", p="8", source="api")
    reg.counters[("link_global_bytes",
                  (("backend", "bine"), ("topology", "lumi")))] = 1024.0
    reg.counters[("link_local_bytes",
                  (("backend", "bine"), ("topology", "lumi")))] = 3072.0
    for x in (1.0, 2.0, 3.0):
        reg.observe("serve_request_seconds", x, replica="0")
    path = str(tmp_path / "run.json")
    with open(path, "w") as f:
        json.dump({"format": 1, "timestamp": "t0", "kind": "train",
                   "config": {"topology": "lumi"},
                   "registry": reg.snapshot(),
                   "timeline": [{"name": "step", "lane": "train",
                                 "ts_us": 1.0, "dur_us": 1.0,
                                 "track": "0", "args": {}}]}, f)
    return path


def test_report_cli_end_to_end(tmp_path):
    art = _artifact(tmp_path)
    ddir = _mispriced_drift(tmp_path, p=8, topology="lumi")
    prom = str(tmp_path / "m.prom")
    trace = str(tmp_path / "trace.json")
    rc, out = _run(R.main, ["--artifact", art, "--drift-dir", ddir,
                            "--prom", prom, "--trace-out", trace])
    assert rc == 0
    from repro_torch.topology.presets import PRESETS
    for preset in PRESETS:
        assert f"preset={preset} p=8 nbytes=1048576 " \
               f"collective=allreduce chosen=" in out
    assert "global_frac=0.250" in out
    assert out.count("<-- RETUNE") == 1
    flagged = [ln for ln in out.splitlines() if "<-- RETUNE" in ln][0]
    assert f"allreduce/b{D.payload_bucket(1 << 20)}" in flagged
    assert "python -m repro_torch.launch.tune --hints" in out
    assert "serve_request_seconds" in out
    assert "collective_calls" in out
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    with open(prom) as f:
        assert "collective_calls_total" in f.read()


def test_report_equals_reference_report(tmp_path):
    """The two packages' reports on one artifact and drift store print
    the same lines (the retune hint names each package's own CLI)."""
    from repro.launch import report as JR
    art = _artifact(tmp_path)
    ddir = _mispriced_drift(tmp_path, p=8, topology="lumi")
    argv = ["--artifact", art, "--drift-dir", ddir, "--p", "16",
            "--nbytes", str(1 << 22)]
    rc, got = _run(R.main, argv)
    jrc, exp = _run(JR.main, argv)
    assert rc == jrc == 0
    assert got.replace("repro_torch.launch", "repro.launch") == exp
    prom_got, prom_exp = str(tmp_path / "a.prom"), str(tmp_path / "b.prom")
    _run(R.main, ["--artifact", art, "--prom", prom_got])
    _run(JR.main, ["--artifact", art, "--prom", prom_exp])
    assert open(prom_got).read() == open(prom_exp).read()


def test_report_on_a_train_steps_registry(tmp_path):
    """The artifact of a real registry: a train step build records its
    bucket plan, and the report's link-byte table is that registry's
    ``global_local_summary``."""
    from repro_torch.configs import base
    from repro_torch.models import transformer as TF
    from repro_torch.obs import collect
    from repro_torch.train.step import TrainConfig, make_train_step
    reg = metrics.Registry()
    prev = metrics.set_enabled(True)
    saved = metrics._REGISTRY
    metrics._REGISTRY = reg
    try:
        cfg = base.reduced(base.get_config("phi4-mini-3.8b"))
        make_train_step(cfg, TrainConfig(backend="bine", topology="lumi",
                                         bucket_bytes=1 << 16), 4,
                        TF.param_shapes(cfg), "cpu")
    finally:
        metrics._REGISTRY = saved
        metrics.set_enabled(prev)
    rows = collect.global_local_summary(reg)
    assert rows
    path = str(tmp_path / "obs.json")
    with open(path, "w") as f:
        json.dump({"kind": "train", "config": {"topology": "lumi"},
                   "registry": reg.snapshot(), "timeline": []}, f)
    rc, out = _run(R.main, ["--artifact", path, "--drift-dir",
                            str(tmp_path / "none")])
    assert rc == 0
    for (backend, topology), row in rows.items():
        tot = row["global"] + row["local"]
        assert f"backend={backend} topology={topology} " in out
        assert f"global_frac={row['global'] / tot:.3f}" in out
    assert "(no drift store entries)" in out


def test_report_cli_unreadable_artifact(tmp_path, capsys):
    assert R.main(["--artifact", str(tmp_path / "nope.json")]) == 1
    assert "cannot read artifact" in capsys.readouterr().err
