"""The port's measurement plane (``repro_torch.tuner``): the store, the
table refresh and the probe, against the reference's.

Mirrors the reference's ``tests/tuner/test_refresh.py``,
``tests/resilience/test_probe_timeout.py`` and
``tests/resilience/test_store_quarantine.py`` on the port's modules, and
adds the crossings: the same ``Measurement`` list fed to both packages'
``refresh_table`` gives byte-identical table JSON; a ``MeasurementSet``
saved by either package loads in the other; the grids are equal; and the
port's ``probe_grid`` on the CPU times every cell of the reference's
grid.  ``repro.tuner.refresh`` and ``repro.tuner.store`` import no jax at
module level, so the reference runs in process.
"""

import dataclasses
import json
import math
import os
import time
import warnings

import numpy as np
import pytest
import torch

from repro.tuner import probe as jprobe
from repro.tuner import refresh as jrefresh
from repro.tuner import store as jstore
from repro_torch.topology import CANDIDATES, build_table, wire_candidates
from repro_torch.topology import table as tbl
from repro_torch.tuner import probe, store
from repro_torch.tuner.refresh import (measured_cells, measured_wire_cells,
                                       refresh_table)
from repro_torch.tuner.store import (Measurement, MeasurementSet,
                                     load_all_measurements, load_measurements,
                                     save_measurements)
from torch_threads import pin_threads  # noqa: F401

PS = (4, 8)
SIZES = (1 << 14, 1 << 20, 1 << 24)



@pytest.fixture()
def base():
    return build_table("tpu_multipod", ps=PS, size_buckets=SIZES)


def _full_cell(coll, p, nbytes, fastest, slow=1e-3, fast=1e-4):
    """Measurements covering every candidate; ``fastest`` wins."""
    return [Measurement(coll, b, p, nbytes, fast if b == fastest else slow,
                        reps=5)
            for b in CANDIDATES[coll]]


def _full_wire_cell(coll, p, nbytes, fastest, slow=1e-3, fast=1e-4):
    """Measurements covering every (backend, wire) joint candidate."""
    return [Measurement(coll, b, p, nbytes,
                        fast if (b, w) == fastest else slow, reps=5,
                        wire_dtype=w)
            for b, w in wire_candidates(coll, "tpu_multipod")]


def _ms(p=4, topology="lumi"):
    return MeasurementSet(
        device_kind="cpu", topology=topology, p=p,
        provenance={"grid": "tiny", "timestamp": None},
        measurements=[Measurement("allreduce", "bine", p, 1 << 16, 1e-4,
                                  reps=5)])


def _torn(path, seed=0, nbytes=64):
    """Overwrite ``path`` with seed-derived garbage, not atomically: the
    torn write the quarantine must absorb."""
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        f.write(b"{corrupt" + bytes(bytearray(
            rng.randint(0, 256, size=nbytes, dtype=np.uint8))))


@pytest.fixture()
def fresh_warn_state():
    """Per-path warning dedup is process-global; isolate each test."""
    before = set(store._WARNED_PATHS)
    yield
    store._WARNED_PATHS.clear()
    store._WARNED_PATHS.update(before)


# ---------------------------------------------------------------------------
# Store
# ---------------------------------------------------------------------------

def test_store_roundtrip_with_provenance(tmp_path):
    ms = MeasurementSet(
        device_kind="NVIDIA H100 80GB HBM3", topology="tpu_multipod", p=8,
        provenance={"grid": "tiny", "timestamp": "2026-07-31",
                    "torch": "x"},
        measurements=_full_cell("allreduce", 8, 1 << 20, "ring"))
    path = save_measurements(ms, str(tmp_path))
    assert os.path.basename(path) == \
        "NVIDIA-H100-80GB-HBM3__tpu_multipod__p8.json"
    back = load_measurements(path)
    assert back.measurements == ms.measurements
    assert back.provenance["timestamp"] == "2026-07-31"
    assert load_all_measurements(topology="tpu_multipod",
                                 dir=str(tmp_path))[0].p == 8
    assert load_all_measurements(topology="torus", dir=str(tmp_path)) == []
    assert load_all_measurements(dir=str(tmp_path / "nope")) == []


def test_store_dir_env(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_MEASURE_DIR", str(tmp_path))
    assert store.store_dir() == str(tmp_path)
    assert store.measurement_path(_ms()) == str(tmp_path /
                                                "cpu__lumi__p4.json")
    monkeypatch.delenv("REPRO_MEASURE_DIR")
    assert store.store_dir().endswith(
        os.path.join(".cache", "repro-bine", "measurements"))


def test_store_skips_corrupt_files(tmp_path, fresh_warn_state):
    (tmp_path / "junk.json").write_text("{not json")
    (tmp_path / "foreign.json").write_text(json.dumps({"format": 99}))
    with pytest.warns(UserWarning):
        assert load_all_measurements(dir=str(tmp_path)) == []


def test_measurement_wire_dtype_roundtrip(tmp_path):
    ms = MeasurementSet(
        device_kind="cpu", topology="tpu_multipod", p=4,
        provenance={"grid": "tiny"},
        measurements=[Measurement("reduce_scatter", "bine", 4, 1 << 20,
                                  1e-4, 3, wire_dtype="int8")])
    path = save_measurements(ms, str(tmp_path))
    assert load_measurements(path).measurements[0].wire_dtype == "int8"
    # pre-wire stores (no field) default to float32
    d = json.load(open(path))
    del d["measurements"][0]["wire_dtype"]
    with open(path, "w") as f:
        json.dump(d, f)
    assert load_measurements(path).measurements[0].wire_dtype == "float32"


def test_missing_file_is_silently_none(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert load_measurements(str(tmp_path / "nope.json")) is None


def test_corrupt_file_quarantined_once(tmp_path, fresh_warn_state):
    path = save_measurements(_ms(), dir=str(tmp_path))
    _torn(path, seed=1)
    with pytest.warns(UserWarning, match="quarantined"):
        assert load_measurements(path) is None
    assert not os.path.exists(path)
    assert os.path.exists(path + store.CORRUPT_SUFFIX)
    # second hit on the same path: still None, but no repeat warning
    _torn(path, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert load_measurements(path) is None


@pytest.mark.parametrize("blob", [
    '[1, 2, 3]',                                  # not an object
    '{"format": 99}',                             # unknown format
    '{"format": 1, "device_kind": "cpu", "topology": "t", "p": 4, '
    '"measurements": {"oops": 1}}',               # measurements not a list
    '{"format": 1}',                              # missing keys
])
def test_schema_violations_quarantined(tmp_path, blob, fresh_warn_state):
    path = str(tmp_path / "cpu__lumi__p4.json")
    with open(path, "w") as f:
        f.write(blob)
    with pytest.warns(UserWarning, match="unreadable"):
        assert load_measurements(path) is None
    assert os.path.exists(path + store.CORRUPT_SUFFIX)


def test_load_all_skips_corrupt_keeps_valid(tmp_path, fresh_warn_state):
    d = str(tmp_path)
    save_measurements(_ms(p=4), dir=d)
    _torn(save_measurements(_ms(p=8), dir=d), seed=0)
    with pytest.warns(UserWarning):
        sets = load_all_measurements(dir=d)
    assert [ms.p for ms in sets] == [4]
    assert sorted(f for f in os.listdir(d) if f.endswith(".json")) == \
        ["cpu__lumi__p4.json"]


def test_atomic_save_leaves_no_tmp(tmp_path):
    path = save_measurements(_ms(), dir=str(tmp_path))
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    assert load_measurements(path).measurements == _ms().measurements


def test_unwritable_store_warns_once(tmp_path, fresh_warn_state):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory\n")
    d = str(blocker / "store")    # makedirs fails for any uid
    with pytest.warns(UserWarning, match="NOT persisted"):
        assert save_measurements(_ms(), dir=d) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert save_measurements(_ms(), dir=d) is None


def test_quarantine_rename_failure_returns_none(tmp_path, monkeypatch):
    path = save_measurements(_ms(), dir=str(tmp_path))

    def refuse(src, dst):
        raise OSError("read-only filesystem")

    monkeypatch.setattr(store.os, "replace", refuse)
    assert store.quarantine(path) is None
    assert os.path.exists(path)


# ---------------------------------------------------------------------------
# Refresh
# ---------------------------------------------------------------------------

def test_refresh_overrides_and_falls_back(base, tmp_path):
    target = ("reduce_scatter", 4, 1 << 20)
    assert base.lookup(*target) == "bine"
    table = refresh_table("tpu_multipod", _full_cell(*target,
                                                     fastest="ring"),
                          base=base)
    assert table.lookup(*target) == "ring"
    assert table.provenance_of(*target) == "measured"
    assert table.provenance_of("reduce_scatter", 4, 1 << 14) == "analytic"
    assert table.lookup("reduce_scatter", 8, 1 << 20) == \
        base.lookup("reduce_scatter", 8, 1 << 20)
    assert table.lookup("allgather", 4, 1 << 20) == \
        base.lookup("allgather", 4, 1 << 20)
    assert table.measured_cell_count() == 1
    assert table.overrides_vs(base) == 1
    assert table.ps == base.ps and table.size_buckets == base.size_buckets
    assert table.bucket_bytes == base.bucket_bytes
    path = os.path.join(str(tmp_path), "m.json")
    table.save(path)
    assert tbl.DecisionTable.load(path) == table
    assert json.load(open(path))["format"] == 3


def test_measured_count_and_overrides_on_agreement(base):
    """A measured cell that agrees with the analytic pick counts as
    measured but is no override."""
    target = ("allreduce", 8, 1 << 24)
    want = base.lookup(*target)
    table = refresh_table("tpu_multipod",
                          _full_cell(*target, fastest=want), base=base)
    assert table.measured_cell_count() == 1
    assert table.overrides_vs(base) == 0
    assert base.measured_cell_count() == 0 and base.overrides_vs(base) == 0


def test_partial_coverage_stays_analytic(base):
    target = ("allgather", 4, 1 << 20)
    ms = [Measurement("allgather", b, 4, 1 << 20, 1e-5, 5)
          for b in CANDIDATES["allgather"][:2]]
    table = refresh_table("tpu_multipod", ms, base=base)
    assert table.provenance_of(*target) == "analytic"
    assert table.lookup(*target) == base.lookup(*target)
    assert table.measured_cell_count() == 0


def test_median_and_tie_rules(base):
    coll, p, nbytes = "allreduce", 4, 1 << 24
    cands = CANDIDATES[coll]
    ms = []
    for b in cands:
        ms.extend(Measurement(coll, b, p, nbytes, t, 1)
                  for t in (2e-4, 1e-4, 9e9))
    cells = measured_cells(base, ms)
    assert cells[(coll, p, base.bucket_of(nbytes))] == cands[0]


def test_offgrid_measurements_ignored(base):
    ms = (_full_cell("allreduce", 16, 1 << 20, "ring")
          + [Measurement("allreduce", "nonsense", 4, 1 << 20, 1e-6, 1)]
          + [Measurement("fft", "bine", 4, 1 << 20, 1e-6, 1)])
    assert measured_cells(base, ms) == {}


def test_wire_refresh_overrides_and_falls_back(base, tmp_path):
    target = ("reduce_scatter", 4, 1 << 20)
    want = ("ring", "float32")
    table = refresh_table("tpu_multipod",
                          _full_wire_cell(*target, fastest=want), base=base)
    assert table.lookup_wire(*target) == want
    assert table.wire_provenance_of(*target) == "measured"
    assert table.wire_provenance_of("allgather", 4, 1 << 20) == "analytic"
    path = os.path.join(str(tmp_path), "w.json")
    table.save(path)
    assert tbl.DecisionTable.load(path) == table


def test_wire_refresh_can_pick_codec_pair(base):
    target = ("allgather", 8, 1 << 24)
    want = ("pallas_fused", "int8")
    table = refresh_table("tpu_multipod",
                          _full_wire_cell(*target, fastest=want), base=base)
    assert table.lookup_wire(*target) == want


def test_wire_partial_coverage_stays_analytic(base):
    target = ("reduce_scatter", 4, 1 << 20)
    ms = _full_wire_cell(*target, fastest=("bine", "int8"))[:-1]
    assert measured_wire_cells(base, ms) == {}
    assert refresh_table("tpu_multipod", ms, base=base
                         ).wire_provenance_of(*target) == "analytic"


def test_codec_measurements_do_not_touch_backend_rows(base):
    target = ("reduce_scatter", 4, 1 << 20)
    ms = [Measurement("reduce_scatter", b, 4, 1 << 20, 1e-9, 5,
                      wire_dtype="int8")
          for b in ("bine", "recdoub", "pallas_fused")]
    assert measured_cells(base, ms) == {}
    table = refresh_table("tpu_multipod", ms, base=base)
    assert table.lookup(*target) == base.lookup(*target)
    assert table.measured_cell_count() == 0


def test_refresh_from_store_filters(tmp_path):
    from repro_torch.tuner.refresh import refresh_from_store
    d = str(tmp_path)
    target = ("reduce_scatter", 4, 1 << 20)
    for kind, fastest in (("cpu", "ring"), ("other", "recdoub")):
        save_measurements(MeasurementSet(
            device_kind=kind, topology="tpu_multipod", p=4,
            measurements=_full_cell(*target, fastest=fastest)), d)
    table, sets = refresh_from_store("tpu_multipod", store_dir=d,
                                     device_kind="cpu")
    assert [s.device_kind for s in sets] == ["cpu"]
    assert table.lookup(*target) == "ring"


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def _seeded_measurements(topology, seed):
    """Seeded timings over a mix of fully covered, partly covered and
    repeated cells, float32 backends and codec pairs alike."""
    rng = np.random.default_rng(seed)
    out = []
    for coll in probe.PROBE_COLLECTIVES:
        pairs = wire_candidates(coll, topology)
        for p in (4, 8, 16, 3):
            for nbytes in (1 << 12, 1 << 16, 3 << 18, 1 << 20, 1 << 24):
                keep = pairs if rng.random() < 0.7 else pairs[:-1]
                for rep in range(int(rng.integers(1, 4))):
                    for b, w in keep:
                        t = float(rng.choice([1e-4, 2e-4, 3e-4])
                                  if rep == 0 else rng.random() * 1e-3)
                        out.append(Measurement(coll, b, p, nbytes, t,
                                               reps=5, wire_dtype=w))
    return out


@pytest.mark.parametrize("topology", ["tpu_multipod", "lumi", "torus"])
@pytest.mark.parametrize("seed", [0, 1])
def test_refresh_table_json_equals_reference(topology, seed):
    ms = _seeded_measurements(topology, seed)
    got = refresh_table(topology, ms)
    exp = jrefresh.refresh_table(
        topology, [jstore.Measurement(**dataclasses.asdict(m)) for m in ms])
    assert got.measured_cell_count() == exp.measured_cell_count()
    # on the torus (no bine_hier to time) only the wire rows turn measured
    assert got.measured_cell_count() + sum(
        row.count("measured") for per_p in got.wire_provenance.values()
        for row in per_p.values()) > 0
    assert got.to_json() == json.dumps(exp.to_json_dict(), indent=1,
                                       sort_keys=True) + "\n"
    from repro.topology import load_table as jload
    jbase = jload(topology)
    assert got.overrides_vs(tbl.load_table(topology)) == \
        exp.overrides_vs(jbase)


def test_measured_cells_equal_reference():
    from repro.topology import build_table as jbuild
    ms = _seeded_measurements("tpu_multipod", 2)
    jms = [jstore.Measurement(**dataclasses.asdict(m)) for m in ms]
    tb = build_table("tpu_multipod", ps=PS, size_buckets=SIZES)
    jb = jbuild("tpu_multipod", ps=PS, size_buckets=SIZES)
    assert measured_cells(tb, ms) == jrefresh.measured_cells(jb, jms)
    assert measured_wire_cells(tb, ms) == \
        jrefresh.measured_wire_cells(jb, jms)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_crosses_packages(tmp_path, writer):
    ms = _seeded_measurements("lumi", 3)[:40]
    prov = {"grid": "small", "timestamp": "t0", "platform": "gpu"}
    d = str(tmp_path)
    if writer == "port":
        path = save_measurements(MeasurementSet(
            device_kind="NVIDIA H100 80GB HBM3", topology="lumi", p=8,
            provenance=prov, measurements=ms), d)
        back = jstore.load_measurements(path)
        assert [dataclasses.asdict(m) for m in back.measurements] == \
            [dataclasses.asdict(m) for m in ms]
        assert jstore.load_all_measurements(topology="lumi", dir=d)[0].key() \
            == os.path.basename(path)[:-5]
    else:
        path = jstore.save_measurements(jstore.MeasurementSet(
            device_kind="NVIDIA H100 80GB HBM3", topology="lumi", p=8,
            provenance=prov, measurements=[
                jstore.Measurement(**dataclasses.asdict(m)) for m in ms]), d)
        back = load_measurements(path)
        assert back.measurements == ms
        assert load_all_measurements(topology="lumi", dir=d)[0].key() == \
            os.path.basename(path)[:-5]
    assert back.provenance == prov and back.p == 8


def test_store_files_byte_identical(tmp_path):
    ms = _seeded_measurements("torus", 4)[:25]
    a = save_measurements(MeasurementSet("cpu", "torus", 4, {"grid": "x"},
                                         ms), str(tmp_path / "a"))
    b = jstore.save_measurements(jstore.MeasurementSet(
        "cpu", "torus", 4, {"grid": "x"},
        [jstore.Measurement(**dataclasses.asdict(m)) for m in ms]),
        str(tmp_path / "b"))
    assert open(a).read() == open(b).read()


def test_grids_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in probe.GRIDS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jprobe.GRIDS.items()}
    assert probe.PROBE_COLLECTIVES == jprobe.PROBE_COLLECTIVES


@pytest.mark.parametrize("topology", ["tpu_multipod", "lumi", "torus"])
def test_probe_cells_equal_reference(topology):
    for coll in probe.PROBE_COLLECTIVES:
        assert probe.probe_backends(coll, topology) == \
            jprobe.probe_backends(coll, topology)
        assert probe.probe_wire_pairs(coll, topology) == \
            jprobe.probe_wire_pairs(coll, topology)
        assert probe.probe_backends(coll) == jprobe.probe_backends(coll)


@pytest.mark.parametrize("n", [1, 2, 5, 6, 10, 11])
def test_trimmed_median_and_payload_equal_reference(n):
    rng = np.random.default_rng(n)
    xs = list(rng.random(n))
    assert probe.trimmed_median(xs) == jprobe.trimmed_median(xs)
    for nbytes, p in ((1 << 16, 4), (1 << 10, 8), (12, 4), (1 << 20, 8)):
        np.testing.assert_array_equal(probe._payload(nbytes, p),
                                      jprobe._payload(nbytes, p))


@pytest.fixture(scope="module")
def tiny_cpu_probe():
    """The port's probe over the tiny grid on the CPU, at a grouped
    preset (bine_hier a candidate), timed once for the module."""
    return probe.probe_grid(probe.GRIDS["tiny"], "lumi", timestamp="t",
                            device="cpu")


def test_probe_grid_covers_reference_grid(tiny_cpu_probe):
    spec = jprobe.GRIDS["tiny"]
    want = set()
    for p in spec.ps:
        for nbytes in spec.sizes:
            for coll in spec.collectives:
                cells = [(b, "float32")
                         for b in jprobe.probe_backends(coll, "lumi")]
                cells += list(jprobe.probe_wire_pairs(coll, "lumi"))
                want |= {(coll, b, w, p, nbytes) for b, w in cells}
    (ms,) = tiny_cpu_probe
    got = [(m.collective, m.backend, m.wire_dtype, m.p, m.nbytes)
           for m in ms.measurements]
    assert len(got) == len(set(got)) and set(got) == want
    assert "bine_hier" in {m.backend for m in ms.measurements}
    assert all(m.time_s > 0 and math.isfinite(m.time_s)
               and m.reps == spec.reps for m in ms.measurements)
    assert ms.device_kind == "cpu" and ms.topology == "lumi"
    prov = ms.provenance
    assert (prov["platform"], prov["grid"], prov["timestamp"]) == \
        ("cpu", "tiny", "t")
    assert prov["torch"] == torch.__version__
    assert "failed_cells" not in prov and "skipped_ps" not in prov
    # the whole grid's table cells turn measured in both packages
    got_t = refresh_table("lumi", ms.measurements)
    exp_t = jrefresh.refresh_table("lumi", [
        jstore.Measurement(**dataclasses.asdict(m))
        for m in ms.measurements])
    assert got_t.measured_cell_count() == 9
    assert got_t.to_json() == json.dumps(exp_t.to_json_dict(), indent=1,
                                         sort_keys=True) + "\n"


def test_probe_grid_records_each_cells_spread(tiny_cpu_probe):
    """``cells_us``: every timed cell's least and most rep, their sum and
    the cell's wall, in microseconds; the median lies between the least
    and the most, the reps inside the wall; the reference's store loads
    the key unchanged."""
    (ms,) = tiny_cpu_probe
    cells = json.loads(ms.provenance["cells_us"])
    assert set(cells) == {f"{m.collective}:{m.backend}:{m.wire_dtype}:"
                          f"{m.nbytes}" for m in ms.measurements}
    for m in ms.measurements:
        lo, hi, total, wall = cells[f"{m.collective}:{m.backend}:"
                                   f"{m.wire_dtype}:{m.nbytes}"]
        assert 0 < lo <= m.time_s * 1e6 <= hi
        assert (m.reps * lo * (1 - 1e-12) <= total
                <= m.reps * hi * (1 + 1e-12))
        assert total <= wall
    back = jstore.MeasurementSet.from_json_dict(ms.to_json_dict())
    assert back.provenance["cells_us"] == ms.provenance["cells_us"]


# ---------------------------------------------------------------------------
# Probe robustness: budgets, retries, failed cells (no real sleeping)
# ---------------------------------------------------------------------------

def test_unbudgeted_runs_inline():
    assert probe.call_with_budget(lambda: 42, None) == 42


def test_budget_returns_fast_result():
    assert probe.call_with_budget(lambda: "ok", budget_s=5.0) == "ok"


def test_budget_times_out_slow_call():
    with pytest.raises(probe.ProbeTimeout, match="wall-clock budget"):
        probe.call_with_budget(lambda: time.sleep(5.0), budget_s=0.05)


def test_budget_reraises_worker_exception():
    def boom():
        raise KeyError("inside the cell")
    with pytest.raises(KeyError, match="inside the cell"):
        probe.call_with_budget(boom, budget_s=5.0)


def test_budget_validates():
    with pytest.raises(ValueError, match="budget_s must be > 0"):
        probe.call_with_budget(lambda: 1, budget_s=0.0)


def _spec(**kw):
    base = dict(name="t", collectives=("allreduce",), sizes=(1 << 16,),
                ps=(4,), warmup=1, reps=2)
    base.update(kw)
    return probe.GridSpec(**base)


def _cell_args(spec):
    return (spec, "allreduce", "bine", 4, 1 << 16, "cpu", "lumi", "float32")


def test_retry_succeeds_after_flaky_failures(monkeypatch):
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] < 3:
            raise probe.ProbeTimeout("slow")
        return Measurement("allreduce", "bine", 4, 1 << 16, 1e-4, reps=2)

    monkeypatch.setattr(probe, "time_collective", flaky)
    slept = []
    m = probe._probe_cell_with_retry(*_cell_args(_spec(retries=2,
                                                       backoff_s=0.5)),
                                     sleep=slept.append)
    assert m is not None and calls["n"] == 3
    assert slept == [0.5, 1.0]


def test_retries_exhausted_returns_none(monkeypatch):
    def always_slow(*a, **kw):
        raise probe.ProbeTimeout("slow")

    monkeypatch.setattr(probe, "time_collective", always_slow)
    slept = []
    assert probe._probe_cell_with_retry(*_cell_args(_spec(retries=1)),
                                        sleep=slept.append) is None
    assert slept == []


def test_config_errors_propagate_not_retried(monkeypatch):
    calls = {"n": 0}

    def reject(*a, **kw):
        calls["n"] += 1
        raise ValueError("bad backend/wire combo")

    monkeypatch.setattr(probe, "time_collective", reject)
    with pytest.raises(ValueError, match="bad backend"):
        probe._probe_cell_with_retry(*_cell_args(_spec(retries=5)),
                                     sleep=lambda s: None)
    assert calls["n"] == 1


def test_runtime_errors_also_covered(monkeypatch):
    def flaky_device(*a, **kw):
        raise RuntimeError("device wedged")

    monkeypatch.setattr(probe, "time_collective", flaky_device)
    assert probe._probe_cell_with_retry(*_cell_args(_spec()),
                                        sleep=lambda s: None) is None


def test_bad_backend_raises_through_the_real_cell():
    """A backend the API does not know is a config error: it propagates
    from a real cell instead of being retried."""
    with pytest.raises(ValueError, match="unknown backend"):
        probe._probe_cell_with_retry(
            _spec(retries=3), "allreduce", "nonsense", 4, 1 << 16, "cpu",
            "lumi", "float32", sleep=lambda s: None)


def _measure(collective, backend, p, nbytes, **kw):
    return Measurement(collective, backend, p, nbytes, 1e-4, reps=2,
                       wire_dtype=kw.get("wire_dtype", "float32"))


def test_probe_grid_records_failed_cells(monkeypatch, capsys):
    def selective(collective, backend, p, nbytes, **kw):
        if backend == "bine":
            raise probe.ProbeTimeout("wedged cell")
        return _measure(collective, backend, p, nbytes, **kw)

    monkeypatch.setattr(probe, "time_collective", selective)
    (ms,) = probe.probe_grid(_spec(budget_s=1.0), "lumi", progress=True,
                             sleep=lambda s: None, device="cpu")
    backends = {m.backend for m in ms.measurements}
    assert "bine" not in backends and len(backends) >= 2
    failed = ms.provenance["failed_cells"].split(",")
    assert all(f.startswith("allreduce:bine") for f in failed)
    assert "FAILED" in capsys.readouterr().out
    assert MeasurementSet.from_json_dict(ms.to_json_dict()).provenance[
        "failed_cells"] == ms.provenance["failed_cells"]


def test_probe_grid_no_failures_no_provenance_key(monkeypatch):
    monkeypatch.setattr(probe, "time_collective", _measure)
    (ms,) = probe.probe_grid(_spec(), "lumi", sleep=lambda s: None,
                             device="cpu")
    assert "failed_cells" not in ms.provenance
    assert ms.measurements


def test_probe_grid_wedged_device_ends_the_sweep(monkeypatch, capsys):
    """A failed cell after which the device does not drain is recorded
    failed and ends the sweep (the rest cannot be timed on it)."""
    def fail(collective, backend, p, nbytes, **kw):
        if backend == "recdoub":
            raise probe.ProbeTimeout("stuck")
        return _measure(collective, backend, p, nbytes, **kw)

    def wedged(device, budget_s):
        raise probe.DeviceWedged("did not drain")

    monkeypatch.setattr(probe, "time_collective", fail)
    monkeypatch.setattr(probe, "_drain", wedged)
    sets = probe.probe_grid(_spec(ps=(4, 8)), "lumi", progress=True,
                            sleep=lambda s: None, device="cpu")
    assert len(sets) == 1
    (ms,) = sets
    assert [m.backend for m in ms.measurements] == ["bine"]
    assert ms.provenance["failed_cells"] == "allreduce:recdoub:float32:65536"
    assert "did not drain" in ms.provenance["aborted"]
    assert "device wedged" in capsys.readouterr().out


def test_probe_grid_skips_a_p_that_does_not_fit(monkeypatch, capsys):
    monkeypatch.setattr(probe, "time_collective", _measure)
    free = probe.MEMORY_FACTOR * 4 * (1 << 16)
    monkeypatch.setattr(probe, "_free_bytes", lambda dev: free)
    sets = probe.probe_grid(_spec(ps=(4, 8)), "lumi", progress=True,
                            device="cpu")
    assert [ms.p for ms in sets] == [4]
    assert sets[0].provenance["skipped_ps"] == "8"
    assert "p=8 needs" in sets[0].provenance["skipped_why"]
    assert "skipped p=[8]" in capsys.readouterr().out


def test_drain_is_a_no_op_on_the_cpu():
    probe._drain("cpu", 0.01)


def test_grid_specs_carry_budget_fields():
    spec = probe.GRIDS["tiny"]
    assert spec.budget_s is None and spec.retries == 0
    tuned = dataclasses.replace(spec, budget_s=30.0, retries=2,
                                backoff_s=1.0)
    assert tuned.budget_s == 30.0


def test_probe_defaults_to_the_card(monkeypatch):
    """The entry point runs on the card unless asked for the CPU: without
    CUDA the default raises instead of timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.time_collective("allreduce", "bine", 4, 1 << 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.probe_grid(_spec(), "lumi")


@pytest.mark.parametrize("collective", probe.PROBE_COLLECTIVES)
def test_time_collective_cell_on_the_cpu(collective):
    """One real cell: the allgather is fed its nbytes/p block, every
    collective is keyed by the full-vector payload."""
    m = probe.time_collective(collective, "pallas_fused", 4, 1 << 16,
                              device="cpu", warmup=1, reps=3,
                              topology="lumi")
    assert (m.collective, m.p, m.nbytes, m.reps) == \
        (collective, 4, 1 << 16, 3)
    assert m.time_s > 0
