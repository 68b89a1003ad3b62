"""The port's drift store (``repro_torch.obs.drift``) against the
reference's ``repro.obs.drift``.

Mirrors the reference's ``tests/obs/test_drift.py`` on the port (a
mis-priced decision-table cell is flagged, and only that cell; the store
contract: atomic write, quarantine, unwritable warn-once), and adds the
crossings: on a grid of cells the predicted times (rel 1e-12), the
payload buckets and the flagged hints equal the reference's, and a drift
file written by either package loads in the other.  The reference's
module imports no jax, so it runs in process.
"""

import json
import math
import os
import warnings

import numpy as np
import pytest

from repro.obs import drift as J
from repro.tuner import store as jstore
from repro_torch.obs import drift as D
from repro_torch.topology.table import SIZE_BUCKETS
from repro_torch.tuner.store import Measurement, MeasurementSet
from torch_threads import pin_threads  # noqa: F401

CELLS = [("allreduce", 1 << 12), ("allreduce", 1 << 20),
         ("reduce_scatter", 1 << 20), ("allgather", 1 << 16)]

TOPOLOGIES = ["tpu_multipod", "lumi", "leonardo", "torus"]
BACKENDS = ["bine", "recdoub", "ring", "xla", "pallas_fused", "bine_hier",
            "bruck", "no_such_backend"]
COLLECTIVES = ["allreduce", "reduce_scatter", "allgather", "alltoall",
               "broadcast"]


def _dset(p=8, topology="lumi"):
    return D.DriftSet(device_kind="cpu-test", topology=topology, p=p,
                      provenance={"timestamp": "t0", "source": "test"})


@pytest.fixture()
def fresh_warn_state():
    before = set(D._WARNED_PATHS)
    yield
    D._WARNED_PATHS.clear()
    D._WARNED_PATHS.update(before)


def test_mispriced_cell_flagged_and_only_that_cell():
    ds = _dset()
    for coll, nbytes in CELLS:
        pred = D.predicted_time(coll, "bine", 8, nbytes, "lumi")
        assert pred is not None and pred > 0
        for _ in range(5):
            assert D.observe(ds, coll, "bine", nbytes, pred) == 0.0
    coll_bad, nbytes_bad = CELLS[1]
    pred_bad = D.predicted_time(coll_bad, "bine", 8, nbytes_bad, "lumi")
    for _ in range(5):
        D.observe(ds, coll_bad, "bine", nbytes_bad, pred_bad * 10.0)
    (h,) = D.hints(ds)
    assert (h.collective, h.bucket) == (coll_bad,
                                        D.payload_bucket(nbytes_bad))
    assert h.p == 8 and h.last_backend == "bine"
    assert 1.0 < h.ewma_log_ratio <= math.log(10.0) + 1e-9
    assert h.ratio == pytest.approx(math.exp(h.ewma_log_ratio))


@pytest.mark.parametrize("factor", [10.0, 0.1])
def test_threshold_is_two_sided(factor):
    ds = _dset()
    pred = D.predicted_time("allreduce", "bine", 8, 1 << 20, "lumi")
    for _ in range(10):
        D.observe(ds, "allreduce", "bine", 1 << 20, pred * factor)
    assert len(D.hints(ds)) == 1


@pytest.mark.parametrize("factor", [1.49, 1 / 1.49])
def test_threshold_is_ln_one_and_a_half(factor):
    """Just inside ln 1.5 either way: no hint; the default threshold is
    the reference's."""
    assert D.DEFAULT_THRESHOLD == J.DEFAULT_THRESHOLD == math.log(1.5)
    assert D.EWMA_ALPHA == J.EWMA_ALPHA
    ds = _dset()
    pred = D.predicted_time("allreduce", "bine", 8, 1 << 20, "lumi")
    D.observe(ds, "allreduce", "bine", 1 << 20, pred * factor)
    assert D.hints(ds) == []
    assert len(D.hints(ds, threshold=0.3)) == 1


def test_observe_skips_unpriceable_and_degenerate():
    ds = _dset()
    assert D.observe(ds, "allreduce", "bine", 1 << 20, 0.0) is None
    assert D.observe(ds, "allreduce", "no_such_backend", 1 << 20,
                     1e-3) is None
    assert ds.cells == {}


def test_payload_bucket_matches_decision_table():
    for i, edge in enumerate(SIZE_BUCKETS):
        assert D.payload_bucket(edge) == i
        assert D.bucket_bytes(i) == edge
    assert D.payload_bucket(SIZE_BUCKETS[-1] * 4) == len(SIZE_BUCKETS) - 1


def test_ingest_measurements_from_probe_store():
    pred = D.predicted_time("allreduce", "bine", 8, 1 << 20, "lumi")
    ms = MeasurementSet(
        device_kind="cpu-test", topology="lumi", p=8,
        provenance={"timestamp": "t1", "grid": "tiny"},
        measurements=[Measurement("allreduce", "bine", 8, 1 << 20,
                                  pred * 3.0)])
    ds = D.ingest_measurements(ms)
    assert ds.topology == "lumi" and ds.p == 8
    cell = ds.cells["allreduce/b" + str(D.payload_bucket(1 << 20))]
    assert cell.n == 1
    assert cell.ewma_log_ratio == pytest.approx(math.log(3.0))
    ds2 = D.ingest_measurements(ms, base=ds)
    assert ds2 is ds and cell.n == 2


def test_save_load_roundtrip(tmp_path):
    ds = _dset()
    pred = D.predicted_time("allreduce", "bine", 8, 1 << 20, "lumi")
    D.observe(ds, "allreduce", "bine", 1 << 20, pred * 2.0)
    path = D.save_drift(ds, dir=str(tmp_path))
    assert path is not None and os.path.exists(path)
    assert not os.path.exists(path + ".tmp")
    back = D.load_drift("cpu-test", "lumi", 8, dir=str(tmp_path))
    assert back.to_json_dict() == ds.to_json_dict()
    assert D.load_all_drift(dir=str(tmp_path))[0].key() == ds.key()
    assert D.load_all_drift(topology="other", dir=str(tmp_path)) == []
    assert D.load_all_drift(device_kind="other", dir=str(tmp_path)) == []


def test_drift_dir_env(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_DRIFT_DIR", str(tmp_path))
    assert D.drift_dir() == str(tmp_path)
    assert D.drift_path(_dset()) == str(tmp_path /
                                        "cpu-test__lumi__p8.json")


def test_corrupt_store_quarantined_with_one_warning(tmp_path,
                                                    fresh_warn_state):
    path = D.drift_path(_dset(), dir=str(tmp_path))
    with open(path, "w") as f:
        f.write("{ torn write")
    with pytest.warns(UserWarning, match="quarantined"):
        assert D.load_drift("cpu-test", "lumi", 8, dir=str(tmp_path)) is None
    assert os.path.exists(path + D.CORRUPT_SUFFIX)
    assert not os.path.exists(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert D.load_drift("cpu-test", "lumi", 8, dir=str(tmp_path)) is None


def test_unwritable_dir_warns_once_returns_none(tmp_path, fresh_warn_state):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory\n")
    ro = str(blocker / "store")     # makedirs fails for any uid
    with pytest.warns(UserWarning, match="NOT persisted"):
        assert D.save_drift(_dset(), dir=ro) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert D.save_drift(_dset(), dir=ro) is None


def test_format_version_gate(tmp_path, fresh_warn_state):
    d = _dset().to_json_dict()
    d["format"] = 99
    with pytest.raises(ValueError, match="unsupported drift format"):
        D.DriftSet.from_json_dict(d)
    path = os.path.join(str(tmp_path), _dset().key() + ".json")
    with open(path, "w") as f:
        json.dump(d, f)
    with pytest.warns(UserWarning):
        assert D.load_drift("cpu-test", "lumi", 8,
                            dir=str(tmp_path)) is None


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("collective", COLLECTIVES)
def test_predicted_time_equals_reference(topology, collective):
    n = 0
    for backend in BACKENDS:
        for p in (2, 4, 8, 32):
            for nbytes in (256, 1 << 12, 16384, 16385, 1 << 20, 3 << 22,
                           1 << 28):
                for wire in ("float32", "bfloat16", "int8"):
                    got = D.predicted_time(collective, backend, p, nbytes,
                                           topology, wire)
                    exp = J.predicted_time(collective, backend, p, nbytes,
                                           topology, wire)
                    assert (got is None) == (exp is None), \
                        (backend, p, nbytes, wire, got, exp)
                    if exp is not None:
                        assert math.isclose(got, exp, rel_tol=1e-12,
                                            abs_tol=0.0), \
                            (backend, p, nbytes, wire, got, exp)
                        n += 1
    assert n > 0


def test_payload_bucket_equals_reference():
    for nbytes in [0, 1, 255, 256, 257, 1000, 1 << 16, (1 << 16) + 1,
                   1 << 28, 1 << 30]:
        assert D.payload_bucket(nbytes) == J.payload_bucket(nbytes)
    for b in range(len(SIZE_BUCKETS)):
        assert D.bucket_bytes(b) == J.bucket_bytes(b)


def _observations(seed, topology):
    """Seeded samples: most cells near the model, a few mis-priced
    either way by a seeded factor."""
    rng = np.random.default_rng(seed)
    out = []
    for coll in ("allreduce", "reduce_scatter", "allgather"):
        for nbytes in (1 << 12, 1 << 16, 1 << 20, 1 << 24):
            scale = float(rng.choice([1.0, 1.0, 1.0, 4.0, 0.2]))
            for _ in range(int(rng.integers(1, 6))):
                backend = str(rng.choice(["bine", "recdoub", "ring",
                                          "pallas_fused"]))
                wire = "int8" if (coll != "allreduce" and rng.random() < 0.3
                                  and backend != "ring") else "float32"
                pred = J.predicted_time(coll, backend, 8, nbytes, topology,
                                        wire)
                t = pred * scale * float(np.exp(rng.normal(0, 0.1)))
                out.append((coll, backend, nbytes, t, wire))
    return out


@pytest.mark.parametrize("topology", ["lumi", "torus"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hints_equal_reference(topology, seed):
    got = _dset(topology=topology)
    exp = J.DriftSet(device_kind="cpu-test", topology=topology, p=8,
                     provenance={"timestamp": "t0", "source": "test"})
    for coll, backend, nbytes, t, wire in _observations(seed, topology):
        a = D.observe(got, coll, backend, nbytes, t, wire_dtype=wire)
        b = J.observe(exp, coll, backend, nbytes, t, wire_dtype=wire)
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-15)
    for thr in (D.DEFAULT_THRESHOLD, 0.1, 1.0):
        gh, eh = D.hints(got, thr), J.hints(exp, thr)
        assert [(h.collective, h.p, h.bucket, h.nbytes, h.n,
                 h.last_backend) for h in gh] == \
            [(h.collective, h.p, h.bucket, h.nbytes, h.n,
              h.last_backend) for h in eh]
        for g, e in zip(gh, eh):
            assert math.isclose(g.ewma_log_ratio, e.ewma_log_ratio,
                                rel_tol=1e-12, abs_tol=1e-15)
    assert D.hints(got, 0.0)   # some cell moved at all


def test_ingest_equals_reference():
    ms = [Measurement(c, b, 8, n, t, 5, w)
          for c, b, n, t, w in _observations(3, "lumi")]
    got = D.ingest_measurements(MeasurementSet("cpu", "lumi", 8,
                                               {"grid": "g"}, ms))
    exp = J.ingest_measurements(jstore.MeasurementSet(
        "cpu", "lumi", 8, {"grid": "g"},
        [jstore.Measurement(m.collective, m.backend, m.p, m.nbytes,
                            m.time_s, m.reps, m.wire_dtype) for m in ms]))
    gd, ed = got.to_json_dict(), exp.to_json_dict()
    assert sorted(gd["cells"]) == sorted(ed["cells"])
    for k, c in ed["cells"].items():
        g = gd["cells"][k]
        assert math.isclose(g.pop("ewma_log_ratio"), c.pop("ewma_log_ratio"),
                            rel_tol=1e-12, abs_tol=1e-15)
        assert g == c
    gd.pop("cells"), ed.pop("cells")
    assert gd == ed


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_drift_file_crosses_packages(tmp_path, writer):
    d = str(tmp_path)
    obs = _observations(4, "lumi")
    if writer == "port":
        ds = _dset()
        for coll, backend, nbytes, t, wire in obs:
            D.observe(ds, coll, backend, nbytes, t, wire_dtype=wire)
        path = D.save_drift(ds, dir=d)
        back = J.load_drift("cpu-test", "lumi", 8, dir=d)
        assert J.load_all_drift(topology="lumi", dir=d)[0].key() == ds.key()
        flagged = [(h.collective, h.bucket) for h in J.hints(back)]
        assert flagged == [(h.collective, h.bucket) for h in D.hints(ds)]
    else:
        ds = J.DriftSet(device_kind="cpu-test", topology="lumi", p=8,
                        provenance={"timestamp": "t0", "source": "test"})
        for coll, backend, nbytes, t, wire in obs:
            J.observe(ds, coll, backend, nbytes, t, wire_dtype=wire)
        path = J.save_drift(ds, dir=d)
        back = D.load_drift("cpu-test", "lumi", 8, dir=d)
        assert D.load_all_drift(topology="lumi", dir=d)[0].key() == ds.key()
        flagged = [(h.collective, h.bucket) for h in D.hints(back)]
        assert flagged == [(h.collective, h.bucket) for h in J.hints(ds)]
    assert back.to_json_dict() == ds.to_json_dict()
    assert os.path.basename(path) == "cpu-test__lumi__p8.json"


def test_drift_files_byte_identical(tmp_path):
    got, exp = _dset(), J.DriftSet(device_kind="cpu-test", topology="lumi",
                                   p=8, provenance={"timestamp": "t0",
                                                    "source": "test"})
    for coll, backend, nbytes, t, wire in _observations(5, "lumi"):
        pred = J.predicted_time(coll, backend, 8, nbytes, "lumi", wire)
        # exact model times: both EWMAs stay at exactly 0.0
        D.observe(got, coll, backend, nbytes, pred, wire_dtype=wire)
        J.observe(exp, coll, backend, nbytes, pred, wire_dtype=wire)
    a = D.save_drift(got, dir=str(tmp_path / "a"))
    b = J.save_drift(exp, dir=str(tmp_path / "b"))
    assert open(a).read() == open(b).read()
