"""The write side of the port's decision tables (``topology.table``).

* ``build_table`` with the reference's constants rebuilds each of the
  five packaged tables byte for byte.
* ``with_measured_cells`` and ``merge_measured`` give the reference's
  tables on the same cells, and raise its exception types off the grid.
* Tables built at the H100's HBM rate (3.35e12 B/s, NVIDIA data sheet)
  for each grouped preset, on the reference test's small grid: every
  entry is the argmin of the port's ``predict_time`` at that rate, and
  every chosen schedule passes the simulate oracle.  Nothing new is
  packaged.
"""

import pytest

from repro.topology import table as jtable
from repro_torch.core import simulate
from repro_torch.topology import cost, presets, table
from torch_threads import pin_threads  # noqa: F401

H100_HBM_BW = 3.35e12
TEST_PS = (4, 8, 16, 64)
TEST_SIZES = (1 << 10, 1 << 14, 1 << 20, 1 << 26)


@pytest.mark.parametrize("name", presets.PRESETS)
def test_build_table_rebuilds_the_packaged_file(name):
    with open(table.table_path(name)) as f:
        packaged = f.read()
    assert table.build_table(name).to_json() == packaged


def _cells(tab):
    """A few cells of every collective, measured as another backend."""
    cells, wire_cells = {}, {}
    for i, (coll, per_p) in enumerate(sorted(tab.entries.items())):
        p = sorted(per_p)[i % len(per_p)]
        cells[(coll, p, i % len(tab.size_buckets))] = "ring"
        if coll in tab.wire_entries:
            wire_cells[(coll, p, 3)] = ("bine", "int8")
    return cells, wire_cells


@pytest.mark.parametrize("name", ["tpu_multipod", "torus"])
def test_measured_merges_match(name, tmp_path):
    tb = table.load_table(name)
    jb = jtable.load_table(name, build_if_missing=False)
    cells, wire_cells = _cells(tb)
    got = table.with_measured_cells(tb, cells, wire_cells)
    exp = jtable.with_measured_cells(jb, cells, wire_cells)
    assert got.to_json_dict() == exp.to_json_dict()
    again = table.with_measured_cells(got, {("allgather", 8, 0): "bine"})
    assert again.to_json_dict() == jtable.with_measured_cells(
        exp, {("allgather", 8, 0): "bine"}).to_json_dict()
    assert table.merge_measured(tb, got).to_json_dict() == \
        jtable.merge_measured(jb, exp).to_json_dict()
    assert got.provenance_of(*next(iter(cells))[:2],
                             tb.size_buckets[next(iter(cells))[2]]) == \
        table.MEASURED
    path = str(tmp_path / "t.json")
    got.save(path)
    assert table.DecisionTable.load(path) == got
    for bad in ({("allreduce", 5, 0): "ring"}, {("allreduce", 8, 99): "x"}):
        with pytest.raises(KeyError):
            table.with_measured_cells(tb, bad)
        with pytest.raises(KeyError):
            jtable.with_measured_cells(jb, bad)
    with pytest.raises(KeyError):
        table.with_measured_cells(tb, {}, {("alltoall", 8, 0): ("bine",
                                                                 "int8")})
    small = table.build_table(name, ps=(4, 8), size_buckets=(1024,))
    with pytest.raises(ValueError, match="does not match"):
        table.merge_measured(tb, small)


@pytest.mark.parametrize("name", sorted(presets.GROUPED_PRESETS))
def test_h100_table_choices_pass_the_oracle(name):
    tab = table.build_table(name, ps=TEST_PS, size_buckets=TEST_SIZES,
                            hbm_bw=H100_HBM_BW)
    checked = set()
    for coll, per_p in tab.entries.items():
        cands = cost.candidates_for(coll, name)
        for p, row in per_p.items():
            topo = presets.get_topology(name, p)
            for edge, backend in zip(TEST_SIZES, row):
                times = {b: cost.predict_time(coll, b, p, edge, topo,
                                              hbm_bw=H100_HBM_BW)
                         for b in cands}
                assert times[backend] == min(times.values()), (coll, p, edge)
                checked.add(cost.schedule_algo(coll, backend, edge) + (p,))
    for coll, per_p in tab.wire_entries.items():
        for p, row in per_p.items():
            for edge, (backend, _) in zip(TEST_SIZES, row):
                checked.add(cost.schedule_algo(coll, backend, edge) + (p,))
    for sched_coll, algo, p in sorted(checked):
        simulate.check(sched_coll, algo, p)
    assert set(tab.bucket_bytes.values()) <= set(cost.BUCKET_SIZE_CANDIDATES)
