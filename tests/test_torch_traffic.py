"""The port's traffic accounting (``core.traffic``) against the reference.

Exact float equality over the four grouped presets (and the torus) at
p in {8, 16, 64, 256}: the global-link and hop bytes, the α-β step-time
models and the traffic reduction of the paper's schedules, the closed
forms of the composed schedules, and the allocation sampler, which must
draw the same nodes for the same seed.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import schedules as jsc
from repro.core import traffic as jtr
from repro.topology import presets as jpresets
from repro_torch.core import schedules as tsc
from repro_torch.core import traffic as ttr
from repro_torch.topology import presets as tpresets
from torch_threads import pin_threads  # noqa: F401

PS = (8, 16, 64, 256)
GROUPED = ("LUMI", "LEONARDO", "MARENOSTRUM5", "TPU_MULTIPOD")
#: (collective, algo) of the byte and time checks; the base algos of the
#: paper's reduction tables among them
SCHEDS = (("reduce_scatter", "bine"), ("reduce_scatter", "recdoub"),
          ("reduce_scatter", "ring"), ("allgather", "bine"),
          ("allgather", "recdoub"), ("allreduce", "bine"),
          ("allreduce", "recdoub"), ("broadcast", "bine"),
          ("broadcast", "binomial_dh"), ("reduce", "bine_large"),
          ("gather", "bine"), ("scatter", "bine"), ("alltoall", "bine"),
          ("alltoall", "bruck"))
VEC = float(1 << 20)


def _topos(name):
    return getattr(jtr, name), getattr(ttr, name)


@pytest.mark.parametrize("name", GROUPED)
def test_presets_match(name):
    j, t = _topos(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [t.group_of(n) for n in range(0, 2000, 7)] == \
        [j.group_of(n) for n in range(0, 2000, 7)]


def _placement(p, topo_j, seed):
    return jtr.sample_allocation(np.random.RandomState(seed), p, topo_j)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("coll,algo", SCHEDS,
                         ids=[f"{c}-{a}" for c, a in SCHEDS])
def test_bytes_and_times_match(coll, algo, p):
    sj = jsc.get_schedule(coll, algo, p)
    st = tsc.get_schedule(coll, algo, p)
    assert ttr.total_bytes(st, p, VEC) == jtr.total_bytes(sj, p, VEC)
    for name in GROUPED:
        j, t = _topos(name)
        for place in (None, _placement(p, j, p)):
            assert ttr.global_bytes(st, p, VEC, t, place) == \
                jtr.global_bytes(sj, p, VEC, j, place), name
            assert ttr.sched_time(st, p, VEC, t, place) == \
                jtr.sched_time(sj, p, VEC, j, place), name
        assert ttr.sched_time(st, p, VEC, t, segment_bytes=4096.0) == \
            jtr.sched_time(sj, p, VEC, j, segment_bytes=4096.0)
    dims = jpresets.torus_dims(p)
    tj, tt = jtr.TorusTopo("torus", dims), ttr.TorusTopo("torus", dims)
    assert ttr.hop_bytes(st, p, VEC, tt) == jtr.hop_bytes(sj, p, VEC, tj)
    assert ttr.torus_time(st, p, VEC, tt) == jtr.torus_time(sj, p, VEC, tj)


@pytest.mark.parametrize("p", PS)
def test_traffic_reduction_matches(p):
    pairs = (("reduce_scatter", "bine", "recdoub"),
             ("allgather", "bine", "recdoub"),
             ("allreduce", "bine", "recdoub"),
             ("broadcast", "bine", "binomial_dh"))
    for coll, a, b in pairs:
        for name in GROUPED:
            j, t = _topos(name)
            for place in (None, _placement(p, j, 7)):
                assert ttr.traffic_reduction(coll, a, b, p, VEC, t, place) \
                    == jtr.traffic_reduction(coll, a, b, p, VEC, j, place)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", sorted(jpresets.GROUPED_PRESETS))
def test_composed_closed_forms_match(name, p):
    """Per-phase and crossing bytes of the schedules ``bine_hier`` runs,
    at every prefix product of the preset's tier stack."""
    tiers = tpresets.tier_split(name, p)
    prefixes = [1]
    for t in tiers:
        prefixes.append(prefixes[-1] * t)
    for coll in ("reduce_scatter", "allgather", "allreduce"):
        assert ttr.compose_phase_bytes(coll, tiers, VEC) == \
            jtr.compose_phase_bytes(coll, tiers, VEC)
        for pg in prefixes:
            assert ttr.compose_global_bytes(coll, tiers, VEC, pg) == \
                jtr.compose_global_bytes(coll, tiers, VEC, pg)
    if len(tiers) > 1:
        with pytest.raises(ValueError, match="prefix product"):
            ttr.compose_global_bytes("allreduce", tiers, VEC, 3)
        with pytest.raises(ValueError, match="prefix product"):
            jtr.compose_global_bytes("allreduce", tiers, VEC, 3)


@pytest.mark.parametrize("n_nodes", PS)
@pytest.mark.parametrize("name", GROUPED)
def test_sample_allocation_same_draws(name, n_nodes):
    j, t = _topos(name)
    rj, rt = np.random.RandomState(n_nodes), np.random.RandomState(n_nodes)
    for _ in range(5):
        assert ttr.sample_allocation(rt, n_nodes, t) == \
            jtr.sample_allocation(rj, n_nodes, j)


@pytest.mark.parametrize("name", GROUPED)
def test_allocation_reduction_distribution_matches(name):
    j, t = _topos(name)
    for p in (16, 64):
        got = ttr.allocation_reduction_distribution(
            "allreduce", "bine", "recdoub", p, t, n_jobs=8, seed=3)
        exp = jtr.allocation_reduction_distribution(
            "allreduce", "bine", "recdoub", p, j, n_jobs=8, seed=3)
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
