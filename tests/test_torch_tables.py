"""The port's own copies of the schedule tables and of the packaged
bucket capacities equal the JAX package's."""

import numpy as np
import pytest

from repro.core import tables as jtb
from repro.topology import PRESETS, select_bucket_bytes
from repro_torch import topology as ttopo
from repro_torch.core import tables as ttb

PS = [2, 4, 8, 16, 32]
KINDS = ["bine_dd", "recdoub_dd", "bine_dh", "recdoub_dh"]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("kind", KINDS)
def test_butterfly_tables_match(kind, p):
    try:
        exp = jtb.butterfly_tables(kind, p)
    except ValueError as e:          # no future-cone partition (bine_dh)
        with pytest.raises(ValueError, match="future-cone"):
            ttb.butterfly_tables(kind, p)
        assert "future-cone" in str(e)
        return
    got = ttb.butterfly_tables(kind, p)
    assert (got.p, got.s, got.perms) == (exp.p, exp.s, exp.perms)
    for f in ("keep_off", "send_off", "cbit", "final_block", "inv_final"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f),
                                      err_msg=f)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("kind", KINDS)
def test_small_butterfly_perms_match(kind, p):
    assert ttb.small_butterfly_perms(kind, p) == \
        jtb.small_butterfly_perms(kind, p)


def test_bucket_bytes_presets_match():
    assert sorted(ttopo.BUCKET_BYTES) == sorted(PRESETS)


@pytest.mark.parametrize("topology", sorted(ttopo.BUCKET_BYTES))
def test_bucket_bytes_copy_matches(topology):
    for p in (2, 3, 4, 6, 8, 12, 16, 32, 64, 128, 256, 1024):
        assert ttopo.select_bucket_bytes(p, topology) == \
            select_bucket_bytes(p, topology), (topology, p)


def test_bucket_bytes_unknown_topology_raises():
    with pytest.raises(ValueError, match="unknown topology"):
        ttopo.select_bucket_bytes(4, "nowhere")
