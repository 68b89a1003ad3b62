"""The port's block-level oracle (``core.simulate``) against the reference.

Over the reference's own conformance matrix (every registered
(collective, algo) at p in {4, 6, 8, 12, 16, 24}, the rooted ones also at
nonzero roots), the port's ``check`` passes where the reference's passes
and raises the same exception type where it raises.  It also runs on
``compose(collective, tiers)`` for every tier stack ``tier_split`` gives
at p = 8, 16 and 64 (the schedules ``bine_hier`` executes), and on
corrupted schedules, which both oracles must reject with the same type.
"""

import pytest

from repro.core import schedules as jsc
from repro.core import simulate as jsim
from repro_torch.core import schedules as tsc
from repro_torch.core import simulate as tsim
from repro_torch.topology import presets as tpresets
from torch_threads import pin_threads  # noqa: F401

PS = (4, 6, 8, 12, 16, 24)
ROOTED = ("broadcast", "reduce", "gather", "scatter")
MATRIX = [(c, a, p) for c in jsc.COLLECTIVES for a in jsc.list_algos(c)
          for p in PS]
GROUPED = sorted(tpresets.GROUPED_PRESETS)
TIER_STACKS = sorted({tpresets.tier_split(n, p) for n in GROUPED
                      for p in (8, 16, 64)})
RUNNERS = {"reduce_scatter": "run_reduce_scatter",
           "allgather": "run_allgather", "allreduce": "run_allreduce"}


def _outcome(fn):
    """None if ``fn()`` returns, else the name of what it raised."""
    try:
        fn()
    except Exception as e:      # the outcome under test
        return type(e).__name__
    return None


def _both(fn_j, fn_t):
    exp, got = _outcome(fn_j), _outcome(fn_t)
    assert got == exp, (got, exp)
    return got


def test_registry_matches_reference():
    assert tsc.COLLECTIVES == jsc.COLLECTIVES
    for c in jsc.COLLECTIVES:
        assert tsc.list_algos(c) == jsc.list_algos(c), c


@pytest.mark.parametrize("collective,algo,p", MATRIX,
                         ids=[f"{c}-{a}-p{p}" for c, a, p in MATRIX])
def test_check_matches_reference(collective, algo, p):
    assert _both(lambda: jsim.check(collective, algo, p),
                 lambda: tsim.check(collective, algo, p)) is None


@pytest.mark.parametrize(
    "collective,algo", [(c, a) for c in ROOTED for a in jsc.list_algos(c)],
    ids=[f"{c}-{a}" for c in ROOTED for a in jsc.list_algos(c)])
@pytest.mark.parametrize("p", PS)
def test_rooted_nonzero_roots_match_reference(collective, algo, p):
    for root in (1, p // 2, p - 1):
        assert _both(lambda: jsim.check(collective, algo, p, root=root),
                     lambda: tsim.check(collective, algo, p,
                                        root=root)) is None


@pytest.mark.parametrize("tiers", TIER_STACKS,
                         ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("collective", sorted(RUNNERS))
def test_composed_schedules_pass_the_oracle(collective, tiers):
    """Every composed schedule ``bine_hier`` runs passes both oracles."""
    p = 1
    for t in tiers:
        p *= t
    run = RUNNERS[collective]
    assert _both(
        lambda: getattr(jsim, run)(jsc.compose(collective, tiers), p),
        lambda: getattr(tsim, run)(tsc.compose(collective, tiers),
                                   p)) is None


def _corrupt(sc, how, collective, tiers):
    s = sc.compose(collective, tiers)
    if how == "drop_last":
        return sc.Schedule(s.steps[:-1], s.kinds[:-1], s.collective, s.p)
    if how == "reversed":
        return sc.Schedule(s.steps[::-1], s.kinds[::-1], s.collective, s.p)
    kinds = tuple("copy" if k == "reduce" else "reduce" for k in s.kinds)
    return sc.Schedule(s.steps, kinds, s.collective, s.p)


#: (collective, corruption); the allgather oracle reads no step kinds
CORRUPTED = [(c, h) for c in sorted(RUNNERS)
             for h in ("drop_last", "reversed", "kinds_swapped")
             if (c, h) != ("allgather", "kinds_swapped")]


@pytest.mark.parametrize("collective,how", CORRUPTED)
def test_corrupted_schedules_fail_alike(collective, how):
    tiers = (4, 2)
    run = RUNNERS[collective]
    got = _both(
        lambda: getattr(jsim, run)(_corrupt(jsc, how, collective, tiers), 8),
        lambda: getattr(tsim, run)(_corrupt(tsc, how, collective, tiers), 8))
    assert got is not None


def test_unknown_collective_and_algo_raise_alike():
    assert _both(lambda: jsim.check("nope", "bine", 8),
                 lambda: tsim.check("nope", "bine", 8)) is not None
    assert _both(lambda: jsim.check("allreduce", "nope", 8),
                 lambda: tsim.check("allreduce", "nope", 8)) is not None
