"""The fused collective kernels: the plain stacked versions of the step
kernels (``rs_step``, ``ag_step``, ``rs_step_q``, ``ring_update``) are
BITWISE equal, row by row, to the JAX package's ``ref.py`` and to its
Pallas kernels run in interpret mode, and those of the matmul
(``matmul_pack``, ``gather_matmul``) within 1e-5, as the reference's own
tests hold its kernels; on a card the CUDA kernels equal the plain
versions (the matmul within a bound stated from k), and a CUDA tensor never
falls back to them."""

import functools
import importlib

import numpy as np
import pytest
import torch

from repro_torch.collectives import compression as tcomp
from repro_torch.kernels import build as KB
from repro_torch.kernels.collectives import kernel as K
from repro_torch.kernels.collectives import ref as R


class _Lazy:
    """A module imported at its first use: only the CPU comparisons run the
    JAX reference, and the GPU machine that runs the ``cuda`` tests has no
    JAX."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jax = _Lazy("jax")
jnp = _Lazy("jax.numpy")
PK = _Lazy("repro.kernels.collectives.kernel")
JR = _Lazy("repro.kernels.collectives.ref")

rng = np.random.RandomState(0)
#: per-rank half bits covering every (c, c_next) pair across 4 ranks
C = np.array([0, 1, 1, 0], np.int32)
CN = np.array([1, 0, 1, 0], np.int32)
P = len(C)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _same(a, b, msg=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape, msg)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.astype(np.float32).view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [8, 1024, 6, 10])
def test_rs_step_plain_matches_jax(h, dtype):
    buf = rng.randn(P, 2 * h).astype(np.float32)
    recv = rng.randn(P, h).astype(np.float32)
    tdt = getattr(torch, dtype)
    new = R.rs_step_ref(_t(buf, tdt), _t(recv, tdt), _t(C))
    new2, send = R.rs_step_ref(_t(buf, tdt), _t(recv, tdt), _t(C), _t(CN))
    _same(new, new2)
    for r in range(P):
        jb = jnp.asarray(buf[r]).astype(dtype)
        jv = jnp.asarray(recv[r]).astype(dtype)
        c, cn = int(C[r]), int(CN[r])
        _same(new[r], JR.rs_step_ref(jb, jv, c), f"ref rank {r}")
        _same(new[r], PK.rs_step_kernel(jb, jv, c, interpret=True),
              f"pallas rank {r}")
        if h % 2:
            continue
        jo, js = PK.rs_step_kernel(jb, jv, c, cn, interpret=True)
        _same(new2[r], jo, f"pallas send-variant rank {r}")
        _same(send[r], js, f"pallas send rank {r}")
        _same(send[r], JR.rs_step_ref(jb, jv, c, cn)[1], f"ref send {r}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h", [8, 512, 6])
def test_ag_step_plain_matches_jax(h, dtype):
    if dtype == "int8":
        buf = rng.randint(-127, 128, (P, h)).astype(np.int8)
        recv = rng.randint(-127, 128, (P, h)).astype(np.int8)
        tdt = torch.int8
    else:
        buf = rng.randn(P, h).astype(np.float32)
        recv = rng.randn(P, h).astype(np.float32)
        tdt = getattr(torch, dtype)
    out = R.ag_step_ref(_t(buf, tdt), _t(recv, tdt), _t(C))
    assert out.dtype == tdt
    for r in range(P):
        jb = jnp.asarray(buf[r]).astype(dtype)
        jv = jnp.asarray(recv[r]).astype(dtype)
        _same(out[r], JR.ag_step_ref(jb, jv, int(C[r])), f"ref rank {r}")
        _same(out[r], PK.ag_step_kernel(jb, jv, int(C[r]), interpret=True),
              f"pallas rank {r}")


def _q_inputs(h):
    buf = rng.randn(P, 2 * h).astype(np.float32)
    recv, scales = tcomp.quantize_wire(_t(rng.randn(P, h).astype(np.float32)))
    return buf, recv.numpy(), scales.numpy()


def _q_inputs_non_finite(h):
    """``_q_inputs`` with a NaN and an infinity in each half of every
    rank's row of ``new`` (so in the next send half whatever ``c_next``):
    in one codec chunk at h = 512, in two chunks from h = 1024."""
    buf, rq, rs = _q_inputs(h)
    for j in (5, h // 2 + 5):
        buf[:, j], buf[:, h + j] = np.nan, np.nan
        buf[:, j + h // 4], buf[:, h + j + h // 4] = np.inf, -np.inf
    return buf, rq, rs


@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("h", [512, 1024, 2048])
def test_rs_step_q_send_plain_matches_jax(h, finite):
    """Also with a NaN or an infinity in the send half: the chunk max keeps
    NaN (scale 1.0), and float-to-int8 maps NaN to 0."""
    buf, rq, rs = (_q_inputs if finite else _q_inputs_non_finite)(h)
    new, sq, ss = R.rs_step_ref_q(_t(buf), _t(rq), _t(rs), _t(C), _t(CN))
    assert sq.dtype == torch.int8 and ss.shape == (P, h // 2 // 256)
    assert bool(torch.isfinite(new).all()) == finite
    for r in range(P):
        args = (jnp.asarray(buf[r]), jnp.asarray(rq[r]), jnp.asarray(rs[r]),
                int(C[r]), int(CN[r]))
        for tag, exp in (("ref", JR.rs_step_ref_q(*args)),
                         ("pallas", PK.rs_step_kernel_q(*args,
                                                        interpret=True))):
            _same(new[r], exp[0], f"{tag} new rank {r}")
            _same(sq[r], exp[1], f"{tag} q rank {r}")
            _same(ss[r], exp[2], f"{tag} scales rank {r}")


@pytest.mark.parametrize("h", [6, 96, 512])
def test_rs_step_q_nosend_plain_matches_jax(h):
    buf, rq, rs = _q_inputs(h)
    assert rs.shape == (P, h // tcomp.wire_chunk(h))
    new = R.rs_step_ref_q(_t(buf), _t(rq), _t(rs), _t(C))
    for r in range(P):
        args = (jnp.asarray(buf[r]), jnp.asarray(rq[r]), jnp.asarray(rs[r]),
                int(C[r]))
        _same(new[r], JR.rs_step_ref_q(*args), f"ref rank {r}")
        _same(new[r], PK.rs_step_kernel_q(*args, interpret=True),
              f"pallas rank {r}")


def test_wrappers_take_plain_version_on_cpu():
    h = 512
    buf, rq, rs = _q_inputs(h)
    KB.reset_launches()
    _same(K.rs_step(_t(buf), _t(buf[:, :h]), _t(C)),
          R.rs_step_ref(_t(buf), _t(buf[:, :h]), _t(C)))
    _same(K.ag_step(_t(rq), _t(rq), _t(C)), R.ag_step_ref(_t(rq), _t(rq), _t(C)))
    for a, b in zip(K.rs_step_q(_t(buf), _t(rq), _t(rs), _t(C), _t(CN)),
                    R.rs_step_ref_q(_t(buf), _t(rq), _t(rs), _t(C), _t(CN))):
        _same(a, b)
    # the plain version is no kernel launch
    assert not any(KB.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else must be a
    CUDA launch or an error, never a quiet fallback."""
    meta = torch.empty((P, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        K.rs_step(torch.empty((P, 32), device="meta"), meta,
                  torch.empty(P, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        K.ag_step(meta, torch.zeros((P, 16)), torch.zeros(P, dtype=torch.int32))


#: per-rank block indices, mixed across ranks
RIDX = np.array([2, 0, 3, 2], np.int32)
NBLK = 4


def _ring_inputs(b, dtype):
    if dtype == "int32":
        v = rng.randint(-1000, 1000, (P, NBLK * b)).astype(np.int32)
        recv = rng.randint(-1000, 1000, (P, b)).astype(np.int32)
    elif dtype == "bool":
        v = rng.rand(P, NBLK * b) > 0.5
        recv = rng.rand(P, b) > 0.5
    else:
        v = rng.randn(P, NBLK * b).astype(np.float32)
        recv = rng.randn(P, b).astype(np.float32)
    return v, recv


def _jt(a, dtype):
    """A numpy array as a JAX array of ``dtype`` (bf16 via float32)."""
    return jnp.asarray(a).astype(dtype)


@functools.lru_cache(maxsize=None)
def _jax_ring(acc, upd):
    """The reference's ref and interpret-mode kernel, jitted with the block
    index traced, so the ranks of one case share one compile."""
    ref = jax.jit(lambda v, r, i: JR.ring_update_ref(v, r, i, acc))
    ker = jax.jit(lambda v, r, i: PK.ring_update_kernel(
        v, r, i, accumulate=acc, return_updated=upd, interpret=True))
    return ref, ker


@functools.lru_cache(maxsize=None)
def _jax_mm(perm):
    perm = np.asarray(perm, np.int32)
    return (jax.jit(lambda x, w: JR.matmul_pack_ref(x, w, perm)),
            jax.jit(lambda x, w: PK.matmul_pack_kernel(
                x, w, jnp.asarray(perm), interpret=True)),
            jax.jit(lambda x, w: JR.gather_matmul_ref(x, w, perm)),
            jax.jit(lambda x, w: PK.gather_matmul_kernel(
                x, w, jnp.asarray(perm), interpret=True)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "bool"])
@pytest.mark.parametrize("b", [8, 12, 6, 128])
def test_ring_update_plain_matches_jax(b, dtype):
    """All three variants, a different block per rank, row by row against
    the reference's ref and its interpret-mode kernel.  Accumulate takes
    float32 and bf16; write any dtype."""
    v, recv = _ring_inputs(b, dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "bool": torch.bool}[dtype]
    ridx = _t(RIDX)
    variants = [(False, False)]
    if dtype in ("float32", "bfloat16"):
        variants += [(True, False), (True, True)]
    for acc, upd in variants:
        tv = _t(v, tdt).clone()
        res = R.ring_update_ref(tv, _t(recv, tdt), ridx, acc, upd)
        got, send = (res if upd else (res, None))
        assert got is tv                   # in place
        jref, jker = _jax_ring(acc, upd)
        for r in range(P):
            jv, jr = _jt(v[r], dtype), _jt(recv[r], dtype)
            ri = int(RIDX[r])
            tag = f"acc={acc} upd={upd} rank {r}"
            _same(got[r], jref(jv, jr, jnp.int32(ri)), "ref " + tag)
            kout = jker(jv, jr, jnp.int32(ri))
            if upd:
                _same(got[r], kout[0], "pallas " + tag)
                _same(send[r], kout[1], "pallas send " + tag)
            else:
                _same(got[r], kout, "pallas " + tag)
            # the other blocks are untouched
            for blk in set(range(NBLK)) - {ri}:
                _same(got[r, blk * b:(blk + 1) * b],
                      _t(v[r, blk * b:(blk + 1) * b], tdt), "untouched")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 40, 24), (96, 72, 40), (8, 3, 5)])
def test_perm_matmul_plain_matches_jax(shape, dtype):
    """``matmul_pack_ref`` and ``gather_matmul_ref`` of the port against
    the reference's refs and its interpret-mode kernels, rank by rank, at
    shapes that are no multiples of 128, within 1e-5 (bf16 results: one
    bf16 rounding, 2**-8 relative)."""
    m, k, n = shape
    perm = np.array([2, 0, 3, 1], np.int32)
    x = rng.randn(P, m, k).astype(np.float32)
    w = rng.randn(P, k, n).astype(np.float32)
    tdt = getattr(torch, dtype)
    tx, tw = _t(x, tdt), _t(w, tdt)
    pack = R.matmul_pack_ref(tx, tw, _t(perm))
    gath = R.gather_matmul_ref(tx, tw, _t(perm))
    assert pack.dtype == gath.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2 ** -8 * 8
    jpack, jpack_k, jgath, jgath_k = _jax_mm(tuple(perm))
    for r in range(P):
        jx, jw = _jt(x[r], dtype), _jt(w[r], dtype)
        for tag, got, exp in (
                ("pack ref", pack[r], jpack(jx, jw)),
                ("pack pallas", pack[r], jpack_k(jx, jw)),
                ("gather ref", gath[r], jgath(jx, jw)),
                ("gather pallas", gath[r], jgath_k(jx, jw))):
            np.testing.assert_allclose(_np(got), _np(exp), rtol=tol,
                                       atol=tol, err_msg=f"{tag} rank {r}")


def test_new_wrappers_take_plain_version_on_cpu():
    KB.reset_launches()
    v, recv = _ring_inputs(8, "float32")
    tv = _t(v).clone()
    out, send = K.ring_update(tv, _t(recv), _t(RIDX), True, True)
    ev, es = R.ring_update_ref(_t(v), _t(recv), _t(RIDX), True, True)
    _same(out, ev)
    _same(send, es)
    with pytest.raises(ValueError, match="return_updated needs accumulate"):
        K.ring_update(tv, _t(recv), _t(RIDX), False, True)
    x = _t(rng.randn(P, 8, 3).astype(np.float32))
    w = _t(rng.randn(P, 3, 5).astype(np.float32))
    perm = _t(np.array([1, 0], np.int32))
    _same(K.perm_matmul(x, w, perm, lhs_perm=False),
          R.matmul_pack_ref(x, w, perm))
    _same(K.perm_matmul(x, w, perm, lhs_perm=True),
          R.gather_matmul_ref(x, w, perm))
    assert not any(KB.LAUNCHES.values())


#: (p, m, k, n), nb, x and w dtypes, whether the tensor-core kernel takes
#: the call: chip_smoke.py's TP shapes (MM_RS, MM_AG) in bf16 and float32,
#: the cuda test's shapes, and each condition of the rule broken alone
WGMMA_RULE = [
    ((4, 8192, 2048, 3072), 4, ("bfloat16", "bfloat16"), True),   # MM_RS
    ((4, 8192, 3072, 2048), 4, ("bfloat16", "bfloat16"), True),   # MM_AG
    ((4, 8192, 2048, 3072), 4, ("float32", "float32"), False),
    ((4, 256, 264, 136), 4, ("bfloat16", "bfloat16"), True),      # ragged k, n
    ((4, 512, 1000, 520), 4, ("bfloat16", "bfloat16"), True),
    ((4, 512, 256, 384), 4, ("bfloat16", "bfloat16"), True),
    ((4, 512, 256, 384), 8, ("bfloat16", "bfloat16"), True),      # rows 64
    ((4, 512, 256, 384), 4, ("bfloat16", "float32"), False),      # mixed
    ((4, 512, 256, 384), 4, ("float32", "bfloat16"), False),
    ((4, 384, 256, 384), 4, ("bfloat16", "bfloat16"), False),     # rows 96
    ((4, 512, 260, 384), 4, ("bfloat16", "bfloat16"), False),     # k % 8
    ((4, 512, 256, 388), 4, ("bfloat16", "bfloat16"), False),     # n % 8
    ((4, 260, 70, 130), 4, ("bfloat16", "bfloat16"), False),
    ((4, 40, 24, 12), 4, ("bfloat16", "bfloat16"), False),
]


@pytest.mark.parametrize("shape,nb,dtypes,wgmma", WGMMA_RULE,
                         ids=[f"{'x'.join(map(str, c[0]))}-nb{c[1]}-"
                              f"{c[2][0][:4]}{c[2][1][:4]}"
                              for c in WGMMA_RULE])
def test_perm_matmul_wgmma_rule(shape, nb, dtypes, wgmma):
    """Which calls the tensor-core kernel takes: bf16 x and w, row blocks
    of a multiple of 64 rows, k and n multiples of 8 (stride-0 stand-ins:
    the rule reads shapes, dtypes and addresses only)."""
    p, m, k, n = shape
    x = torch.zeros((), dtype=getattr(torch, dtypes[0])).expand(p, m, k)
    w = torch.zeros((), dtype=getattr(torch, dtypes[1])).expand(p, k, n)
    assert K.perm_matmul_uses_wgmma(x, w, nb) is wgmma


def test_perm_matmul_wgmma_rule_needs_aligned_operands():
    """TMA reads from 16-byte aligned addresses: a bf16 view two bytes in
    goes to the CUDA-core kernel."""
    p, m, k, n = 4, 256, 64, 64
    x = torch.zeros(p * m * k + 8, dtype=torch.bfloat16)
    w = torch.zeros((p, k, n), dtype=torch.bfloat16)
    assert K.perm_matmul_uses_wgmma(x[:-8].view(p, m, k), w, 4)
    assert not K.perm_matmul_uses_wgmma(x[1:-7].view(p, m, k), w, 4)


#: (h, itemsize, send, aligned) -> rs_step's vector kernel
RS_VEC_RULE = [
    ((8 << 20, 4, True, True), True),     # the smoke's bucket step, f32
    ((8 << 20, 2, True, True), True),     # bf16
    ((8 << 20, 4, True, False), False),   # a pointer off 16 bytes
    ((6, 4, False, True), False),         # h not a multiple of the lanes
    ((12, 4, False, True), True),
    ((12, 4, True, True), False),         # h/2 not a multiple of the lanes
    ((1000, 2, False, True), True),
    ((1000, 2, True, True), False),
    ((1000, 4, True, True), True),
    ((1002, 4, False, True), False),
]


@pytest.mark.parametrize("case,vec", RS_VEC_RULE,
                         ids=[f"h{c[0]}-{c[1]}B-{'send' if c[2] else 'nosend'}"
                              f"-{'al' if c[3] else 'off'}"
                              for c, _ in RS_VEC_RULE])
def test_rs_step_launch_rule(case, vec):
    h, itemsize, send, aligned = case
    got_vec, grid = K.rs_step_launch(4, h, itemsize, send, aligned, 1056)
    assert got_vec is vec
    units = h // (16 // itemsize) if vec else h
    per = K.STEP_THREADS * (K.RS_UNROLL if vec else 1)
    assert grid == K.step_grid(4, units, per, 1056)


#: (h, aligned) -> (path, log2 of the codec chunk)
Q_RULE = [
    ((8 << 20, True), (0, 8)),      # the smoke's bucket step
    ((8 << 20, False), (1, 8)),
    ((512, True), (0, 8)),
    ((96, True), (0, 5)),           # codec chunk 32
    ((1000, True), (0, 3)),         # codec chunk 8: one scale a lane
    ((1000, False), (1, 3)),
    ((1004, True), (2, 2)),         # chunk 4: a lane would straddle scales
    ((6, True), (2, 1)),
    ((1001, False), (2, 0)),
]


@pytest.mark.parametrize("case,path", Q_RULE,
                         ids=[f"h{c[0]}-{'al' if c[1] else 'off'}"
                              for c, _ in Q_RULE])
def test_rs_step_q_launch_rule(case, path):
    h, aligned = case
    got = K.rs_step_q_launch(4, h, aligned, 1056)
    assert got[:2] == path
    assert 1 << got[1] == tcomp.wire_chunk(h)
    per = K.STEP_THREADS if path[0] == 2 else \
        K.STEP_THREADS // 32 * K.Q_WARP_ELEMS
    assert got[2] == K.step_grid(4, h, per, 1056)


#: (p, h, itemsize, pointer alignment) -> ag_step's unit (bytes)
AG_RULE = [
    ((4, 8 << 20, 4, 16), 16),     # the smoke's last AG step, f32
    ((4, 8 << 20, 2, 16), 16),     # bf16
    ((4, 8 << 20, 1, 16), 16),     # the int8 wire
    ((4, 128 << 10, 4, 16), 16),   # 1 MiB a rank
    ((1, 1000, 4, 16), 16),        # a row half ends mid-tile
    ((6, 1000, 1, 16), 4),         # 1000 bytes: not a 16-byte multiple
    ((8, 1001, 2, 16), 2),         # 2002 bytes
    ((4, 999, 1, 16), 1),          # int8, odd h
    ((4, 1001, 4, 16), 4),         # 4004 bytes
    ((4, 512, 4, 4), 4),           # a pointer 4 bytes off
    ((4, 512, 4, 8), 4),           # 8 bytes off: no 8-byte unit
    ((4, 512, 2, 2), 2),
    ((4, 512, 1, 1), 1),
    ((4, 0, 4, 16), 16),           # an empty row
]


@pytest.mark.parametrize("case,unit", AG_RULE,
                         ids=[f"p{c[0]}-h{c[1]}-{c[2]}B-al{c[3]}"
                              for c, _ in AG_RULE])
def test_ag_step_launch_rule(case, unit):
    """The widest unit dividing the row's bytes and the pointers' alignment;
    the units of a row half; a block for each tile of STEP_THREADS *
    RS_UNROLL units, each tile inside one of the 2p row halves."""
    p, h, itemsize, aligned = case
    got = K.ag_step_launch(p, h, itemsize, aligned)
    assert got[0] == unit and unit in K.AG_UNITS
    assert (h * itemsize) % unit == 0 and aligned % unit == 0
    assert got[1] * unit == h * itemsize
    tile = K.STEP_THREADS * K.RS_UNROLL
    assert got[2] == max(1, 2 * p * -(-got[1] // tile))
    # no tile of a row half is empty
    assert got[1] == 0 or (got[2] // (2 * p) - 1) * tile < got[1]


@pytest.mark.parametrize("p", [1, 4, 8, 6])
def test_step_grid_covers_the_row_within_the_waves(p):
    """A rank's blocks cover its row in one iteration where RS_WAVES waves
    allow it; otherwise all p ranks' blocks together fill RS_WAVES waves
    (to within one block a rank).  Never fewer than 1 block."""
    wave = 1056
    for units in (0, 1, 255, 256, 257, 4096, 1 << 20, 2 << 20, 1 << 30):
        for per in (256, 1024, 2048):
            g = K.step_grid(p, units, per, wave)
            assert g >= 1
            if g * per < units:
                assert K.RS_WAVES * wave <= g * p < K.RS_WAVES * wave + p
            else:
                assert (g - 1) * per < max(units, 1)
    assert K.step_grid(0, 10, 256, wave) == 1


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_wrapper_raises_without_library(cuda_device, monkeypatch,
                                             tmp_path):
    """A CUDA tensor with no buildable kernel raises; it never runs the
    plain version instead."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    from repro_torch.kernels import build as KB
    monkeypatch.setattr(KB, "_LIBS", {})
    monkeypatch.setattr(KB, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(KB, "_nvcc", no_nvcc)
    buf = torch.zeros((P, 32), device=cuda_device)
    c = torch.zeros(P, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.rs_step(buf, buf[:, :16].contiguous(), c)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.ag_step(buf, buf, c)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.ring_update(buf, buf[:, :16].contiguous(), c)
    x = torch.zeros((P, 8, 4), device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.perm_matmul(x, x.transpose(1, 2).contiguous(), c, lhs_perm=True)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [512, 4096, 6, 12, 96, 1000, 1002, 1001,
                               (1 << 20) + 12])
def test_cuda_kernels_match_plain(cuda_device, h):
    """Bitwise, f32 and bf16, with and without send, every path of the
    launch rules: h a multiple of the vector lanes (512, 4096) or not (6,
    1002, 1001), h/2 not (12 f32, 1000 bf16); rs_step_q's codec chunks 256
    (512, 4096), 32 (96), 8 (1000: the warp kernel, one scale a lane) and
    2 and 1 (6, 1002, 1001: the element-wise kernel); ag_step at p = 1, 4,
    6 and 8 in f32, bf16 and int8, every unit of ``ag_step_launch`` (16,
    4, 2 and 1 bytes across these h and dtypes: int8 at 1000, 1002 and
    1001 takes 4, 2 and 1), row halves that end mid-block, at 2**20 + 12
    more units than one pass of the grid covers, and through its C entry
    point at grids of 1 and 7 blocks, where each block walks many
    tiles."""
    dev = cuda_device
    buf = rng.randn(P, 2 * h).astype(np.float32)
    recv = rng.randn(P, h).astype(np.float32)
    c, cn = _t(C).to(dev), _t(CN).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        b, v = _t(buf, dt), _t(recv, dt)
        _same(K.rs_step(b.to(dev), v.to(dev), c).cpu(),
              R.rs_step_ref(b, v, _t(C)))
        _same(K.ag_step(v.to(dev), v.flip(0).contiguous().to(dev), c).cpu(),
              R.ag_step_ref(v, v.flip(0).contiguous(), _t(C)))
        if h % 2 == 0:
            for a, e in zip(K.rs_step(b.to(dev), v.to(dev), c, cn),
                            R.rs_step_ref(b, v, _t(C), _t(CN))):
                _same(a.cpu(), e)
    b, rq, rs = _q_inputs(h)
    args = (_t(b), _t(rq), _t(rs))
    _same(K.ag_step(args[1].to(dev), args[1].flip(0).contiguous().to(dev),
                    c).cpu(), R.ag_step_ref(args[1], args[1].flip(0), _t(C)))
    _same(K.rs_step_q(*(a.to(dev) for a in args), c).cpu(),
          R.rs_step_ref_q(*args, _t(C)))
    if h % 512 == 0:
        for a, e in zip(K.rs_step_q(*(a.to(dev) for a in args), c, cn),
                        R.rs_step_ref_q(*args, _t(C), _t(CN))):
            _same(a.cpu(), e)
    # ag_step at p = 1, 4, 6, 8 with distinct inputs and random bits, f32,
    # bf16 and int8 (the int8 row of odd h takes the byte kernel)
    for p in (1, 4, 6, 8):
        bits = _t(rng.randint(0, 2, p).astype(np.int32))
        x = rng.randn(2, p, h).astype(np.float32)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            a, b = (_t(np.clip(v * 50, -127, 127), dt) if dt == torch.int8
                    else _t(v, dt) for v in x)
            before = KB.LAUNCHES["ag_step"]
            got = K.ag_step(a.to(dev), b.to(dev), bits.to(dev)).cpu()
            assert KB.LAUNCHES["ag_step"] == before + 1
            exp = R.ag_step_ref(a, b, bits)
            _same(got, exp)
            if p != 4:
                continue
            # grids of 1 and 7 blocks walking the tiles
            ad, bd, cd = a.to(dev), b.to(dev), bits.to(dev)
            unit, n, _ = K.ag_step_launch(p, h, a.element_size(), 16)
            for grid in (1, 7):
                out = torch.empty((p, 2 * h), dtype=dt, device=dev)
                KB.raise_on(K._lib().repro_ag_step(
                    ad.data_ptr(), bd.data_ptr(), out.data_ptr(),
                    cd.data_ptr(), p, n, unit, grid, KB.stream(ad)),
                    "ag_step")
                _same(out.cpu(), exp, f"{dt} grid {grid}")


def _q_inputs_edges(h):
    """``_q_inputs_non_finite`` plus, in the last two codec chunks of both
    halves of both kept halves of every rank (so in the next send half
    whatever ``c`` and ``c_next``; clear of the NaN and infinity chunks
    from h = 4096), a chunk of subnormals whose max is a subnormal and a
    chunk holding FLT_MAX, -FLT_MAX and the smallest subnormal, each with
    a zero payload so ``new`` keeps them."""
    buf, rq, rs = _q_inputs_non_finite(h)
    tiny = np.float32(np.finfo(np.float32).tiny)
    big = np.finfo(np.float32).max
    for half in (0, h // 2):
        sub = h // 2 - 2 * 256 + half           # the last two chunks of a half
        for off in (0, h):
            buf[:, off + sub:off + sub + 256] = (
                rng.uniform(-1, 1, (P, 256)) * tiny / 4).astype(np.float32)
            buf[:, off + sub + 256:off + sub + 512] = rng.randn(P, 256)
            buf[:, off + sub + 300] = big
            buf[:, off + sub + 301] = -big
            buf[:, off + sub + 302] = np.float32(1.4e-45)
        rq[:, sub:sub + 512] = 0
    return buf, rq, rs


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1024, 4096, 8192])
def test_cuda_rs_step_q_non_finite_matches_plain(cuda_device, h):
    """The kernel's chunk max keeps NaN and its int8 cast maps NaN to 0, so
    a loss spike's NaN or infinity gives the plain version's bits; from h
    = 4096 so do a chunk whose max is a subnormal (scale 2**-126) and
    chunks holding FLT_MAX (scale 2**122): the quantizer's multiply by
    1/scale is exact.  The plain version runs on the card too (a NaN's
    bits are the card's)."""
    dev = cuda_device
    edges = h >= 4096
    args = tuple(_t(a) for a in (_q_inputs_edges if edges
                                 else _q_inputs_non_finite)(h))
    c, cn = _t(C).to(dev), _t(CN).to(dev)
    got = K.rs_step_q(*(a.to(dev) for a in args), c, cn)
    exp = R.rs_step_ref_q(*(a.to(dev) for a in args), c, cn)
    # the edge chunks reach the send half: scales 2**-126 and 2**122
    assert not edges or (bool((exp[2] == 2.0 ** -126).any())
                         and bool((exp[2] == 2.0 ** 122).any()))
    assert bool(exp[0].isnan().any()) and bool(exp[0].isinf().any())
    for a, e in zip(got, exp):
        _same(a.cpu(), e.cpu())
    _same(K.rs_step_q(*(a.to(dev) for a in args), c).cpu(),
          R.rs_step_ref_q(*(a.to(dev) for a in args), c).cpu())


def _offset_view(t, dev, nbytes=4):
    """A contiguous copy of ``t`` on ``dev``, ``nbytes`` into its storage
    (off 16 and 8 bytes: the allocator's blocks are 512-byte aligned)."""
    k = nbytes // t.element_size()
    flat = torch.zeros(t.numel() + k, dtype=t.dtype, device=dev)
    v = flat[k:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 == nbytes
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("h", [512, 1000])
def test_cuda_step_kernels_unaligned_views_match_plain(cuda_device, h):
    """Contiguous views 4 bytes into their storage: rs_step runs its
    element-wise kernel, rs_step_q its warp kernel element by element
    (``rs_step_q_launch`` path 1); both bitwise the plain version, with and
    without send.  ag_step through views 4, 2 and 1 bytes off takes the
    unit of that many bytes, bitwise."""
    dev = cuda_device
    c, cn = _t(C).to(dev), _t(CN).to(dev)
    buf = rng.randn(P, 2 * h).astype(np.float32)
    recv = rng.randn(P, h).astype(np.float32)
    for dt in (torch.float32, torch.bfloat16):
        b, v = _t(buf, dt), _t(recv, dt)
        ob, ov = _offset_view(b, dev), _offset_view(v, dev)
        assert not K.rs_step_launch(P, h, b.element_size(), False, False,
                                    1)[0]
        _same(K.rs_step(ob, ov, c).cpu(), R.rs_step_ref(b, v, _t(C)))
        for a, e in zip(K.rs_step(ob, ov, c, cn),
                        R.rs_step_ref(b, v, _t(C), _t(CN))):
            _same(a.cpu(), e)
    # ag_step through views 4, 2 and 1 bytes off: the 4-, 2- and 1-byte
    # units
    bits = _t(C).to(dev)
    for dt, off in ((torch.float32, 4), (torch.bfloat16, 4),
                    (torch.bfloat16, 2), (torch.int8, 1), (torch.int8, 2)):
        a, b = (_t(np.clip(x * 50, -127, 127), dt) if dt == torch.int8
                else _t(x, dt) for x in (recv, recv[::-1].copy()))
        oa, ob = _offset_view(a, dev, off), _offset_view(b, dev, off)
        unit = K.ag_step_launch(P, h, a.element_size(), off)[0]
        assert unit == off
        _same(K.ag_step(oa, ob, bits).cpu(), R.ag_step_ref(a, b, _t(C)))
    args = tuple(_t(a) for a in _q_inputs(h))
    offs = tuple(_offset_view(a, dev) for a in args)
    assert K.rs_step_q_launch(P, h, False, 1)[0] == 1
    _same(K.rs_step_q(*offs, c).cpu(), R.rs_step_ref_q(*args, _t(C)))
    if h % 512 == 0:
        for a, e in zip(K.rs_step_q(*offs, c, cn),
                        R.rs_step_ref_q(*args, _t(C), _t(CN))):
            _same(a.cpu(), e)


@pytest.mark.cuda
def test_cuda_step_kernels_at_the_smoke_shape(cuda_device):
    """p = 4, h = 8 Mi (one 64 MiB f32 bucket's first step, the vector and
    warp kernels at ``chip_smoke.py``'s shape): rs_step f32 / bf16 with and
    without send, ag_step f32 / bf16 / int8, rs_step_q with and without
    send, bitwise the plain versions run on the card."""
    dev = cuda_device
    h = 8 << 20
    gen = torch.Generator(device=dev).manual_seed(0)
    c, cn = _t(C).to(dev), _t(CN).to(dev)
    buf = torch.randn((P, 2 * h), generator=gen, device=dev)
    recv = torch.randn((P, h), generator=gen, device=dev)

    def same(got, exp):
        for a, e in zip(got if isinstance(got, tuple) else (got,),
                        exp if isinstance(exp, tuple) else (exp,)):
            assert a.dtype == e.dtype and a.shape == e.shape
            if a.is_floating_point():
                a, e = (t.view(torch.int32 if t.element_size() == 4
                               else torch.int16) for t in (a, e))
            assert torch.equal(a, e)

    for dt in (torch.float32, torch.bfloat16):
        b, v = buf.to(dt), recv.to(dt)
        assert K.rs_step_launch(P, h, b.element_size(), True, True, 1)[0]
        same(K.rs_step(b, v, c), R.rs_step_ref(b, v, c))
        same(K.rs_step(b, v, c, cn), R.rs_step_ref(b, v, c, cn))
        del b, v
    # ag_step at the bucket's last AG step: out [4, 16 Mi]
    a, b = recv, torch.randn((P, h), generator=gen, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        same(K.ag_step(a.to(dt), b.to(dt), c),
             R.ag_step_ref(a.to(dt), b.to(dt), c))
    qa_, _ = tcomp.quantize_wire(a)
    qb_, _ = tcomp.quantize_wire(b)
    same(K.ag_step(qa_, qb_, c), R.ag_step_ref(qa_, qb_, c))
    del a, b, qa_, qb_
    rq, rs = tcomp.quantize_wire(recv)
    assert K.rs_step_q_launch(P, h, True, 1)[0] == 0
    same(K.rs_step_q(buf, rq, rs, c), R.rs_step_ref_q(buf, rq, rs, c))
    same(K.rs_step_q(buf, rq, rs, c, cn), R.rs_step_ref_q(buf, rq, rs, c, cn))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4096, 6, 1000])
def test_cuda_ring_update_matches_plain(cuda_device, b):
    """Bitwise, every variant, f32 and bf16 (accumulate) and 1/2/4/8-byte
    elements (write); the other blocks stay as they were."""
    dev = cuda_device
    ridx = _t(RIDX)
    v, recv = _ring_inputs(b, "float32")
    for dt in (torch.float32, torch.bfloat16):
        for acc, upd in ((True, False), (True, True), (False, False)):
            tv, tr = _t(v, dt), _t(recv, dt)
            exp = R.ring_update_ref(tv.clone(), tr, ridx, acc, upd)
            got = K.ring_update(tv.to(dev), tr.to(dev), ridx.to(dev), acc,
                                upd)
            for a, e in zip(got if upd else (got,), exp if upd else (exp,)):
                _same(a.cpu(), e)
    for dt in (torch.int8, torch.int16, torch.int32, torch.int64, torch.bool):
        tv = _t(v * 100).to(dt)
        tr = _t(recv * 100).to(dt)
        exp = R.ring_update_ref(tv.clone(), tr, ridx, False)
        got = K.ring_update(tv.to(dev), tr.to(dev), ridx.to(dev), False)
        assert torch.equal(got.cpu(), exp)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 24, 12), (260, 70, 130),
                                   (512, 256, 384), (256, 264, 136),
                                   (512, 1000, 520), (132, 1001, 67),
                                   (516, 67, 1001), (1028, 36, 130)])
def test_cuda_perm_matmul_matches_plain(cuda_device, shape):
    """Both directions, f32 and bf16, within ``2 k 2**-24 (|x| @ |w|)``
    elementwise (two float32 sums of k products in different orders), plus
    one bf16 rounding for a bf16 result; the launch counts say which
    kernel ran (``perm_matmul_uses_wgmma``: bf16 at the shapes (512, 256,
    384), (256, 264, 136) and (512, 1000, 520), rows 128 / 64 / 128 and
    ragged k, n tails, on the tensor cores).  The last three shapes put
    m, n and k off the CUDA-core kernel's 128-row, 128-column and 16-deep
    tiles and off its 4-element vectors (element-wise loads)."""
    dev = cuda_device
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    perm = _t(np.array([2, 0, 3, 1], np.int32))
    x = _t(rng.randn(P, m, k).astype(np.float32))
    w = _t(rng.randn(P, k, n).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        tx, tw = x.to(dt), w.to(dt)
        bound = 2 * k * 2.0 ** -24 * torch.matmul(tx.float().abs(),
                                                  tw.float().abs())
        for lhs in (False, True):
            exp = K.perm_matmul(tx, tw, perm, lhs)
            name = "gather_matmul" if lhs else "matmul_pack"
            before = dict(KB.LAUNCHES)
            dx, dw = tx.to(dev), tw.to(dev)
            wgmma = K.perm_matmul_uses_wgmma(dx, dw, len(perm))
            got = K.perm_matmul(dx, dw, perm.to(dev), lhs).cpu()
            assert wgmma == (dt == torch.bfloat16 and m // 4 % 64 == 0)
            assert KB.LAUNCHES[name] == before[name] + 1
            assert KB.LAUNCHES[name + "_wgmma"] == \
                before[name + "_wgmma"] + wgmma
            assert got.dtype == exp.dtype == dt
            lim = R.row_blocks(bound, perm)
            if lhs:
                lim = torch.matmul(R.row_blocks(tx.float(), perm).abs(),
                                   tw.float().abs()) * 2 * k * 2.0 ** -24
            if dt == torch.bfloat16:
                lim = lim + 2.0 ** -7 * exp.float().abs()
            assert bool(((got.float() - exp.float()).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("bfloat16", "float32"),
                                    ("float32", "bfloat16")])
@pytest.mark.parametrize("shape", [(512, 256, 384), (132, 1001, 67)])
def test_cuda_perm_matmul_mixed_dtypes_matches_plain(cuda_device, shape,
                                                     dtypes):
    """A bf16 operand beside a float32 one runs the CUDA-core kernel
    (widened to float32, a float32 result) within ``2 k 2**-24 (|x| @
    |w|)`` of the plain version, both directions."""
    dev = cuda_device
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    perm = _t(np.array([2, 0, 3, 1], np.int32))
    tx = _t(rng.randn(P, m, k).astype(np.float32)).to(getattr(torch,
                                                               dtypes[0]))
    tw = _t(rng.randn(P, k, n).astype(np.float32)).to(getattr(torch,
                                                               dtypes[1]))
    for lhs in (False, True):
        exp = K.perm_matmul(tx, tw, perm, lhs)
        name = "gather_matmul" if lhs else "matmul_pack"
        before = dict(KB.LAUNCHES)
        dx, dw = tx.to(dev), tw.to(dev)
        assert not K.perm_matmul_uses_wgmma(dx, dw, len(perm))
        got = K.perm_matmul(dx, dw, perm.to(dev), lhs).cpu()
        assert KB.LAUNCHES[name] == before[name] + 1
        assert KB.LAUNCHES[name + "_wgmma"] == before[name + "_wgmma"]
        assert got.dtype == exp.dtype == torch.float32
        xs = R.row_blocks(tx.float(), perm) if lhs else tx.float()
        lim = torch.matmul(xs.abs(), tw.float().abs()) * 2 * k * 2.0 ** -24
        if not lhs:
            lim = R.row_blocks(lim, perm)
        assert bool(((got - exp).abs() <= lim).all())
