"""The three fused step kernels: their plain stacked versions are BITWISE
equal, row by row, to the JAX package's ``ref.py`` and to its Pallas
kernels run in interpret mode; on a card the CUDA kernels equal the plain
versions, and a CUDA tensor never falls back to them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.collectives import kernel as PK
from repro.kernels.collectives import ref as JR
from repro_torch.collectives import compression as tcomp
from repro_torch.kernels.collectives import kernel as K
from repro_torch.kernels.collectives import ref as R

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
    K.reset_launches()
    _same(K.rs_step(_t(buf), _t(buf[:, :h]), _t(C)),
          R.rs_step_ref(_t(buf), _t(buf[:, :h]), _t(C)))
    _same(K.ag_step(_t(rq), _t(rq), _t(C)), R.ag_step_ref(_t(rq), _t(rq), _t(C)))
    for a, b in zip(K.rs_step_q(_t(buf), _t(rq), _t(rs), _t(C), _t(CN)),
                    R.rs_step_ref_q(_t(buf), _t(rq), _t(rs), _t(C), _t(CN))):
        _same(a, b)
    # the plain version is no kernel launch
    assert K.LAUNCHES == {"rs_step": 0, "ag_step": 0, "rs_step_q": 0}


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else must be a
    CUDA launch or an error, never a quiet fallback."""
    meta = torch.empty((P, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        K.rs_step(torch.empty((P, 32), device="meta"), meta,
                  torch.empty(P, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        K.ag_step(meta, torch.zeros((P, 16)), torch.zeros(P, dtype=torch.int32))


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

    monkeypatch.setattr(K, "_LIB", None)
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(K, "_nvcc", no_nvcc)
    buf = torch.zeros((P, 32), device=cuda_device)
    c = torch.zeros(P, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.rs_step(buf, buf[:, :16].contiguous(), c)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.ag_step(buf, buf, c)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [512, 4096, 6])
def test_cuda_kernels_match_plain(cuda_device, h):
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


@pytest.mark.cuda
def test_cuda_rs_step_q_non_finite_matches_plain(cuda_device):
    """The kernel's chunk max keeps NaN and its int8 cast maps NaN to 0, so
    a loss spike's NaN or infinity gives the plain version's bits."""
    dev = cuda_device
    args = tuple(_t(a) for a in _q_inputs_non_finite(1024))
    c, cn = _t(C).to(dev), _t(CN).to(dev)
    for a, e in zip(K.rs_step_q(*(a.to(dev) for a in args), c, cn),
                    R.rs_step_ref_q(*(a.to(dev) for a in args), c, cn)):
        _same(a.cpu(), e.cpu())
