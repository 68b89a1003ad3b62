"""The serving kernels of the port — RMSNorm, flash attention and int8
dequantize-accumulate — against the JAX package.

On the CPU the wrappers run their plain versions; these are held against
the JAX package's ops (its Pallas kernels in interpret mode) and against
its ``ref.py`` oracles on the cases of the reference's own tests
(``tests/kernels/test_rmsnorm.py``, ``test_flash_attention.py``,
``test_qdot.py``), with the tolerances stated there:

  * rmsnorm: float32 1e-6 (rtol and atol), bf16 2e-2;
  * flash attention: float32 2e-5, bf16 3e-2 (max abs);
  * dequantize-accumulate: 1e-6, as the reference's test; the port's
    plain version is held bitwise to the reference's ``ref.py`` too.

Inputs are made from numpy seeds as float32 (bf16 inputs are cast from
float32 on both sides, so they are the same values).  The JAX side runs
once, in a subprocess, and hands its outputs over as an ``.npz``.

On a card (``cuda`` marker; skipped elsewhere) each kernel is held to its
plain version: rmsnorm within float32 rtol 1e-6 or one bf16 ulp, flash
attention within the tolerances above (at head_dim 80 and 160 too, the
bf16 call on the tensor-core kernel, and at zamba2-2.7b's insert shape
and pixtral-12b's prefill shape), qacc bitwise.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.qdot import kernel as QK
from repro_torch.kernels.qdot import ops as QO
from repro_torch.kernels.qdot import ref as QR
from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.kernels.rmsnorm import ops as RO
from repro_torch.kernels.rmsnorm import ref as RR
from torch_threads import pin_threads, subproc  # noqa: F401

RMS_SHAPES = [(8, 64), (256, 128), (3, 7, 96), (1000, 48)]
RMS_DTYPES = {"float32": 1e-6, "bfloat16": 2e-2}
#: (B, T, nh, nkv, hd, window, dtype, tol), the reference test's cases
FLASH_CASES = [
    (2, 256, 4, 2, 64, None, "float32", 2e-5),
    (1, 384, 8, 2, 128, None, "float32", 2e-5),
    (2, 256, 4, 4, 64, 64, "float32", 2e-5),
    (1, 128, 4, 1, 32, None, "bfloat16", 3e-2),
    (1, 256, 8, 8, 64, 32, "bfloat16", 3e-2),
    (1, 130, 2, 2, 64, 48, "float32", 2e-5),     # padding path
    (1, 257, 2, 1, 16, None, "float32", 2e-5),   # padding, MQA, tiny hd
    # bf16 on the tensor cores: g = 1, 2, 3, 8 (4 above), hd 16-128,
    # windows, T not a multiple of 64
    (1, 130, 3, 1, 128, None, "bfloat16", 3e-2),
    (2, 192, 2, 2, 128, None, "bfloat16", 3e-2),
    (1, 320, 4, 2, 64, 100, "bfloat16", 3e-2),
    (1, 1000, 8, 1, 64, 256, "bfloat16", 3e-2),
    (1, 1000, 6, 2, 128, None, "bfloat16", 3e-2),
    (1, 130, 8, 1, 128, None, "bfloat16", 3e-2),
    (1, 257, 2, 1, 16, None, "bfloat16", 3e-2),
    # head_dim 256 (gemma3-4b, gemma-7b): both kernels, g = 1, 2, 8,
    # windows, T not a multiple of 64
    (1, 320, 8, 4, 256, None, "bfloat16", 3e-2),
    (1, 256, 2, 2, 256, 100, "bfloat16", 3e-2),
    (1, 130, 8, 1, 256, None, "bfloat16", 3e-2),
    (1, 192, 4, 2, 256, 64, "float32", 2e-5),
    (2, 130, 2, 2, 256, None, "float32", 2e-5),
    (1, 128, 8, 1, 256, 48, "float32", 2e-5),
    # head_dim 80 (zamba2-2.7b's shared attention, g = 1): both kernels,
    # T a multiple of 64 and not, a window, GQA
    (1, 256, 4, 4, 80, None, "float32", 2e-5),
    (2, 130, 4, 4, 80, None, "bfloat16", 3e-2),
    (1, 320, 4, 2, 80, 100, "bfloat16", 3e-2),
    (1, 200, 2, 1, 80, 64, "float32", 2e-5),
    # head_dim 160 (pixtral-12b, g = 4; its frames run float32): both
    # kernels, g = 1 and 4, T a multiple of 64 and not, windows
    (1, 256, 4, 4, 160, None, "float32", 2e-5),
    (1, 192, 2, 2, 160, None, "bfloat16", 3e-2),
    (2, 130, 8, 2, 160, None, "bfloat16", 3e-2),
    (1, 320, 4, 1, 160, 100, "bfloat16", 3e-2),
    (1, 200, 8, 2, 160, 64, "float32", 2e-5),
]
#: on the card also zamba2-2.7b's insert, q [4, 1024, 32, 80], and
#: pixtral-12b's prefill, q [4, 1024, 32, 160] over 8 K/V heads, both
#: dtypes; then the edges of the tensor-core kernel's tiles at head_dim 80
#: and 160 (64-column panels and a 16- or 32-column tail panel; at 80 two
#: warpgroups of 64 queries a block): T = 40 (Tk < 64: one partial key
#: tile), 100 (Tq and Tk off 64), 200 and 300 (Tq off 64 and off the
#: block's 128 rows), windows that cross a key tile, g = 1, 4 and 8, and
#: zamba2-2.7b's prefill over 2 TP ranks, q [8, 1024, 16, 80]; then head
#: dim 256's two warpgroups that take a 64-row tile's key tiles in turn:
#: T = 40 (one live tile, the second warpgroup idle), 100 and 130 (an odd
#: number of tiles), 300 with windows 64 and 100 (crossing tiles), g = 1,
#: 2 and 8, gemma3-4b's windowed insert and its serve-TP insert (the 2 TP
#: ranks folded into the batch); then the float32 kernel's tiles (blocks of
#: 128 query rows, 64 at head_dim 256, in warps of 16 or 8 rows, 64-key
#: tiles): every head dim, T = 40, 100, 200 and 300 (rows and keys off
#: the tiles), windows that cross a key tile, g = 1, 4 and 8,
#: musicgen-medium's frames prefill q [8, 1024, 24, 64] and gemma3-4b's
#: insert at float32
FLASH_CUDA_CASES = FLASH_CASES + [
    (4, 1024, 32, 32, 80, None, "bfloat16", 3e-2),
    (4, 1024, 32, 32, 80, None, "float32", 2e-5),
    (4, 1024, 32, 8, 160, None, "bfloat16", 3e-2),
    (4, 1024, 32, 8, 160, None, "float32", 2e-5),
    (1, 40, 4, 4, 80, None, "bfloat16", 3e-2),
    (2, 100, 16, 4, 80, None, "bfloat16", 3e-2),
    (1, 300, 8, 1, 80, 100, "bfloat16", 3e-2),
    (1, 200, 8, 8, 80, 48, "bfloat16", 3e-2),
    (8, 1024, 16, 16, 80, None, "bfloat16", 3e-2),
    (1, 40, 8, 1, 160, None, "bfloat16", 3e-2),
    (2, 100, 4, 4, 160, 64, "bfloat16", 3e-2),
    (1, 300, 16, 4, 160, 100, "bfloat16", 3e-2),
    (1, 200, 8, 2, 160, None, "bfloat16", 3e-2),
    (1, 130, 16, 2, 160, 70, "bfloat16", 3e-2),
    (1, 40, 8, 4, 256, None, "bfloat16", 3e-2),
    (2, 100, 4, 2, 256, None, "bfloat16", 3e-2),
    (1, 130, 16, 2, 256, None, "bfloat16", 3e-2),
    (1, 300, 8, 8, 256, 64, "bfloat16", 3e-2),
    (1, 300, 8, 1, 256, 100, "bfloat16", 3e-2),
    (1, 2048, 8, 4, 256, 1024, "bfloat16", 3e-2),
    (2, 2048, 4, 2, 256, None, "bfloat16", 3e-2),
    (1, 40, 4, 4, 16, None, "float32", 2e-5),
    (2, 100, 8, 2, 32, 48, "float32", 2e-5),
    (1, 200, 8, 1, 64, 70, "float32", 2e-5),
    (1, 300, 16, 4, 64, None, "float32", 2e-5),
    (1, 40, 8, 1, 80, None, "float32", 2e-5),
    (1, 300, 4, 4, 80, 100, "float32", 2e-5),
    (2, 100, 16, 2, 128, 48, "float32", 2e-5),
    (1, 300, 4, 1, 128, None, "float32", 2e-5),
    (1, 40, 4, 1, 160, None, "float32", 2e-5),
    (2, 100, 4, 4, 160, 64, "float32", 2e-5),
    (1, 300, 8, 2, 160, 100, "float32", 2e-5),
    (1, 40, 8, 1, 256, None, "float32", 2e-5),
    (2, 100, 8, 2, 256, None, "float32", 2e-5),
    (1, 200, 8, 8, 256, 100, "float32", 2e-5),
    (1, 300, 8, 1, 256, 64, "float32", 2e-5),
    (8, 1024, 24, 24, 64, None, "float32", 2e-5),
    (1, 2048, 8, 4, 256, None, "float32", 2e-5),
]
QACC_CASES = [(64, 128), (100, 256), (1, 64)]


def _rms_inputs(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    return x, w


def _flash_inputs(i):
    Bn, T, nh, nkv, hd = FLASH_CUDA_CASES[i][:5]
    rng = np.random.RandomState(1000 + i)
    return tuple(rng.randn(Bn, T, n, hd).astype(np.float32)
                 for n in (nh, nkv, nkv))


def _qacc_inputs(C, chunk):
    rng = np.random.RandomState(0)
    q = rng.randint(-127, 128, size=(C, chunk)).astype(np.int8)
    s = (np.abs(rng.randn(C, 1)) * 0.01).astype(np.float32)
    acc = rng.randn(C, chunk).astype(np.float32)
    return q, s, acc


JAX_CODE = r"""
import numpy as np, jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention, flash_attention_ref
from repro.kernels.qdot import dequant_accumulate, dequant_accumulate_ref
from repro.kernels.rmsnorm import rmsnorm, rmsnorm_ref

inp = dict(np.load({inp!r}))
out = {{}}
f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
for key in [k for k in inp if k.startswith("rms_x_")]:
    tag = key[len("rms_x_"):]
    dt = jnp.bfloat16 if tag.endswith("bfloat16") else jnp.float32
    x = jnp.asarray(inp[key]).astype(dt)
    w = jnp.asarray(inp["rms_w_" + tag]).astype(dt)
    out["rms_ops_" + tag] = f32(rmsnorm(x, w))
    out["rms_ref_" + tag] = f32(rmsnorm_ref(x, w))
for i, (B, T, nh, nkv, hd, window, dtype, tol) in enumerate({cases!r}):
    dt = getattr(jnp, dtype)
    q, k, v = (jnp.asarray(inp[f"fa_{{n}}_{{i}}"]).astype(dt) for n in "qkv")
    out[f"fa_ops_{{i}}"] = f32(flash_attention(q, k, v, window=window,
                                               bq=128, bk=128))
    g = nh // nkv
    qg = q.reshape(B, T, nkv, g, hd).transpose(0, 2, 3, 1, 4)
    ref = flash_attention_ref(qg, k.transpose(0, 2, 1, 3),
                              v.transpose(0, 2, 1, 3), window=window)
    out[f"fa_ref_{{i}}"] = f32(ref.transpose(0, 3, 1, 2, 4).reshape(
        B, T, nh, hd))
for key in [k for k in inp if k.startswith("qa_q_")]:
    tag = key[len("qa_q_"):]
    q, s, a = (jnp.asarray(inp[f"qa_{{n}}_{{tag}}"]) for n in ("q", "s", "a"))
    out["qa_ops_" + tag] = np.asarray(dequant_accumulate(q, s, a))
    out["qa_ref_" + tag] = np.asarray(dequant_accumulate_ref(q, s, a))
np.savez({path!r}, **out)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_out(subproc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_serve_kernels")
    inp = {}
    for shape in RMS_SHAPES:
        x, w = _rms_inputs(shape)
        for dt in RMS_DTYPES:
            tag = f"{'x'.join(map(str, shape))}_{dt}"
            inp["rms_x_" + tag], inp["rms_w_" + tag] = x, w
    for i in range(len(FLASH_CASES)):
        for n, a in zip("qkv", _flash_inputs(i)):
            inp[f"fa_{n}_{i}"] = a
    for C, chunk in QACC_CASES:
        for n, a in zip(("q", "s", "a"), _qacc_inputs(C, chunk)):
            inp[f"qa_{n}_{C}x{chunk}"] = a
    np.savez(tmp / "in.npz", **inp)
    path = str(tmp / "out.npz")
    out = subproc(JAX_CODE.format(inp=str(tmp / "in.npz"), path=path,
                                  cases=FLASH_CASES), devices=1, timeout=600)
    assert "JAX_OK" in out
    return dict(np.load(path))


def _f32(t):
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# Plain versions on the CPU against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(RMS_DTYPES))
@pytest.mark.parametrize("shape", RMS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rmsnorm_plain_matches_jax(jax_out, shape, dtype):
    x, w = _rms_inputs(shape)
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = RO.rmsnorm(tx, tw)
    assert got.dtype == tdt and got.shape == tx.shape
    assert torch.equal(got, RR.rmsnorm_ref(tx, tw))
    tol = RMS_DTYPES[dtype]
    tag = f"{'x'.join(map(str, shape))}_{dtype}"
    for which in ("ops", "ref"):
        np.testing.assert_allclose(_f32(got), jax_out[f"rms_{which}_{tag}"],
                                   rtol=tol, atol=tol, err_msg=which)


@pytest.mark.parametrize("i", range(len(FLASH_CASES)),
                         ids=[f"{c[:6]}-{c[6]}" for c in FLASH_CASES])
def test_flash_attention_plain_matches_jax(jax_out, i):
    Bn, T, nh, nkv, hd, window, dtype, tol = FLASH_CASES[i]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in _flash_inputs(i))
    got = FO.flash_attention(q, k, v, window=window)
    assert got.dtype == tdt and got.shape == q.shape
    for which in ("ops", "ref"):
        err = np.max(np.abs(_f32(got) - jax_out[f"fa_{which}_{i}"]))
        assert err < tol, (which, err)


def test_flash_attention_ops_pads_keys_like_reference():
    """Without ``causal``, ops pads K/V to the reference's 128-key tile and
    the zero keys count (``kpos < Tk`` of the padded length), as in the
    reference's ops; with ``causal`` they are masked, and a row past every
    live key gives 0, not NaN."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 130, n, 16).astype(np.float32))
               for n in (2, 1, 1))
    got = FO.flash_attention(q, k, v, causal=False)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 126))
    qg = q.reshape(1, 130, 1, 2, 16).permute(0, 2, 3, 1, 4)
    exp = FR.flash_attention_ref(qg, pad(k).permute(0, 2, 1, 3),
                                 pad(v).permute(0, 2, 1, 3), causal=False)
    np.testing.assert_allclose(
        got.numpy(), exp.permute(0, 3, 1, 2, 4).reshape(1, 130, 2, 16).numpy(),
        rtol=2e-5, atol=2e-5)
    # window 1 with causal: only the diagonal; an all-masked row (window
    # of a key range that ends before the query) is zero
    qg5, k4, v4 = qg, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    out = FK.flash_attention_kernel(qg5, k4[:, :, :8], v4[:, :, :8],
                                    window=1)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, :, :, 8:], torch.zeros_like(out[:, :, :, 8:]))


@pytest.mark.parametrize("C,chunk", QACC_CASES)
def test_dequant_accumulate_plain_matches_jax(jax_out, C, chunk):
    q, s, a = _qacc_inputs(C, chunk)
    got = QO.dequant_accumulate(torch.from_numpy(q), torch.from_numpy(s),
                                torch.from_numpy(a))
    assert got.dtype == torch.float32
    tag = f"{C}x{chunk}"
    # the reference's ref.py rounds the product and the sum once each
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  jax_out["qa_ref_" + tag].view(np.int32))
    np.testing.assert_allclose(got.numpy(), jax_out["qa_ops_" + tag],
                               rtol=1e-6, atol=1e-6)


def test_wrappers_take_plain_version_on_cpu():
    B.reset_launches()
    x, w = (torch.from_numpy(a) for a in _rms_inputs((8, 64)))
    assert torch.equal(RK.rmsnorm_kernel(x, w), RR.rmsnorm_ref(x, w))
    q, s, a = (torch.from_numpy(t) for t in _qacc_inputs(4, 64))
    assert torch.equal(QK.qacc_kernel(q, s, a),
                       QR.dequant_accumulate_ref(q, s, a))
    qq, kk, vv = (torch.from_numpy(t) for t in _flash_inputs(5))
    qg = qq.reshape(1, 130, 2, 1, 64).permute(0, 2, 3, 1, 4)
    assert torch.equal(
        FK.flash_attention_kernel(qg, kk.permute(0, 2, 1, 3),
                                  vv.permute(0, 2, 1, 3)),
        FR.flash_attention_ref(qg, kk.permute(0, 2, 1, 3),
                               vv.permute(0, 2, 1, 3)))
    # the plain version is no kernel launch
    assert B.LAUNCHES["rmsnorm"] == B.LAUNCHES["flash_attention"] == \
        B.LAUNCHES["qacc"] == 0
    assert set(B.LAUNCHES) >= {"rmsnorm", "flash_attention", "qacc"}


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else must be a
    CUDA launch or an error, never a quiet fallback."""
    meta = torch.empty((8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        RK.rmsnorm_kernel(meta, torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        QK.qacc_kernel(meta.to(torch.int8), torch.zeros(8, 1),
                       torch.zeros(8, 64))
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        FK.flash_attention_kernel(torch.empty((1, 1, 1, 8, 16), device="meta"),
                                  torch.zeros(1, 1, 8, 16),
                                  torch.zeros(1, 1, 8, 16))


def _model_layout(Bn, T, nh, nkv, hd, dtype):
    """q, k, v as ``ops.flash_attention`` hands them to the kernel: views
    of the model's ``[B, T, heads, hd]`` tensors, K/V padded to the key
    tile (stride-0 stand-ins for q's storage: the rule reads strides,
    dtypes and addresses only)."""
    q = torch.zeros((Bn, T, nh, hd), dtype=dtype)
    k = torch.zeros((Bn, T, nkv, hd), dtype=dtype)
    qg = q.reshape(Bn, T, nkv, nh // nkv, hd).permute(0, 2, 3, 1, 4)
    bk = min(FO.KEY_TILE, max(16, T))
    kg = FO._pad_to(k.permute(0, 2, 1, 3), 2, bk)
    return qg, kg, kg


#: (B, T, nh, nkv, hd, dtype) -> whether the tensor-core kernel takes it:
#: the serve cell's insert (phi4-mini, a 1024-token page) and chip_smoke's
#: T = 1000 variant, the bf16 test cases' head dims, float32
FLASH_RULE = [
    ((1, 1024, 24, 8, 128, "bfloat16"), True),
    ((1, 1000, 24, 8, 128, "bfloat16"), True),
    ((1, 1024, 24, 8, 128, "float32"), False),
    ((1, 128, 4, 1, 32, "bfloat16"), True),
    ((1, 257, 2, 1, 16, "bfloat16"), True),
    ((1, 256, 8, 8, 64, "bfloat16"), True),
    ((2, 256, 4, 2, 64, "float32"), False),
    # gemma3-4b's and gemma-7b's inserts (head_dim 256)
    ((1, 2048, 8, 4, 256, "bfloat16"), True),
    ((1, 1024, 16, 16, 256, "bfloat16"), True),
    ((1, 2048, 8, 4, 256, "float32"), False),
    # pixtral-12b's prefill (head_dim 160: rows of 320 bytes): a token
    # prompt's bf16, a frames prompt's float32
    ((4, 1024, 32, 8, 160, "bfloat16"), True),
    ((4, 1024, 32, 8, 160, "float32"), False),
]


@pytest.mark.parametrize("case,wgmma", FLASH_RULE,
                         ids=["x".join(map(str, c[:5])) + f"-{c[5]}"
                              for c, _ in FLASH_RULE])
def test_flash_wgmma_rule(case, wgmma):
    *shape, dtype = case
    assert FK.flash_uses_wgmma(*_model_layout(*shape, getattr(torch, dtype))) \
        is wgmma


def test_flash_wgmma_rule_needs_tma_strides():
    """A stride TMA cannot take (0, or not a multiple of 16 bytes) or an
    address off 16 bytes sends a bf16 call to the CUDA-core kernel."""
    q, k, v = _model_layout(1, 128, 4, 2, 64, torch.bfloat16)
    assert FK.flash_uses_wgmma(q, k, v)
    assert not FK.flash_uses_wgmma(q, k[:, :, :1].expand_as(k), v)
    flat = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 2, 128, 64)
    assert not FK.flash_uses_wgmma(q, odd, v)
    wide = torch.zeros((1, 2, 128, 68), dtype=torch.bfloat16)[..., :64]
    assert not FK.flash_uses_wgmma(q, wide, v)


#: (d, itemsize, vector path) -> (threads, vectors a thread)
RMS_LAUNCH = [
    ((3072, 2, True), (128, 3)),      # the serve cell's rows, bf16
    ((3072, 4, True), (256, 3)),
    ((3080, 2, True), (160, 3)),
    ((1, 4, False), (32, 1)),
    ((7, 2, False), (32, 1)),
    ((48, 2, True), (32, 1)),
    ((48, 4, True), (32, 1)),
    ((2048, 4, False), (512, 4)),     # the last row held in registers
    ((2049, 4, False), (512, 0)),     # the loop over the row
    ((16384, 2, True), (512, 4)),
    ((16392, 2, True), (512, 0)),
    ((RK.MAX_D, 2, True), (512, 0)),
    ((RK.MAX_D, 4, True), (512, 0)),
]


@pytest.mark.parametrize("case,shape", RMS_LAUNCH,
                         ids=[f"d{c[0]}-{c[1]}B-{'vec' if c[2] else 'elem'}"
                              for c, _ in RMS_LAUNCH])
def test_rmsnorm_launch_shape_cases(case, shape):
    d, itemsize, vec = case
    threads, vpt, grid = RK.launch_shape(1024, d, itemsize, vec, 1584)
    assert (threads, vpt) == shape
    assert grid == 1024
    assert RK.launch_shape(10000, d, itemsize, vec, 1584)[2] == 1584


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_launch_shape_covers_every_d(dtype):
    """Every d the wrapper takes, 0 < d <= MAX_D, in both dtypes, on the
    vector path (d a multiple of 16 bytes) and element by element: a
    block of 32 to MAX_THREADS threads (whole warps) whose threads hold 1 to
    MAX_VPT vectors covering the row with less than one vector a thread
    to spare, or the loop over the row once that would take more than
    MAX_VPT; the grid is one wave or the rows, whichever is fewer."""
    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    per = 16 // itemsize
    for vec in (True, False):
        for d in (range(per, RK.MAX_D + 1, per) if vec
                  else range(1, RK.MAX_D + 1)):
            nv = d // per if vec else d
            threads, vpt, grid = RK.launch_shape(7, d, itemsize, vec, 5)
            assert threads % 32 == 0 and 32 <= threads <= RK.MAX_THREADS, d
            assert grid == 5
            if vpt:
                assert 1 <= vpt <= RK.MAX_VPT, d
                assert threads * (vpt - 1) < nv <= threads * vpt, d
            else:
                assert threads == RK.MAX_THREADS, d
                assert nv > RK.MAX_THREADS * RK.MAX_VPT, d


#: (C, chunk, aligned) -> (vector kernel, log2 of chunk or -1)
QACC_RULE = [
    ((65536, 256, True), (True, 8)),    # the smoke's 64 MiB accumulator
    ((65536, 256, False), (False, 8)),  # a pointer off its vector
    ((1000, 128, True), (True, 7)),
    ((7, 100, True), (True, -1)),       # not a power of two: a division
    ((5, 96, True), (True, -1)),
    ((10, 4, True), (True, 2)),         # one vector a row
    ((3, 7, True), (False, -1)),        # chunk % 4 != 0: element-wise
    ((4, 2, True), (False, 1)),
    ((4, 1, True), (False, 0)),
    ((37, 256, True), (True, 8)),       # C * chunk not a block's multiple
]


@pytest.mark.parametrize("case,path", QACC_RULE,
                         ids=[f"C{c[0]}-chunk{c[1]}-{'al' if c[2] else 'off'}"
                              for c, _ in QACC_RULE])
def test_qacc_launch_rule(case, path):
    """The vector kernel for chunk % 4 == 0 on aligned pointers (a float4
    never straddles two rows), else the element-wise one; the scale's row
    a shift for a power-of-two chunk, else a division; a grid that covers
    the work in one pass where QACC_WAVES waves allow it, never more, and
    at least one block."""
    C, chunk, aligned = case
    for wave in (1, 1056):
        vec, shift, grid = QK.qacc_launch(C, chunk, aligned, wave)
        assert (vec, shift) == path
        if vec:
            assert chunk % 4 == 0
        units, per = ((C * chunk // 4, QK.QACC_THREADS * QK.QACC_UNROLL)
                      if vec else (C * chunk, QK.QACC_THREADS))
        assert 1 <= grid <= max(1, QK.QACC_WAVES * wave)
        assert grid * per >= units or grid == QK.QACC_WAVES * wave
        assert (grid - 1) * per < max(units, 1)
    # the row of element e: the shift where there is one, the division's
    e = np.arange(0, C * chunk, max(1, C * chunk // 997))
    rows = e >> shift if shift >= 0 else e // chunk
    np.testing.assert_array_equal(rows, e // chunk)


def test_every_kernel_source_is_built():
    """The build module finds one source per kernel file of every package
    (the smoke's build phase starts one nvcc for each)."""
    names = sorted(p.name for p in B.sources())
    assert names == ["collective_steps.cu", "flash_attention.cu",
                     "perm_matmul.cu", "qacc.cu", "ring_update.cu",
                     "rmsnorm.cu"]
    paths = {B.library_path(p) for p in B.sources()}
    assert len(paths) == len(names)
    assert all(p.parent == B.BUILD_DIR for p in paths)


def test_shared_header_change_rebuilds_every_source(monkeypatch, tmp_path):
    """Every library's name hashes the shared headers (``kernels/csrc/
    hopper.cuh``), so a change there rebuilds each source that may
    include it."""
    assert any(h.name == "hopper.cuh" for h in B.headers())
    before = {p: B.library_path(p) for p in B.sources()}
    header = tmp_path / "hopper.cuh"
    header.write_bytes(B.headers()[0].read_bytes() + b"// changed\n")
    monkeypatch.setattr(B, "headers", lambda: [header])
    after = {p: B.library_path(p) for p in B.sources()}
    assert all(before[p] != after[p] for p in before)


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _bf16_ulp(x):
    """One bf16 ulp at each value of float32 ``x``."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def _rms_check(got, exp, dtype):
    """float32 within rtol 1e-6, bf16 within one bf16 ulp."""
    d = (got.float() - exp.float()).abs()
    if dtype == "float32":
        assert bool((d <= 1e-6 * exp.float().abs() + 1e-30).all()), \
            float(d.max())
    else:
        assert bool((d <= _bf16_ulp(exp.float())).all()), float(d.max())


#: beyond the reference's shapes: the serve cell's insert and decode rows,
#: rows past one wave of blocks, d of one element and of 7 (no 16-byte
#: vectors), d = 3072 + 8 (160 threads of 3 vectors in bf16), d = 4097,
#: 16392 and MAX_D (the loop over the row, in both dtypes or in float32)
RMS_CUDA_SHAPES = RMS_SHAPES + [(1024, 3072), (8, 3072), (10000, 3072),
                                (3, 1), (5, 7), (16, 3080), (2, 4097),
                                (3, 16392), (4, RK.MAX_D),
                                # gemma3-4b's and qwen3-32b's rows: the
                                # last thread's vectors partly filled
                                (1024, 2560), (8, 5120),
                                # the fixed-batch loop's: xlstm-125m's
                                # prefill and decode rows at d_model 768
                                # and the mLSTM norm's 1536 (one warp and
                                # two a row), zamba2-2.7b's at 2560 and
                                # 5120
                                (8192, 768), (8, 768), (8192, 1536),
                                (8, 1536), (4096, 5120), (4, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_CUDA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_rmsnorm_matches_plain(cuda_device, shape, dtype):
    x, w = _rms_inputs(shape)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(cuda_device, tdt)
    tw = torch.from_numpy(w).to(cuda_device, tdt)
    before = B.LAUNCHES["rmsnorm"]
    got = RO.rmsnorm(tx, tw)
    assert B.LAUNCHES["rmsnorm"] == before + 1
    _rms_check(got, RR.rmsnorm_ref(tx, tw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1024, 3072), (7, 48), (3, RK.MAX_D)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_rmsnorm_unaligned_view_matches_plain(cuda_device, shape,
                                                   dtype):
    """Contiguous views one element into their storage (x and w off 16
    bytes) take the vectors' layout read element by element (d a multiple
    of the lanes) and stay within the same bounds."""
    x, w = _rms_inputs(shape)
    tdt = getattr(torch, dtype)
    n, d = shape
    fx = torch.zeros(n * d + 1, dtype=tdt, device=cuda_device)
    fw = torch.zeros(d + 1, dtype=tdt, device=cuda_device)
    tx, tw = fx[1:].view(n, d), fw[1:]
    tx.copy_(torch.from_numpy(x).to(tdt))
    tw.copy_(torch.from_numpy(w).to(tdt))
    assert tx.is_contiguous() and tx.data_ptr() % 16
    before = B.LAUNCHES["rmsnorm"]
    got = RO.rmsnorm(tx, tw)
    assert B.LAUNCHES["rmsnorm"] == before + 1
    _rms_check(got, RR.rmsnorm_ref(tx, tw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [3072, 16392, 4097])
def test_cuda_rmsnorm_batch_invariant(cuda_device, d, dtype):
    """A row's bits do not depend on the batch it comes in: rows 0, 5 and 7
    alone, in a batch of 8 and in a batch of 1024 give the same bits, and
    so do the same rows reached through views 2 or 4 bytes into their
    storage (x, w and y off 16 bytes).  d = 3072 is the serve cell's row
    (registers), 16392 bf16 the loop over the row, 4097 one element a
    vector; the serve cell compares a request alone with the same request
    in the pool."""
    tdt = getattr(torch, dtype)
    x, w = _rms_inputs((1024, d))
    tx = torch.from_numpy(x).to(cuda_device, tdt)
    tw = torch.from_numpy(w).to(cuda_device, tdt)
    fx = torch.zeros(1024 * d + 1, dtype=tdt, device=cuda_device)
    fw = torch.zeros(d + 1, dtype=tdt, device=cuda_device)
    ux, uw = fx[1:].view(1024, d), fw[1:]
    ux.copy_(tx)
    uw.copy_(tw)
    assert ux.data_ptr() % 16 and uw.data_ptr() % 16
    full = RK.rmsnorm_kernel(tx, tw)
    eight = RK.rmsnorm_kernel(tx[:8], tw)
    off = RK.rmsnorm_kernel(ux, uw)
    off8 = RK.rmsnorm_kernel(ux[:8], uw)
    bits = torch.int32 if dtype == "float32" else torch.int16
    for i in (0, 5, 7):
        alone = RK.rmsnorm_kernel(tx[i:i + 1], tw).view(bits)
        for tag, got in (("batch 1024", full[i:i + 1]),
                         ("batch 8", eight[i:i + 1]),
                         ("unaligned 1024", off[i:i + 1]),
                         ("unaligned 8", off8[i:i + 1]),
                         ("unaligned alone",
                          RK.rmsnorm_kernel(ux[i:i + 1], uw))):
            assert torch.equal(got.view(bits), alone), (tag, i)


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(FLASH_CUDA_CASES)),
                         ids=[f"{c[:6]}-{c[6]}" for c in FLASH_CUDA_CASES])
def test_cuda_flash_attention_matches_plain(cuda_device, i):
    Bn, T, nh, nkv, hd, window, dtype, tol = FLASH_CUDA_CASES[i]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda_device, tdt)
               for a in _flash_inputs(i))
    before = B.LAUNCHES["flash_attention_wgmma"]
    got = FO.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    # bf16 runs on the tensor cores, float32 on the CUDA cores
    assert B.LAUNCHES["flash_attention_wgmma"] == \
        before + (dtype == "bfloat16")
    g = nh // nkv
    qg = q.reshape(Bn, T, nkv, g, hd).permute(0, 2, 3, 1, 4)
    exp = FR.flash_attention_ref(qg, k.permute(0, 2, 1, 3),
                                 v.permute(0, 2, 1, 3), window=window)
    exp = exp.permute(0, 3, 1, 2, 4).reshape(Bn, T, nh, hd)
    err = float((got.float() - exp.float()).abs().max())
    assert err < tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [48, 96, 192, 512])
def test_cuda_flash_attention_refuses_other_head_dims(cuda_device, hd,
                                                      dtype):
    """A head dim outside ``HEAD_DIMS`` raises on the card, whichever
    kernel its dtype would take: there is no fallback."""
    tdt = getattr(torch, dtype)
    q = torch.zeros((1, 1, 2, 64, hd), dtype=tdt, device=cuda_device)
    k = torch.zeros((1, 1, 64, hd), dtype=tdt, device=cuda_device)
    before = dict(B.LAUNCHES)
    with pytest.raises(ValueError, match="head_dim"):
        FK.flash_attention_kernel(q, k, k)
    assert B.LAUNCHES == before


#: head_dim -> the tensor-core kernel's blocks an SM: two at 80 (of two
#: warpgroups each, 61 KB) and 160 (101 KB), as many as shared memory
#: allows
FLASH_WGMMA_BLOCKS = {16: 1, 32: 1, 64: 1, 80: 2, 128: 2, 160: 2, 256: 1}
#: head_dim -> its threads a block: two warpgroups at 80 (128 query rows)
#: and at 256 (one 64-row tile, its key tiles taken in turn)
FLASH_WGMMA_THREADS = {16: 128, 32: 128, 64: 128, 80: 256, 128: 128,
                       160: 128, 256: 256}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", FK.HEAD_DIMS)
def test_cuda_flash_wgmma_residency(cuda_device, hd):
    """At every head dim the tensor-core kernel spills no register, holds
    the blocks an SM that its launch bounds ask for and runs its
    warpgroups a block."""
    r = FK.wgmma_residency(hd)
    assert r["local_bytes"] == 0, r
    assert r["blocks_per_sm"] >= FLASH_WGMMA_BLOCKS[hd], r
    assert r["threads"] == FLASH_WGMMA_THREADS[hd], r


#: head_dim -> the float32 kernel's blocks an SM: two of 105 KB at 64
#: (within 128 registers a thread), one elsewhere (at 16 and 32 a cap of
#: 128 registers spilled, and no path runs them)
FLASH_F32_BLOCKS = {16: 1, 32: 1, 64: 2, 80: 1, 128: 1, 160: 1, 256: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", FK.HEAD_DIMS)
def test_cuda_flash_f32_residency(cuda_device, hd):
    """At every head dim the float32 kernel spills no register, holds the
    blocks an SM it was designed for and runs 8 warps a block."""
    r = FK.f32_residency(hd)
    assert r["local_bytes"] == 0, r
    assert r["blocks_per_sm"] >= FLASH_F32_BLOCKS[hd], r
    assert r["threads"] == 256, r


#: (B, T, nh, nkv, hd, view of q, k and v, causal) for float32 views
#: whose strides or base addresses leave 16-byte copies out (the kernel's
#: 4-byte copies), and calls without the causal mask
FLASH_F32_VIEW_CASES = [
    (1, 200, 8, 2, 160, "wide", True),
    (2, 130, 4, 1, 64, "odd", True),
    (1, 100, 4, 4, 256, "odd", False),
    (2, 300, 8, 2, 80, None, False),
    (1, 130, 16, 4, 128, "wide", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_F32_VIEW_CASES,
                         ids=lambda c: "x".join(map(str, c[:5]))
                         + f"-{c[5]}-causal{int(c[6])}")
def test_cuda_flash_attention_f32_views_match_plain(cuda_device, case):
    """The float32 kernel on views that 16-byte copies cannot take (rows
    one float wider than the head dim, or bases 4 bytes off) and without
    the causal mask, within float32 rounding of the plain version."""
    Bn, T, nh, nkv, hd, kind, causal = case
    gen = torch.Generator(device=cuda_device).manual_seed(T + hd)

    def make(shape):
        *lead, d = shape
        if kind == "wide":
            return torch.randn((*lead, d + 1), generator=gen,
                               device=cuda_device)[..., :d]
        if kind == "odd":
            flat = torch.randn(math.prod(shape) + 1, generator=gen,
                               device=cuda_device)
            return flat[1:].view(shape)
        return torch.randn(shape, generator=gen, device=cuda_device)

    g = nh // nkv
    qg = make((Bn, nkv, g, T, hd))
    k, v = (make((Bn, nkv, T, hd)) for _ in range(2))
    before = dict(B.LAUNCHES)
    got = FK.flash_attention_kernel(qg, k, v, causal=causal)
    torch.cuda.synchronize()
    assert B.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert B.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"]
    exp = FR.flash_attention_ref(qg, k, v, causal=causal)
    assert float((got - exp).abs().max()) < 2e-5


#: bf16 GQA grids that fill an H100's 132 SMs several times over
#: (phi4-mini's 24/8 heads, g = 8, and g = 4 with a window): correctness
#: inputs for the tensor-core kernel at larger batch and length
FLASH_GROUPED_CASES = [
    (2, 2048, 24, 8, 128, None),
    (12, 512, 8, 1, 64, None),
    (10, 1024, 4, 1, 64, 200),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_GROUPED_CASES,
                         ids=lambda c: "x".join(map(str, c[:5])) + f"-w{c[5]}")
def test_cuda_flash_attention_grouped_matches_plain(cuda_device, case):
    Bn, T, nh, nkv, hd, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    q, k, v = (torch.randn((Bn, T, n, hd), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for n in (nh, nkv, nkv))
    before = B.LAUNCHES["flash_attention_wgmma"]
    got = FO.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert B.LAUNCHES["flash_attention_wgmma"] == before + 1
    qg = q.reshape(Bn, T, nkv, nh // nkv, hd).permute(0, 2, 3, 1, 4)
    exp = FR.flash_attention_ref(qg, k.permute(0, 2, 1, 3),
                                 v.permute(0, 2, 1, 3), window=window)
    exp = exp.permute(0, 3, 1, 2, 4).reshape(Bn, T, nh, hd)
    err = float((got.float() - exp.float()).abs().max())
    assert err < 3e-2, err


def _off_tma(kind, shape, gen, dev):
    """A bf16 tensor of ``shape`` as a view that TMA cannot take: rows 4
    elements wider than the head dim (a row stride not a multiple of 8
    elements) or a base address 2 bytes past a 16-byte boundary."""
    *lead, hd = shape
    if kind == "wide":
        return torch.randn((*lead, hd + 4), generator=gen, device=dev)\
            .to(torch.bfloat16)[..., :hd]
    flat = torch.randn(math.prod(shape) + 1, generator=gen, device=dev)
    return flat.to(torch.bfloat16)[1:].view(shape)


#: (B, T, nh, nkv, hd, window, view of k and v) for bf16 calls that the
#: tensor-core rule refuses
FLASH_OFF_TMA_CASES = [
    (1, 256, 8, 2, 128, None, "wide"),
    (2, 130, 4, 1, 64, 48, "odd"),
    (2, 100, 4, 4, 80, 48, "odd"),
    (1, 130, 8, 2, 160, None, "odd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_OFF_TMA_CASES,
                         ids=lambda c: "x".join(map(str, c[:5]))
                         + f"-w{c[5]}-{c[6]}")
def test_cuda_flash_attention_bf16_off_tma_matches_plain(cuda_device, case):
    """bf16 views that TMA cannot take run the CUDA-core kernel's bf16
    branch, within bf16 rounding of the plain version."""
    Bn, T, nh, nkv, hd, window, kind = case
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    q = torch.randn((Bn, T, nh, hd), generator=gen, device=cuda_device)\
        .to(torch.bfloat16)
    qg = q.reshape(Bn, T, nkv, nh // nkv, hd).permute(0, 2, 3, 1, 4)
    k, v = (_off_tma(kind, (Bn, nkv, T, hd), gen, cuda_device)
            for _ in range(2))
    assert not FK.flash_uses_wgmma(qg, k, v)
    before = dict(B.LAUNCHES)
    got = FK.flash_attention_kernel(qg, k, v, window=window)
    torch.cuda.synchronize()
    assert B.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert B.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"]
    exp = FR.flash_attention_ref(qg, k, v, window=window)
    err = float((got.float() - exp.float()).abs().max())
    assert err < 3e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("C,chunk", QACC_CASES + [
    (65536, 256), (7, 100), (300, 96), (41, 100), (37, 256), (13, 7),
    (3000, 1)])
def test_cuda_qacc_matches_plain_bitwise(cuda_device, C, chunk):
    """Every path of ``qacc_launch``: the vector kernel with a shift (256,
    128, 64) or a division (96, 100: not powers of two), C * chunk not a
    multiple of a block's 4096 elements (37 x 256, 41 x 100), and the
    element-wise kernel (7, 1); the launch counted."""
    q, s, a = (torch.from_numpy(t).to(cuda_device)
               for t in _qacc_inputs(C, chunk))
    before = B.LAUNCHES["qacc"]
    got = QK.qacc_kernel(q, s, a)
    assert B.LAUNCHES["qacc"] == before + 1
    exp = QR.dequant_accumulate_ref(q, s, a)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [256, 100, 7])
def test_cuda_qacc_non_finite_matches_plain_bitwise(cuda_device, chunk):
    """NaN, +inf and -inf in acc, and q = +-127 at the codec's largest
    scale (2**122) and at FLT_MAX (the product overflows to +-inf, and
    inf + -inf is NaN), bitwise the plain version run on the card, on the
    vector kernel's shift (256) and division (100) and the element-wise
    kernel (7)."""
    C = 64
    q, s, a = (torch.from_numpy(t) for t in _qacc_inputs(C, chunk))
    a[0, 0], a[1, 1], a[2, 2] = float("nan"), float("inf"), float("-inf")
    big = torch.finfo(torch.float32).max
    s[3, 0], s[4, 0], s[5, 0] = 2.0 ** 122, big, big
    q[3:6, :] = 127
    q[3:6, 1::2] = -127
    a[5, 0], a[5, 1] = float("-inf"), float("inf")   # inf - inf, -inf + inf
    q, s, a = q.to(cuda_device), s.to(cuda_device), a.to(cuda_device)
    got = QK.qacc_kernel(q, s, a)
    exp = QR.dequant_accumulate_ref(q, s, a)
    assert bool(exp.isnan().any()) and bool(exp.isinf().any())
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.cuda
def test_cuda_qacc_unaligned_views_match_plain_bitwise(cuda_device):
    """q and acc 4 bytes into their storage: the element-wise kernel
    (``qacc_launch`` says so), bitwise."""
    C, chunk = 33, 256
    q, s, a = (torch.from_numpy(t) for t in _qacc_inputs(C, chunk))
    fq = torch.zeros(C * chunk + 4, dtype=torch.int8, device=cuda_device)
    fa = torch.zeros(C * chunk + 1, dtype=torch.float32, device=cuda_device)
    vq, va = fq[4:].view(C, chunk), fa[1:].view(C, chunk)
    vq.copy_(q)
    va.copy_(a)
    assert not QK.qacc_launch(C, chunk, va.data_ptr() % 16 == 0, 1)[0]
    got = QK.qacc_kernel(vq, s.to(cuda_device), va)
    exp = QR.dequant_accumulate_ref(q, s, a)
    assert torch.equal(got.cpu().view(torch.int32), exp.view(torch.int32))


@pytest.mark.cuda
def test_cuda_wrapper_raises_without_library(cuda_device, monkeypatch,
                                             tmp_path):
    """A CUDA tensor with no buildable kernel raises; it never runs the
    plain version instead."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(B, "_LIBS", {})
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(B, "_nvcc", no_nvcc)
    x = torch.zeros((8, 64), device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        RK.rmsnorm_kernel(x, x[0].contiguous())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        QK.qacc_kernel(x.to(torch.int8), x[:, :1].contiguous(), x)
    q = torch.zeros((1, 1, 1, 8, 16), device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        FK.flash_attention_kernel(q, q[0], q[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tp_serve_launches(cuda_device, dtype):
    """Serving under tensor parallelism on the card: ``launch/cell.py``'s
    small megatron_sp model at (dp, tp) = (2, 2).  An insert launches the
    RMSNorm kernel 2 L + 1 times and the flash kernel L times (the TP
    ranks in its batch; on wgmma in bf16), a decode step RMSNorm 2 L + 1
    times and no flash; in float32 the logits are within 2e-5 of
    max |logit| of the CPU's run on the same weights (the bound
    tests/test_torch_serve_tp.py holds the port to the reference with)."""
    from repro_torch import tree as T
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as E
    from repro_torch.serve.sampling import gather_vocab
    cfg = cell.tp_small_config().replace(dtype=dtype)
    L, n_pages, S = cfg.n_layers, 4, 128
    init = TF.init_params(cfg, 0, "cpu")
    tok = np.random.RandomState(2).randint(0, cfg.vocab_size, (1, S))
    out = {}
    for dev in ("cpu", cuda_device):
        fns = E.make_serve_fns(cfg, E.ServeConfig(), n_pages, S, dev, dp=2,
                               tp=2)
        params = T.tree_map(lambda x: x.to(dev), init)
        pool = fns.init_pool()
        B.reset_launches()
        ins, pool = fns.insert(params, pool, tok, 77, 1)
        ins_counts = dict(B.LAUNCHES)
        B.reset_launches()
        dec, pool = fns.decode_slots(params, pool, tok[:, :n_pages].T,
                                     np.ones(n_pages, np.int32))
        dec_counts = dict(B.LAUNCHES)
        out[str(dev)] = [gather_vocab(x, cfg.vocab_size).float().cpu()
                         for x in (ins, dec)]
    wg = int(dtype == "bfloat16")
    assert {k: v for k, v in ins_counts.items() if v} == {
        "rmsnorm": 2 * L + 1, "flash_attention": L,
        **({"flash_attention_wgmma": L} if wg else {})}
    assert {k: v for k, v in dec_counts.items() if v} == {
        "rmsnorm": 2 * L + 1}
    for got, exp in zip(out[str(cuda_device)], out["cpu"]):
        assert bool(torch.isfinite(got).all())
        if dtype == "float32":
            assert float((got - exp).abs().max()) <= 2e-5 * float(
                exp.abs().max())
