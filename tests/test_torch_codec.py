"""The port's int8 wire codec is BITWISE equal to the JAX package's:
power-of-two scales read off the exponent bits, exact division by them,
and round-half-to-even in both frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.collectives import compression as jcomp
from repro_torch.collectives import compression as tcomp

rng = np.random.RandomState(0)


def _payload(n: int) -> np.ndarray:
    """Random values mixed with zeros, negatives and exact powers of two."""
    v = (rng.randn(n) * np.exp(rng.uniform(-8, 8, n))).astype(np.float32)
    v[::7] = 0.0
    v[1::11] = -np.float32(2.0) ** rng.randint(-20, 20, v[1::11].shape)
    v[2::13] = np.float32(2.0) ** rng.randint(-20, 20, v[2::13].shape)
    return v


def _bits(x) -> np.ndarray:
    a = np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor) else x,
                   dtype=np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize("n", [1, 6, 7, 96, 256, 512, 768, 1000, 4096])
def test_wire_chunk_matches(n):
    assert tcomp.wire_chunk(n) == jcomp.wire_chunk(n)


def test_pow2_scale_bitwise_special_values():
    t = np.array([0.0, -1.0, 1.0, 2.0, 0.75, 3.0, 127.0, 3.4e38, 5e-3,
                  np.float32(2.0) ** -126, 1.5e-38], dtype=np.float32)
    t = np.concatenate([t, np.abs(_payload(512)) / np.float32(127.0)])
    got = tcomp.pow2_scale(torch.from_numpy(t))
    exp = jcomp.pow2_scale(jnp.asarray(t))
    np.testing.assert_array_equal(_bits(got), _bits(exp))


def test_pow2_scale_subnormal_keeps_ieee():
    """XLA on the CPU flushes subnormals to zero, so the reference maps a
    subnormal ``t`` to 1.0; the port (and its CUDA kernel, built without
    flush-to-zero) keeps IEEE semantics and gives the smallest normal power
    of two.  Only chunks with max|v| < 127 * 2**-126 are affected."""
    t = np.array([1e-40, 1e-45, 1e-38], dtype=np.float32)
    got = tcomp.pow2_scale(torch.from_numpy(t))
    np.testing.assert_array_equal(
        _bits(got), np.full(3, np.float32(2.0) ** -126).view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(jcomp.pow2_scale(jnp.asarray(t))), np.ones(3, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [6, 7, 96, 256, 1000, 1536])
def test_quantize_dequantize_bitwise(dtype, n):
    v = _payload(n)
    jv = jnp.asarray(v).astype(dtype)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    jq, js = jcomp.quantize_wire(jv)
    tq, ts = tcomp.quantize_wire(tv)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert ts.shape[0] == n // tcomp.wire_chunk(n)
    np.testing.assert_array_equal(_bits(tcomp.dequantize_wire(tq, ts)),
                                  _bits(jcomp.dequantize_wire(jq, js)))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_quantize_non_finite_matches(bad):
    """A chunk holding a NaN gets scale 1.0 and sends its NaN as 0; a chunk
    holding an infinity gets scale inf and sends 0 everywhere — as in the
    reference, where the chunk max keeps NaN and float-to-int8 maps NaN
    to 0."""
    v = _payload(512)
    v[3] = v[300] = bad
    jq, js = jcomp.quantize_wire(jnp.asarray(v))
    tq, ts = tcomp.quantize_wire(torch.from_numpy(v))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert tq[3] == tq[300] == 0
    np.testing.assert_array_equal(tcomp.dequantize_wire(tq, ts).numpy(),
                                  np.asarray(jcomp.dequantize_wire(jq, js)))


def test_quantize_stacked_rows_match_per_rank():
    """A stacked [p, n] buffer is coded row by row, as each rank codes its
    own vector in the reference."""
    p, n = 4, 768
    x = np.stack([_payload(n) for _ in range(p)])
    tq, ts = tcomp.quantize_wire(torch.from_numpy(x))
    for r in range(p):
        jq, js = jcomp.quantize_wire(jnp.asarray(x[r]))
        np.testing.assert_array_equal(tq[r].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(ts[r]), _bits(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_wire_int8_bitwise(dtype):
    g = _payload(1024)
    res = (rng.randn(1024) * 1e-3).astype(np.float32)
    js, jr = jcomp.ef_compress(jnp.asarray(g).astype(dtype), jnp.asarray(res),
                               codec="wire_int8")
    tg, tres = torch.from_numpy(g).to(getattr(torch, dtype)), \
        torch.from_numpy(res.copy())
    if dtype == "float32":
        tg = tg.clone()
    ts, tr = tcomp.ef_compress(tg, tres, codec="wire_int8")
    assert ts is tg and tr is tres          # in place
    assert ts.dtype == getattr(torch, dtype) and tr.dtype == torch.float32
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(_bits(tr), _bits(jr))


@pytest.mark.parametrize("n", [1536, 2560])
def test_codec_blocks_cut_no_chunk(monkeypatch, n):
    """A long row is coded block by block; the blocks give the bits of one
    pass over the row."""
    x = torch.from_numpy(np.stack([_payload(n) for _ in range(3)]))
    res = torch.from_numpy((rng.randn(3, n) * 1e-3).astype(np.float32))
    one = (*tcomp.quantize_wire(x),
           *tcomp.ef_compress(x.clone(), res.clone()))
    monkeypatch.setattr(tcomp, "_BLOCK", 512)
    many = (*tcomp.quantize_wire(x),
            *tcomp.ef_compress(x.clone(), res.clone()))
    for a, b in zip(one, many):
        assert torch.equal(a, b)
    assert torch.equal(tcomp.dequantize_wire(*one[:2]),
                       tcomp.dequantize_wire(*many[:2]))
    jq, js = jcomp.quantize_wire(jnp.asarray(x[1].numpy()))
    np.testing.assert_array_equal(many[0][1].numpy(), np.asarray(jq))


def test_ef_compress_other_codecs_not_ported():
    with pytest.raises(NotImplementedError, match="wire_int8"):
        tcomp.ef_compress(torch.zeros(8), torch.zeros(8), codec="int8")


def test_wire_constants_match():
    assert tcomp.WIRE_CHUNK == jcomp.WIRE_CHUNK
    assert tcomp.WIRE_BYTES_PER_ELEM == jcomp.WIRE_BYTES_PER_ELEM
    assert jax.devices()[0].platform == "cpu"
