"""The int8 wire codec with power-of-two scales, and its error feedback.

Port of the wire-codec part of ``repro.collectives.compression``.  Every
function acts on the LAST dimension, so a stacked ``[p, n]`` buffer is
coded row by row exactly as the JAX package codes each rank's ``[n]``
vector.  The results are bitwise equal to the JAX codec: the scales are
read off the float32 exponent bits, division by a power of two is exact,
and ``torch.round`` rounds half to even as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: codec chunk cap (elements) shared by the stacked and fused int8 paths
WIRE_CHUNK = 256

#: wire bytes per f32 element for each wire dtype (int8 counts its
#: per-chunk f32 scale)
WIRE_BYTES_PER_ELEM = {
    "float32": 4.0,
    "bfloat16": 2.0,
    "int8": 1.0 + 4.0 / WIRE_CHUNK,
}


def wire_chunk(n: int, cap: int = WIRE_CHUNK) -> int:
    """Codec chunk for a payload of ``n`` elements: the largest power of
    two dividing ``n``, capped at ``cap`` (1 when ``n`` is odd)."""
    if n <= 0:
        return cap
    return min(n & -n, cap)


def pow2_scale(t: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= ``t`` (elementwise; 1.0 where ``t <= 0``),
    read off the float32 exponent bits.  A power-of-two scale makes the
    decode ``q * scale`` exact, so the receiver's ``kept + q * scale`` has
    one rounding whatever the backend."""
    t = t.to(torch.float32)
    bits = t.view(torch.int32)
    frac = bits & 0x7FFFFF
    up = torch.where(frac == 0, bits, (((bits >> 23) & 0xFF) + 1) << 23)
    scale = up.view(torch.float32)
    return torch.where(t > 0, scale, torch.ones_like(scale))


#: elements of a row the codec handles at once: a multiple of every wire
#: chunk, so a block never cuts a codec chunk, and small enough that a
#: multi-GB bucket needs no full-size float32 temporaries
_BLOCK = 1 << 22


def _blocks(n: int):
    for a in range(0, n, _BLOCK):
        yield a, min(a + _BLOCK, n)


def _quantize(m: torch.Tensor):
    """``m [..., k, ch]`` float32 -> (q int8 ``[..., k, ch]``, scales
    ``[..., k]``)."""
    scale = pow2_scale(m.abs().amax(dim=-1) / 127.0)
    q = torch.clamp(torch.round(m / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_wire(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``v [..., n]`` per ``wire_chunk(n)`` chunk of the last dim.

    Returns ``(q, scales)``: ``q`` int8 ``[..., n]``, ``scales`` float32
    ``[..., n // wire_chunk(n)]``.  Scale math runs in float32.
    """
    lead, n = tuple(v.shape[:-1]), v.shape[-1]
    ch = wire_chunk(n)
    q = torch.empty(v.shape, dtype=torch.int8, device=v.device)
    scales = torch.empty(lead + (n // ch,), dtype=torch.float32,
                         device=v.device)
    for a, b in _blocks(n):
        m = v[..., a:b].to(torch.float32).reshape(lead + ((b - a) // ch, ch))
        qb, sb = _quantize(m)
        q[..., a:b] = qb.reshape(lead + (b - a,))
        scales[..., a // ch:b // ch] = sb
    return q, scales


def dequantize_wire(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Decode a :func:`quantize_wire` pair back to float32."""
    lead, n = tuple(q.shape[:-1]), q.shape[-1]
    ch = n // scales.shape[-1]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for a, b in _blocks(n):
        m = q[..., a:b].to(torch.float32).reshape(lead + ((b - a) // ch, ch))
        out[..., a:b] = (m * scales[..., a // ch:b // ch, None]).reshape(
            lead + (b - a,))
    return out


def ef_compress(grad: torch.Tensor, residual: torch.Tensor,
                codec: str = "wire_int8"):
    """Error-feedback compression of ``grad [..., n]``:
    ``corrected = grad + residual``, ``sent = decode(encode(corrected))``,
    ``residual' = corrected - sent``, coded per ``wire_chunk(n)`` chunk of
    the last dim.

    Works IN PLACE, block by block, so a multi-GB bucket needs no
    full-size temporaries: ``grad`` is overwritten with ``sent`` (in its
    own dtype) and the float32 ``residual`` with ``residual'``; both are
    returned.  The train step hands over buffers it no longer needs, as the
    reference step donates its state.  Only the ``wire_int8`` codec (the
    int8-wire train step's) is ported.
    """
    if codec != "wire_int8":
        raise NotImplementedError(
            f"ef_compress codec {codec!r} is not ported; only 'wire_int8' "
            "(the int8-wire train step's codec) is")
    if residual.dtype != torch.float32 or residual.shape != grad.shape:
        raise ValueError("the residual must be float32 of the grad's shape")
    lead, n = tuple(grad.shape[:-1]), grad.shape[-1]
    ch = wire_chunk(n)
    for a, b in _blocks(n):
        corrected = grad[..., a:b].to(torch.float32) + residual[..., a:b]
        q, s = _quantize(corrected.reshape(lead + ((b - a) // ch, ch)))
        sent = (q.to(torch.float32) * s[..., None]).reshape(
            lead + (b - a,)).to(grad.dtype)
        residual[..., a:b] = corrected - sent.to(torch.float32)
        grad[..., a:b] = sent
    return grad, residual
