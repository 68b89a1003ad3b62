"""Public wrapper of the flash-attention kernel (the port of
``repro.kernels.flash_attention.ops``).

Takes the model's layout (``[B, T, nh, hd]`` Q and ``[B, T, nkv, hd]``
K/V) and pads K/V with zeros to the reference's tile multiple, as its
``ops.py`` does: the padded keys count as valid (``kpos < Tk`` of the
padded length), which matters only without ``causal``.  Query rows are
independent, so padding Q would add only rows that are cut off again; the
port leaves Q as it is.
"""

from __future__ import annotations

import torch.nn.functional as F

from .kernel import flash_attention_kernel

#: the reference's key tile (its ops.py ``bk``), which sets the padding
KEY_TILE = 128


def _pad_to(x, axis: int, mult: int):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def flash_attention(q, k, v, *, window=None, causal: bool = True):
    """q: [B, Tq, nh, hd]; k, v: [B, Tk, nkv, hd] -> [B, Tq, nh, hd]."""
    B, Tq, nh, hd = q.shape
    Tk, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, Tq, nkv, g, hd).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)
    bk_ = min(KEY_TILE, max(16, Tk))
    kg = _pad_to(kg, 2, bk_)
    vg = _pad_to(vg, 2, bk_)
    out = flash_attention_kernel(qg, kg, vg, window=window, causal=causal)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, nh, hd)
