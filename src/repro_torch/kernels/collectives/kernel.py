"""Hopper kernels of the fused collectives, and their wrappers.

Counterpart of ``repro.kernels.collectives.kernel``: kernels 1-6 of the TPU
set, CUDA C++ in ``csrc/``:

  * ``collective_steps.cu``: ``rs_step``, ``ag_step``, ``rs_step_q`` (the
    butterfly steps, TPU kernels 1-3);
  * ``ring_update.cu``: ``ring_update`` (the ring step, TPU kernel 4);
  * ``perm_matmul.cu``: ``perm_matmul`` (``matmul_pack_kernel`` and
    ``gather_matmul_kernel``, TPU kernels 5-6, with an ``lhs_perm`` flag as
    the reference's ``_mm_call`` has): a tensor-core (``wgmma``) kernel for
    the bf16 calls ``perm_matmul_uses_wgmma`` admits, a CUDA-core kernel
    for every other call.

``repro_torch.kernels.build`` compiles and loads them.

Dispatch: a wrapper handed CPU tensors runs the plain version from
``ref.py``; handed CUDA tensors it launches its kernel or raises.  There is
no fallback from the card to the plain version.  Each wrapper counts its
kernel launches in ``build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.collectives import compression as comp
from repro_torch.kernels import build as B

from . import ref as R

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("collective_steps.cu", "ring_update.cu", "perm_matmul.cu")

_VP, _LL, _INT = B.VP, B.LL, B.INT
#: source -> C entry point -> argument types (each returns a cudaError_t)
_SIGNATURES = {
    "collective_steps.cu": {
        "repro_rs_step_f32": [_VP] * 6 + [_LL, _LL, _INT, _INT, _VP],
        "repro_rs_step_bf16": [_VP] * 6 + [_LL, _LL, _INT, _INT, _VP],
        "repro_ag_step": [_VP] * 4 + [_LL, _LL, _INT, _INT, _VP],
        "repro_rs_step_q": [_VP] * 8 + [_LL, _LL] + [_INT] * 3 + [_VP],
        "repro_step_blocks_per_sm": [_INT, ctypes.POINTER(ctypes.c_int)],
    },
    "ring_update.cu": {
        "repro_ring_acc_f32": [_VP] * 4 + [_LL, _LL, _LL, _VP],
        "repro_ring_acc_bf16": [_VP] * 4 + [_LL, _LL, _LL, _VP],
        "repro_ring_write": [_VP] * 3 + [_LL] * 4 + [_VP],
    },
    "perm_matmul.cu": {
        "repro_perm_matmul": [_VP] * 4 + [_INT] * 3 + [_LL] * 5 + [_VP],
        "repro_perm_matmul_wgmma": [_VP] * 4 + [_INT] + [_LL] * 5 + [_VP],
    },
}


#: source -> its path (joined once: a Path join costs microseconds of the
#: wrappers' host time)
_PATHS = {source: CSRC / source for source in SOURCES}


def _lib(source: str = "collective_steps.cu"):
    return B.load(_PATHS[source], _SIGNATURES[source])


def _check_bits(c: torch.Tensor, p: int, name: str) -> None:
    if not (c.dtype == torch.int32 and c.dim() == 1 and c.shape[0] == p
            and c.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [p={p}] tensor, "
                         f"got {c.dtype} {tuple(c.shape)}")


# ---------------------------------------------------------------------------
# Launch rules of rs_step, ag_step and rs_step_q
# ---------------------------------------------------------------------------

#: threads a block of every step kernel (``collective_steps.cu`` kThreads)
STEP_THREADS = 256
#: 16-byte vectors a thread of rs_step's vector kernel holds per stream,
#: and units a thread of ag_step holds (kUnroll)
RS_UNROLL = 4
#: waves of resident blocks (blocks per SM x SMs) a grid spans at most
RS_WAVES = 2
#: elements a warp of rs_step_q's warp kernel takes at a time: one codec
#: chunk, 8 a lane
Q_WARP_ELEMS = 256
#: the smallest codec chunk the warp kernel takes (a lane's 8 elements)
Q_LANE_ELEMS = 8
#: ag_step's units (bytes), widest first: a 16-byte vector, else the widest
#: the row and the pointers allow
AG_UNITS = (16, 4, 2, 1)

#: kernel -> id of ``repro_step_blocks_per_sm`` (``step_kernel`` in the
#: source): rs_step (dtype, vector kernel); rs_step_q (path, send)
_KERNEL_ID = {
    ("rs", torch.float32, True): 0, ("rs", torch.bfloat16, True): 1,
    ("rs", torch.float32, False): 2, ("rs", torch.bfloat16, False): 3,
    ("q", 0, False): 4, ("q", 0, True): 5, ("q", 1, False): 6,
    ("q", 1, True): 7, ("q", 2, False): 8,
}
#: call key -> launch shape, for each wrapper
_RS_PLANS: dict = {}
_AG_PLANS: dict = {}
_Q_PLANS: dict = {}


def step_grid(p: int, units: int, per_block: int, wave: int) -> int:
    """Blocks a rank (grid.x) for ``p`` rows of ``units`` work units, a
    block covering ``per_block`` units an iteration of its grid-stride
    loop: enough to cover a row in one iteration, at most ``RS_WAVES``
    waves of ``wave`` resident blocks over all p rows, at least 1."""
    need = -(-units // per_block)
    cap = -(-RS_WAVES * wave // max(p, 1))
    return max(1, min(need, cap))


def rs_step_launch(p: int, h: int, itemsize: int, send: bool,
                   aligned: bool, wave: int):
    """rs_step's launch of ``p`` rows of ``h`` elements of ``itemsize``
    bytes: ``(vec, grid)``.  The vector kernel (16-byte vectors, RS_UNROLL
    a thread in flight) takes rows whose h, and with ``send`` whose h/2,
    is a multiple of the vector's lanes, when every pointer is 16-byte
    ``aligned``; the element-wise kernel takes the rest."""
    lanes = 16 // itemsize
    vec = aligned and h % lanes == 0 and (not send or (h // 2) % lanes == 0)
    if vec:
        return True, step_grid(p, h // lanes, STEP_THREADS * RS_UNROLL, wave)
    return False, step_grid(p, h, STEP_THREADS, wave)


def ag_step_launch(p: int, h: int, itemsize: int, aligned: int):
    """ag_step's launch of ``p`` rows of ``h`` elements of ``itemsize``
    bytes, every pointer a multiple of ``aligned`` bytes (16 or more: any
    unit): ``(unit, n, grid)``.  ``unit``: the widest of ``AG_UNITS``
    that divides both the row's bytes and ``aligned``, ``n`` the units of
    a row half; ``grid``: one block for each tile of ``STEP_THREADS *
    RS_UNROLL`` units, ``ceil(n / tile)`` in each of the ``2p`` row
    halves (at least 1).  On an H100 a grid of a few waves of resident
    blocks walking the tiles, as ``rs_step``'s, ran 3% slower on this
    pure copy (its last pass leaves SMs idle; PERF.md section 6)."""
    nbytes = h * itemsize
    unit = next(u for u in AG_UNITS if nbytes % u == 0 and aligned % u == 0)
    n = nbytes // unit
    tiles = 2 * p * -(-n // (STEP_THREADS * RS_UNROLL))
    return unit, n, max(1, min(tiles, 2 ** 31 - 1))


def rs_step_q_launch(p: int, h: int, aligned: bool, wave: int):
    """rs_step_q's launch of ``p`` rows of ``h`` elements: ``(path,
    shift, grid)``.  ``shift`` is log2 of the codec chunk
    ``wire_chunk(h)`` (a power of two).  Path 0, the warp kernel with
    vectors, takes chunks of at least ``Q_LANE_ELEMS`` when buf is 16-byte
    and recv_q 8-byte ``aligned``; path 1, the warp kernel element by
    element, those chunks otherwise; path 2, the element-wise kernel,
    smaller chunks (no send: the send variant's h % 512 == 0 makes the
    chunk 256)."""
    ch_r = comp.wire_chunk(h)
    shift = ch_r.bit_length() - 1
    if ch_r < Q_LANE_ELEMS:
        return 2, shift, step_grid(p, h, STEP_THREADS, wave)
    per_block = STEP_THREADS // 32 * Q_WARP_ELEMS
    return (0 if aligned else 1), shift, step_grid(p, h, per_block, wave)


def _wave(kernel, dev: int) -> int:
    """One wave of ``kernel``'s (a ``_KERNEL_ID`` key) resident blocks."""
    return B.wave(kernel, dev, lambda blocks: _lib().repro_step_blocks_per_sm(
        _KERNEL_ID[kernel], blocks))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def rs_step(buf, recv, c, c_next=None):
    """``buf [p, 2h]``, ``recv [p, h]`` (f32 or bf16) -> ``new [p, h]``, plus
    ``send [p, h/2]`` when ``c_next`` is given.  See ``ref.rs_step_ref``.
    The launch (``rs_step_launch``) is cached per shape, dtype, variant,
    alignment and device; check messages are built only on failure."""
    if not B.on_cuda(buf, recv, c, c_next):
        return R.rs_step_ref(buf, recv, c, c_next)
    dtype = buf.dtype
    if not ((dtype == torch.float32 or dtype == torch.bfloat16)
            and recv.dtype == dtype):
        raise ValueError(f"rs_step takes float32 or bfloat16 buf and recv of "
                         f"one dtype, got {dtype}, {recv.dtype}")
    if not (recv.dim() == 2 and buf.dim() == 2
            and buf.shape[0] == recv.shape[0]
            and buf.shape[1] == 2 * recv.shape[1]):
        raise ValueError(f"rs_step needs buf [p, 2h] and recv [p, h], got "
                         f"{tuple(buf.shape)} and {tuple(recv.shape)}")
    if not (buf.is_contiguous() and recv.is_contiguous()):
        raise ValueError("rs_step needs contiguous buf and recv")
    p, h = recv.shape
    _check_bits(c, p, "c")
    send_on = c_next is not None
    if send_on:
        if h % 2:
            raise ValueError(f"rs_step with c_next needs even h, got {h}")
        _check_bits(c_next, p, "c_next")
    out = torch.empty_like(recv)
    send = (torch.empty((p, h // 2), dtype=dtype, device=buf.device)
            if send_on else None)
    bp, rp = buf.data_ptr(), recv.data_ptr()
    aligned = (bp | rp) & 15 == 0       # out and send are fresh: aligned
    dev = buf.get_device()
    key = (p, h, dtype, send_on, aligned, dev)
    plan = _RS_PLANS.get(key)
    if plan is None:
        if p >= 2 ** 16:
            raise ValueError(f"rs_step takes fewer than 2**16 ranks, got {p}")
        vec, _ = rs_step_launch(p, h, buf.element_size(), send_on, aligned, 1)
        wave = _wave(("rs", dtype, vec), dev)
        plan = _RS_PLANS[key] = rs_step_launch(p, h, buf.element_size(),
                                               send_on, aligned, wave)
    lib = _lib()
    fn = lib.repro_rs_step_f32 if dtype == torch.float32 \
        else lib.repro_rs_step_bf16
    B.raise_on(fn(bp, rp, out.data_ptr(), B.ptr(send), c.data_ptr(),
                  B.ptr(c_next), p, h, plan[0], plan[1], B.stream(buf)),
               "rs_step")
    B.LAUNCHES["rs_step"] += 1
    return out if send is None else (out, send)


def ag_step(buf, recv, c):
    """``buf, recv [p, h]`` (any of f32, bf16, int8) -> ``[p, 2h]``: each
    row ``[buf, recv]`` if ``c == 0`` else ``[recv, buf]``.  The launch
    (``ag_step_launch``) is cached per shape, dtype and alignment; check
    messages are built only on failure."""
    if not B.on_cuda(buf, recv, c):
        return R.ag_step_ref(buf, recv, c)
    dtype = buf.dtype
    if not (dtype == torch.float32 or dtype == torch.bfloat16
            or dtype == torch.int8):
        raise ValueError(f"ag_step takes float32, bfloat16 or int8, got "
                         f"{dtype}")
    if not (recv.dtype == dtype and recv.shape == buf.shape
            and buf.dim() == 2):
        raise ValueError(f"ag_step needs buf and recv of one [p, h] shape "
                         f"and dtype, got {dtype}{tuple(buf.shape)} and "
                         f"{recv.dtype}{tuple(recv.shape)}")
    if not (buf.is_contiguous() and recv.is_contiguous()):
        raise ValueError("ag_step needs contiguous buf and recv")
    p, h = buf.shape
    _check_bits(c, p, "c")
    out = torch.empty((p, 2 * h), dtype=dtype, device=buf.device)
    bp, rp = buf.data_ptr(), recv.data_ptr()
    # out is fresh: 16-byte aligned; the lowest set bit of the pointers
    # (16 when both are 16-byte aligned)
    low = (bp | rp | 16) & 31
    aligned = low & -low
    key = (p, h, dtype, aligned)
    plan = _AG_PLANS.get(key)
    if plan is None:
        plan = _AG_PLANS[key] = ag_step_launch(p, h, buf.element_size(),
                                               aligned)
    B.raise_on(_lib().repro_ag_step(bp, rp, out.data_ptr(), c.data_ptr(), p,
                                    plan[1], plan[0], plan[2],
                                    B.stream(buf)), "ag_step")
    B.LAUNCHES["ag_step"] += 1
    return out


def rs_step_q(buf, recv_q, recv_s, c, c_next=None):
    """int8-wire RS step: ``buf [p, 2h]`` f32, ``recv_q [p, h]`` int8,
    ``recv_s [p, h / wire_chunk(h)]`` f32 -> ``new [p, h]`` f32, plus the
    re-quantized next send ``(q [p, h/2] int8, s [p, h/512] f32)`` when
    ``c_next`` is given (that variant needs ``h % 512 == 0``).  See
    ``ref.rs_step_ref_q``.  The launch (``rs_step_q_launch``) is cached
    per shape, variant, alignment and device; check messages are built
    only on failure."""
    if not B.on_cuda(buf, recv_q, recv_s, c, c_next):
        return R.rs_step_ref_q(buf, recv_q, recv_s, c, c_next)
    if not (buf.dtype == torch.float32 and recv_q.dtype == torch.int8
            and recv_s.dtype == torch.float32):
        raise ValueError("rs_step_q takes float32 buf, int8 recv_q, float32 "
                         f"recv_s, got {buf.dtype}, {recv_q.dtype}, "
                         f"{recv_s.dtype}")
    p, h = recv_q.shape if recv_q.dim() == 2 else (-1, -1)
    if not (buf.shape == (p, 2 * h)
            and recv_s.shape == (p, h // comp.wire_chunk(h))):
        raise ValueError(f"rs_step_q shapes: buf {tuple(buf.shape)}, recv_q "
                         f"{tuple(recv_q.shape)}, recv_s "
                         f"{tuple(recv_s.shape)}")
    if not (buf.is_contiguous() and recv_q.is_contiguous()
            and recv_s.is_contiguous()):
        raise ValueError("rs_step_q needs contiguous inputs")
    _check_bits(c, p, "c")
    send_on = c_next is not None
    if send_on:
        if h % (2 * comp.WIRE_CHUNK):
            raise ValueError(f"rs_step_q send variant needs h % 512 == 0, "
                             f"got {h}")
        _check_bits(c_next, p, "c_next")
    dev = buf.get_device()
    out = torch.empty((p, h), dtype=torch.float32, device=buf.device)
    sq = ss = None
    if send_on:
        w = h // 2
        sq = torch.empty((p, w), dtype=torch.int8, device=buf.device)
        ss = torch.empty((p, w // comp.WIRE_CHUNK), dtype=torch.float32,
                         device=buf.device)
    bp, qp = buf.data_ptr(), recv_q.data_ptr()
    aligned = bp & 15 == 0 and qp & 7 == 0     # out and send are fresh
    key = (p, h, send_on, aligned, dev)
    plan = _Q_PLANS.get(key)
    if plan is None:
        if p >= 2 ** 16:
            raise ValueError(f"rs_step_q takes fewer than 2**16 ranks, got "
                             f"{p}")
        path = rs_step_q_launch(p, h, aligned, 1)[0]
        plan = _Q_PLANS[key] = rs_step_q_launch(
            p, h, aligned, _wave(("q", path, send_on), dev))
    B.raise_on(_lib().repro_rs_step_q(
        bp, qp, recv_s.data_ptr(), out.data_ptr(), B.ptr(sq), B.ptr(ss),
        c.data_ptr(), B.ptr(c_next), p, h, plan[1], plan[0], plan[2],
        B.stream(buf)), "rs_step_q")
    B.LAUNCHES["rs_step_q"] += 1
    return out if sq is None else (out, sq, ss)


def ring_update(v, recv, ridx, accumulate=True, return_updated=False):
    """One ring step IN PLACE: ``v [p, P*b]``, ``recv [p, b]``, ``ridx``
    int32 ``[p]``; row r's block ``ridx[r]`` gets ``cur + recv[r]``
    (``accumulate``; float32 or bf16) or ``recv[r]`` (any dtype of 1, 2,
    4 or 8 bytes).  Returns ``v``, plus the updated blocks ``[p, b]`` (the
    next ring send) with ``return_updated``.  See ``ref.ring_update_ref``."""
    if return_updated and not accumulate:
        raise ValueError("return_updated needs accumulate: an allgather's "
                         "next send is recv itself")
    if not B.on_cuda(v, recv, ridx):
        return R.ring_update_ref(v, recv, ridx, accumulate, return_updated)
    B.check(v.dim() == 2 and recv.dim() == 2 and recv.shape[0] == v.shape[0],
           f"ring_update needs v [p, P*b] and recv [p, b], got "
           f"{tuple(v.shape)} and {tuple(recv.shape)}")
    p, b = recv.shape
    B.check(b > 0 and v.shape[1] % b == 0,
           f"v's row {v.shape[1]} is not a whole number of blocks of {b}")
    B.check(recv.dtype == v.dtype, "v and recv dtypes differ")
    B.check(v.is_contiguous() and recv.is_contiguous(),
           "ring_update needs contiguous v and recv")
    _check_bits(ridx, p, "ridx")
    send = None
    if accumulate:
        B.check(v.dtype in (torch.float32, torch.bfloat16),
               f"ring_update accumulates float32 or bfloat16, got {v.dtype}")
        if return_updated:
            send = torch.empty_like(recv)
        fn = (_lib("ring_update.cu").repro_ring_acc_f32
              if v.dtype == torch.float32
              else _lib("ring_update.cu").repro_ring_acc_bf16)
        err = fn(v.data_ptr(), recv.data_ptr(), B.ptr(send), ridx.data_ptr(),
                 p, v.shape[1], b, B.stream(v))
    else:
        B.check(v.element_size() in (1, 2, 4, 8),
               f"ring_update writes 1, 2, 4 or 8-byte elements, got "
               f"{v.dtype}")
        err = _lib("ring_update.cu").repro_ring_write(
            v.data_ptr(), recv.data_ptr(), ridx.data_ptr(), p, v.shape[1], b,
            v.element_size(), B.stream(v))
    B.raise_on(err, "ring_update")
    B.LAUNCHES["ring_update"] += 1
    return v if send is None else (v, send)


#: rows of a wgmma A sub-tile: a permuted row block must hold whole ones
WGMMA_ROWS = 64


def perm_matmul_uses_wgmma(x, w, nb: int) -> bool:
    """The rule that sends a ``perm_matmul`` call to the tensor-core
    kernel: x and w both bf16, row blocks of ``m / nb`` rows a multiple of
    64 (no A sub-tile straddles two permuted blocks), k and n multiples of
    8 and x and w 16-byte aligned (TMA's 16-byte stride and address
    rule).  Every other call runs the CUDA-core kernel."""
    _, m, k = x.shape
    n = w.shape[2]
    return (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and nb > 0 and m % nb == 0 and (m // nb) % WGMMA_ROWS == 0
            and k % 8 == 0 and n % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def perm_matmul(x, w, perm, lhs_perm: bool):
    """Row-block-permuted ``x [p, m, k] @ w [p, k, n]`` in float32
    arithmetic, result in ``result_type(x, w)``; ``perm`` int32 ``[nb]``
    (one for all ranks), ``m % nb == 0``.  Output row-block ``b`` holds
    the product's row-block ``perm[b]``: ``lhs_perm`` reads the LHS
    through the permutation (``ref.gather_matmul_ref``), otherwise the
    output writes go through its inverse (``ref.matmul_pack_ref``).  On
    the card, calls ``perm_matmul_uses_wgmma`` admits run on the tensor
    cores (bf16 products are exact in float32, summed in float32), the
    rest on the CUDA cores."""
    if not B.on_cuda(x, w, perm):
        return (R.gather_matmul_ref(x, w, perm) if lhs_perm
                else R.matmul_pack_ref(x, w, perm))
    ok = (torch.float32, torch.bfloat16)
    B.check(x.dtype in ok and w.dtype in ok,
           f"perm_matmul takes float32 or bfloat16, got {x.dtype}, {w.dtype}")
    B.check(x.dim() == 3 and w.dim() == 3 and x.shape[0] == w.shape[0]
           and x.shape[2] == w.shape[1],
           f"perm_matmul needs x [p, m, k] and w [p, k, n], got "
           f"{tuple(x.shape)} and {tuple(w.shape)}")
    B.check(x.is_contiguous() and w.is_contiguous(),
           "perm_matmul needs contiguous x and w")
    p, m, k = x.shape
    n = w.shape[2]
    nb = perm.shape[0] if perm.dim() == 1 else 0
    B.check(perm.dtype == torch.int32 and nb > 0 and m % nb == 0
           and perm.is_contiguous(),
           f"perm must be a contiguous int32 [nb] with m % nb == 0, got "
           f"{perm.dtype} {tuple(perm.shape)} for m={m}")
    # the output-side map is the inverse order (reference kernel.py:421)
    order = perm if lhs_perm else torch.argsort(perm).to(torch.int32)
    out = torch.empty((p, m, n), dtype=torch.result_type(x, w),
                      device=x.device)
    name = "gather_matmul" if lhs_perm else "matmul_pack"
    # both kernels index rows, columns and k in 32 bits
    B.check(m < 2 ** 31 and k < 2 ** 31 and n < 2 ** 31,
            f"perm_matmul dims out of range: {tuple(x.shape)}, {n}")
    if perm_matmul_uses_wgmma(x, w, nb):
        B.raise_on(_lib("perm_matmul.cu").repro_perm_matmul_wgmma(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), order.data_ptr(),
            int(lhs_perm), p, m, n, k, nb, B.stream(x)), "perm_matmul_wgmma")
        B.LAUNCHES[name] += 1
        B.LAUNCHES[name + "_wgmma"] += 1
        return out
    B.raise_on(_lib("perm_matmul.cu").repro_perm_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), order.data_ptr(),
        int(lhs_perm), int(x.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16), p, m, n, k, nb, B.stream(x)),
        "perm_matmul")
    # one count per TPU kernel replaced, chosen by lhs_perm
    B.LAUNCHES[name] += 1
    return out
