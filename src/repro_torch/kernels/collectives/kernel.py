"""Hopper kernels of the fused butterfly steps, and their wrappers.

Counterpart of ``repro.kernels.collectives.kernel`` for kernels 1–3 of the
TPU set (``rs_step_kernel``, ``ag_step_kernel``, ``rs_step_kernel_q``).  The
kernels are CUDA C++ in ``csrc/collective_steps.cu``, compiled for
``sm_90a`` with ``nvcc`` at first use into ``build/repro_torch/`` (keyed by
a hash of the source) and loaded with ``ctypes``.

Dispatch: a wrapper handed CPU tensors runs the plain version from
``ref.py``; handed CUDA tensors it launches its kernel or raises.  There is
no fallback from the card to the plain version.  Each wrapper counts its
kernel launches in ``LAUNCHES`` (see :func:`reset_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.collectives import compression as comp

from . import ref as R

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("collective_steps.cu",)
#: build outputs, at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: kernel launches per wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {"rs_step": 0, "ag_step": 0, "rs_step_q": 0}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"collective_steps_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(CSRC / n) for n in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for name in ("repro_rs_step_f32", "repro_rs_step_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, vp]
            fn.restype = ctypes.c_int
        lib.repro_ag_step.argtypes = [vp, vp, vp, vp, ll, ll, ll, vp]
        lib.repro_ag_step.restype = ctypes.c_int
        lib.repro_rs_step_q.argtypes = [vp] * 8 + [ll, ll, ll, vp]
        lib.repro_rs_step_q.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _on_cuda(*tensors) -> bool:
    """True when every tensor lies on CUDA, False when every one lies on
    the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors
                                  if t is not None}) == 1:
        return True
    raise ValueError(f"tensors must all lie on one CUDA device or all on "
                     f"the CPU, got {sorted(str(t.device) for t in tensors if t is not None)}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_bits(c: torch.Tensor, p: int, name: str) -> None:
    _check(c.dtype == torch.int32 and c.shape == (p,) and c.is_contiguous(),
           f"{name} must be a contiguous int32 [p={p}] tensor, got "
           f"{c.dtype} {tuple(c.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def rs_step(buf, recv, c, c_next=None):
    """``buf [p, 2h]``, ``recv [p, h]`` (f32 or bf16) -> ``new [p, h]``, plus
    ``send [p, h/2]`` when ``c_next`` is given.  See ``ref.rs_step_ref``."""
    if not _on_cuda(buf, recv, c, c_next):
        return R.rs_step_ref(buf, recv, c, c_next)
    p, h = recv.shape
    _check(buf.dtype in (torch.float32, torch.bfloat16),
           f"rs_step takes float32 or bfloat16, got {buf.dtype}")
    _check(recv.dtype == buf.dtype, "buf and recv dtypes differ")
    _check(buf.shape == (p, 2 * h), f"buf {tuple(buf.shape)} != [p, 2h]")
    _check(buf.is_contiguous() and recv.is_contiguous(),
           "rs_step needs contiguous buf and recv")
    _check_bits(c, p, "c")
    out = torch.empty_like(recv)
    send = None
    if c_next is not None:
        _check(h % 2 == 0, f"rs_step with c_next needs even h, got {h}")
        _check_bits(c_next, p, "c_next")
        send = torch.empty((p, h // 2), dtype=buf.dtype, device=buf.device)
    fn = (_lib().repro_rs_step_f32 if buf.dtype == torch.float32
          else _lib().repro_rs_step_bf16)
    _raise_on(fn(buf.data_ptr(), recv.data_ptr(), out.data_ptr(), _ptr(send),
                 c.data_ptr(), _ptr(c_next), p, h, _stream(buf)), "rs_step")
    LAUNCHES["rs_step"] += 1
    return out if send is None else (out, send)


def ag_step(buf, recv, c):
    """``buf, recv [p, h]`` (any of f32, bf16, int8) -> ``[p, 2h]``: each
    row ``[buf, recv]`` if ``c == 0`` else ``[recv, buf]``."""
    if not _on_cuda(buf, recv, c):
        return R.ag_step_ref(buf, recv, c)
    _check(buf.dtype in (torch.float32, torch.bfloat16, torch.int8),
           f"ag_step takes float32, bfloat16 or int8, got {buf.dtype}")
    _check(recv.dtype == buf.dtype and recv.shape == buf.shape
           and buf.dim() == 2, "ag_step needs buf and recv of one [p, h] "
           "shape and dtype")
    _check(buf.is_contiguous() and recv.is_contiguous(),
           "ag_step needs contiguous buf and recv")
    p, h = buf.shape
    _check_bits(c, p, "c")
    out = torch.empty((p, 2 * h), dtype=buf.dtype, device=buf.device)
    _raise_on(_lib().repro_ag_step(
        buf.data_ptr(), recv.data_ptr(), out.data_ptr(), c.data_ptr(), p, h,
        buf.element_size(), _stream(buf)), "ag_step")
    LAUNCHES["ag_step"] += 1
    return out


def rs_step_q(buf, recv_q, recv_s, c, c_next=None):
    """int8-wire RS step: ``buf [p, 2h]`` f32, ``recv_q [p, h]`` int8,
    ``recv_s [p, h / wire_chunk(h)]`` f32 -> ``new [p, h]`` f32, plus the
    re-quantized next send ``(q [p, h/2] int8, s [p, h/512] f32)`` when
    ``c_next`` is given (that variant needs ``h % 512 == 0``).  See
    ``ref.rs_step_ref_q``."""
    if not _on_cuda(buf, recv_q, recv_s, c, c_next):
        return R.rs_step_ref_q(buf, recv_q, recv_s, c, c_next)
    p, h = recv_q.shape
    ch_r = comp.wire_chunk(h)
    _check(buf.dtype == torch.float32 and recv_q.dtype == torch.int8
           and recv_s.dtype == torch.float32,
           "rs_step_q takes float32 buf, int8 recv_q, float32 recv_s")
    _check(buf.shape == (p, 2 * h) and recv_s.shape == (p, h // ch_r),
           f"rs_step_q shapes: buf {tuple(buf.shape)}, recv_q "
           f"{tuple(recv_q.shape)}, recv_s {tuple(recv_s.shape)}")
    _check(all(t.is_contiguous() for t in (buf, recv_q, recv_s)),
           "rs_step_q needs contiguous inputs")
    _check_bits(c, p, "c")
    out = torch.empty((p, h), dtype=torch.float32, device=buf.device)
    sq = ss = None
    if c_next is not None:
        _check(h % (2 * comp.WIRE_CHUNK) == 0,
               f"rs_step_q send variant needs h % 512 == 0, got {h}")
        _check_bits(c_next, p, "c_next")
        w = h // 2
        sq = torch.empty((p, w), dtype=torch.int8, device=buf.device)
        ss = torch.empty((p, w // comp.WIRE_CHUNK), dtype=torch.float32,
                         device=buf.device)
    _raise_on(_lib().repro_rs_step_q(
        buf.data_ptr(), recv_q.data_ptr(), recv_s.data_ptr(), out.data_ptr(),
        _ptr(sq), _ptr(ss), c.data_ptr(), _ptr(c_next), p, h, ch_r,
        _stream(buf)), "rs_step_q")
    LAUNCHES["rs_step_q"] += 1
    return out if sq is None else (out, sq, ss)
