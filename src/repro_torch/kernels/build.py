"""Build, load and count the port's hand-written Hopper kernels.

Every kernel package keeps its CUDA C++ sources under its own ``csrc/``.
Each source is compiled for ``sm_90a`` with its own ``nvcc`` at first use
(all of them started together) into ``build/repro_torch/``, keyed by a
hash of the source and of every shared header (``kernels/csrc/*.cuh``),
and loaded with ``ctypes``: a plain C interface whose entry points each
return ``cudaGetLastError()``.  No ``--use_fast_math``:
the bitwise contracts rest on IEEE division, ``expf`` and round-half-even.

``LAUNCHES`` counts kernel launches, one count per TPU kernel replaced,
over every package, plus one per tensor-core (``wgmma``) implementation of
such a kernel: a wgmma launch adds one to both its own count and its TPU
kernel's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

KERNELS_DIR = Path(__file__).resolve().parent
#: build outputs, at the root of the checkout (listed in .gitignore)
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: kernel launches since the last reset_launches(), one count per TPU
#: kernel replaced, over every kernel package, and one per wgmma kernel;
#: each wrapper adds one where it launches its kernel
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("rs_step", "ag_step", "rs_step_q", "ring_update", "matmul_pack",
     "gather_matmul", "rmsnorm", "flash_attention", "qacc",
     "matmul_pack_wgmma", "gather_matmul_wgmma", "flash_attention_wgmma"), 0)

#: source path -> loaded library
_LIBS: Dict[str, ctypes.CDLL] = {}
#: (kernel key, device index) -> one wave: resident blocks per SM x SMs
_WAVES: Dict[tuple, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> List[Path]:
    """Every ``csrc/*.cu`` of every kernel package."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def headers() -> List[Path]:
    """The shared headers (``kernels/csrc/*.cuh``); any source may include
    them, so each goes into every library's hash."""
    return sorted(KERNELS_DIR.glob("csrc/*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes())
    for header in headers():
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(str(Path(source).relative_to(KERNELS_DIR)).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build() -> Dict[Path, Path]:
    """Compile every source that has no library yet, one ``nvcc`` each,
    all running at once.  Returns source -> library path."""
    outs = {src: library_path(src) for src in sources()}
    todo = [src for src, out in outs.items() if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmps = {}
    procs = {}
    try:
        for src in todo:
            fd, tmps[src] = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[src] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmps[src], str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        failed = []
        for src, proc in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {src.name} failed ({proc.returncode}):"
                              f"\n{out}\n{err}")
            else:
                os.replace(tmps[src], outs[src])  # atomic: never half a .so
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps.values():
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def load(source: Path, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The library of ``source``, built (with every other missing one) at
    first use; ``signatures`` maps each C entry point to its argument
    types, every entry returning a ``cudaError_t``."""
    key = str(source)
    if key not in _LIBS:
        lib = ctypes.CDLL(str(build()[Path(source)]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[key] = lib
    return _LIBS[key]


# ---------------------------------------------------------------------------
# Helpers the wrappers share
# ---------------------------------------------------------------------------

VP, LL, INT, FLOAT = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on CUDA, False when every one lies on
    the CPU; anything else raises.  The first argument is a tensor; the
    card's case is tested first and cheaply, since a wrapper's host time
    is part of its kernel's cost."""
    d = tensors[0].get_device() if tensors[0].is_cuda else -1
    if d >= 0 and all(t is None or (t.is_cuda and t.get_device() == d)
                      for t in tensors):
        return True
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors
                                  if t is not None}) == 1:
        return True
    raise ValueError(f"tensors must all lie on one CUDA device or all on "
                     f"the CPU, got {sorted(str(t.device) for t in tensors if t is not None)}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(t) -> int:
    """The handle of the current stream of ``t``'s CUDA device (the raw
    getter: ``torch.cuda.current_stream`` builds a ``Stream`` object, a
    few microseconds a call on the wrappers' host path)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def wave(key: tuple, dev: int, blocks_per_sm) -> int:
    """One wave of a kernel's resident blocks on CUDA device ``dev``: its
    blocks per SM, which ``blocks_per_sm(ctypes.byref(blocks))`` (the
    kernel's C occupancy entry point, returning a cudaError) writes, times
    the device's SMs; cached per ``(key, dev)``."""
    w = _WAVES.get((key, dev))
    if w is None:
        blocks = ctypes.c_int(0)
        raise_on(blocks_per_sm(ctypes.byref(blocks)), f"{key} occupancy")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        w = _WAVES[(key, dev)] = max(1, blocks.value) * sms
    return w
