"""What one flash-attention call costs on the card, beside the library's.

At the paths' shapes (``SHAPES``: causal, some with a window, bf16 on the
tensor-core kernel or float32 on the CUDA-core one, the model's
``[B, T, heads, hd]`` tensors as the paths hand them to
``ops.flash_attention``) prints, in one process and in turns (the
kernel, then the library, then the library and the kernel again), for
each of the two:

  * event ms: CUDA events around one call, median of 20 (host and device
    together, as ``chip_smoke.py``'s ``ms``);
  * device ms per call under ``torch.profiler`` (the kernel's
    ``flash_kernel_wgmma`` launches in bf16, its CUDA-core
    ``flash_kernel*`` ones in float32; every kernel of the SDPA call);
  * host us per call: 100 calls in a row with no sync;
  * loop ms: CUDA events around 50 back-to-back calls, per call;

The library in bf16 is cuDNN's SDPA forced with
``sdpa_kernel([SDPBackend.CUDNN_ATTENTION])`` on a causal shape, and SDPA
on the dense window mask, the backend that ran named, on a windowed one.
In float32 (no cuDNN or flash backend takes it) it is SDPA forced to
``EFFICIENT_ATTENTION`` on K and V repeated to the query heads before the
timed call (``enable_gqa`` sends float32 to the math backend), and beside
it SDPA's own choice with ``enable_gqa``, each with the backend that ran
named (a backend that refuses the shape is named so in the row).
Then the plain version once (one CUDA-event timing) and the kernel's max
|diff| to it, the bound (q, k, v read and o written once over 3.35 TB/s
against 4 hd flops a live (query head, query, key) over 989 TFLOP/s in
bf16, 67 TFLOP/s in float32, the larger), and the kernel's residency
(blocks an SM from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
shared bytes a block, registers and spilled bytes a thread, threads a
block) where the tree has that entry point.  The last line is one JSON
object of it all, with the card's name and power limit.

Only the wrapper's public entry points are used, so the same file runs
against an older tree of the port (copied into it):

  python -m repro_torch.launch.profile_flash [--shapes hd160,hd80]
  python -m repro_torch.launch.profile_flash --shapes hd256,hd256_w,hd256_tp,hd256_g1
  python -m repro_torch.launch.profile_flash --shapes hd160_f32,hd80_f32,hd256_f32,hd64_f32
"""

from __future__ import annotations

import argparse
import json
import subprocess
import warnings

import torch

from repro_torch.launch.profile_rmsnorm import (device_ms_per_call, event_ms,
                                                host_us_per_call)

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
#: name -> (B, T, query heads, K/V heads, head_dim, window or None,
#: dtype): pixtral-12b's token prefill, zamba2-2.7b's shared-attention
#: prefill on one rank and over 2 TP ranks (the ranks folded into the
#: batch), phi4-mini's insert, gemma3-4b's insert on its global and its
#: local (1024-token window) layers, and over 2 TP ranks, gemma-7b's
#: insert; in float32 pixtral-12b's frames prefill, zamba2's and
#: gemma3-4b's shapes, and musicgen-medium's frames prefill
SHAPES = {
    "hd160": (4, 1024, 32, 8, 160, None, "bfloat16"),
    "hd80": (4, 1024, 32, 32, 80, None, "bfloat16"),
    "hd80_tp": (8, 1024, 16, 16, 80, None, "bfloat16"),
    "hd128": (1, 1024, 24, 8, 128, None, "bfloat16"),
    "hd256": (1, 2048, 8, 4, 256, None, "bfloat16"),
    "hd256_w": (1, 2048, 8, 4, 256, 1024, "bfloat16"),
    "hd256_tp": (2, 2048, 4, 2, 256, None, "bfloat16"),
    "hd256_g1": (1, 1024, 16, 16, 256, None, "bfloat16"),
    "hd160_f32": (4, 1024, 32, 8, 160, None, "float32"),
    "hd80_f32": (4, 1024, 32, 32, 80, None, "float32"),
    "hd256_f32": (1, 2048, 8, 4, 256, None, "float32"),
    "hd64_f32": (8, 1024, 24, 24, 64, None, "float32"),
}
#: calls timed on the host clock (below the launch queue's depth: the
#: device runs longer than the host a call)
HOST_CALLS = 100


def loop_ms(fn, calls: int = 50) -> float:
    """CUDA-event ms per call over ``calls`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def timings(fn, match) -> dict:
    return {"event_ms": event_ms(fn),
            "device_ms": device_ms_per_call(fn, match),
            "host_us": host_us_per_call(fn, HOST_CALLS),
            "loop_ms": loop_ms(fn)}


def live_pairs(T: int, window=None) -> int:
    """(query, key) pairs a causal mask over T tokens keeps, with keys at
    most ``window - 1`` behind their query where a window is given."""
    w = T if window is None else min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def bound(Bn: int, T: int, nh: int, nkv: int, hd: int, window=None,
          dtype: str = "bfloat16") -> tuple:
    """(bound ms, what bounds it) of a causal call over its live pairs:
    bf16 on the tensor cores, float32 on the CUDA cores."""
    f32 = dtype == "float32"
    nbytes = 2 * Bn * T * (nh + nkv) * hd * (4 if f32 else 2)
    flops = 4 * hd * Bn * nh * live_pairs(T, window)
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / (F32_FLOPS if f32 else BF16_FLOPS)
    return max(t_b, t_f) * 1e3, "bytes" if t_b > t_f else "operations"


def sdpa_backend(fn) -> str:
    """The SDPA backend that ran ``fn`` (an SDPA call): those of
    ``torch.nn.attention.SDPBackend`` that, forced alone, give its output
    bit for bit (a backend that refuses the call is passed over)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    want = fn()
    same = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # why a backend refuses
                got = fn()
        except RuntimeError:
            continue
        if torch.equal(got, want):
            same.append(b.name.lower())
    return " or ".join(same) or "none alone"


def residency(hd: int, dtype: str = "bfloat16"):
    """The residency of the kernel the dtype runs (tensor cores for bf16,
    CUDA cores for float32), or None in a tree without the entry point."""
    from repro_torch.kernels.flash_attention import kernel as FK
    fn = getattr(FK, "f32_residency" if dtype == "float32"
                 else "wgmma_residency", None)
    return None if fn is None else fn(hd)


def refuses(backend, fn) -> bool:
    """Whether SDPA forced to ``backend`` refuses the call ``fn``."""
    from torch.nn.attention import sdpa_kernel
    try:
        with sdpa_kernel([backend]), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn()
    except RuntimeError:
        return True
    return False


def measure(name: str, dev) -> dict:
    from contextlib import nullcontext
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import ref as FR

    Bn, T, nh, nkv, hd, window, dtype = SHAPES[name]
    f32 = dtype == "float32"
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((Bn, T, n, hd), generator=gen, device=dev)
               .to(getattr(torch, dtype)) for n in (nh, nkv, nkv))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kern = lambda: FO.flash_attention(q, k, v, window=window)
    match = "flash_kernel" if f32 else "flash_kernel_wgmma"
    only_lib = nullcontext
    if window is None:
        lib_fn = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        if not f32:
            # cuDNN's, forced
            only_lib = lambda: sdpa_kernel([SDPBackend.CUDNN_ATTENTION])
    else:
        # the backend SDPA picks for the dense window mask
        pos = torch.arange(T, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[:, None] - pos[None, :] < window)
        lib_fn = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    qg = q.reshape(Bn, T, nkv, nh // nkv, hd).permute(0, 2, 3, 1, 4)
    plain = lambda: FR.flash_attention_ref(qg, k.permute(0, 2, 1, 3),
                                           v.permute(0, 2, 1, 3),
                                           window=window)
    got = kern().float()
    exp = plain().float().permute(0, 3, 1, 2, 4).reshape(Bn, T, nh, hd)
    with only_lib():
        lib = lib_fn().float().transpose(1, 2)
        backend = sdpa_backend(lib_fn)
    out = {"shape": [Bn, T, nh, nkv, hd], "window": window, "dtype": dtype,
           "max_abs_err": float((got - exp).abs().max()),
           "library_backend": backend,
           "library_max_abs_err": float((lib - exp).abs().max())}
    libs = {"library": (lib_fn, only_lib)}
    if f32 and window is None:
        # the efficient backend on K and V repeated to the query heads
        # (made before the timed call)
        kr, vr = (t.repeat_interleave(nh // nkv, dim=1) for t in (kt, vt))
        eff = lambda: F.scaled_dot_product_attention(qt, kr, vr,
                                                     is_causal=True)
        only_eff = lambda: sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])
        if refuses(SDPBackend.EFFICIENT_ATTENTION, eff):
            out["efficient_backend"] = "refused"
        else:
            with only_eff():
                out["efficient_backend"] = sdpa_backend(eff)
                out["efficient_max_abs_err"] = float(
                    (eff().float().transpose(1, 2) - exp).abs().max())
            libs["efficient"] = (eff, only_eff)
    del got, exp, lib
    out["kernel"] = [timings(kern, match)]
    for who, (fn, ctx) in libs.items():
        with ctx():
            out[who] = [timings(fn, None), timings(fn, None)]
    out["kernel"].append(timings(kern, match))
    out["plain_ms"] = event_ms(plain, reps=1)
    out["bound_ms"], out["bound_by"] = bound(Bn, T, nh, nkv, hd, window,
                                             dtype)
    out["residency"] = residency(hd, dtype)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of SHAPES")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"flash attention on {card}")
    res = {"card": card, "device": torch.cuda.get_device_name(0)}
    for name in args.shapes.split(","):
        r = res[name] = measure(name, dev)
        print(f"  {name} q {r['shape']} {r['dtype']} causal, window "
              f"{r['window']}: max |diff| {r['max_abs_err']:.3e}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, residency {r['residency']}; "
              f"library: SDPA on {r['library_backend']}"
              + (f", efficient: {r['efficient_backend']}"
                 if "efficient_backend" in r else ""))
        for who in ("kernel", "library", "efficient"):
            for i, t in enumerate(r.get(who, [])):
                print(f"    {who} (turn {i + 1}): event "
                      f"{t['event_ms']:.4f} ms, device {t['device_ms']:.4f} "
                      f"ms ({r['bound_ms'] / t['device_ms']:.0%} of the "
                      f"bound), host {t['host_us']:.2f} us, 50 back to back "
                      f"{t['loop_ms']:.4f} ms")
        torch.cuda.empty_cache()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
