"""What one RMSNorm call costs on the card, host and device apart.

At the serve cell's rows (phi4-mini, d = 3072: an insert's [1024, 3072]
and a decode step's [8, 3072], bf16 and float32) prints, for
``ops.rmsnorm`` and for ``F.rms_norm`` (weight ``1 + w``, the same
function, made outside the timing):

  * host us per call: ``CALLS`` calls in a row with no sync, by
    ``time.perf_counter`` (what the wrapper costs the host; the card runs
    behind);
  * device ms per call: the kernels' own time under ``torch.profiler``
    over ``PROFILED`` calls (for ``ops.rmsnorm`` the ``rmsnorm_kernel``
    launches only, for ``F.rms_norm`` every kernel it launches);
  * event ms per call: CUDA events around one call, median of 20 (host
    and device together, as ``chip_smoke.py``'s ``ms``).

Only the wrapper's public entry points are used, so the same file runs
against an older tree of the port (``PYTHONPATH=<tree>/src``):

  python -m repro_torch.launch.profile_rmsnorm
"""

from __future__ import annotations

import json
import statistics
import time

import torch
import torch.nn.functional as F

#: calls timed on the host clock
CALLS = 1000
#: calls under the profiler
PROFILED = 100
#: the serve cell's rows
SHAPES = ((1024, 3072), (8, 3072))


def host_us_per_call(fn, calls: int = CALLS) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls with no
    sync between them (after a warm-up and a sync)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / calls


def device_ms_per_call(fn, match=None, calls: int = PROFILED,
                       sessions: int = 3) -> float:
    """Device milliseconds per call of ``fn`` under ``torch.profiler``:
    the kernels whose name contains ``match`` (every kernel when None).
    A profiler session now and then records no kernel at all (CUPTI
    delivered nothing; seen on an H100), so a session that saw no device
    time is run again, up to ``sessions`` in all; then it raises."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if match is None or match in ev.key:
                total += getattr(ev, "self_device_time_total", 0.0) or 0.0
        if total > 0:
            return total / 1e3 / calls
    raise RuntimeError(f"{sessions} profiler sessions saw no device time "
                       f"for {match}")


def event_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of one call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def measure(rows: int, d: int, dtype, dev, eps: float = 1e-6) -> dict:
    """The three numbers for the kernel and the library at ``[rows, d]``."""
    from repro_torch.kernels.rmsnorm import ops

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    w = (0.1 * torch.randn((d,), generator=gen, device=dev)).to(dtype)
    w1 = 1.0 + w
    kern = lambda: ops.rmsnorm(x, w, eps)
    lib = lambda: F.rms_norm(x, (d,), w1, eps)
    return {"shape": [rows, d], "dtype": str(dtype)[6:],
            "host_us": host_us_per_call(kern),
            "device_ms": device_ms_per_call(kern, "rmsnorm_kernel"),
            "event_ms": event_ms(kern),
            "library_host_us": host_us_per_call(lib),
            "library_device_ms": device_ms_per_call(lib),
            "library_event_ms": event_ms(lib)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_rmsnorm needs a CUDA device")
    dev = torch.device("cuda", 0)
    out = []
    print(f"rmsnorm on {torch.cuda.get_device_name(0)}")
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in SHAPES:
            r = measure(rows, d, dtype, dev)
            out.append(r)
            print(f"  [{rows}, {d}] {r['dtype']}: host {r['host_us']:.2f} "
                  f"us/call, device {r['device_ms'] * 1e3:.2f} us, event "
                  f"{r['event_ms'] * 1e3:.2f} us; F.rms_norm host "
                  f"{r['library_host_us']:.2f} us, device "
                  f"{r['library_device_ms'] * 1e3:.2f} us, event "
                  f"{r['library_event_ms'] * 1e3:.2f} us")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
