"""What one call of each butterfly step kernel costs on the card.

At the train step's shapes (one 64 MiB float32 bucket per rank at p = 4:
``buf [4, 16 Mi]``, ``recv [4, 8 Mi]``, the bucket's first reduce-scatter
step) prints, for ``rs_step`` (float32 and bf16, with and without the next
send), ``rs_step_q`` (with and without send), ``ag_step`` (float32, the
bucket's last allgather step, ``[4, 8 Mi]`` twice -> ``[4, 16 Mi]``, and
the same at 1 MiB a rank) beside ``torch.cat([buf, recv], 1)`` (the same
placement, the c = 0 order on every rank), ``ring_update`` (float32
accumulate, with and without send; b = 4 Mi) and ``qacc`` (a 64 MiB
float32 accumulator, 65536 codec chunks of 256) beside
``torch.addcmul(acc, q, scale)`` (the same function, rounded once):

  * host us per call: ``CALLS`` calls in a row with no sync;
  * device ms per call: the kernel's own time under ``torch.profiler``
    over ``profile_rmsnorm.PROFILED`` calls (every kernel of a library
    call);
  * event ms per call: CUDA events around one call, median of 20 (host
    and device together, as ``chip_smoke.py``'s ``ms``);
  * the bound: the bytes the call must move (each input read once, each
    output written once) over 3.35 TB/s, and the device time's share of
    it.

Only the wrappers' public entry points are used, so the same file runs
against an older tree of the port:

  PYTHONPATH=<tree>/src python src/repro_torch/launch/profile_collective_steps.py
"""

from __future__ import annotations

import json

import torch

#: H100 SXM device memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: calls timed on the host clock (the card runs behind, far from a full
#: launch queue)
CALLS = 100
#: ranks and one rank's bucket (float32 elements)
P, N = 4, 16 << 20
#: float32 elements of 1 MiB (ag_step's small case: 1 MiB a rank out)
MiB_ELEMS = 1 << 18


def cases(dev):
    """(name, call, kernel-name substring or None for every kernel, bytes
    moved) for each case."""
    from repro_torch.collectives import compression as comp
    from repro_torch.kernels.collectives import kernel as K
    from repro_torch.kernels.qdot import kernel as QK

    gen = torch.Generator(device=dev).manual_seed(0)
    h = N // 2
    c = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
    cn = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=dev)
    buf = torch.randn((P, N), generator=gen, device=dev)
    recv = torch.randn((P, h), generator=gen, device=dev)
    b16, r16 = buf.to(torch.bfloat16), recv.to(torch.bfloat16)
    rq, rs = comp.quantize_wire(recv)
    # the allgather step's two distinct halves, at 64 MiB and at 1 MiB a rank
    own = torch.randn((P, h), generator=gen, device=dev)
    hs = MiB_ELEMS // 2
    own1, recv1 = own[:, :hs].contiguous(), recv[:, :hs].contiguous()
    v = torch.randn((P, N), generator=gen, device=dev)
    b = N // P
    rv = torch.randn((P, b), generator=gen, device=dev)
    ridx = torch.tensor([1, 3, 0, 2], dtype=torch.int32, device=dev)
    sq = P * (h // 2 + 4 * h // 2 // 256)       # int8 send + its scales
    C, chunk = N // 256, 256
    qq = torch.randint(-127, 128, (C, chunk), generator=gen, device=dev,
                       dtype=torch.int8)
    qs = torch.rand((C, 1), generator=gen, device=dev) * 0.01
    acc = torch.randn((C, chunk), generator=gen, device=dev)
    return [
        ("rs_step f32 + send", lambda: K.rs_step(buf, recv, c, cn),
         "rs_step", 4 * P * (3 * h + h // 2)),
        ("rs_step f32", lambda: K.rs_step(buf, recv, c), "rs_step",
         4 * P * 3 * h),
        ("rs_step bf16 + send", lambda: K.rs_step(b16, r16, c, cn),
         "rs_step", 2 * P * (3 * h + h // 2)),
        ("rs_step bf16", lambda: K.rs_step(b16, r16, c), "rs_step",
         2 * P * 3 * h),
        ("rs_step_q + send", lambda: K.rs_step_q(buf, rq, rs, c, cn),
         "rs_step_q", P * (4 * h + h + 4 * h // 256 + 4 * h) + sq),
        ("rs_step_q", lambda: K.rs_step_q(buf, rq, rs, c), "rs_step_q",
         P * (4 * h + h + 4 * h // 256 + 4 * h)),
        ("ag_step f32", lambda: K.ag_step(own, recv, c), "ag_step",
         4 * P * 4 * h),
        ("ag_step f32 1 MiB", lambda: K.ag_step(own1, recv1, c), "ag_step",
         4 * P * 4 * hs),
        ("torch.cat f32", lambda: torch.cat([own, recv], dim=1), None,
         4 * P * 4 * h),
        ("torch.cat f32 1 MiB", lambda: torch.cat([own1, recv1], dim=1),
         None, 4 * P * 4 * hs),
        ("ring_update f32 accumulate + send",
         lambda: K.ring_update(v, rv, ridx, True, True), "ring_",
         4 * P * 4 * b),
        ("ring_update f32 accumulate",
         lambda: K.ring_update(v, rv, ridx, True, False), "ring_",
         4 * P * 3 * b),
        ("qacc", lambda: QK.qacc_kernel(qq, qs, acc), "qacc",
         C * chunk * 9 + 4 * C),
        ("torch.addcmul", lambda: torch.addcmul(acc, qq, qs), None,
         C * chunk * 9 + 4 * C),
    ]


def main():
    from repro_torch.launch import profile_rmsnorm as PR

    if not torch.cuda.is_available():
        raise SystemExit("profile_collective_steps needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"butterfly step kernels on {torch.cuda.get_device_name(0)}, p={P}, "
          f"{N * 4 >> 20} MiB float32 a rank")
    out = []
    for name, fn, match, nbytes in cases(dev):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        r = {"case": name, "host_us": PR.host_us_per_call(fn, CALLS),
             "device_ms": PR.device_ms_per_call(fn, match),
             "event_ms": PR.event_ms(fn), "bound_ms": bound}
        r["share_of_bound"] = bound / r["device_ms"]
        out.append(r)
        print(f"  {name}: host {r['host_us']:.2f} us/call, device "
              f"{r['device_ms']:.4f} ms ({r['share_of_bound']:.0%} of the "
              f"{bound:.4f} ms bound), event {r['event_ms']:.4f} ms",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
