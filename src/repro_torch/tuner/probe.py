"""Microbenchmark harness: time the REAL collectives.

Port of ``repro.tuner.probe``.  For every (collective × backend × payload
× p) cell of a grid, the probe calls ``repro_torch.collectives.api`` on a
stacked ``[p, n]`` buffer on the caller's device — the dispatch the
train step uses, the stacked schedules and the ``pallas_fused`` step
kernels alike — warms it up, and times it with a trimmed median over
repetitions.  On the card each sample is one call between two CUDA
events; on the CPU, ``time.perf_counter`` around the call.  Payloads are
deterministic (arange-derived, never RNG at probe time) so two probe
runs time bit-identical inputs.

The probe measures the machine it runs on; ``topology`` is only the
decision-table key the measurements are filed under (which table
``refresh`` will rebuild) and the preset ``bine_hier``'s tier stack is
derived from.  Every rank count of a grid runs on the ONE device: the p
ranks are stacked on it, so a table the probe writes is a fact about the
stacked executor and its kernels on that device, not about links.  On
the CPU the ``pallas_fused`` cells run the kernels' plain versions —
wiring-correct, not performance-representative.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tuner.store import Measurement, MeasurementSet

#: collectives the probe can drive end-to-end through collectives.api
PROBE_COLLECTIVES = ("allreduce", "reduce_scatter", "allgather")

#: device bytes one rank count may take, as a multiple of its largest
#: stacked input (the input, the output and the schedules' temporaries)
MEMORY_FACTOR = 8


class ProbeTimeout(RuntimeError):
    """One probe cell exceeded its wall-clock budget (a hung launch or a
    wedged collective); the grid sweep retries or skips the cell instead
    of hanging the whole tune run."""


class DeviceWedged(RuntimeError):
    """After a failed cell the device did not drain within the cell's
    budget: the rest of the grid cannot be timed on it."""


def call_with_budget(fn: Callable[[], object],
                     budget_s: Optional[float]) -> object:
    """Run ``fn()`` with a wall-clock budget; ``None`` = unbudgeted.

    The call runs on a worker thread and the caller joins with a timeout:
    a wedged launch or synchronize cannot be interrupted from Python, so
    on timeout the worker is *abandoned* (a daemon thread that dies with
    the process) and :class:`ProbeTimeout` raises — the price of not
    hanging the sweep.  Exceptions from ``fn`` re-raise in the caller.
    """
    if budget_s is None:
        return fn()
    if budget_s <= 0:
        raise ValueError(f"budget_s must be > 0, got {budget_s}")
    box: Dict[str, object] = {}

    def worker():
        try:
            box["result"] = fn()
        except BaseException as e:   # re-raised in the caller below
            box["error"] = e

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    t.join(budget_s)
    if t.is_alive():
        raise ProbeTimeout(
            f"probe cell exceeded its {budget_s:g}s wall-clock budget "
            f"(worker abandoned)")
    if "error" in box:
        raise box["error"]  # type: ignore[misc]
    return box.get("result")


@dataclass(frozen=True)
class GridSpec:
    """One probe grid: the cells ``probe_grid`` times."""
    name: str
    collectives: Tuple[str, ...]
    sizes: Tuple[int, ...]          # FULL-vector payload bytes (pow2)
    ps: Tuple[int, ...]
    warmup: int = 2
    reps: int = 10
    #: per-cell wall-clock budget (warmup + reps), seconds; None =
    #: unbudgeted
    budget_s: Optional[float] = None
    #: extra attempts after a timed-out/failed cell before skipping it
    retries: int = 0
    #: sleep between attempts, seconds (linear: attempt * backoff_s)
    backoff_s: float = 0.0


#: named grids for launch/tune.py, the reference's.  Sizes sit exactly on
#: decision-table bucket edges (SIZE_BUCKETS) so every measurement lands
#: in the cell it was aimed at.  "tiny" is the CPU smoke grid.
GRIDS: Dict[str, GridSpec] = {
    "tiny": GridSpec("tiny", PROBE_COLLECTIVES,
                     sizes=(1 << 16, 1 << 18, 1 << 20), ps=(4,),
                     warmup=1, reps=5),
    "small": GridSpec("small", PROBE_COLLECTIVES,
                      sizes=(1 << 16, 1 << 20, 1 << 24), ps=(4, 8),
                      warmup=2, reps=10),
    "full": GridSpec("full", PROBE_COLLECTIVES,
                     sizes=tuple(1 << k for k in range(14, 27, 2)),
                     ps=(4, 8, 16), warmup=2, reps=20),
}


def trimmed_median(times: List[float], trim: float = 0.2) -> float:
    """Median of the middle (1 - 2*trim) of the sorted samples.

    Robust to the one-off hiccups (GC, interrupts) that poison a mean and
    to the cold tail a plain min hides behind.
    """
    if not times:
        raise ValueError("no samples")
    xs = sorted(times)
    k = int(len(xs) * trim)
    xs = xs[k:len(xs) - k] or xs
    mid = len(xs) // 2
    if len(xs) % 2:
        return xs[mid]
    return 0.5 * (xs[mid - 1] + xs[mid])


def _payload(nbytes: int, p: int) -> np.ndarray:
    """Deterministic full-vector payload, one row per rank ([p, n])."""
    n = max(p, nbytes // 4)
    n -= n % p
    base = (np.arange(n, dtype=np.float32) % 977.0) / 977.0
    rows = np.stack([np.roll(base, r) for r in range(p)])
    return rows


#: the one live payload: every backend of a (p, nbytes) grid point times
#: the identical tensor, so it is built and copied to the device once
_payload_cache: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _payload_cached(nbytes: int, p: int,
                    device: torch.device) -> torch.Tensor:
    key = (nbytes, p, str(device))
    if key not in _payload_cache:
        _payload_cache.clear()   # one grid point live at a time
        _payload_cache[key] = torch.from_numpy(_payload(nbytes, p)).to(
            device)
    return _payload_cache[key]


def _build_fn(collective: str, backend: str,
              topology: Optional[str] = None,
              wire_dtype: str = "float32") -> Callable[[torch.Tensor],
                                                       torch.Tensor]:
    """One probe cell's call: stacked ``[p, ...]`` in, the stacked
    per-rank results out, through the ``collectives.api`` dispatch.

    ``topology`` seeds the config preset so ``bine_hier`` cells execute
    the tier stack of the table the measurement is filed under.
    ``wire_dtype`` times the codec'd call — quantize/dequantize included,
    exactly what the train step would run."""
    from repro_torch.collectives import api

    cfg = api.CollectiveConfig(backend=backend, wire_dtype=wire_dtype)
    if topology is not None:
        cfg = cfg.replace(topology=topology)
    if collective == "allreduce":
        return lambda x: api.allreduce(x, cfg)
    if collective == "reduce_scatter":
        return lambda x: api.reduce_scatter(x, cfg)
    if collective == "allgather":
        return lambda x: api.allgather(x, cfg)
    raise ValueError(f"probe cannot drive collective {collective!r}")


def _samples(fn, x: torch.Tensor, warmup: int, reps: int) -> List[float]:
    """Seconds of ``reps`` calls of ``fn(x)`` after ``warmup`` calls: CUDA
    events around each call on the card, the host clock on the CPU."""
    for _ in range(max(1, warmup)):
        fn(x)
    ts = []
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):
            torch.cuda.synchronize()
            for _ in range(max(1, reps)):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(x)
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b) * 1e-3)
        return ts
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn(x)
        ts.append(time.perf_counter() - t0)
    return ts


def time_collective(collective: str, backend: str, p: int, nbytes: int,
                    device=None, warmup: int = 2, reps: int = 10,
                    topology: Optional[str] = None,
                    wire_dtype: str = "float32",
                    budget_s: Optional[float] = None,
                    samples: Optional[List[float]] = None) -> Measurement:
    """Warm up and time one cell on ``device`` (the card unless the
    caller asks for the CPU); returns its ``Measurement``.  ``samples``,
    where given, is extended with the cell's raw seconds per rep.

    ``allgather`` is fed its block input (``nbytes/p`` per rank) so the
    FULL-vector payload — the decision-table key — is ``nbytes`` for
    every collective alike (and stays the float32 payload whatever
    ``wire_dtype`` the timed call compresses to).  ``budget_s`` caps the
    cell's whole warmup+reps wall clock (:func:`call_with_budget`;
    raises :class:`ProbeTimeout` past it).
    """
    dev = resolve_device(device or "cuda")
    rows = _payload_cached(nbytes, p, dev)
    if collective == "allgather":
        rows = rows[:, :rows.shape[1] // p].contiguous()

    def cell() -> List[float]:
        fn = _build_fn(collective, backend, topology, wire_dtype)
        return _samples(fn, rows, warmup, reps)

    times = call_with_budget(cell, budget_s)
    if samples is not None:
        samples.extend(times)
    return Measurement(collective=collective, backend=backend, p=p,
                       nbytes=int(nbytes), time_s=trimmed_median(times),
                       reps=len(times), wire_dtype=wire_dtype)


def _drain(device, budget_s: Optional[float]) -> None:
    """Wait for the device after a failed cell: a timed-out cell's
    abandoned worker may still hold the stream, and the next cell's
    timing must not start behind it.  Raises :class:`DeviceWedged` when
    the wait itself times out or fails."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    try:
        call_with_budget(lambda: torch.cuda.synchronize(dev), budget_s)
    except Exception as e:
        raise DeviceWedged(
            f"{dev} did not drain after a failed probe cell: {e!r}") from e


def _free_bytes(device: torch.device) -> Optional[int]:
    """Free bytes on ``device`` (the host's available memory for the
    CPU), or None where it cannot be read."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return None


def probe_backends(collective: str,
                   topology: Optional[str] = None) -> Tuple[str, ...]:
    """The candidate set a measured cell must cover — exactly what the
    decision table for ``topology`` minimizes over (``bine_hier`` is not
    a candidate on the torus)."""
    if topology is not None:
        from repro_torch.topology.cost import candidates_for
        return candidates_for(collective, topology)
    from repro_torch.topology import CANDIDATES
    return CANDIDATES[collective]


def probe_wire_pairs(collective: str,
                     topology: str) -> Tuple[Tuple[str, str], ...]:
    """The *compressed* ``(backend, wire_dtype)`` cells of the joint wire
    grid — the float32 pairs are already covered by the plain backend
    sweep, so the probe only adds the codec variants on top."""
    from repro_torch.topology.cost import wire_candidates
    return tuple(bw for bw in wire_candidates(collective, topology)
                 if bw[1] != "float32")


def grid_cells(spec: GridSpec, topology: str
               ) -> List[Tuple[int, str, str, str]]:
    """One rank count's cells in probe order: ``(nbytes, collective,
    backend, wire)``, sizes outermost so every candidate of a (p, nbytes)
    grid point reuses the one cached payload."""
    out = []
    for nbytes in spec.sizes:
        for collective in spec.collectives:
            cells = [(b, "float32")
                     for b in probe_backends(collective, topology)]
            cells += list(probe_wire_pairs(collective, topology))
            out += [(nbytes, collective, b, w) for b, w in cells]
    return out


def _probe_cell_with_retry(spec: GridSpec, collective: str, backend: str,
                           p: int, nbytes: int, device, topology: str,
                           wire: str,
                           sleep: Callable[[float], None] = time.sleep,
                           samples: Optional[List[float]] = None
                           ) -> Optional[Measurement]:
    """One cell under the spec's budget/retry policy; ``None`` = gave up.

    Retries cover timeouts AND in-cell runtime errors (a flaky device can
    throw once and succeed on the retry); config errors (ValueError /
    TypeError from a bad backend/wire combo) propagate — retrying a
    deterministic rejection only wastes the budget.  After every failed
    attempt the device is drained (:func:`_drain`); a device that does
    not drain raises :class:`DeviceWedged`.
    """
    attempts = 1 + max(0, spec.retries)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        if attempt and spec.backoff_s > 0:
            sleep(attempt * spec.backoff_s)
        try:
            return time_collective(collective, backend, p, nbytes,
                                   device=device, warmup=spec.warmup,
                                   reps=spec.reps, topology=topology,
                                   wire_dtype=wire, budget_s=spec.budget_s,
                                   samples=samples)
        except (ValueError, TypeError):
            raise
        except Exception as e:
            last = e
            _drain(device, spec.budget_s)
    assert last is not None
    return None


def probe_grid(spec: GridSpec, topology: str,
               timestamp: Optional[str] = None,
               progress: bool = False,
               sleep: Callable[[float], None] = time.sleep,
               device=None) -> List[MeasurementSet]:
    """Run every cell of ``spec`` on ``device`` (the card unless the
    caller asks for the CPU); one ``MeasurementSet`` per rank count.

    Every rank count runs stacked on the one device.  A rank count whose
    buffers would not fit in the device's free memory is skipped loudly
    (``skipped_ps`` in every set's provenance, ``skipped_why`` saying
    why) rather than silently shrinking the grid.  Cells that exhaust
    the spec's budget/retry policy (``budget_s``/``retries``/
    ``backoff_s``) are dropped the same way — recorded in
    ``failed_cells`` provenance, the rest of the grid still measured and
    the partial store still valid (``tuner.refresh`` only flips table
    cells with full candidate coverage, so a failed cell can never skew
    a decision).  A device that does not drain after a failed cell ends
    the sweep: that cell is recorded failed and ``aborted`` says why.
    ``cells_us`` in each set's provenance is a JSON object: for every
    timed cell (``collective:backend:wire:nbytes``), the least and the
    most of its reps, their sum, and the cell's wall clock (warmup, reps
    and retries), in microseconds — how far apart two candidates' reps
    lie, and how much of the sweep the timed reps are.  ``sleep`` is
    injectable for tests.
    """
    dev = resolve_device(device or "cuda")
    on_card = dev.type == "cuda"
    device_kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    out: List[MeasurementSet] = []
    skipped: List[int] = []
    why: List[str] = []
    aborted: Optional[str] = None
    for p in spec.ps:
        if aborted:
            break
        need = MEMORY_FACTOR * p * max(spec.sizes)
        free = _free_bytes(dev)
        if free is not None and need > free:
            skipped.append(p)
            why.append(f"p={p} needs ~{need} B, {free} B free on {dev}")
            continue
        failed: List[str] = []
        spread: Dict[str, List[float]] = {}
        ms = MeasurementSet(
            device_kind=device_kind, topology=topology, p=p,
            provenance={
                "grid": spec.name,
                "timestamp": timestamp,
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "platform": "gpu" if on_card else "cpu",
                "warmup": str(spec.warmup), "reps": str(spec.reps),
            })
        for nbytes, collective, backend, wire in grid_cells(spec, topology):
            tag = (f"p={p} {collective:>14} {backend:>12} {wire:>8} "
                   f"{nbytes:>10}B")
            samples: List[float] = []
            t0 = time.perf_counter()
            try:
                m = _probe_cell_with_retry(spec, collective, backend, p,
                                           nbytes, dev, topology, wire,
                                           sleep=sleep, samples=samples)
            except DeviceWedged as e:
                m = None
                aborted = f"{collective}:{backend}:{wire}:{nbytes}: {e}"
            if m is None:
                failed.append(f"{collective}:{backend}:{wire}:{nbytes}")
                why_failed = ("device wedged" if aborted
                              else "budget/retries exhausted")
                if progress:
                    print(f"[probe] {tag}    FAILED ({why_failed})")
                if aborted:
                    break
                continue
            ms.measurements.append(m)
            if samples:
                spread[f"{collective}:{backend}:{wire}:{nbytes}"] = [
                    min(samples) * 1e6, max(samples) * 1e6,
                    sum(samples) * 1e6, (time.perf_counter() - t0) * 1e6]
            if progress:
                print(f"[probe] {tag} {m.time_s * 1e6:10.1f}us")
        if spread:
            ms.provenance["cells_us"] = json.dumps(spread)
        if failed:
            ms.provenance["failed_cells"] = ",".join(failed)
        if aborted:
            ms.provenance["aborted"] = aborted
        out.append(ms)
    _payload_cache.clear()
    if skipped:
        for ms in out:
            ms.provenance["skipped_ps"] = ",".join(map(str, skipped))
            ms.provenance["skipped_why"] = "; ".join(why)
        if progress:
            print(f"[probe] skipped p={skipped}: " + "; ".join(why))
    return out
