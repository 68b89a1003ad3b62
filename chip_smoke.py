#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if anything is off:

1. build   — compile every kernel from the ``csrc/`` of every package under
             ``src/repro_torch/kernels`` (one nvcc per source, all at once);
2. kernels — each kernel against its plain PyTorch version on the card at
             its path's shapes, with its median time, the plain
             version's, a library call's where one computes the same
             function, and its bound; every row also records the
             wrapper's host us per call, and a row with a library call
             that call's device ms (torch.profiler) and host us:
             rs_step, ag_step, rs_step_q and
             ring_update BITWISE (one 64 MiB f32 bucket at p=4; rs_step_q
             also with NaN, inf, subnormal and FLT_MAX codec chunks in
             the send half; their rows and qacc's add the kernel's own
             device ms from torch.profiler), the
             matmul_pack / gather_matmul directions of perm_matmul within a
             bound stated from k (phi4-mini's tensor-parallel MLP shapes;
             float32 on the CUDA-core kernel, bf16 on the tensor-core
             ``wgmma`` kernel, the launch counts saying which ran);
             rmsnorm (rtol 1e-6 / one bf16 ulp; its row adds the
             kernel's device ms per call from torch.profiler)
             and flash_attention (2e-5 float32 on the CUDA cores / 3e-2
             bf16 on wgmma) at the serve
             cell's insert and decode shapes, qacc BITWISE on a 64 MiB
             accumulator (and at chunks 100 and 99), then the qdot op's
             own path (four int8 payloads accumulated, launches counted);
3. collectives — fused ``ops`` reduce-scatter / allgather / allreduce and
             the int8-wire pair against the plain ``stacked`` executor,
             bitwise, at p in {4, 8} on 64 MiB f32 vectors;
4. api     — the collectives API (``repro_torch.collectives.api``) at 64
             MiB per rank: reduce_scatter / allgather / allreduce for every
             backend at p in {4, 8} (ring, xla and the fused ring also at
             p=6, 48 MiB), ``pallas_fused`` x algo bitwise equal to the
             stacked algo and ``auto`` to the backend it resolved to; the
             rooted collectives and all_to_all at p=8 held to their
             definitions; the fused matmul collectives at phi4-mini's TP
             shapes in float32 and bf16 (the bf16 ones on the wgmma
             perm_matmul); with the launch counts read around the run and
             the per-backend times;
5. two-tier — ``bine_hier`` (the paper's composed schedules): one axis
             at p=8 with tpu_multipod's tiers (4, 2), and two axes,
             (pods, data) = (2, 4), on 64 MiB f32 a rank: reduce_scatter /
             allgather / allreduce held to a float64 sum within gamma_3
             sum |x| (the allgather exact), the card's bits equal to the
             CPU's on a 1 MiB slice, each call's time beside flat bine's;
             then the train cell over two DP axes (pod, data) = (2, 2):
             bine_hier bucketed == per-leaf (1 step each, bitwise),
             pallas_fused float32 (3 steps) == bine after step 1
             (bitwise), pallas_fused int8 (2 steps), every step-1 loss
             bitwise the flat p=4 pallas_fused one and later ones within
             1e-3 of the flat run's, rs_step / ag_step / rs_step_q
             launched on the two-axis path; warm step ms, tokens/s, peak;
6. train   — a small reference first (reduced phi4-mini, float32: the card
             against the CPU), then the main path, the cell of
             ``repro_torch/launch/cell.py``: full-width phi4-mini cut to 2
             layers, 4 DP ranks stacked on the card, global batch 8 x 1024
             tokens, ``backend="pallas_fused"``, table bucket size (64 MiB),
             3 float32-wire steps and 2 int8-wire steps, with the kernel
             launch counts read around each run (the ``train:`` JSON
             line carries their losses as ``float.hex`` and a sha256 of
             the params after each, which two trees share when they
             train to the same bits); then one ``bine`` float32
             step from the same start must give the same bits, one
             ``auto`` step on the torus preset the bits of the explicit
             ``recdoub`` step, and one ``wire_dtype="auto"`` step those of
             the explicit step with the pair every bucket resolved to;
7. serve   — a small reference first (reduced phi4-mini, float32: prefill
             and decode logits and 6 greedy streams, the card against the
             CPU), then the main path, ``SERVE_CELL`` of
             ``repro_torch/launch/cell.py``: phi4-mini at full width and
             depth, an 8-page pool of 1024 tokens, 16 greedy Poisson
             requests of 32 new tokens; every request retires with its
             tokens, every logit is finite, the launch counts read around
             the run are 65 rmsnorm per insert and per decode step and 32
             flash_attention per insert, every one on the wgmma kernel,
             and request 0 alone in a 1-page pool gets the same first
             token (the agreement of its later tokens, and which of one
             decode step's ops differ between a row alone and in a batch
             of 8, reported).  Prints prefill ms per insert, decode ms
             per step, tokens/s, p50/p99 time to first token and peak
             memory;
8. runtime — on the train cell (``pallas_fused``, float32 wire): the
             obs summary of the step's bucket plan against
             ``core.traffic``'s closed forms (rel 1e-12), the API hook's
             cost on phase 4's xla, fused and bine calls at 64 MiB (one
             call's ms and host us with the hook on and off in turns,
             and the hook alone); 3 steps with an
             ``AsyncCheckpointer`` save of the global state after step 1
             (step 2 timed with the save in flight, step 3 without), a
             restore into a fresh build whose step 2 must equal the
             uninterrupted step 2 bitwise (loss and params), the save's
             and the restore's wall times and GB/s; a ``TrainLoop`` with a
             transient failure injected at step 3 (its losses the
             uninterrupted ones, one restart); the train CLI saved at 2
             and 4 and resumed to 6 on the card; a measured table for the
             torus preset naming ``pallas_fused`` for the step's bucket
             cells, under which the ``auto`` step launches rs_step and
             ag_step where the analytic one launches neither.  The
             checkpoints go to a directory under ``build/`` that the
             phase removes; it fails if the disk lacks room for two;
9. tensor parallelism — the small megatron_sp and the reduced-width
             pure_sp configs of ``launch/cell.py`` at (dp, tp) = (2, 2),
             2 float32 steps, the card against the CPU (phase 6's
             bounds); then full-width phi4-mini (2 layers) at
             ``cell.TP_SHAPE`` = (2, 2) under megatron_sp and
             ``pallas_fused``: 3 float32-wire and 2 int8-wire steps
             (loss, grad norm, ms, peak GiB each; losses as
             ``float.hex`` and every rank's params sha256 after each
             run in the ``tp:`` line), the launches read
             around them, step 0 gated against (2, 1) on the same weights
             and batch (``TP_LOSS_RTOL``, ``TP_GNORM_RTOL``), and the
             step's device groups and idle share from
             ``launch/profile_step.py`` at ``--mesh 2,2`` (a ``tp:`` JSON
             line);
10. serving under TP — the small megatron_sp config at (dp, tp) =
             (1, 2) and the reduced-width pure_sp one at (2, 2), float32:
             insert and decode logits within 2e-5 of max |logit| and 6
             greedy streams equal, the card against the CPU; then the
             serve cell at ``cell.SERVE_TP_SHAPE`` = (2, 2) (megatron_sp,
             phase 7's weights, prompts and trace; each page's 1024 slots
             512 a TP rank): every request retires with its tokens, every
             logit is finite, 65 rmsnorm per insert and per decode step
             and 32 flash_attention per insert, all on wgmma, request 0's
             insert within ``SERVE_TP_ULPS`` bf16 ulps of max |logit| of
             phase 7's with its first token equal, the peak within phase
             7's plus the pool's bytes; the later tokens' agreement with
             phase 7, the serve numbers beside phase 7's and
             ``launch/profile_serve.py``'s breakdown and idle share at
             (1, 1) and (2, 2) (a ``serve-tp:`` JSON line);
11. dense configs — (a) the flash kernel at head_dim 256 against its
             plain version (bf16 within 3e-2 on wgmma, float32 within 2e-5
             on the CUDA cores) at gemma3-4b's insert (q [1, 2048, 8,
             256], causal and with its 1024-token window), its serve-TP
             insert and gemma-7b's (q [1, 1024, 16, 256]), with a
             ``flash_attention_hd256`` row (gemma3's causal bf16 shape,
             SDPA beside it and the SDPA backend named); flash at
             qwen3-32b's insert (64/8 heads of 128, bf16) and rmsnorm at
             the three cells' insert and decode rows (d_model 2560,
             3072, 5120; bf16 within one ulp, float32 within rtol 1e-6);
             (b) the three
             dense serve cells of ``launch/cell.py`` one after another
             (gemma3-4b and gemma-7b at full depth, qwen3-32b at 16 of 64
             layers), each through ``serve_checks`` (every request
             retired, finite logits, 2 L + 1 rmsnorm per insert and per
             step, L flash per insert, all on wgmma) with request 0 alone
             in a 1-page pool giving the same first token; (c) gemma3-4b
             at (dp, tp) = (2, 2), megatron_sp, request 0's insert within
             ``SERVE_TP_ULPS`` bf16 ulps of max |logit| of (b)'s; (d) one
             float32 step of the gemma3-4b train cell (2 layers, p = 4)
             under ``pallas_fused`` and ``bine``: params bitwise equal,
             the loss within ``G3_LOSS_ATOL`` of the plain float32 loss
             of the same weights and batch, as are the bf16 forward's
             losses on three seeds, while each fault of ``G3_FAULTS``
             lands outside it (a ``dense:`` JSON line);
12. MoE train — (a) reduced mixtral-8x7b and phi3.5-moe (float32) at
             (dp, tp) = (2, 1) and (2, 2), one pallas_fused step, the
             card against the CPU (phase 9's bounds); (b)-(c)
             ``cell.MOE_TRAIN_CELL``, mixtral-8x7b at full width cut to 1
             layer (1.71 B params), batch 8 x 1024, bf16, float32 wire,
             at (2, 1) (the dense capacity dispatch) and (2, 2)
             (megatron_sp with expert parallelism): 2 pallas_fused steps
             and 1 bine step from the same start, params bitwise equal
             after the first, rs_step and ag_step launched, the step-0
             loss within ``MOE_LOSS_ATOL`` of the plain float32 forward
             of the same weights (at (2, 2) the EP forward) and its
             tokens' NLL within ``MOE_TOKEN_ATOL`` on average, three
             seeds' bf16 forwards within both at (2, 1) and two faults
             of ``MOE_FAULTS`` outside the token gate; at (2, 2) the EP
             all_to_all's calls, backend and global-link bytes from the
             obs record; (d) step ms, peak GiB, and the (2, 2) step's
             device groups, its MoE layer by phase and idle share from
             ``launch/profile_step.py`` (a ``moe:`` JSON line).
13. recurrent blocks — (a) reduced xlstm-125m and zamba2-2.7b
             (float32, float32 caches), the card against the CPU: two
             pallas_fused train steps at p = 2 (losses and step 1's grad
             norm rtol 1e-4, params after step 1 as 12a) and prefill + 4
             decode steps (logits within 1e-4 of max |logit|); (b) the
             flash kernel at head_dim 80, zamba2's insert q [4, 1024, 32,
             80] causal (bf16 on wgmma within 3e-2, float32 on the CUDA
             cores within 2e-5; a ``flash_attention_hd80`` row beside
             SDPA); (c) ``cell.SSM_TRAIN_CELLS``: zamba2-2.7b at full
             width cut to 12 of 54 Mamba2 blocks (two firings of its tied
             shared block) and xlstm-125m at full depth, p = 4, batch 8 x
             1024, float32 wire: two pallas_fused steps and a bine step,
             params bitwise equal after the first, rs_step and ag_step
             launched, the loss and each token's NLL within
             ``SSM_GATES`` of the plain float32 forward (three seeds'
             bf16 forwards inside, two faults an arch outside), step ms,
             tokens/s, peak, and zamba2's idle share from
             ``launch/profile_step.py``; (d) ``cell.SSM_SERVE_CELLS``
             through ``launch.serve.run_fixed_batch``: zamba2-2.7b at full
             depth (4 x 1024 prompts) and xlstm-125m (8 x 1024), 32 greedy
             tokens each, 2 rmsnorm a block and the final norm per prefill
             and per decode step (each rmsnorm shape of the loop then held
             to the plain version, bf16 within one ulp), zamba2's 9 flash
             launches all on wgmma,
             its bf16 prefill logits within ``SSM_LOGIT_ULPS`` of the
             float32 prefill on three seeds and a planted flash fault
             outside (an ``ssm:`` JSON line).
14. frontend configs — (a) reduced pixtral-12b and musicgen-medium
             (float32, float32 caches) on frames, the card against the
             CPU, as 13a; (b) the flash kernel at head_dim 160, pixtral's
             prefill q [4, 1024, 32, 160] over 8 K/V heads, causal: bf16
             on wgmma within 3e-2 (``flash_attention_hd160``), float32 on
             the CUDA cores within 2e-5 (``flash_attention_hd160_f32``,
             the frames path's), each row beside SDPA with 50
             back-to-back calls timed (``loop_ms``), and float32 at
             musicgen's prefill (q [8, 1024, 24, 64]); (c)
             ``cell.FRONTEND_SERVE_CELLS`` through
             ``launch.serve.run_fixed_batch`` on float32 frames:
             pixtral-12b at full depth (4 x 1024 patches) and
             musicgen-medium (8 x 1024 frames), 32 greedy tokens, 2 L + 1
             rmsnorm per prefill and per step and L float32 flash per
             prefill (no wgmma), each rmsnorm shape of the loop held to
             plain (float32, rtol 1e-6), the frames prefill's last-token
             logits within ``FRAMES_LOGIT_RTOL`` of ``forward``'s (plain
             attention), then pixtral's token prefill (L wgmma flash at
             160) within ``PIXTRAL_LOGIT_ULPS`` of float32 on three seeds
             with a planted panel fault outside; (d)
             ``cell.FRONTEND_TRAIN_CELL``, musicgen-medium at full width
             cut to 16 of 48 layers, p = 4, batch 8 x 1024 frames, at
             (dp, tp) = (4, 1) and (2, 2): two pallas_fused steps (and a
             bine step at (4, 1), bitwise), rs_step and ag_step launched,
             the step-0 loss within ``FRONTEND_LOSS_RTOL`` of the plain
             float32 forward while two faults land outside, step ms,
             tokens/s, peak and idle share (a ``frontend:`` JSON line).
15. remat and MoE serving — (a) ``cfg.remat`` (on in every cell above,
             the reference's default): the phi4-mini train cell (p = 4)
             and the MoE cell at (2, 2) each trained two pallas_fused
             steps with remat off and on, losses and params bitwise
             equal, the MoE obs record the same (12 ``bine``
             all_to_all calls), fewer bytes saved for the backward with
             remat, step ms and peak both ways; (b)
             ``cell.MOE_SERVE_CELL`` through
             ``launch.serve.run_fixed_batch``: mixtral-8x7b at full width
             cut to 8 layers, 4 x 1024 prompts, 32 greedy tokens, 2 L + 1
             rmsnorm per prefill and per step and L flash per prefill,
             all on wgmma, the capacity drops counted, each rmsnorm and
             flash shape of the loop held to plain, the bf16 prefill
             logits within ``MOE_LOGIT_ULPS`` of a plain float32
             ``forward`` on three seeds with two MoE faults outside (a
             ``remat-moe-serve:`` JSON line).
16. the recurrent blocks and the fixed-batch loop over TP ranks — (a)
             reduced zamba2-2.7b and xlstm-125m at d_model 1024
             (megatron_sp: split heads and units) and xlstm at 64
             (pure_sp), float32: the TP forward, prefill_tp and 3
             decode_step_tp steps within 1e-4 of max |logit| of one
             rank's; (b) ``cell.SSM_TP_TRAIN_CELLS`` at (dp, tp) = (2,
             2): zamba2-2.7b x12 (megatron_sp) and xlstm-125m x4
             (pure_sp), two pallas_fused steps and a bine step (bitwise
             after the first), zamba2 remat on == off (params sha256),
             rs_step and ag_step launched, the step-0 loss within phase
             13's ``SSM_GATES`` loss bound of the plain float32 one-rank
             forward, the TP bf16 forward's token gap within its token
             bound and a TP fault (``TP_FAULTS``) outside; zamba2's grad
             norms within ``SSM_TP_GNORM_RTOL`` of phase 13's p = 4 run and
             its step-1 loss within the loss bound of that run's, two
             gradient faults (``TP_GRAD_FAULTS``) outside; step ms,
             tokens/s, peak; (c) ``cell.FIXED_TP_SERVE_CELLS`` through
             ``launch.serve.run_fixed_batch`` over 2 TP ranks:
             zamba2-2.7b at full depth, mixtral-8x7b x8 (its prefill on
             expert parallelism) and musicgen-medium (frames), the
             whole-row norms on rmsnorm and every flash launch counted,
             each rmsnorm and flash shape of the loop held to plain, the
             prefill logits within ``FIXED_TP_ULPS`` of the one-rank
             prefill on three seeds with planted faults outside, the
             greedy tokens against phases 13-15's, prefill ms, tokens/s,
             peak (an ``ssm-tp:`` JSON line).
17. the measurement plane — ``launch/tune.py --grid small --topology
             lumi`` in process on the card (p = 4 and 8 stacked, 64 KiB,
             1 MiB and 16 MiB, every candidate backend and int8 / bf16
             wire pair, each cell on a budgeted worker thread): no failed
             cell, every time finite and positive, every rank count's
             cells exactly the grid's, each measured table cell the
             argmin of its medians (backend and wire rows), all 18 cells
             measured, rs_step, ag_step and rs_step_q launched by the
             probe; every pallas_fused cell of the probe rerun at its
             shapes on its payload (float32, bf16 and int8 wires), held
             bitwise to stacked ``bine`` on the same wire and the float32
             ones to their definitions (a float64 rank sum within 1e-4);
             ``api.allreduce(backend="auto", tuning="measured")``
             on a measured cell launching what the table names (the same
             kernel counts and bits as that backend called directly); a
             drift store with one planted mis-priced cell: ``hints``
             flags it and only it, and ``tune --hints`` re-probes only
             its axes; ``launch/report.py`` on phase 8's obs registry
             (link bytes, one chosen line per preset, the probe's drift
             table, prom and trace outputs) (a ``tune:`` JSON line with
             every cell's median, least and most rep in us, the cells
             picked within the reps' spread, and the timed reps' share of
             the probe's wall).

The kernels line's launches of rs_step, ag_step and rs_step_q sum the
train step's main path, its two-axis path, phase 8's runs, the TP path's,
the gemma3 train step's, the MoE train steps', the recurrent train
cells' (phase 16's at (2, 2) too), the frontend train cell's, phase
15a's and phase 17's probe; those of rmsnorm the serve, serve-TP, dense serve and fixed-batch
paths' (the frontend and MoE ones, and phase 16's over TP ranks, too);
flash_attention's (head_dim 128) the serve, serve-TP, qwen3-32b and
mixtral fixed-batch paths' (one rank and two),
flash_attention_hd256's the gemma3-4b, gemma-7b and gemma3-4b serve-TP
paths', flash_attention_hd80's zamba2's fixed-batch paths' (one rank and
two),
flash_attention_hd160's pixtral's token prefill, and
flash_attention_hd160_f32's pixtral's frames prefill (musicgen's float32
flash at head_dim 64 counts in the by-path line only); the ``kernels by
path:`` line gives each
path's own counts, each of which must be above 0.  Prints a ``kernels:``
summary, one JSON line of per-kernel numbers, the card's name and power
limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits 2 without a result when there is
no CUDA device or no ``src/repro_torch`` beside this file.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet), for the kernels' bounds: device
#: memory, float32 on the CUDA cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
MiB = 1 << 20
CSRC = "src/repro_torch/kernels/collectives/csrc/"
KSRC = "src/repro_torch/kernels/"
SOURCE = {"rs_step": CSRC + "collective_steps.cu",
          "ag_step": CSRC + "collective_steps.cu",
          "rs_step_q": CSRC + "collective_steps.cu",
          "ring_update": CSRC + "ring_update.cu",
          "matmul_pack": CSRC + "perm_matmul.cu",
          "gather_matmul": CSRC + "perm_matmul.cu",
          "matmul_pack_wgmma": CSRC + "perm_matmul.cu",
          "gather_matmul_wgmma": CSRC + "perm_matmul.cu",
          "rmsnorm": KSRC + "rmsnorm/csrc/rmsnorm.cu",
          "flash_attention": KSRC + "flash_attention/csrc/flash_attention.cu",
          "flash_attention_hd256":
          KSRC + "flash_attention/csrc/flash_attention.cu",
          "flash_attention_hd80":
          KSRC + "flash_attention/csrc/flash_attention.cu",
          "flash_attention_hd160":
          KSRC + "flash_attention/csrc/flash_attention.cu",
          "flash_attention_hd160_f32":
          KSRC + "flash_attention/csrc/flash_attention.cu",
          "qacc": KSRC + "qdot/csrc/qacc.cu"}
REPLACES = {
    "rs_step": "src/repro/kernels/collectives/kernel.py:78",
    "ag_step": "src/repro/kernels/collectives/kernel.py:258",
    "rs_step_q": "src/repro/kernels/collectives/kernel.py:166",
    "ring_update": "src/repro/kernels/collectives/kernel.py:300",
    "matmul_pack": "src/repro/kernels/collectives/kernel.py:412",
    "gather_matmul": "src/repro/kernels/collectives/kernel.py:426",
    "matmul_pack_wgmma": "src/repro/kernels/collectives/kernel.py:412",
    "gather_matmul_wgmma": "src/repro/kernels/collectives/kernel.py:426",
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:26",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:91",
    "flash_attention_hd256": "src/repro/kernels/flash_attention/kernel.py:91",
    "flash_attention_hd80": "src/repro/kernels/flash_attention/kernel.py:91",
    "flash_attention_hd160": "src/repro/kernels/flash_attention/kernel.py:91",
    "flash_attention_hd160_f32":
    "src/repro/kernels/flash_attention/kernel.py:91",
    "qacc": "src/repro/kernels/qdot/kernel.py:27",
}
#: phi4-mini's tensor-parallel MLP at p=4 (d_model 3072, d_ff 8192): the
#: matmul_reduce_scatter (x @ w_o shard) and allgather_matmul (gathered x
#: @ w_i shard) shapes, (p, m, k, n)
MM_RS = (4, 8192, 2048, 3072)
MM_AG = (4, 8192, 3072, 2048)
#: unit roundoff of bf16 (8 significant bits, round to nearest even)
BF16_U = 2.0 ** -8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def ms(x: float) -> str:
    return f"{x:.4f}"


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after a warm-up."""
    import torch
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


def max_abs_err(got, exp) -> float:
    return max(float((g.double() - e.double()).abs().max())
               for g, e in zip(got, exp))


def same_bits(got, exp, what: str) -> None:
    import torch
    for g, e in zip(got, exp):
        check(g.dtype == e.dtype and g.shape == e.shape,
              f"{what}: {g.dtype}{tuple(g.shape)} vs {e.dtype}{tuple(e.shape)}")
        if g.dtype == torch.float32:
            g, e = g.view(torch.int32), e.view(torch.int32)
        elif g.dtype == torch.bfloat16:
            g, e = g.view(torch.int16), e.view(torch.int16)
        check(torch.equal(g, e), f"{what}: kernel differs from plain version")


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def params_sha256(params) -> str:
    """sha256 of the given ranks' every leaf, raw bytes in tree order:
    two trees of the port train to the same bits when it is equal."""
    import hashlib
    import torch
    from repro_torch import tree as T

    h = hashlib.sha256()
    for rank in params:
        for x in T.flatten(rank):
            t = x.detach().contiguous().cpu()
            h.update(str(t.dtype).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mm_bound(x, w, k: int):
    """Elementwise bound on two float32 sums of k products taken in
    different orders: 2 k 2**-24 (|x| @ |w|) (each order is within
    k 2**-24 (|x| @ |w|) of the exact sum)."""
    import torch
    return 2 * k * 2.0 ** -24 * torch.matmul(x.float().abs(), w.float().abs())


def within(got, exp, lim, what: str) -> float:
    """|got - exp| <= lim elementwise; returns max |got - exp|."""
    d = (got.double() - exp.double()).abs()
    check(bool((d <= lim.double()).all()),
          f"{what}: off by {float(d.max())} (bound {float(lim.max())})")
    return float(d.max())


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(dev):
    import torch
    from repro_torch.collectives import compression as comp
    from repro_torch.core import tables as tb
    from repro_torch.kernels.collectives import kernel as K
    from repro_torch.kernels.collectives import ref as R
    from repro_torch.launch import cell
    from repro_torch.launch import profile_rmsnorm as PR

    p, n = cell.N_DP, 64 * MiB // 4       # one 64 MiB f32 bucket per rank
    h = n // 2
    bt = tb.butterfly_tables("bine_dd", p)
    c = torch.as_tensor(bt.cbit[0], dtype=torch.int32, device=dev)
    cn = torch.as_tensor(bt.cbit[1], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = {}

    def row(name, err, kernel_fn, plain_fn, bound, bound_by,
            library_fn=None, device=None, host_calls=100, **extra):
        """One kernels-line row; ``device``: the kernel's name (a
        substring) whose own time under torch.profiler goes into
        ``device_ms`` beside the host-inclusive ``ms``.  Every row also
        records the wrapper's host us per call (``host_us``: host_calls
        calls, no sync), and a row with a library call that call's
        device time (``library_device_ms``: every kernel it launches,
        under torch.profiler) and host us per call."""
        torch.cuda.synchronize()
        k_ms = time_ms(kernel_fn)
        plain_ms = time_ms(plain_fn)
        lib_ms = None if library_fn is None else time_ms(library_fn)
        if device is not None:
            extra["device_ms"] = PR.device_ms_per_call(kernel_fn, device)
        extra["host_us"] = PR.host_us_per_call(kernel_fn, host_calls)
        if library_fn is not None:
            extra["library_device_ms"] = PR.device_ms_per_call(library_fn)
            extra["library_host_us"] = PR.host_us_per_call(library_fn,
                                                           host_calls)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": lib_ms, **extra}
        dev_note = ("" if device is None else
                    f", device {ms(extra['device_ms'])} ms "
                    f"({bound / extra['device_ms']:.0%} of the bound)")
        lib_note = ("none" if lib_ms is None else
                    f"{ms(lib_ms)} ms, device "
                    f"{ms(extra['library_device_ms'])} ms, host "
                    f"{extra['library_host_us']:.2f} us")
        log(f"  {name}: {ms(k_ms)} ms{dev_note}, host "
            f"{extra['host_us']:.2f} us per call ({host_calls} calls, no "
            f"sync), plain {ms(plain_ms)} ms, bound {ms(bound)} ms "
            f"({bound_by}), library {lib_note}")

    def entry(name, kernel_fn, plain_fn, nbytes, variants, library_fn=None):
        got, exp = as_tuple(kernel_fn()), as_tuple(plain_fn())
        same_bits(got, exp, name)
        err = max_abs_err(got, exp)
        for what, kf, pf in variants:   # the other dtypes / variants
            same_bits(as_tuple(kf()), as_tuple(pf()), f"{name} {what}")
        log(f"  {name}: bitwise OK ({1 + len(variants)} variants), "
            f"{nbytes / MiB:.0f} MiB moved")
        row(name, err, kernel_fn, plain_fn, nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes", library_fn, device=name)

    # rs_step, f32 with the next send: reads the kept half and recv, writes
    # new and send
    buf, recv = randn(p, 2 * h), randn(p, h)
    kept = R.take_half(buf, c)
    b16, r16 = buf.to(torch.bfloat16), recv.to(torch.bfloat16)
    entry("rs_step", lambda: K.rs_step(buf, recv, c, cn),
          lambda: R.rs_step_ref(buf, recv, c, cn),
          4 * p * (h + h + h + h // 2),
          [("f32 no-send", lambda: K.rs_step(buf, recv, c),
            lambda: R.rs_step_ref(buf, recv, c)),
           ("bf16 send", lambda: K.rs_step(b16, r16, c, cn),
            lambda: R.rs_step_ref(b16, r16, c, cn)),
           ("bf16 no-send", lambda: K.rs_step(b16, r16, c),
            lambda: R.rs_step_ref(b16, r16, c))],
          # the library call: torch.add of the kept half and recv, the
          # no-send variant's function (timed beside it below)
          library_fn=lambda: torch.add(kept, recv))
    rows["rs_step"]["no_send_ms"] = time_ms(lambda: K.rs_step(buf, recv, c))
    rows["rs_step"]["no_send_device_ms"] = PR.device_ms_per_call(
        lambda: K.rs_step(buf, recv, c), "rs_step")
    log(f"  rs_step no-send (the library call's function): "
        f"{ms(rows['rs_step']['no_send_ms'])} ms, device "
        f"{ms(rows['rs_step']['no_send_device_ms'])} ms; rs_step_q has no "
        f"single-call library counterpart (decode, add, re-quantize)")

    # ag_step, f32 at the last AG step of the bucket (out [p, 2h])
    a, b = randn(p, h), randn(p, h)
    a16, b16_ = a.to(torch.bfloat16), b.to(torch.bfloat16)
    qa, _ = comp.quantize_wire(a)
    qb, _ = comp.quantize_wire(b)
    entry("ag_step", lambda: K.ag_step(a, b, c), lambda: R.ag_step_ref(a, b, c),
          4 * p * 4 * h,
          [("bf16", lambda: K.ag_step(a16, b16_, c),
            lambda: R.ag_step_ref(a16, b16_, c)),
           ("int8", lambda: K.ag_step(qa, qb, c),
            lambda: R.ag_step_ref(qa, qb, c)),
           ("int8 odd h", lambda: K.ag_step(qa[:, :999].contiguous(),
                                            qb[:, :999].contiguous(), c),
            lambda: R.ag_step_ref(qa[:, :999], qb[:, :999], c))],
          # the library call: every rank's [buf, recv] (the c = 0 order)
          library_fn=lambda: torch.cat([a, b], dim=1))

    # rs_step_q with the next send: f32 kept half, int8 recv + scales in;
    # f32 new, int8 send + scales out
    rq, rs = comp.quantize_wire(randn(p, h))
    h2 = h // 2
    rq2, rs2 = comp.quantize_wire(randn(p, h2))
    buf2 = randn(p, 2 * h2)
    # a NaN in one codec chunk and an infinity in another of both halves of
    # both kept halves: whatever c and c_next, the send half holds both;
    # likewise a chunk of subnormals (scale 2**-126) and one holding
    # FLT_MAX (scale 2**122), with a zero payload so new keeps them
    bufn, rqn = buf.clone(), rq.clone()
    tiny, big = torch.finfo(torch.float32).tiny, torch.finfo(torch.float32).max
    for j in (5, h // 2 + 5, h + 5, h + h // 2 + 5):
        bufn[:, j], bufn[:, j + 256] = float("nan"), float("inf")
        bufn[:, j + 507:j + 763] = tiny / 4 * torch.rand(p, 256, device=dev,
                                                         generator=gen)
        bufn[:, j + 763] = big
        rqn[:, (j + 507) % h:(j + 764) % h] = 0
    entry("rs_step_q", lambda: K.rs_step_q(buf, rq, rs, c, cn),
          lambda: R.rs_step_ref_q(buf, rq, rs, c, cn),
          p * (4 * h + h + 4 * h // 256 + 4 * h + h // 2 + 4 * h // 2 // 256),
          [("no-send", lambda: K.rs_step_q(buf2, rq2, rs2, cn),
            lambda: R.rs_step_ref_q(buf2, rq2, rs2, cn)),
           ("NaN/inf/subnormal/FLT_MAX send",
            lambda: K.rs_step_q(bufn, rqn, rs, c, cn),
            lambda: R.rs_step_ref_q(bufn, rqn, rs, c, cn))])
    ss = R.rs_step_ref_q(bufn, rqn, rs, c, cn)[2]
    check(bool((ss == 2.0 ** -126).any() and (ss == 2.0 ** 122).any()
               and ss.isinf().any() and (ss == 1.0).any()),
          "rs_step_q's edge chunks did not reach the send half")
    del buf, recv, kept, b16, r16, a, b, a16, b16_, qa, qb, rq, rs, rq2, rs2
    del buf2
    del bufn, rqn, ss
    torch.cuda.empty_cache()
    phase_ring_update(dev, randn, entry, row)
    phase_perm_matmul(dev, randn, row)
    qacc_launches = phase_serve_kernels(dev, randn, row)
    return rows, qacc_launches, row, randn


def phase_ring_update(dev, randn, entry, row):
    """ring_update on one 64 MiB f32 bucket at p=4: v [4, 16 Mi] in place,
    b = 4 Mi, a different block per rank; accumulate with the next send
    (the reduce-scatter step), accumulate, write, and the same in bf16,
    all BITWISE.  The row is the accumulate with the next send, which no
    library call computes (library none); the f32 and bf16 accumulates
    without send are logged beside one ``index_put_(...,
    accumulate=True)`` over the ranks' blocks, the same work, both with
    their device times."""
    import torch
    from repro_torch.kernels.collectives import kernel as K
    from repro_torch.kernels.collectives import ref as R
    from repro_torch.launch import profile_rmsnorm as PR

    p, n = 4, 64 * MiB // 4
    b = n // p
    ridx = torch.tensor([1, 3, 0, 2], dtype=torch.int32, device=dev)
    v, recv = randn(p, n), randn(p, b)
    v16, r16 = v.to(torch.bfloat16), recv.to(torch.bfloat16)

    def pair(vv, rr, acc, upd):
        return (lambda: K.ring_update(vv.clone(), rr, ridx, acc, upd),
                lambda: R.ring_update_ref(vv.clone(), rr, ridx, acc, upd))

    variants = [("f32 accumulate", *pair(v, recv, True, False)),
                ("f32 write", *pair(v, recv, False, False)),
                ("bf16 accumulate + send", *pair(v16, r16, True, True)),
                ("bf16 accumulate", *pair(v16, r16, True, False)),
                ("bf16 write", *pair(v16, r16, False, False)),
                ("bool write", *pair(v > 0, recv > 0, False, False))]
    kf, pf = pair(v, recv, True, True)
    got, exp = kf(), pf()
    same_bits(got, exp, "ring_update")
    for tag, kv, pv in variants:
        same_bits(as_tuple(kv()), as_tuple(pv()), f"ring_update {tag}")
    # the blocks a rank does not receive into stay as they were
    out = got[0].view(p, p, b)
    keep = torch.ones(p, p, dtype=torch.bool, device=dev)
    keep[torch.arange(p, device=dev), ridx.long()] = False
    check(torch.equal(out[keep], v.view(p, p, b)[keep]),
          "ring_update touched a block it does not own")
    err = max_abs_err(got, exp)
    del got, exp, out
    log(f"  ring_update: bitwise OK ({1 + len(variants)} variants)")
    rows_idx = (torch.arange(p, device=dev) * p + ridx.long())
    nbytes = 4 * p * b * 4          # block read + recv read + block + send
    # no library call writes the next send beside the accumulate: the
    # library time stands beside the f32 accumulate below, the same work
    row("ring_update", err,
        lambda: K.ring_update(v, recv, ridx, True, True),
        lambda: R.ring_update_ref(v, recv, ridx, True, True),
        nbytes / HBM_BYTES_PER_S * 1e3, "bytes", device="ring_")
    # every other variant: kernel, plain version, bound (and the library
    # call, beside its device time, where it computes the same function)
    for tag, vv, rr, acc, upd in (
            ("f32 accumulate", v, recv, True, False),
            ("f32 write", v, recv, False, False),
            ("bf16 accumulate + send", v16, r16, True, True),
            ("bf16 accumulate", v16, r16, True, False),
            ("bf16 write", v16, r16, False, False)):
        nb = (2 + acc + upd) * p * b * vv.element_size()
        t = time_ms(lambda: K.ring_update(vv, rr, ridx, acc, upd))
        tp = time_ms(lambda: R.ring_update_ref(vv, rr, ridx, acc, upd))
        lib = ""
        if acc and not upd:
            lf = lambda: vv.view(p * p, b).index_put_((rows_idx,), rr,
                                                      accumulate=True)
            kd = PR.device_ms_per_call(
                lambda: K.ring_update(vv, rr, ridx, acc, upd), "ring_")
            lib = (f", device {ms(kd)} ms; library {ms(time_ms(lf))} ms, "
                   f"device {ms(PR.device_ms_per_call(lf))} ms")
        log(f"    ring_update {tag}: {ms(t)} ms, plain {ms(tp)} ms, bound "
            f"{ms(nb / HBM_BYTES_PER_S * 1e3)} ms{lib}")
    del v, recv, v16, r16
    torch.cuda.empty_cache()


def phase_perm_matmul(dev, randn, row):
    """perm_matmul in both directions at phi4-mini's TP shapes, f32 (the
    CUDA-core kernel, rows ``matmul_pack`` / ``gather_matmul``) and bf16
    (the tensor-core kernel, rows ``*_wgmma``): within ``mm_bound`` of the
    plain version (plus one bf16 rounding, 2**-7 |y|, for a bf16 result),
    with both held against a float64 product; the launch counts say which
    kernel ran.  Library call: ``torch.matmul`` of the same shapes and
    dtype (TF32 off).  Each row adds the kernel's own device ms per call
    under torch.profiler (``device_ms``)."""
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.collectives import kernel as K
    from repro_torch.kernels.collectives import ref as R

    perm = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=dev)
    for name, (p, m, k, n), lhs in (("matmul_pack", MM_RS, False),
                                    ("gather_matmul", MM_AG, True)):
        x, w = randn(p, m, k), randn(p, k, n)
        flops = 2 * p * m * n * k
        for dt in (torch.float32, torch.bfloat16):
            xd, wd = x.to(dt), w.to(dt)
            wgmma = dt == torch.bfloat16
            check(K.perm_matmul_uses_wgmma(xd, wd, len(perm)) == wgmma,
                  f"{name} {dt}: the dispatch rule sends it to the wrong "
                  f"kernel")
            before = KB.LAUNCHES[name + "_wgmma"]
            got = K.perm_matmul(xd, wd, perm, lhs)
            check(KB.LAUNCHES[name + "_wgmma"] - before == wgmma,
                  f"{name} {dt}: the {'wgmma' if wgmma else 'CUDA-core'} "
                  f"kernel did not run")
            plain = (R.gather_matmul_ref if lhs else R.matmul_pack_ref)
            exp = plain(xd, wd, perm)
            lim = mm_bound(R.row_blocks(xd, perm) if lhs else xd, wd, k)
            if not lhs:
                lim = R.row_blocks(lim, perm)
            if wgmma:
                lim = lim + 2.0 ** -7 * exp.float().abs()
            err = within(got, exp, lim, f"{name} {dt}")
            x64 = (R.row_blocks(xd, perm) if lhs else xd).double()
            y64 = torch.matmul(x64, wd.double())
            if not lhs:
                y64 = R.row_blocks(y64, perm)
            e_k = float((got.double() - y64).abs().max())
            e_p = float((exp.double() - y64).abs().max())
            log(f"  {name} {str(dt)[6:]} {tuple(x.shape)} @ "
                f"{tuple(w.shape)} ({'wgmma' if wgmma else 'CUDA cores'}): "
                f"within bound of plain (max |diff| {err:.3e}); vs float64: "
                f"kernel {e_k:.3e}, plain {e_p:.3e}")
            del got, exp, lim, x64, y64
            row(name + "_wgmma" if wgmma else name, err,
                lambda: K.perm_matmul(xd, wd, perm, lhs),
                lambda: plain(xd, wd, perm),
                flops / (BF16_FLOPS if wgmma else F32_FLOPS) * 1e3,
                "operations", lambda: torch.matmul(xd, wd),
                device="perm_matmul_wgmma" if wgmma else "perm_matmul_kernel",
                host_calls=10)
            del xd, wd
        del x, w
        torch.cuda.empty_cache()


def bf16_ulp(x):
    """One bf16 ulp at each value of float32 ``x``."""
    import torch
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def flash_case(dev, randn, heads, T, window, dt, b=1, tp=1):
    """One flash-attention call on the card at the model's layout (q
    ``[b, T, nh / tp, hd]``, k and v ``[b, T, nkv / tp, hd]`` from
    ``randn``; ``heads`` = (nh, nkv, hd)), causal, optionally windowed:
    held to the plain version (bf16 within 3e-2 on the tensor cores,
    float32 within 2e-5 on the CUDA cores, the launch counts saying which
    ran), timed beside the plain version and SDPA, with its bound by
    operations or bytes.  Returns (kernel fn, plain fn, SDPA fn, max
    |diff|, bound ms, what bounds it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import ref as FR

    nh, nkv, hd = heads
    hq, hk = nh // tp, nkv // tp           # a TP rank's heads
    q, k, v = (randn(b, T, n, hd, dtype=dt) for n in (hq, hk, hk))
    qpos = torch.arange(T, device=dev)
    mask = qpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - qpos[None, :]) < window
    live = b * hq * int(mask.sum())
    qg = q.reshape(b, T, hk, hq // hk, hd).permute(0, 2, 3, 1, 4)
    kg, vg = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    kern = lambda: FO.flash_attention(q, k, v, window=window)
    plain = lambda: FR.flash_attention_ref(qg, kg, vg, window=window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    wgmma = dt == torch.bfloat16
    check(FK.flash_uses_wgmma(qg, kg, vg) == wgmma,
          f"flash_attention {dt}: the dispatch rule sends it to the "
          f"wrong kernel")
    before = KB.LAUNCHES["flash_attention_wgmma"]
    got = kern().float()
    check(KB.LAUNCHES["flash_attention_wgmma"] - before == wgmma,
          f"flash_attention T={T} {dt}: the "
          f"{'wgmma' if wgmma else 'CUDA-core'} kernel did not run")
    exp = plain().float().permute(0, 3, 1, 2, 4).reshape(b, T, hq, hd)
    ref = lib().float().transpose(1, 2)
    err = float((got - exp).abs().max())
    tol = 2e-5 if dt == torch.float32 else 3e-2
    check(err < tol, f"flash_attention T={T} window={window} {dt}: "
          f"off by {err} (tolerance {tol})")
    # q, k and v read once, o written once
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    flops = 4 * hd * live
    peak = F32_FLOPS if dt == torch.float32 else BF16_FLOPS
    bound = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / peak \
        else "operations"
    log(f"    flash_attention B={b} T={T} heads {hq}/{hk} "
        f"window={window} {str(dt)[6:]} "
        f"({'wgmma' if wgmma else 'CUDA cores'}): "
        f"{ms(time_ms(kern))} ms, plain {ms(time_ms(plain, reps=5))} ms, "
        f"library {ms(time_ms(lib))} ms, bound {ms(bound)} ms ({by}, "
        f"{live} live query-key pairs over its heads); max |diff| "
        f"{err:.3e} (vs SDPA "
        f"{float((got - ref).abs().max()):.3e})")
    return kern, plain, lib, err, bound, by


def rmsnorm_case(randn, rows_, d, eps, dt):
    """One rmsnorm call on the card, x [rows_, d] and w [d] from
    ``randn``, held to the plain version (float32 within rtol 1e-6, bf16
    within one bf16 ulp) and timed beside it and ``F.rms_norm``.  Returns
    (x, w, the library's weight 1 + w, max |diff|, bytes moved)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm import ref as RR

    x, w = randn(rows_, d, dtype=dt), (0.1 * randn(d)).to(dt)
    w1 = 1.0 + w        # the library's weight, made outside the timing
    before = KB.LAUNCHES["rmsnorm"]
    got = RK.rmsnorm_kernel(x, w, eps).float()
    check(KB.LAUNCHES["rmsnorm"] == before + 1,
          f"rmsnorm [{rows_}, {d}] {dt}: the kernel did not run")
    exp = RR.rmsnorm_ref(x, w, eps).float()
    diff = (got - exp).abs()
    lim = (1e-6 * exp.abs() if dt == torch.float32 else bf16_ulp(exp))
    check(bool((diff <= lim).all()),
          f"rmsnorm [{rows_}, {d}] {dt}: off by {float(diff.max())}")
    nbytes = (2 * rows_ * d + d) * x.element_size()
    t = time_ms(lambda: RK.rmsnorm_kernel(x, w, eps))
    tp = time_ms(lambda: RR.rmsnorm_ref(x, w, eps))
    tl = time_ms(lambda: F.rms_norm(x, (d,), w1, eps))
    log(f"    rmsnorm [{rows_}, {d}] {str(dt)[6:]}: {ms(t)} ms, plain "
        f"{ms(tp)} ms, library {ms(tl)} ms, bound "
        f"{ms(nbytes / HBM_BYTES_PER_S * 1e3)} ms; max |diff| "
        f"{float(diff.max()):.3e}")
    return x, w, w1, float(diff.max()), nbytes


def phase_serve_kernels(dev, randn, row):
    """The serving kernels at the serve cell's shapes: rmsnorm on one
    insert's rows [1024, 3072] and one decode step's [8, 3072], bf16 and
    float32 (float32 within rtol 1e-6 of the plain version, bf16 within one
    bf16 ulp), its row with the kernel's and ``F.rms_norm``'s device time
    per call (``device_ms``, ``library_device_ms``) beside the
    host-inclusive ``ms``, and the wrapper's host us per call; flash
    attention on one insert's prefill (q [1, 1024, 24, 128], k/v [1, 1024,
    8, 128], bf16, causal), a window-256, a T = 1000
    (padded) and a T = 4096 variant and the serve-TP insert's shape (the 2
    TP ranks in the batch, 12 / 4 heads each), within 3e-2 (bf16,
    the tensor-core kernel)
    and float32 (the CUDA-core kernel) within 2e-5, the launch counts
    saying which kernel ran;
    qacc on C = 65536 chunks of 256 (a 64 MiB float32 accumulator),
    BITWISE.  Then the qdot op's own path, driven with the counts set to 0:
    four int8 payloads of that bucket accumulated into one float32 partial
    (the compressed reduce-scatter's accumulate the reference's kernel
    describes).  Returns that path's launch count."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.qdot import kernel as QK
    from repro_torch.kernels.qdot import ops as QO
    from repro_torch.kernels.qdot import ref as QR
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm import ref as RR
    from repro_torch.launch import cell
    from repro_torch.launch import profile_rmsnorm as PR

    cfg = cell.serve_model_config()
    d, eps = cfg.d_model, cfg.norm_eps
    # rmsnorm
    variants = {(rows_, dt): rmsnorm_case(randn, rows_, d, eps, dt)
                for rows_, dt in ((1024, torch.bfloat16),
                                  (8, torch.bfloat16),
                                  (1024, torch.float32),
                                  (8, torch.float32))}
    x, w, w1, err, nbytes = variants[(1024, torch.bfloat16)]
    log("  rmsnorm: within rtol 1e-6 (float32) / one bf16 ulp of plain "
        "(4 variants)")
    kern = lambda: RK.rmsnorm_kernel(x, w, eps)
    lib = lambda: F.rms_norm(x, (d,), w1, eps)
    # the single-call time (ms) holds the host's part; the kernel's own
    # device time, and the library's (the sum of its kernels), apart
    row("rmsnorm", err, kern, lambda: RR.rmsnorm_ref(x, w, eps),
        nbytes / HBM_BYTES_PER_S * 1e3, "bytes", lib,
        device="rmsnorm_kernel", host_calls=PR.CALLS)
    del variants, x, w, w1, kern, lib

    # flash attention at the prefill of one insert (a 1024-token page)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    for T, window, dt, b, tp in ((1024, 256, torch.bfloat16, 1, 1),
                                 (1000, None, torch.bfloat16, 1, 1),
                                 (4096, None, torch.bfloat16, 1, 1),
                                 (1024, None, torch.bfloat16, 2, 2),
                                 (1024, None, torch.float32, 1, 1)):
        flash_case(dev, randn, heads, T, window, dt, b, tp)
    kern, plain, lib, err, bound, by = flash_case(dev, randn, heads, 1024,
                                                  None, torch.bfloat16)
    log("  flash_attention: within 3e-2 (bf16, tensor cores) / 2e-5 "
        "(float32, CUDA cores) of plain (6 variants)")
    row("flash_attention", err, kern, plain, bound, by, lib,
        device="flash_kernel_wgmma")
    del kern, plain, lib
    torch.cuda.empty_cache()

    # qacc: one 64 MiB float32 accumulator, bitwise
    C, chunk = 64 * MiB // 4 // 256, 256
    gen = torch.Generator(device=dev).manual_seed(9)

    def payload():
        q = torch.randint(-127, 128, (C, chunk), generator=gen, device=dev,
                          dtype=torch.int8)
        return q, torch.rand((C, 1), generator=gen, device=dev) * 0.01

    q, sc = payload()
    acc = randn(C, chunk)
    same_bits([QK.qacc_kernel(q, sc, acc)],
              [QR.dequant_accumulate_ref(q, sc, acc)], "qacc")
    same_bits([QK.qacc_kernel(q[:, :100].contiguous(), sc,
                              acc[:, :100].contiguous())],
              [QR.dequant_accumulate_ref(q[:, :100], sc, acc[:, :100])],
              "qacc chunk 100 (the scale's row a division)")
    same_bits([QK.qacc_kernel(q[:, :99].contiguous(), sc,
                              acc[:, :99].contiguous())],
              [QR.dequant_accumulate_ref(q[:, :99], sc, acc[:, :99])],
              "qacc chunk 99 (element-wise kernel)")
    log("  qacc: bitwise OK (3 variants: chunk 256, 100, 99)")
    row("qacc", 0.0, lambda: QK.qacc_kernel(q, sc, acc),
        lambda: QR.dequant_accumulate_ref(q, sc, acc),
        (C * chunk * 9 + 4 * C) / HBM_BYTES_PER_S * 1e3, "bytes",
        lambda: torch.addcmul(acc, q, sc), device="qacc")
    # the qdot op's path, counted
    recvs = [payload() for _ in range(4)]
    torch.cuda.synchronize()
    KB.reset_launches()
    part = acc
    for rq, rs in recvs:
        part = QO.dequant_accumulate(rq, rs, part)
    n = KB.LAUNCHES["qacc"]
    plain_part = acc
    for rq, rs in recvs:
        plain_part = QR.dequant_accumulate_ref(rq, rs, plain_part)
    same_bits([part], [plain_part], "qacc path (4 accumulates)")
    check(n == 4, f"the qdot path launched qacc {n} times, not 4")
    log(f"  qdot path: 4 int8 payloads accumulated into a 64 MiB float32 "
        f"partial, bitwise the plain accumulation; qacc x{n}")
    del q, sc, acc, recvs, part, plain_part
    torch.cuda.empty_cache()
    return n


# ---------------------------------------------------------------------------
# Phase 3: fused collectives against the plain stacked executor
# ---------------------------------------------------------------------------

def phase_collectives(dev):
    import torch
    from repro_torch.collectives import stacked
    from repro_torch.kernels.collectives import ops

    n = 64 * MiB // 4
    for p in (4, 8):
        gen = torch.Generator(device=dev).manual_seed(p)
        x = torch.randn((p, n), generator=gen, device=dev)
        row = ops.reduce_scatter(x)
        same_bits([row], [stacked.reduce_scatter(x)], f"reduce_scatter p{p}")
        same_bits([ops.allgather(row)], [stacked.allgather(row)],
                  f"allgather p{p}")
        full = ops.allreduce(x)
        same_bits([full], [stacked.allreduce_butterfly(x)], f"allreduce p{p}")
        ref = x.double().sum(0)
        err = float((full[0].double() - ref).abs().max())
        check(err < 1e-4 and all(torch.equal(full[0], full[r])
                                 for r in range(p)),
              f"allreduce p{p} is not the rank sum on every rank ({err})")
        del full
        rq = ops.reduce_scatter_q(x)
        same_bits([rq], [stacked.reduce_scatter_q(x)], f"reduce_scatter_q p{p}")
        same_bits([ops.allgather_q(rq)], [stacked.allgather_q(rq)],
                  f"allgather_q p{p}")
        log(f"  p={p}: reduce_scatter/allgather/allreduce and the int8 pair "
            f"bitwise equal to stacked; allreduce vs f64 sum {err:.2e}")
        del x, row, rq
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: the collectives API
# ---------------------------------------------------------------------------

#: backend name -> CollectiveConfig fields; (stacked twin) for the fused
API_BACKENDS = {
    "bine": {"backend": "bine"},
    "recdoub": {"backend": "recdoub"},
    "ring": {"backend": "ring"},
    "xla": {"backend": "xla"},
    "pallas_fused/bine": {"backend": "pallas_fused"},
    "pallas_fused/recdoub": {"backend": "pallas_fused",
                             "fused_algo": "recdoub"},
    "pallas_fused/ring": {"backend": "pallas_fused", "fused_algo": "ring"},
    "auto/tpu_multipod": {"backend": "auto"},
    "auto/torus": {"backend": "auto", "topology": "torus"},
}
#: what each fused config must equal bitwise
FUSED_TWIN = {"pallas_fused/bine": "bine", "pallas_fused/recdoub": "recdoub",
              "pallas_fused/ring": "ring"}
P6_BACKENDS = ("ring", "xla", "pallas_fused/ring")


def phase_api(dev):
    """Correctness pass (launch counts read around it), then one timing
    pass.  Returns the correctness pass's launch counts."""
    import torch
    from repro_torch.collectives import api, stacked
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.collectives import ops

    torch.cuda.synchronize()
    KB.reset_launches()
    timed = []
    per_call = {}

    def counted(fn):
        before = dict(KB.LAUNCHES)
        out = fn()
        return out, {k: v - before[k] for k, v in KB.LAUNCHES.items()
                     if v != before[k]}

    for p in (4, 8, 6):
        per_rank = (48 if p == 6 else 64) * MiB // 4   # divisible by p
        gen = torch.Generator(device=dev).manual_seed(100 + p)
        x = torch.randn((p, per_rank), generator=gen, device=dev)
        names = P6_BACKENDS if p == 6 else tuple(API_BACKENDS)
        outs = {}
        ref_sum = x.double().sum(0)
        for name in names:
            cfg = api.CollectiveConfig(**API_BACKENDS[name])
            rs, n_rs = counted(lambda: api.reduce_scatter(x, cfg))
            ag, n_ag = counted(lambda: api.allgather(rs, cfg))
            ar, n_ar = counted(lambda: api.allreduce(x, cfg))
            if n_rs or n_ag or n_ar:
                per_call[(name, p)] = (n_rs, n_ag, n_ar)
            # definitions: the rank sum (to rounding), gathered exactly
            err = float((ar[0].double() - ref_sum).abs().max())
            check(err < 1e-4 and all(torch.equal(ar[0], ar[r])
                                     for r in range(p)),
                  f"{name} p{p}: allreduce is not the rank sum ({err})")
            gathered = rs.reshape(1, -1).expand(p, -1)
            check(torch.equal(ag, gathered),
                  f"{name} p{p}: allgather is not the rank-ordered blocks")
            rs_err = float((rs.reshape(-1).double() - ref_sum).abs().max())
            check(rs_err < 1e-4, f"{name} p{p}: reduce_scatter off by "
                  f"{rs_err}")
            outs[name] = (rs, ag, ar)
            timed.append((name, p, cfg, x, rs))
        for fused, twin in FUSED_TWIN.items():
            if fused in outs:
                for a, b, what in zip(outs[fused], outs[twin],
                                      ("rs", "ag", "ar")):
                    same_bits([a], [b], f"{fused} vs {twin} {what} p{p}")
        for name in names:
            if not name.startswith("auto"):
                continue
            cfg = api.CollectiveConfig(**API_BACKENDS[name])
            picks = []
            for i, (coll, inp, kw) in enumerate(
                    (("reduce_scatter", x, {}), ("allgather", outs[name][0],
                                                 {"gathered": True}),
                     ("allreduce", x, {}))):
                b = api._resolve(cfg, coll, inp, **kw).backend
                twin = {"pallas_fused": "pallas_fused/bine"}.get(b, b)
                same_bits([outs[name][i]], [outs[twin][i]],
                          f"{name} {coll} p{p} vs its resolution {b}")
                picks.append(f"{coll}->{b}")
            log(f"  p={p} {name}: {', '.join(picks)} (bitwise)")
        log(f"  p={p}, {per_rank * 4 // MiB} MiB per rank: reduce_scatter / "
            f"allgather / allreduce of {len(names)} backends hold their "
            f"definitions; fused == stacked bitwise")
        del outs, ref_sum
        if p == 8:
            phase_api_rooted(x)
        del x
        torch.cuda.empty_cache()

    mm = phase_api_matmul(dev)
    launches = dict(KB.LAUNCHES)
    for k in ("ring_update", "matmul_pack", "gather_matmul", "rs_step",
              "ag_step", "matmul_pack_wgmma", "gather_matmul_wgmma"):
        check(launches[k] > 0, f"the API run did not launch {k}")
    # bf16 calls ran on the tensor cores, float32 ones on the CUDA cores:
    # two of each direction (bine, ring)
    for k in ("matmul_pack", "gather_matmul"):
        check(launches[k + "_wgmma"] == 2 and launches[k] == 4,
              f"the API's matmul collectives launched {k} "
              f"{launches[k]} times, {launches[k + '_wgmma']} on wgmma "
              f"(expected 4, 2)")
    for (name, p), (a, b, c) in sorted(per_call.items()):
        log(f"  launches per call, {name} p={p}: reduce_scatter {a}, "
            f"allgather {b}, allreduce {c}")

    # timing pass (launch counts above are the correctness pass's)
    for name, p, cfg, x, rs in timed:
        t_rs = time_ms(lambda: api.reduce_scatter(x, cfg), reps=5)
        t_ag = time_ms(lambda: api.allgather(rs, cfg), reps=5)
        t_ar = time_ms(lambda: api.allreduce(x, cfg), reps=5)
        log(f"  time {name} p={p}: reduce_scatter {ms(t_rs)} ms, allgather "
            f"{ms(t_ag)} ms, allreduce {ms(t_ar)} ms")
    del timed
    for tag, fn in mm:
        log(f"  time {tag}: {ms(time_ms(fn, reps=5))} ms")
    torch.cuda.empty_cache()
    return launches


def phase_api_rooted(x):
    """broadcast / reduce / gather / scatter (root 1) and all_to_all at p=8
    under bine, recdoub (binomial trees) and xla: moves exact, sums within
    1e-4 of a float64 sum."""
    import torch
    from repro_torch.collectives import api

    p, root = x.shape[0], 1
    blk = x[:, : x.shape[1] // p].contiguous()
    a2a = x.view(p, p, -1)
    ref_sum = x.double().sum(0)
    for name in ("bine", "recdoub", "xla"):
        cfg = api.CollectiveConfig(backend=name)
        bc = api.broadcast(x, root, cfg)
        check(torch.equal(bc, x[root].expand_as(x)), f"{name} broadcast")
        red = api.reduce(x, root, cfg)
        err = float((red[root].double() - ref_sum).abs().max())
        check(err < 1e-4, f"{name} reduce off by {err}")
        g = api.gather(blk, root, cfg)
        check(torch.equal(g[root], blk.reshape(-1)), f"{name} gather")
        sc = api.scatter(x, root, cfg)
        check(torch.equal(sc, x[root].view(p, -1)), f"{name} scatter")
        at = api.all_to_all(a2a, cfg)
        check(torch.equal(at, a2a.transpose(0, 1)), f"{name} all_to_all")
        del bc, red, g, sc, at
    log(f"  p=8 rooted (root {root}) and all_to_all under bine, recdoub, "
        f"xla: moves exact, reduce within 1e-4 of the float64 sum")


def phase_api_matmul(dev):
    """matmul_reduce_scatter / allgather_matmul (bine, ring) at the TP
    shapes, float32 and bf16, against torch.matmul followed by the stacked
    RS / AG, both held against float64.  float32: within (k + p) 2**-24
    max(sum_r |x_r| @ |w_r|) (each float32 sum of k products, then p rank
    adds).  bf16 (the tensor-core perm_matmul), elementwise: each bf16
    rounding errs by at most u = 2**-8 of what it rounds, and what it
    rounds (a rank's product, or a partial sum of them) is at most
    T = sum_r |x_r @ w_r| (float64), so with steps = the rank adds that
    round to bf16 (log2 p for bine, p - 1 for the ring) and
    gam = (1 + steps) u / (1 - (1 + steps) u) the bound is
    (1 + gam) (k + p) 2**-24 S + gam T, S = sum_r |x_r| @ |w_r|; the
    allgather's one rounding of its product y, (1 + u) k 2**-24 S + u |y|.
    Returns the calls to time."""
    import torch
    from repro_torch.collectives import stacked
    from repro_torch.kernels.collectives import ops

    gen = torch.Generator(device=dev).manual_seed(7)
    timed = []
    p, m, k, n = MM_RS
    x32 = torch.randn((p, m, k), generator=gen, device=dev)
    w32 = torch.randn((p, k, n), generator=gen, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        x, w = x32.to(dt), w32.to(dt)
        tag = str(dt)[6:]
        y64 = torch.matmul(x.double(), w.double())              # [p, m, n]
        T = y64.abs().sum(0)
        y64 = y64.sum(0)
        S = torch.matmul(x.float().abs(), w.float().abs()).sum(0)
        for algo in ("bine", "ring"):
            if dt == torch.float32:
                lim = torch.full_like(S, (k + p) * 2.0 ** -24 * float(S.max()))
            else:
                steps = (p - 1) if algo == "ring" else int(math.log2(p))
                gam = (1 + steps) * BF16_U / (1 - (1 + steps) * BF16_U)
                lim = ((1 + gam) * (k + p) * 2.0 ** -24 * S.double()
                       + gam * T)
            lim = lim.view(p, m // p, n)
            got = ops.matmul_reduce_scatter(x, w, algo)
            plain = stacked.reduce_scatter(torch.matmul(x, w).reshape(p, -1),
                                           algo).reshape(p, m // p, n)
            exp = y64.view(p, m // p, n)
            e_f = within(got, exp, lim, f"matmul_reduce_scatter {algo} {tag}")
            e_p = within(plain, exp, lim, f"matmul + reduce_scatter {algo} "
                         f"{tag}")
            log(f"  matmul_reduce_scatter {algo} {tag} {tuple(x.shape)} @ "
                f"{tuple(w.shape)}: vs float64 fused {e_f:.3e}, matmul+RS "
                f"{e_p:.3e} (bound max {float(lim.max()):.3e})")
            timed += [(f"matmul_reduce_scatter {algo} {tag} (fused)",
                       lambda a=algo, x=x, w=w: ops.matmul_reduce_scatter(
                           x, w, a)),
                      (f"matmul + reduce_scatter {algo} {tag} (plain)",
                       lambda a=algo, x=x, w=w: stacked.reduce_scatter(
                           torch.matmul(x, w).reshape(p, -1), a))]
            del got, plain, lim
        del y64, S, T
    del x32, w32
    p, m, k, n = MM_AG
    xb32 = torch.randn((p, m // p, k), generator=gen, device=dev)
    w32 = torch.randn((p, k, n), generator=gen, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        xb, w2 = xb32.to(dt), w32.to(dt)
        tag = str(dt)[6:]
        xg = xb.reshape(1, m, k).expand(p, m, k)
        y64 = torch.matmul(xg.double(), w2.double())
        S = torch.matmul(xg.float().abs(), w2.float().abs())
        if dt == torch.float32:
            lim = torch.full_like(S, k * 2.0 ** -24 * float(S.max()))
        else:
            lim = ((1 + BF16_U) * k * 2.0 ** -24 * S.double()
                   + BF16_U * y64.abs())
        for algo in ("bine", "ring"):
            got = ops.allgather_matmul(xb, w2, algo)
            plain = torch.matmul(stacked.allgather(xb.reshape(p, -1), algo)
                                 .view(p, m, k), w2)
            e_f = within(got, y64, lim, f"allgather_matmul {algo} {tag}")
            e_p = within(plain, y64, lim, f"allgather + matmul {algo} {tag}")
            log(f"  allgather_matmul {algo} {tag} {tuple(xb.shape)} -> {m} "
                f"rows @ {tuple(w2.shape)}: vs float64 fused {e_f:.3e}, "
                f"AG+matmul {e_p:.3e} (bound max {float(lim.max()):.3e})")
            timed += [(f"allgather_matmul {algo} {tag} (fused)",
                       lambda a=algo, xb=xb, w2=w2: ops.allgather_matmul(
                           xb, w2, a)),
                      (f"allgather + matmul {algo} {tag} (plain)",
                       lambda a=algo, xb=xb, w2=w2: torch.matmul(
                           stacked.allgather(xb.reshape(p, -1), a)
                           .view(p, m, k), w2))]
            del got, plain
        del y64, S, lim
    return timed


# ---------------------------------------------------------------------------
# Phase 5: the two-tier half of the paper (bine_hier)
# ---------------------------------------------------------------------------

#: float32 unit roundoff
F32_U = 2.0 ** -24


def gamma(k: int) -> float:
    """Higham's gamma_k = k u / (1 - k u): a float32 sum whose every
    element takes k rounded adds lies within gamma_k * sum |x_r| of the
    exact sum."""
    return k * F32_U / (1 - k * F32_U)


def phase_two_tier(dev):
    """(a) one-axis bine_hier at p = 8 (tiers (4, 2) from tpu_multipod) and
    (b) two-axis bine_hier, (pods, data) = (2, 4), on 64 MiB f32 a rank:
    reduce_scatter / allgather / allreduce held to a float64 sum within
    gamma_3 sum_r |x_r| (each element takes log2 8 = 3 adds; the
    two-axis reduce-scatter's rank (o, i) holds block i * 2 + o), the
    allgather exact, and on a 1 MiB slice the card's bits equal the
    CPU's; each call's time beside flat bine's.  (c) the train cell over
    two DP axes.  Returns (launch counts of the two-axis train path,
    numbers)."""
    import torch
    from repro_torch.collectives import api
    from repro_torch.core import schedules as sc
    from repro_torch.core import traffic
    from repro_torch.topology import tier_split

    p = 8
    n = 64 * MiB // 4
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((p, n), generator=gen, device=dev)
    ref = x.double().sum(0)
    lim = gamma(3) * x.double().abs().sum(0)
    small = x[:, : MiB // 4].contiguous()
    small_cpu = small.cpu()
    tiers = tier_split("tpu_multipod", p)
    check(tiers == (4, 2), f"tpu_multipod tiers at p=8: {tiers}")
    # the traffic model's bytes crossing groups of 4 ranks (a host of
    # tpu_multipod), per collective of the 64 MiB vector: the host computes
    # them from the schedules, the card plays no part
    groups = traffic.GroupedTopo("groups of 4", group_size=4)
    for coll in ("reduce_scatter", "allgather", "allreduce"):
        model = {a: traffic.global_bytes(sc.get_schedule(coll, a, p), p,
                                         4.0 * n, groups) / MiB
                 for a in ("bine", "recdoub")}
        model["bine_hier"] = traffic.compose_global_bytes(
            coll, tiers, 4.0 * n, 4) / MiB
        log(f"  traffic model, {coll} of 64 MiB at p={p}, groups of 4: "
            f"MiB crossing groups {model}")
    flat = api.CollectiveConfig(backend="bine")
    nums = {}
    for tag, cfg, outer, inner in (
            ("one-axis tiers (4, 2)",
             api.CollectiveConfig(backend="bine_hier"), 1, p),
            ("two-axis (pods, data) = (2, 4)",
             api.CollectiveConfig(backend="bine_hier", dp_shape=(2, 4)),
             2, 4)):
        rs = api.reduce_scatter(x, cfg)
        # rank (o, i) holds block i * outer + o (one axis: block r)
        own = torch.tensor([(r % inner) * outer + r // inner
                            for r in range(p)], device=dev)
        blocks = ref.view(p, -1)[own]
        e_rs = within(rs, blocks, lim.view(p, -1)[own],
                      f"bine_hier {tag} reduce_scatter")
        ag = api.allgather(rs, cfg)
        check(torch.equal(ag[0], rs[torch.argsort(own)].reshape(-1)) and
              all(torch.equal(ag[0], ag[r]) for r in range(p)),
              f"bine_hier {tag} allgather is not every block in place")
        ar = api.allreduce(x, cfg)
        e_ar = within(ar, ref.expand(p, -1), lim.expand(p, -1),
                      f"bine_hier {tag} allreduce")
        check(all(torch.equal(ar[0], ar[r]) for r in range(p)),
              f"bine_hier {tag} allreduce differs between ranks")
        del ag, ar
        s_rs = api.reduce_scatter(small, cfg)
        same_bits([s_rs.cpu(), api.allgather(s_rs, cfg).cpu(),
                   api.allreduce(small, cfg).cpu()],
                  [api.reduce_scatter(small_cpu, cfg),
                   api.allgather(s_rs.cpu(), cfg),
                   api.allreduce(small_cpu, cfg)],
                  f"bine_hier {tag} 1 MiB slice, card vs CPU")
        log(f"  bine_hier {tag}, p={p}, 64 MiB a rank: reduce_scatter and "
            f"allreduce vs float64 {e_rs:.2e} / {e_ar:.2e} (bound max "
            f"{float(lim.max()):.2e}), allgather exact; 1 MiB slice "
            f"bitwise equal card vs CPU")
        times = {}
        for name, c in (("bine_hier", cfg), ("bine", flat)):
            times[name] = (time_ms(lambda: api.reduce_scatter(x, c), reps=5),
                           time_ms(lambda: api.allgather(rs, c), reps=5),
                           time_ms(lambda: api.allreduce(x, c), reps=5))
            log(f"  time {name} ({tag}) p={p}: reduce_scatter "
                f"{ms(times[name][0])} ms, allgather {ms(times[name][1])} ms,"
                f" allreduce {ms(times[name][2])} ms")
        nums[tag] = times
        del rs, s_rs
        torch.cuda.empty_cache()
    del x, ref, lim, small
    torch.cuda.empty_cache()
    launches, train = phase_two_tier_train(dev)
    nums.update(train)
    return launches, nums


def train_runs(dev, cfg=None):
    """A runner of the train cell's steps (``cfg``: the cell's model
    unless given): ``run(tcfg, dp, steps, tag,
    tp=1, digest=False)`` -> (launch counts read around the steps, losses,
    step seconds, peak GiB, params after step 1 on rank 0);
    ``run.gnorms[tag]`` keeps the grad norms, ``run.aux[tag]`` the
    weighted aux losses, and with ``digest``
    ``run.digests[tag]`` the sha256 of every rank's params after the last
    step."""
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels import build as KB
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import make_batch
    from repro_torch.train.step import make_init_fns, make_train_step

    cfg = cell.model_config() if cfg is None else cfg
    shapes = TF.param_shapes(cfg)
    dcfg = cell.data_config(cfg)

    def run(tcfg, dp, steps, tag, tp=1, digest=False):
        step, info, _ = make_train_step(cfg, tcfg, dp, shapes, dev, tp=tp)
        init_p, init_s = make_init_fns(cfg, tcfg, dp, dev, tp=tp)
        params = init_p(0)
        state = init_s(params)
        torch.cuda.synchronize()
        KB.reset_launches()
        losses, times, peaks, first = [], [], [], None
        for s in range(steps):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, m = step(params, state, make_batch(dcfg, s))
            loss = float(m["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            losses.append(loss)
            run.gnorms.setdefault(tag, []).append(float(m["grad_norm"]))
            run.aux.setdefault(tag, []).append(float(m["aux_loss"]))
            check(math.isfinite(loss), f"{tag} step {s}: loss {loss}")
            if s == 0:
                first = [x.clone() for x in T.flatten(params[0])]
            log(f"  {tag} step {s}: loss {loss:.6f} gnorm "
                f"{float(m['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms, "
                f"peak {peaks[-1]:.1f} GiB")
        counts = {k: v for k, v in KB.LAUNCHES.items() if v}
        plan = info["bucket_plan"]
        where = ("per-leaf" if plan is None
                 else f"{len(plan.buckets)} buckets")
        log(f"  {tag}: {where}, launches {counts}, peak {max(peaks):.1f} "
            f"GiB")
        if digest:
            run.digests[tag] = params_sha256(params)
        del params, state
        torch.cuda.empty_cache()
        return dict(KB.LAUNCHES), losses, times, max(peaks), first

    run.gnorms = {}     # each tag's grad norms, step by step
    run.aux = {}        # each tag's weighted aux losses, step by step
    run.digests = {}    # each digested tag's params sha256
    return cfg, dcfg, run


def phase_two_tier_train(dev):
    """The train cell (``launch/cell.py``) over two DP axes, ("pod",
    "data") = ``cell.HIER_DP``: bine_hier bucketed and per-leaf (1 step
    each, bitwise equal), pallas_fused float32 (3 steps; after step 1
    bitwise equal to two-axis bine) and int8 (2 steps), which must launch
    rs_step, ag_step and rs_step_q.  Every step-1 loss equals the flat
    p=4 pallas_fused step-1 loss bitwise; later losses lie within 1e-3 of
    the flat run's at the same step (same params, same batches)."""
    import torch
    from repro_torch.launch import cell

    cfg, dcfg, run = train_runs(dev)
    tokens = dcfg.global_batch * dcfg.seq_len
    flat = {}
    for wire, steps in (("float32", 3), ("int8", 2)):
        flat[wire] = run(cell.train_config("pallas_fused", wire), cell.N_DP,
                         steps, f"flat pallas_fused/{wire}")[1]
    loss0 = flat["float32"][0]

    def flat_eq(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    def losses_ok(tag, losses, wire):
        check(losses[0] == loss0, f"{tag}: step-1 loss {losses[0]!r} is not "
              f"the flat pallas_fused step-1 loss {loss0!r}")
        for s, (a, b) in enumerate(zip(losses[1:], flat[wire][1:]), 1):
            check(abs(a - b) <= 1e-3, f"{tag} step {s}: loss {a} vs flat {b}")

    hier = cell.hier_train_config
    dp = cell.HIER_DP
    _, lb, tb, pb, bucketed = run(hier("bine_hier", "float32"), dp, 1,
                                  "two-axis bine_hier/float32 bucketed")
    losses_ok("bine_hier bucketed", lb, "float32")
    _, ll, tl, pl, per_leaf = run(
        hier("bine_hier", "float32").replace(bucket_bytes=0), dp, 1,
        "two-axis bine_hier/float32 per-leaf")
    losses_ok("bine_hier per-leaf", ll, "float32")
    check(flat_eq(bucketed, per_leaf),
          "bucketed and per-leaf bine_hier params differ after one step")
    log("  bine_hier bucketed == per-leaf after one float32 step, bitwise")
    del bucketed, per_leaf
    c32, l32, t32, p32, fused_first = run(
        hier("pallas_fused", "float32"), dp, 3,
        "two-axis pallas_fused/float32")
    losses_ok("pallas_fused float32", l32, "float32")
    _, lbn, _, _, bine_first = run(hier("bine", "float32"), dp, 1,
                                   "two-axis bine/float32")
    losses_ok("bine float32", lbn, "float32")
    check(flat_eq(fused_first, bine_first),
          "two-axis pallas_fused and bine params differ after one step")
    log("  two-axis pallas_fused == bine after one float32 step, bitwise")
    del fused_first, bine_first
    c8, l8, t8, p8, _ = run(hier("pallas_fused", "int8"), dp, 2,
                            "two-axis pallas_fused/int8")
    losses_ok("pallas_fused int8", l8, "int8")
    launches = {k: c32[k] + c8[k] for k in ("rs_step", "ag_step",
                                             "rs_step_q")}
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the two-axis path")
    check(c8["rs_step_q"] > 0, "the two-axis int8 steps did not run "
          "rs_step_q")
    warm = statistics.median(t32[1:])
    nums = {"hier_bucketed_step_ms": tb[0] * 1e3,
            "hier_per_leaf_step_ms": tl[0] * 1e3,
            "two_axis_f32_step_ms": warm * 1e3,
            "two_axis_f32_tokens_per_s": tokens / warm,
            "two_axis_int8_step_ms": t8[1] * 1e3,
            "two_axis_int8_tokens_per_s": tokens / t8[1],
            "peak_gib": {"bine_hier_bucketed": pb, "bine_hier_per_leaf": pl,
                         "pallas_fused_f32": p32, "pallas_fused_int8": p8}}
    log(f"  two-axis pallas_fused warm step: float32 {warm * 1e3:.1f} ms "
        f"({tokens / warm:.0f} tokens/s, peak {p32:.1f} GiB), int8 "
        f"{t8[1] * 1e3:.1f} ms ({tokens / t8[1]:.0f} tokens/s, peak "
        f"{p8:.1f} GiB); bine_hier step (cold) bucketed {tb[0] * 1e3:.1f} "
        f"ms, per-leaf {tl[0] * 1e3:.1f} ms; launches {launches}")
    return launches, nums


# ---------------------------------------------------------------------------
# Phase 6: the train step
# ---------------------------------------------------------------------------

def phase_small_reference(dev):
    """Reduced phi4-mini, float32, p=4, 2 steps: the card (fused kernels)
    against the CPU (plain versions).  Tolerance: loss and grad-norm rtol
    1e-4, params 1e-3 absolute — the model's float32 sums round in another
    order on the two devices (tests/test_torch_train_step.py states why)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import base
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)

    cfg = base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32")
    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    out = {}
    p = cell.N_DP
    for where in ("cpu", dev):
        step, _, _ = make_train_step(cfg, tcfg, p, TF.param_shapes(cfg), where)
        init = TF.init_params(cfg, 0, "cpu")
        params = [T.tree_map(lambda x: x.to(where), init) for _ in range(p)]
        state = init_train_state(cfg, tcfg, params, p)
        ms = []
        for s in range(2):
            params, state, m = step(params, state, make_batch(dcfg, s))
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        out[str(where)] = (ms, [x.cpu() for x in T.flatten(params[0])])
    (mc, pc), (mg, pg) = out["cpu"], out[str(dev)]
    for (lc, gc), (lg, gg) in zip(mc, mg):
        check(math.isclose(lc, lg, rel_tol=1e-4)
              and math.isclose(gc, gg, rel_tol=1e-4),
              f"small reference: card {mg} vs cpu {mc}")
    perr = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    check(perr <= 1e-3, f"small reference: params differ by {perr}")
    log(f"  small reference (reduced, f32): card losses "
        f"{[round(l, 6) for l, _ in mg]} vs cpu {[round(l, 6) for l, _ in mc]}"
        f", params max |diff| {perr:.2e}")


def phase_train(dev):
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels import build as KB
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import make_batch
    from repro_torch.train.step import make_init_fns, make_train_step

    cfg = cell.model_config()
    shapes = TF.param_shapes(cfg)
    dcfg = cell.data_config(cfg)
    P, B, S = cell.N_DP, dcfg.global_batch, dcfg.seq_len
    log(f"  {cfg.name} cut to {cfg.n_layers} layers: "
        f"{TF.param_count(shapes):,} params, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; dp={P}, batch {B}x{S}")

    def flat_eq(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    digests = {}     # wire -> params sha256 after the pallas_fused run

    def run(backend, wire, steps, snapshot=False, topology="tpu_multipod",
            **overrides):
        tcfg = cell.train_config(backend, wire, topology).replace(
            **overrides)
        step, info, _ = make_train_step(cfg, tcfg, P, shapes, dev)
        init_p, init_s = make_init_fns(cfg, tcfg, P, dev)
        params = init_p(0)
        state = init_s(params)
        plan = info["bucket_plan"]
        torch.cuda.synchronize()
        KB.reset_launches()
        first, times, losses, peaks = None, [], [], []
        for s in range(steps):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, m = step(params, state, make_batch(dcfg, s))
            loss = float(m["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            losses.append(loss)
            check(math.isfinite(loss), f"{backend}/{wire} step {s}: loss {loss}")
            flats = [T.flatten(pr) for pr in params]
            check(all(flat_eq(flats[0], flats[r]) for r in range(1, P)),
                  f"{backend}/{wire} step {s}: ranks' params differ")
            if snapshot and s == 0:
                first = [x.clone() for x in flats[0]]
            del flats
            log(f"  {backend}/{wire} step {s}: loss {loss:.6f} gnorm "
                f"{float(m['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms, "
                f"peak {peaks[-1]:.1f} GiB")
        counts = dict(KB.LAUNCHES)
        log(f"  {backend}/{wire} ({topology}): {len(plan.buckets)} buckets "
            f"(capacity {plan.capacity_bytes} B), launches {counts}, "
            f"peak memory {max(peaks):.1f} GiB")
        if backend == "auto" or wire == "auto":
            log(f"  {backend}/{wire} ({topology}) per-bucket (rs backend, "
                f"rs wire, ag backend, ag wire): {info['decisions']}")
        if backend == "pallas_fused":
            # every rank's params are checked equal above: rank 0's hash
            digests[wire] = params_sha256(params[:1])
        del params, state
        torch.cuda.empty_cache()
        return counts, losses, times, first, info

    c32, losses, times, first, _ = run("pallas_fused", "float32", 3,
                                        snapshot=True)
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {losses[0]} is not near ln(V) for random weights")
    steady = statistics.median(times[1:])
    log(f"  pallas_fused/float32 steady step {steady * 1e3:.1f} ms, "
        f"{B * S / steady:.0f} tokens/s")
    c8, losses8, t8, _, _ = run("pallas_fused", "int8", 2)
    log(f"  pallas_fused/int8 warm step {t8[1] * 1e3:.1f} ms, "
        f"{B * S / t8[1]:.0f} tokens/s")
    launches = {k: c32[k] + c8[k] for k in ("rs_step", "ag_step",
                                             "rs_step_q")}
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    check(c8["rs_step_q"] > 0, "the int8 steps did not run rs_step_q")
    cb, _, _, bine_first, _ = run("bine", "float32", 1, snapshot=True)
    check(sum(cb.values()) == 0, f"the bine path launched kernels: {cb}")
    check(flat_eq(first, bine_first),
          "bine and pallas_fused params differ after one float32 step")
    log("  bine float32 step == pallas_fused float32 step, bitwise")
    del bine_first
    # auto on the torus preset: every bucket, allgather and the small
    # allreduce resolve to recdoub at p=4
    _, _, _, auto_first, info = run("auto", "float32", 1, snapshot=True,
                                    topology="torus")
    check(all(d == ("recdoub", "float32", "recdoub", "float32")
              for d in info["decisions"]),
          f"auto on torus resolved to {info['decisions']}")
    _, _, _, rd_first, _ = run("recdoub", "float32", 1, snapshot=True,
                               topology="torus")
    check(flat_eq(auto_first, rd_first),
          "auto (torus) and recdoub (torus) params differ after one step")
    log("  auto float32 step (torus) == recdoub float32 step (torus), "
        "bitwise")
    del auto_first, rd_first
    # wire_dtype="auto" on tpu_multipod: where every bucket resolved to one
    # (backend, wire), the explicit step with that pair gives the same
    # bits.  "auto" plans its buckets at float32 width, so the explicit
    # step gets the capacity that gives its wire the same plan.
    _, _, _, wa_first, info = run("auto", "auto", 1, snapshot=True)
    dec, plan = info["decisions"], info["bucket_plan"]
    pairs = {(d[0], d[1]) for d in dec}
    if len(pairs) == 1:
        from repro_torch.collectives.compression import WIRE_BYTES_PER_ELEM
        b, w = pairs.pop()
        cap = int(plan.capacity_bytes / 4 * WIRE_BYTES_PER_ELEM[w])
        _, _, _, ref_first, ref_info = run(b, w, 1, snapshot=True,
                                           bucket_bytes=cap)
        check(ref_info["decisions"] == dec and
              [bk.slots for bk in ref_info["bucket_plan"].buckets] ==
              [bk.slots for bk in plan.buckets],
              f"the explicit {b}/{w} step plans or decides otherwise")
        check(flat_eq(wa_first, ref_first),
              f"wire_dtype=auto and the explicit {b}/{w} step differ")
        log(f"  auto/auto step (tpu_multipod) == {b}/{w} step at the same "
            f"bucket plan, bitwise")
        del ref_first
    del wa_first
    # steps after the first of each run: warm, so the wires compare
    return launches, {"f32_step_ms": steady * 1e3,
                      "tokens_per_s": B * S / steady,
                      "int8_step_ms": t8[1] * 1e3,
                      "f32_losses_hex": [x.hex() for x in losses],
                      "int8_losses_hex": [x.hex() for x in losses8],
                      "f32_params_sha256": digests["float32"],
                      "int8_params_sha256": digests["int8"]}


# ---------------------------------------------------------------------------
# Phase 7: serving
# ---------------------------------------------------------------------------

def phase_serve_small_reference(dev):
    """Reduced phi4-mini, float32 with a float32 cache, the same weights on
    the card (kernels) and on the CPU (plain versions): one padded prefill
    and two decode steps within rtol 1e-4, atol 1e-5 (the bound
    tests/test_torch_serve.py holds the port to JAX with: float32 sums in
    other orders), and every request's greedy stream through the scheduler
    equal."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import base
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                             poisson_trace)

    cfg = base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32", cache_dtype="float32")
    init = TF.init_params(cfg, 0, "cpu")
    S, n_new = 64, 6
    tok = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, S)), dtype=torch.int32)
    out, streams = {}, {}
    for where in ("cpu", dev):
        params = T.tree_map(lambda x: x.to(where), init)
        logits = []
        lg, st = TF.prefill(params, cfg, tok.to(where), length=37)
        logits.append(lg.cpu())
        for t in range(2):
            lg, st = TF.decode_step(params, cfg, st, tok[:, t:t + 1].to(where))
            logits.append(lg.cpu())
        out[str(where)] = logits
        fns = E.make_serve_fns(cfg, E.ServeConfig(), 3, S, where)
        reqs = poisson_trace(6, 0.8, (5, 40), n_new, cfg.vocab_size, seed=5)
        sched = ContinuousBatchingScheduler(cfg, fns, params, 3, S, seed=11)
        for r in reqs:
            sched.submit(r)
        sched.run()
        streams[str(where)] = [r.generated for r in reqs]
    err = 0.0
    for a, b in zip(out["cpu"], out[str(dev)]):
        check(bool(torch.isclose(b, a, rtol=1e-4, atol=1e-5).all()),
              f"serve small reference: logits differ by "
              f"{float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()))
    check(streams["cpu"] == streams[str(dev)],
          f"serve small reference: card streams {streams[str(dev)]} vs cpu "
          f"{streams['cpu']}")
    log(f"  small reference (reduced, f32): prefill + 2 decode logits max "
        f"|diff| {err:.2e}; 6 greedy streams through 3 pages equal "
        f"(card vs cpu)")


def serve_run(cfg, params, dev, reqs, slots: int, S: int, seed: int,
              dp=1, tp: int = 1) -> dict:
    """Serve ``reqs`` through ``slots`` pages of ``S`` tokens at (dp, tp)
    on the card, each insert and decode step timed (synced) and its
    logits checked finite, the launch counts set to 0 just before the
    scheduler runs and read just after.  Returns the stats, the wall s,
    the times, the counts, whether every logit was finite and the first
    insert's logits (float32 ``[V]``, on the host)."""
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.serve import engine as E
    from repro_torch.serve.sampling import gather_vocab
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    finite = []
    times = {"insert": [], "decode_slots": []}
    first = []

    def timed(name, fn):
        def wrapped(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, pool = fn(*args)
            finite.append(torch.isfinite(logits).all())
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            if name == "insert" and not first:
                first.append(gather_vocab(logits, cfg.vocab_size)[0]
                             .float().cpu())
            return logits, pool
        return wrapped

    fns = E.make_serve_fns(cfg, E.ServeConfig(), slots, S, dev, dp=dp, tp=tp)
    fns.insert = timed("insert", fns.insert)
    fns.decode_slots = timed("decode_slots", fns.decode_slots)
    sched = ContinuousBatchingScheduler(cfg, fns, params, slots, S, seed=seed)
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    KB.reset_launches()
    t0 = time.perf_counter()
    stats = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: KB.LAUNCHES[k] for k in ("rmsnorm", "flash_attention",
                                             "flash_attention_wgmma")}
    return {"stats": stats, "wall": wall, "times": times,
            "launches": launches, "finite": bool(torch.stack(finite).all()),
            "insert0": first[0]}


def serve_checks(cfg, run, reqs, max_new: int, what: str) -> dict:
    """The checks a serve run of the cell must pass: every request retires
    with its tokens, every logit is finite, the launch counts are
    2 L + 1 rmsnorm per insert and per decode step and L flash_attention
    per insert, every one on the wgmma kernel.  Returns the numbers."""
    import torch
    from repro_torch.serve.scheduler import wall_ttft_ms

    stats, wall = run["stats"], run["wall"]
    check(all(r.finished and len(r.generated) == max_new for r in reqs),
          f"{what}: not every request retired with its tokens")
    check(run["finite"], f"{what}: non-finite logits")
    L, n_ins, n_dec = cfg.n_layers, stats["inserts"], stats["decode_steps"]
    want = {"rmsnorm": (2 * L + 1) * (n_ins + n_dec),
            "flash_attention": L * n_ins, "flash_attention_wgmma": L * n_ins}
    check(run["launches"] == want, f"{what}: launch counts "
          f"{run['launches']}, expected {want} ({n_ins} inserts, {n_dec} "
          f"decode steps)")
    ttft = wall_ttft_ms(reqs)
    nums = {"prefill_ms_per_insert":
            statistics.median(run["times"]["insert"]) * 1e3,
            "decode_ms_per_step":
            statistics.median(run["times"]["decode_slots"]) * 1e3,
            "mean_occupancy": stats["mean_occupancy"],
            "tokens_per_s": stats["tokens_out"] / wall,
            "ttft_ms_p50": ttft["ttft_ms_p50"],
            "ttft_ms_p99": ttft["ttft_ms_p99"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "wall_s": wall}
    log(f"  {what}: served {len(reqs)} requests: {stats['tokens_out']} "
        f"tokens, {n_ins} inserts, {n_dec} decode steps (occupancy mean "
        f"{stats['mean_occupancy']:.2f}, peak {stats['peak_occupancy']}), "
        f"all logits finite; launches {run['launches']} == {2 * L + 1} x "
        f"(inserts + steps) and {L} x inserts, every flash launch on wgmma")
    log(f"  {what}: prefill {nums['prefill_ms_per_insert']:.2f} ms per "
        f"insert (median of {n_ins}), decode {nums['decode_ms_per_step']:.2f}"
        f" ms per step (median of {n_dec}), {nums['tokens_per_s']:.1f} "
        f"tokens/s over {wall:.2f} s, ttft p50 {ttft['ttft_ms_p50']:.1f} ms "
        f"/ p99 {ttft['ttft_ms_p99']:.1f} ms, peak {nums['peak_gib']:.2f} "
        f"GiB")
    return nums


def phase_serve(dev):
    """The serve cell (repro_torch/launch/cell.py SERVE_CELL): phi4-mini at
    full width and depth, random weights from the port's init_params, an
    8-page pool of 1024 tokens, 16 greedy Poisson requests.  Checks every
    request retires with its 32 tokens, every logit is finite, the launch
    counts are 65 rmsnorm per insert and per decode step and 32 flash
    attention per insert, and request 0 served alone in a 1-page pool gets
    the same first token; reports how many of its later tokens agree, and
    which of one decode step's ops give a row alone other bits than the
    same row in a batch of 8.  Returns the launch counts, the numbers and
    what phase 10 compares with: request 0's insert logits and every
    request's tokens."""
    import torch
    from repro_torch.kernels.rmsnorm import ops as RO
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import Request, poisson_trace

    c = cell.SERVE_CELL
    cfg = cell.serve_model_config()
    S = E.page_len(cfg, c.prompt_len_max, c.max_new)
    torch.cuda.reset_peak_memory_stats()
    params = TF.init_params(cfg, c.seed, dev)
    log(f"  {cfg.name}: {cfg.n_layers} layers, {TF.param_count(params):,} "
        f"params ({cfg.dtype}), {c.slots} pages x {S} tokens "
        f"({cfg.cache_dtype} cache), {c.requests} requests at "
        f"{c.rate}/step, prompts {c.prompt_len_min}-{c.prompt_len_max}, "
        f"{c.max_new} new tokens each")
    trace = poisson_trace(c.requests, c.rate,
                          (c.prompt_len_min, c.prompt_len_max), c.max_new,
                          cfg.vocab_size, seed=c.seed,
                          temperature=c.temperature)
    run = serve_run(cfg, params, dev, trace, c.slots, S, c.seed)
    launches = run["launches"]
    nums = serve_checks(cfg, run, trace, c.max_new, "one card")
    ref = {"insert0": run["insert0"],
           "tokens": [list(r.generated) for r in trace]}
    # request 0 alone in a 1-page pool: its insert is the same B=1 work
    solo = Request(rid=0, prompt=trace[0].prompt, max_new_tokens=c.max_new)
    serve_run(cfg, params, dev, [solo], 1, S, c.seed)
    check(solo.generated[0] == trace[0].generated[0],
          f"request 0's first token alone {solo.generated[0]} vs pooled "
          f"{trace[0].generated[0]}")
    agree = sum(a == b for a, b in zip(solo.generated[1:],
                                       trace[0].generated[1:]))
    nums["solo_later_tokens_agree"] = agree / (c.max_new - 1)
    log(f"  request 0 alone in a 1-page pool: same first token; "
        f"{agree}/{c.max_new - 1} later tokens agree (decode at batch 1 vs "
        f"8 may take other cuBLAS kernels: reported, not gated)")
    # where batch 1 and batch 8 part: one decode step's ops on row 0 alone
    # against row 0 of a batch of 8 (bf16 rows [8, 1, d_model], layer 0's
    # weights): rmsnorm, every matmul of the layer and the head (cuBLAS),
    # and the attention scores over a 1024-slot page (float32 einsum)
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = getattr(torch, cfg.dtype)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device=dev).to(dt)
    seg = params["segments"][0]
    norm_same = torch.equal(RO.rmsnorm(x[:1], seg["ln1"][0]),
                            RO.rmsnorm(x, seg["ln1"][0])[:1])
    head = (params["embed"].t() if cfg.tie_embeddings
            else params["lm_head"])
    mats = {f"attn.{k}": seg["attn"][k][0] for k in ("wq", "wk", "wv", "wo")}
    mats.update({f"mlp.{k}": seg["mlp"][k][0] for k in ("wi", "wg", "wo")})
    mats["head"] = head
    differ = {}
    for name, w in mats.items():
        xi = torch.randn((8, 1, w.shape[0]), generator=gen,
                         device=dev).to(dt)
        differ[name] = int((torch.matmul(xi[:1], w)
                            != torch.matmul(xi, w)[:1]).sum())
    nkv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    qg = torch.randn((8, 1, nkv, g, hd), generator=gen, device=dev)
    ck = torch.randn((8, S, nkv, hd), generator=gen, device=dev)
    sc = "btkgh,bskh->bkgs"
    differ["attn scores"] = int((torch.einsum(sc, qg[:1], ck[:1])
                                 != torch.einsum(sc, qg, ck)[:1]).sum())
    nums["batch1_vs_8_rmsnorm_bitwise"] = norm_same
    nums["batch1_vs_8_outputs_differ"] = differ
    log(f"  row 0 alone vs in a batch of 8 ({cfg.dtype}, layer 0's "
        f"weights): rmsnorm bitwise {'equal' if norm_same else 'DIFFERENT'}"
        f"; outputs that differ: {differ}")
    del params, x, xi, seg, head, mats, qg, ck
    torch.cuda.empty_cache()
    return launches, nums, ref



# ---------------------------------------------------------------------------
# Phase 8: checkpoint, resume, measured tables, obs
# ---------------------------------------------------------------------------

def checkpoint_bytes(cfg) -> int:
    """Bytes of the train cell's global state: params in their dtype plus
    float32 master, m and v (and the int32 step)."""
    from repro_torch.models import transformer as TF
    n = TF.param_count(TF.param_shapes(cfg))
    itemsize = {"bfloat16": 2, "float32": 4}[cfg.dtype]
    return n * (itemsize + 3 * 4) + 4


def bucket_closed_forms(plan, decisions, topology: str):
    """``core.traffic``'s (global, local) bytes per (backend, topology) of
    a bucket plan's reduce-scatters and allgathers: the closed forms the
    obs summary must equal."""
    import torch
    from repro_torch.collectives.compression import wire_factor
    from repro_torch.core import traffic
    from repro_torch.core.schedules import get_schedule
    from repro_torch.topology import get_topology, schedule_algo
    p = plan.n_dp
    topo = get_topology(topology, p)
    want = {}
    for b, (rs_b, rs_w, ag_b, ag_w) in zip(plan.buckets, decisions):
        for coll, be, w, nbytes in (
                ("reduce_scatter", rs_b, rs_w,
                 b.nbytes(plan.wire_itemsize, p)),
                ("allgather", ag_b, ag_w,
                 b.nbytes(getattr(torch, b.dtype).itemsize, p))):
            sched = get_schedule(*schedule_algo(coll, be, nbytes), p)
            scale = 1.0 if w == "float32" else wire_factor(w)
            g = traffic.global_bytes(sched, p, float(nbytes), topo) * scale
            t = traffic.total_bytes(sched, p, float(nbytes)) * scale
            row = want.setdefault((be, topology),
                                  {"global": 0.0, "local": 0.0})
            row["global"] += g
            row["local"] += t - g
    return want


def phase_runtime(dev):
    """Phase 8 on the train cell (``launch/cell.py``, pallas_fused,
    float32 wire).  Returns (the step kernels' launches of its runs, the
    numbers it logs, its obs registry as a ``launch/report.py``
    artifact)."""
    import shutil
    import tempfile
    import torch
    from repro_torch import tree as T
    from repro_torch.collectives import api
    from repro_torch.kernels import build as KB
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.obs import collect, metrics, timeline
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import make_batch
    from repro_torch.train.runtime import (FailureInjector, TrainLoop,
                                           TrainLoopConfig, train_build)
    from repro_torch.train.step import (bucket_report, from_global,
                                        make_init_fns, make_train_step,
                                        to_global)

    cfg = cell.model_config()
    shapes = TF.param_shapes(cfg)
    dcfg = cell.data_config(cfg)
    tcfg = cell.train_config("pallas_fused", "float32")
    P = cell.N_DP
    out = {}

    # (a) obs: the build records its bucket plan; the summary's link bytes
    # are the closed forms of the plan's schedules
    metrics.set_enabled(True)
    reg = metrics.get_registry()
    reg.reset()
    step, info, _ = make_train_step(cfg, tcfg, P, shapes, dev)
    got = collect.global_local_summary(reg)
    want = bucket_closed_forms(info["bucket_plan"], info["decisions"],
                               tcfg.topology)
    check(sorted(got) == sorted(want) and all(
        math.isclose(got[k][g], want[k][g], rel_tol=1e-12, abs_tol=0.0)
        for k in want for g in ("global", "local")),
        f"obs link bytes {got} != core.traffic's {want}")
    log(f"  obs: {len(info['bucket_plan'].buckets)} buckets recorded at "
        f"build; link bytes (global, local) {got} == core.traffic's closed "
        f"forms (rel 1e-12)")

    # the API hook's cost: phase 4's calls at 64 MiB a rank, p = 4, with
    # the hook on and off in turns (one call's CUDA-event ms as phase 4
    # times it, and the host's us until the call returns), then the hook
    # alone (each median of 20)
    x = torch.randn((P, 64 * MiB // 4), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    hook = {}
    for name in ("xla", "pallas_fused", "bine"):
        c = api.CollectiveConfig(backend=name)
        rs = api.reduce_scatter(x, c)
        for coll, fn, inp, gathered in (
                ("reduce_scatter", lambda: api.reduce_scatter(x, c), x,
                 False),
                ("allgather", lambda: api.allgather(rs, c), rs, True),
                ("allreduce", lambda: api.allreduce(x, c), x, False)):
            fn()
            ts = {(on, k): [] for on in (True, False)
                  for k in ("ms", "host_us")}
            for i in range(40):
                on = i % 2 == 0
                metrics.set_enabled(on)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.record()
                fn()
                b.record()
                ts[on, "host_us"].append((time.perf_counter() - t0) * 1e6)
                b.synchronize()
                ts[on, "ms"].append(a.elapsed_time(b))
            metrics.set_enabled(True)
            alone = []
            for i in range(21):
                t0 = time.perf_counter()
                api._obs_record(coll, inp, c, gathered=gathered)
                alone.append((time.perf_counter() - t0) * 1e6)
            row = {f"{k}_{'on' if on else 'off'}": statistics.median(v)
                   for (on, k), v in ts.items()}
            row["hook_us"] = statistics.median(alone[1:])
            hook[f"{name}_{coll}"] = row
            log(f"  obs hook, {name} {coll} 64 MiB p={P}: ms on "
                f"{row['ms_on']:.4f} / off {row['ms_off']:.4f}, host us on "
                f"{row['host_us_on']:.1f} / off {row['host_us_off']:.1f}, "
                f"hook alone {row['hook_us']:.1f} us (medians of 20, on "
                f"and off in turns)")
        del rs
    del x
    out["obs_hook"] = hook

    need = checkpoint_bytes(cfg)
    tmp_root = ROOT / "build"
    tmp_root.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt_smoke_", dir=tmp_root))
    free = shutil.disk_usage(root).free
    log(f"  checkpoint {need / 1e9:.2f} GB a step; {free / 1e9:.1f} GB "
        f"free under {root}")
    # the loop keeps one step, so at most two are on disk (the new one
    # written beside the old before the old goes)
    check(free >= 2.2 * need, f"only {free / 1e9:.1f} GB free for "
          f"checkpoints of {need / 1e9:.2f} GB (need 2.2x)")
    torch.cuda.synchronize()
    KB.reset_launches()
    try:
        # (b) 1 step, async save, step 2 with the save in flight, step 3
        init_p, init_s = make_init_fns(cfg, tcfg, P, dev)
        params = init_p(0)
        state = init_s(params)
        losses, times = [], []
        cpr = ckpt.AsyncCheckpointer(str(root / "b"), keep=1)
        for s in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, make_batch(dcfg, s))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if s == 0:
                t0 = time.perf_counter()
                glob = to_global(cfg, tcfg, params, state, P)
                cpr.save(1, glob)
                del glob
                d2h = time.perf_counter() - t0
            if s == 1:
                cpr.wait()
                write = cpr.last_write_s
                params1 = [x.cpu() for x in T.flatten(params[0])]
        check(all(math.isfinite(v) for v in losses), f"losses {losses}")
        del params, state
        torch.cuda.empty_cache()
        log(f"  steps 1-3 losses {losses}; step 2 with the save in flight "
            f"{times[1] * 1e3:.1f} ms, step 3 without {times[2] * 1e3:.1f} "
            f"ms")
        log(f"  save: to_global + device->host {d2h:.2f} s "
            f"({need / d2h / 1e9:.2f} GB/s), write {write:.2f} s "
            f"({need / write / 1e9:.2f} GB/s)")
        # restore into a freshly built step and run step 2
        step2, _, _ = make_train_step(cfg, tcfg, P, shapes, dev)
        init_p, init_s = make_init_fns(cfg, tcfg, P, dev)
        params = init_p(1)
        state = init_s(params)
        like = to_global(cfg, tcfg, params, state, P, device="meta")
        del params, state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tree = ckpt.restore(str(root / "b"), 1, like, device="cpu")
        read = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, state = from_global(cfg, tcfg, tree, P, dev)
        torch.cuda.synchronize()
        h2d = time.perf_counter() - t0
        del tree
        check(all(x.device.type == dev.type
                  for x in T.flatten(state) + T.flatten(params)),
              "the restored state is not on the card")
        check(int(state["step"]) == 1, f"restored step {state['step']}")
        params, state, m = step2(params, state, make_batch(dcfg, 1))
        loss = float(m["loss"])
        check(loss == losses[1], f"resumed step 2 loss {loss!r} != "
              f"uninterrupted {losses[1]!r}")
        flats = [T.flatten(pr) for pr in params]
        check(all(torch.equal(a.cpu(), b)
                  for a, b in zip(flats[0], params1)) and
              all(torch.equal(flats[0][i], flats[r][i])
                  for r in range(1, P) for i in range(len(params1))),
              "resumed step 2 params differ from the uninterrupted run's")
        del params, state, flats, params1
        torch.cuda.empty_cache()
        shutil.rmtree(root / "b")
        log(f"  restore: read {read:.2f} s ({need / read / 1e9:.2f} GB/s), "
            f"host->device {h2d:.2f} s ({need / h2d / 1e9:.2f} GB/s); "
            f"resumed step 2 == uninterrupted step 2 (loss and params, "
            f"bitwise)")
        out.update(save_d2h_s=d2h, save_write_s=write, restore_read_s=read,
                   restore_h2d_s=h2d, ckpt_gb=need / 1e9,
                   step_with_save_ms=times[1] * 1e3,
                   step_without_ms=times[2] * 1e3)

        # (c) TrainLoop: a transient failure at step 3 resumes from step 2
        loop = TrainLoop(TrainLoopConfig(total_steps=3, ckpt_every=2, keep=1,
                                         ckpt_dir=str(root / "loop")),
                         train_build(cfg, tcfg, dcfg, P, dev),
                         FailureInjector({2: False}))
        t0 = time.perf_counter()
        res = loop.run(0)
        hist = [(h["step"], h["loss"]) for h in res["history"]]
        check(res["restarts"] == 1 and hist == list(enumerate(losses)),
              f"TrainLoop history {hist}, restarts {res['restarts']}; "
              f"uninterrupted {losses}")
        log(f"  TrainLoop, failure injected at step 3: restarts 1, losses "
            f"== the uninterrupted run's ({time.perf_counter() - t0:.1f} s)")
        del loop, res
        torch.cuda.empty_cache()
        shutil.rmtree(root / "loop")
        launches = {k: KB.LAUNCHES[k] for k in ("rs_step", "ag_step")}
        for k, v in launches.items():
            check(v > 0, f"{k} was not launched by the resumed runs")

        # (d) the train CLI on the card: save at 2 and 4, resume to 6
        env = dict(os.environ, PYTHONPATH=str(SRC))
        cli = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
               "--backend", "pallas_fused", "--ckpt-dir", str(root / "cli"),
               "--ckpt-every", "2", "--log-every", "1"]
        runs = []
        for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
            r = subprocess.run(cli + extra, capture_output=True, text=True,
                               env=env, timeout=300)
            check(r.returncode == 0, f"train CLI {extra}: {r.stderr[-2000:]}")
            runs.append(r.stdout)
        check("device=cuda" in runs[1] and
              "[train] resumed from step 4" in runs[1] and
              "step     5" in runs[1] and "step     3" not in runs[1],
              f"the CLI did not resume on the card:\n{runs[1]}")
        check(ckpt.all_steps(str(root / "cli"))[-1] == 6,
              "the CLI's final save is missing")
        log("  train CLI: --steps 4 saved steps 2, 4; --resume --steps 6 "
            "resumed from step 4 on the card: " +
            " | ".join(line for line in runs[1].splitlines()
                       if line.startswith("step")))

        # (e) a measured table steers auto: torus's analytic pick at p = 4
        # is recdoub (no kernel); measured cells name pallas_fused
        from repro_torch import topology as TP
        auto = cell.train_config("auto", "float32", "torus")
        _, ainfo, _ = make_train_step(cfg, auto, P, shapes, dev)
        check(all(d[0] == d[2] == "recdoub" for d in ainfo["decisions"]),
              f"torus analytic decisions {ainfo['decisions']}")
        plan, base = ainfo["bucket_plan"], TP.load_table("torus")
        cells = {}
        for b in plan.buckets:
            cells[("reduce_scatter", P, base.bucket_of(
                b.nbytes(plan.wire_itemsize, P)))] = "pallas_fused"
            cells[("allgather", P, base.bucket_of(
                b.nbytes(getattr(torch, b.dtype).itemsize, P)))] = \
                "pallas_fused"
        os.environ["REPRO_MEASURED_TABLE_DIR"] = str(root / "measured")
        TP.with_measured_cells(base, cells).save(
            TP.measured_table_path("torus"))
        TP.invalidate_tables()
        measured = auto.replace(tuning="measured")
        steered = {}
        for tag, t in (("analytic", auto), ("measured", measured)):
            st, inf, _ = make_train_step(cfg, t, P, shapes, dev)
            init_p, init_s = make_init_fns(cfg, t, P, dev)
            params = init_p(0)
            state = init_s(params)
            torch.cuda.synchronize()
            before = dict(KB.LAUNCHES)
            params, state, m = st(params, state, make_batch(dcfg, 0))
            check(float(m["loss"]) == losses[0],
                  f"{tag} step 1 loss {float(m['loss'])} != {losses[0]}")
            steered[tag] = {k: KB.LAUNCHES[k] - before[k]
                            for k in ("rs_step", "ag_step")}
            if tag == "measured":
                rep = bucket_report(t, inf["bucket_plan"])
                check(all(r["rs_provenance"] == r["ag_provenance"] ==
                          "measured" and r["rs_backend"] == "pallas_fused"
                          for r in rep), f"measured report {rep}")
            del params, state
            torch.cuda.empty_cache()
        check(sum(steered["analytic"].values()) == 0 and
              all(v > 0 for v in steered["measured"].values()),
              f"launches {steered}: the measured table did not steer")
        log(f"  measured table (torus, p={P}): step kernels launched "
            f"analytic {steered['analytic']}, measured "
            f"{steered['measured']}; every bucket 'measured' -> "
            f"pallas_fused")
        del os.environ["REPRO_MEASURED_TABLE_DIR"]
        TP.invalidate_tables()
        launches = {k: KB.LAUNCHES[k] for k in ("rs_step", "ag_step")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the phase's obs record as a report artifact (phase 17 renders it)
    artifact = {"format": 1, "kind": "train", "timestamp": None,
                "config": {"topology": tcfg.topology,
                           "backend": tcfg.backend},
                "registry": reg.snapshot(),
                "timeline": timeline.get_timeline().to_json_dict()}
    return launches, out, artifact


# ---------------------------------------------------------------------------
# Phase 9: tensor parallelism
# ---------------------------------------------------------------------------

#: the loss gate of the full-width TP step against (dp, tp) = (2, 1) on the
#: same weights and global batch.  Both run phi4-mini in bf16; the TP step
#: adds one bf16 rounding (unit roundoff 2^-8) to each row-parallel partial
#: sum before the ranks' reduce-scatter (2 a layer) and sums the vocab
#: shards' exponentials in another order.  Those are unbiased rounding
#: errors in activations, and the loss and the grad norm each average over
#: 8192 tokens, so both move by far less than one ulp of bf16: 1e-3
#: relative on the loss (a quarter of bf16's unit roundoff) and 1% on the
#: grad norm (a sum of squares of bf16 gradients, each within 2^-8).
TP_LOSS_RTOL, TP_GNORM_RTOL = 1e-3, 1e-2


def phase_tp_small_reference(dev):
    """The small megatron_sp config and the reduced-width pure_sp config
    (``launch/cell.py``) at (dp, tp) = (2, 2), float32, 2 pallas_fused
    steps: the card against the CPU.  Loss and grad norm rtol 1e-4, as in
    phase 6.  Params: all but 0.1% within 1e-5, every one within two
    AdamW steps (2.5 lr): AdamW's first steps normalise each gradient
    element (m / sqrt(v) ~ sign(g)), so an element whose gradient is near
    zero can move by up to lr a step when its sign differs between the
    devices' float32 sums (tests/test_torch_train_step.py's reasoning;
    the megatron_sp config's million-element weights hold a few)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import cell
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)

    dp, tp = cell.TP_SHAPE
    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))
    for cfg in (cell.tp_small_config(), cell.tp_pure_sp_config()):
        dcfg = DataConfig(global_batch=8, seq_len=64,
                          vocab_size=cfg.vocab_size)
        init = SH.shard_params(cfg, TF.init_params(cfg, 0, "cpu"), tp)
        out = {}
        for where in ("cpu", dev):
            step, _, _ = make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg),
                                         where, tp=tp)
            params = [T.tree_map(lambda x: x.to(where), init)
                      for _ in range(dp)]
            state = init_train_state(cfg, tcfg, params, dp, tp)
            ms_ = []
            for s in range(2):
                params, state, m = step(params, state, make_batch(dcfg, s))
                ms_.append((float(m["loss"]), float(m["grad_norm"])))
            out[str(where)] = (ms_, [x.cpu() for x in T.flatten(params[0])])
        (mc, pc), (mg, pg) = out["cpu"], out[str(dev)]
        strat = SH.strategy(cfg, tp)
        for (lc, gc), (lg, gg) in zip(mc, mg):
            check(math.isclose(lc, lg, rel_tol=1e-4)
                  and math.isclose(gc, gg, rel_tol=1e-4),
                  f"tp small reference ({strat}): card {mg} vs cpu {mc}")
        diffs = [(a - b).abs() for a, b in zip(pc, pg)]
        perr = max(float(d.max()) for d in diffs)
        n_all = sum(d.numel() for d in diffs)
        n_out = sum(int((d > 1e-5).sum()) for d in diffs)
        lr = tcfg.adamw.lr
        check(perr <= 2.5 * lr and n_out <= 1e-3 * n_all,
              f"tp small reference ({strat}): params differ by {perr} "
              f"(> {2.5 * lr}), {n_out} of {n_all} beyond 1e-5")
        log(f"  small {strat} (d_model {cfg.d_model}) at (dp, tp) = "
            f"{cell.TP_SHAPE}: card losses {[round(l, 6) for l, _ in mg]} "
            f"vs cpu {[round(l, 6) for l, _ in mc]}, params max |diff| "
            f"{perr:.2e}, {n_out} of {n_all} beyond 1e-5")


def phase_tp(dev):
    """Full-width phi4-mini (``cell.model_config``) at (dp, tp) =
    ``cell.TP_SHAPE`` under megatron_sp and pallas_fused: 3 float32-wire
    and 2 int8-wire steps with the launches read around them (the DP
    collectives of every bucket run over dp within each TP column, so
    rs_step, ag_step and rs_step_q must run); the loss gate of step 0
    against (2, 1); the step's device-time groups and idle share from
    ``launch/profile_step.py`` at ``--mesh 2,2``."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.launch import profile_step as PS
    from repro_torch.models import sharding as SH

    cfg, dcfg, run = train_runs(dev)
    dp, tp = cell.TP_SHAPE
    tokens = dcfg.global_batch * dcfg.seq_len
    strat = SH.strategy(cfg, tp)
    check(strat == "megatron_sp", f"the TP cell runs {strat}")
    mesh = f"{dp},{tp}"
    c32, l32, t32, p32, _ = run(cell.train_config("pallas_fused", "float32"),
                                dp, 3, f"tp {mesh} pallas_fused/float32",
                                tp=tp, digest=True)
    c8, l8, t8, p8, _ = run(cell.train_config("pallas_fused", "int8"), dp, 2,
                            f"tp {mesh} pallas_fused/int8", tp=tp,
                            digest=True)
    launches = {k: c32[k] + c8[k] for k in ("rs_step", "ag_step",
                                             "rs_step_q")}
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the TP path")
    check(c8["rs_step_q"] > 0, "the TP int8 steps did not run rs_step_q")
    # the loss gate: step 0 without TP, same weights and global batch
    _, l21, _, _, _ = run(cell.train_config("pallas_fused", "float32"), dp,
                          1, f"no-TP ({dp},1) pallas_fused/float32")
    rel = abs(l32[0] - l21[0]) / abs(l21[0])
    check(rel <= TP_LOSS_RTOL, f"TP step-0 loss {l32[0]!r} vs (2,1) "
          f"{l21[0]!r}: rel {rel:.2e} > {TP_LOSS_RTOL}")
    g = run.gnorms
    grel = abs(g[f"tp {mesh} pallas_fused/float32"][0]
               - g[f"no-TP ({dp},1) pallas_fused/float32"][0]) / \
        g[f"no-TP ({dp},1) pallas_fused/float32"][0]
    check(grel <= TP_GNORM_RTOL, f"TP step-0 grad norm rel {grel:.2e} > "
          f"{TP_GNORM_RTOL}")
    log(f"  loss gate: TP step-0 loss {l32[0]:.6f} vs (2,1) {l21[0]:.6f} "
        f"(rel {rel:.2e} <= {TP_LOSS_RTOL}), grad norm rel {grel:.2e} <= "
        f"{TP_GNORM_RTOL}")
    torch.cuda.empty_cache()
    prof = PS.profile(cfg, "pallas_fused", "float32", dev, mesh)
    torch.cuda.empty_cache()
    warm = statistics.median(t32[1:])
    nums = {"mesh": mesh, "strategy": strat,
            "f32_losses": l32, "int8_losses": l8,
            "f32_losses_hex": [x.hex() for x in l32],
            "int8_losses_hex": [x.hex() for x in l8],
            "f32_params_sha256":
                run.digests[f"tp {mesh} pallas_fused/float32"],
            "int8_params_sha256":
                run.digests[f"tp {mesh} pallas_fused/int8"],
            "f32_step_ms": [t * 1e3 for t in t32],
            "int8_step_ms": [t * 1e3 for t in t8],
            "f32_warm_step_ms": warm * 1e3,
            "f32_tokens_per_s": tokens / warm,
            "int8_warm_step_ms": t8[1] * 1e3,
            "int8_tokens_per_s": tokens / t8[1],
            "peak_gib": {"f32": p32, "int8": p8},
            "loss_rel_vs_dp2_tp1": rel, "gnorm_rel_vs_dp2_tp1": grel,
            "profile": {k: prof[k] for k in ("wall_ms", "busy_ms",
                                             "idle_share", "tokens_per_s",
                                             "groups_ms")}}
    log(f"  TP warm step: float32 {warm * 1e3:.1f} ms ({tokens / warm:.0f} "
        f"tokens/s, peak {p32:.1f} GiB), int8 {t8[1] * 1e3:.1f} ms "
        f"({tokens / t8[1]:.0f} tokens/s, peak {p8:.1f} GiB); profiled "
        f"{prof['wall_ms']:.1f} ms, idle share {prof['idle_share']:.3f}; "
        f"launches {launches}")
    return launches, nums


# ---------------------------------------------------------------------------
# Phase 10: serving under tensor parallelism
# ---------------------------------------------------------------------------

#: the serve-TP cell's gate: request 0's insert logits within this many bf16
#: ulps of max |logit| of phase 7's one-card insert (same weights, prompt
#: and page).  Both run phi4-mini's 32 layers in bf16; under megatron_sp
#: each layer rounds the two row-parallel partial sums (attention wo, MLP
#: wo) to bf16 before the ranks' reduce-scatter, and the column blocks'
#: products may take other cuBLAS kernels, so every layer adds rounding
#: the one-card path does not have.  The reference's own GSPMD prefill at
#: phi4-mini's pattern (d_model 1024, 2 layers) lands 2 ulps from its
#: single-device one; grown linearly (the worst case: every layer's
#: rounding of one sign) to 32 layers that is 32 ulps.  A wrong layout or
#: head would move logits by their own size (hundreds of ulps).
SERVE_TP_ULPS = 32


def phase_serve_tp_small_reference(dev):
    """(a) Two small references, the card against the CPU on the same
    weights: ``launch/cell.py``'s small megatron_sp config at (dp, tp) =
    (1, 2) (its prefill on the flash kernel, float32 on the CUDA cores)
    and the reduced-width pure_sp one at (2, 2), float32 with a float32
    cache: two inserts and three decode steps (one page inactive) within
    2e-5 of max |logit| (tests/test_torch_serve_tp.py's float32 bound
    against the reference), and 6 greedy requests through 3 pages equal."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import cell
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as E
    from repro_torch.serve.sampling import gather_vocab
    from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                             poisson_trace)

    S, n_new = 64, 6
    for cfg, (dp, tp) in ((cell.tp_small_config(), (1, 2)),
                          (cell.tp_pure_sp_config(), (2, 2))):
        cfg = cfg.replace(cache_dtype="float32")
        init = TF.init_params(cfg, 0, "cpu")
        rng = np.random.RandomState(1)
        toks = rng.randint(0, cfg.vocab_size, (6, S)).astype(np.int32)
        out, streams = {}, {}
        for where in ("cpu", dev):
            params = T.tree_map(lambda x: x.to(where), init)
            fns = E.make_serve_fns(cfg, E.ServeConfig(), 4, S, where, dp=dp,
                                   tp=tp)
            pool, logits = fns.init_pool(), []
            for i, (L, slot) in enumerate(((37, 1), (10, 3))):
                lg, pool = fns.insert(params, pool, toks[i:i + 1], L, slot)
                logits.append(lg)
            for t in range(3):
                lg, pool = fns.decode_slots(params, pool,
                                            toks[2:, t:t + 1],
                                            np.asarray([1, 1, 0, 1],
                                                       np.int32))
                logits.append(lg)
            out[str(where)] = [gather_vocab(x, cfg.vocab_size).float().cpu()
                               for x in logits]
            fns = E.make_serve_fns(cfg, E.ServeConfig(), 3, S, where, dp=dp,
                                   tp=tp)
            reqs = poisson_trace(6, 0.8, (5, 40), n_new, cfg.vocab_size,
                                 seed=5)
            sched = ContinuousBatchingScheduler(cfg, fns, params, 3, S,
                                                seed=11)
            for r in reqs:
                sched.submit(r)
            sched.run()
            streams[str(where)] = [r.generated for r in reqs]
        strat = SH.strategy(cfg, tp)
        rel = 0.0
        for a, b in zip(out["cpu"], out[str(dev)]):
            d = float((a - b).abs().max()) / float(a.abs().max())
            check(d <= 2e-5, f"serve-TP small reference ({strat}): logits "
                  f"differ by {d:.2e} of max |logit|")
            rel = max(rel, d)
        check(streams["cpu"] == streams[str(dev)],
              f"serve-TP small reference ({strat}): card streams "
              f"{streams[str(dev)]} vs cpu {streams['cpu']}")
        log(f"  small {strat} (d_model {cfg.d_model}) at (dp, tp) = "
            f"{(dp, tp)}: 2 inserts + 3 decode steps, logits max |diff| "
            f"{rel:.2e} of max |logit| (card vs cpu); 6 greedy streams "
            f"through 3 pages equal")


def tp_against_one_rank(what, run, nums, trace, ref, one) -> dict:
    """A TP serve run against the one-rank run of the same weights and
    trace (``ref``: its request 0's insert logits and every request's
    tokens; ``one``: its numbers): request 0's insert within
    ``SERVE_TP_ULPS`` bf16 ulps of max |logit| and its first token equal
    (gated); every request's first and later tokens' agreement and the
    serve numbers beside one rank's (reported).  Returns those readings."""
    got, exp = run["insert0"], ref["insert0"]
    m = float(exp.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(m)) - 7)
    err = float((got - exp).abs().max())
    check(err <= SERVE_TP_ULPS * ulp,
          f"{what}: request 0's insert off the one-rank insert by {err} "
          f"({err / ulp:.1f} bf16 ulps of max |logit| {m:.4f}; bound "
          f"{SERVE_TP_ULPS})")
    tok0 = ref["tokens"]
    check(trace[0].generated[0] == tok0[0][0],
          f"{what}: request 0's first token {trace[0].generated[0]} vs one "
          f"rank {tok0[0][0]}")
    first = sum(r.generated[0] == t[0] for r, t in zip(trace, tok0))
    later = sum(a == b for r, t in zip(trace, tok0)
                for a, b in zip(r.generated[1:], t[1:]))
    n_later = sum(len(t) - 1 for t in tok0)
    log(f"  {what}: request 0's insert {err:.4f} = {err / ulp:.1f} bf16 "
        f"ulps of max |logit| {m:.4f} from one rank's (bound "
        f"{SERVE_TP_ULPS}); first tokens equal {first}/{len(trace)}, later "
        f"tokens {later}/{n_later} (reported, not gated)")
    for k in ("prefill_ms_per_insert", "decode_ms_per_step", "tokens_per_s",
              "ttft_ms_p50", "ttft_ms_p99", "peak_gib"):
        log(f"    {k}: {nums[k]:.2f} at (2, 2), {one[k]:.2f} on one rank")
    return {"insert0_max_abs_diff": err, "insert0_ulps": err / ulp,
            "first_tokens_agree": first / len(trace),
            "later_tokens_agree": later / n_later}


def phase_serve_tp(dev, one_card):
    """(b) The serve cell at ``cell.SERVE_TP_SHAPE`` = (dp, tp) = (2, 2):
    phi4-mini at full width and depth under megatron_sp, phase 7's weights
    (drawn again from the cell's seed on the card: torch's generator is
    deterministic), prompts and trace; 4 pages a DP rank, each page's
    1024 slots 512 a TP rank.  Predicted launches, as on one card: every
    insert 2 L + 1 = 65 rmsnorm (the TP ranks' stacked rows, one gain)
    and L = 32 flash_attention, one a layer with the 2 ranks' 12 query / 4
    KV heads in its batch, each on wgmma; every decode step 65 rmsnorm
    (the projections and MLP run once on the replicated stream) and no
    flash.  Checks (``serve_checks``) every request retires with its 32
    tokens, every logit is finite, those launch counts, request 0's insert
    logits within ``SERVE_TP_ULPS`` bf16 ulps of max |logit| of phase 7's
    and its first token equal, and the peak within phase 7's plus the
    pool's bytes.  Reports the later tokens' agreement with phase 7 (not
    gated: near-ties move bf16 greedy tokens), the serve numbers beside
    phase 7's and ``launch/profile_serve.py``'s breakdown of one insert
    and 5 decode steps at (1, 1) and (2, 2) on the same weights."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.launch import profile_serve as PSV
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import poisson_trace

    c = cell.SERVE_CELL
    cfg = cell.serve_model_config()
    dp, tp = cell.SERVE_TP_SHAPE
    strat = SH.strategy(cfg, tp)
    check(strat == "megatron_sp", f"the serve-TP cell runs {strat}")
    S = E.page_len(cfg, c.prompt_len_max, c.max_new)
    lay = E.cache_layout(cfg, c.slots, S, dp, tp)
    check([(x.kv, x.batch_split) for x in lay] == [("seq", True)],
          f"the serve-TP cell's pool layout {lay}")
    torch.cuda.reset_peak_memory_stats()
    params = TF.init_params(cfg, c.seed, dev)
    trace = poisson_trace(c.requests, c.rate,
                          (c.prompt_len_min, c.prompt_len_max), c.max_new,
                          cfg.vocab_size, seed=c.seed,
                          temperature=c.temperature)
    run = serve_run(cfg, params, dev, trace, c.slots, S, c.seed, dp, tp)
    what = f"(dp, tp) = {cell.SERVE_TP_SHAPE}"
    nums = serve_checks(cfg, run, trace, c.max_new, what)
    launches = run["launches"]
    one = one_card["nums"]
    nums.update(tp_against_one_rank(what, run, nums, trace,
                                    one_card["ref"], one))
    itemsize = torch.empty((), dtype=getattr(torch, cfg.cache_dtype)
                           ).element_size()
    pool_gib = sum(2 * n * c.slots * S * cfg.n_kv_heads * cfg.head_dim
                   for _, n in TF.segments(cfg)) * itemsize / 2 ** 30
    check(nums["peak_gib"] <= one["peak_gib"] + pool_gib,
          f"serve-TP peak {nums['peak_gib']:.2f} GiB > one card's "
          f"{one['peak_gib']:.2f} + the pool's {pool_gib:.2f}")
    nums.update({"mesh": f"{dp},{tp}", "strategy": strat,
                 "pool_gib": pool_gib})
    nums["profile"] = {}
    for mesh in ("1,1", f"{dp},{tp}"):
        torch.cuda.empty_cache()
        prof = PSV.profile(cfg, params, dev, mesh)
        nums["profile"][mesh] = prof
        log(f"  profile_serve --mesh {mesh}: insert wall "
            f"{prof['insert']['wall_ms']:.2f} ms, busy "
            f"{prof['insert']['busy_ms']:.2f} (idle "
            f"{prof['insert']['idle_share']:.3f}); decode step wall "
            f"{prof['decode_step']['wall_ms']:.2f} ms, busy "
            f"{prof['decode_step']['busy_ms']:.2f} (idle "
            f"{prof['decode_step']['idle_share']:.3f})")
    del params
    torch.cuda.empty_cache()
    return launches, nums


# ---------------------------------------------------------------------------
# Phase 11: the dense configs (gemma3-4b, gemma-7b, qwen3-32b)
# ---------------------------------------------------------------------------

def sdpa_backend(fn) -> str:
    """The SDPA backend that ran ``fn`` (an SDPA call): those of
    ``torch.nn.attention.SDPBackend`` that, forced alone, give its output
    bit for bit (a backend that refuses the call is passed over)."""
    import warnings
    import torch
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


def phase_dense_flash(dev, randn, row):
    """(a) The flash kernel at head_dim 256, the card against the plain
    version (``flash_case``: bf16 within 3e-2 on the wgmma kernel,
    float32 within 2e-5 on the CUDA-core kernel; phase 2 measured 3.9e-3
    in bf16 at head_dim 128): gemma3-4b's insert, q [1, 2048, 8, 256]
    against k/v [1, 2048, 4, 256], causal and with its 1024-token window,
    in both dtypes; its serve-TP insert (the 2 TP ranks in the batch, 4/2
    heads each); gemma-7b's, q [1, 1024, 16, 256] (g = 1), in both.  Each
    reads the model's [B, T, heads, hd] tensors as strided views.  Adds
    the ``flash_attention_hd256`` row at gemma3's causal bf16 shape (event
    ms, device ms under torch.profiler, host us, the bound by operations
    over 989 TFLOP/s, SDPA's times) and names the SDPA backend that ran.
    Then the dense serve cells' other kernel shapes: flash at qwen3-32b's
    insert (q [1, 1024, 64, 128] against k/v 8 heads, g = 8, bf16), and
    rmsnorm (``rmsnorm_case``: bf16 within one ulp, float32 within rtol
    1e-6) on each cell's insert rows [page, d_model] and decode rows
    [pages, d_model] (d_model 2560, 3072 and 5120)."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.serve import engine as E

    g3, g7, q3 = (cell.serve_model_config(c)
                  for c in cell.DENSE_SERVE_CELLS)
    h3 = (g3.n_heads, g3.n_kv_heads, g3.head_dim)
    h7 = (g7.n_heads, g7.n_kv_heads, g7.head_dim)
    hq = (q3.n_heads, q3.n_kv_heads, q3.head_dim)
    W = g3.local_window
    n = 0
    for heads, T, window, dt, b, tp in (
            (h3, 2048, W, torch.bfloat16, 1, 1),
            (h3, 2048, None, torch.float32, 1, 1),
            (h3, 2048, W, torch.float32, 1, 1),
            (h3, 2048, None, torch.bfloat16, 2, 2),
            (h3, 2048, W, torch.bfloat16, 2, 2),
            (h7, 1024, None, torch.bfloat16, 1, 1),
            (h7, 1024, None, torch.float32, 1, 1),
            (hq, 1024, None, torch.bfloat16, 1, 1)):
        flash_case(dev, randn, heads, T, window, dt, b, tp)
        n += 1
    n_rms = 0
    for c in cell.DENSE_SERVE_CELLS:
        cfg = cell.serve_model_config(c)
        S = E.page_len(cfg, c.prompt_len_max, c.max_new)
        for rows_ in (S, c.slots):
            for dt in (torch.bfloat16, torch.float32):
                rmsnorm_case(randn, rows_, cfg.d_model, cfg.norm_eps, dt)
                n_rms += 1
    log(f"  rmsnorm at the dense cells' rows: within one bf16 ulp / rtol "
        f"1e-6 (float32) of plain ({n_rms} variants)")
    kern, plain, lib, err, bound, by = flash_case(dev, randn, h3, 2048, None,
                                                  torch.bfloat16)
    log(f"  flash_attention at the dense cells' shapes (head_dim 256, "
        f"qwen3-32b's 128): within 3e-2 (bf16, tensor cores) / 2e-5 "
        f"(float32, CUDA cores) of plain ({n + 1} variants)")
    backend = sdpa_backend(lib)
    log(f"  SDPA at q [1, 2048, 8, 256] bf16 causal ran: {backend}")
    row("flash_attention_hd256", err, kern, plain, bound, by, lib,
        device="flash_kernel_wgmma", sdpa_backend=backend)
    del kern, plain, lib
    torch.cuda.empty_cache()


def phase_dense_serve(dev):
    """(b) The three dense serve cells of ``launch/cell.py``, one after
    another on one rank (each model freed before the next): gemma3-4b at
    full depth (prompts past its 1024-token window, pages of 2048),
    gemma-7b at full depth, qwen3-32b at full width and 16 layers, random
    weights from the port's ``init_params``.  ``serve_checks``: every
    request retires with its tokens, every logit is finite, 2 L + 1
    rmsnorm per insert and per decode step and L flash_attention per
    insert, all on wgmma; request 0 alone in a 1-page pool gets the same
    first token (gated; its later tokens' agreement reported).  Between
    gemma3's run and the next model, (c) serves gemma3 at
    ``SERVE_TP_SHAPE`` on the same weights (``phase_dense_serve_tp``).
    Returns each cell's launch counts and numbers, and (c)'s."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import Request, poisson_trace

    launches, nums = {}, {}
    tp_launches = tp_nums = None
    for c in cell.DENSE_SERVE_CELLS:
        cfg = cell.serve_model_config(c)
        S = E.page_len(cfg, c.prompt_len_max, c.max_new)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = TF.init_params(cfg, c.seed, dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        widths = sorted({b.window or S for b, _ in TF.segments(cfg)})
        log(f"  {cfg.name}: {cfg.n_layers} layers, "
            f"{TF.param_count(params):,} params ({cfg.dtype}, init "
            f"{t_init:.1f} s), head_dim {cfg.head_dim}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads, {c.slots} pages x {S} tokens (cache "
            f"widths {widths}), {c.requests} requests at {c.rate}/step, "
            f"prompts {c.prompt_len_min}-{c.prompt_len_max}, {c.max_new} "
            f"new tokens each")
        trace = poisson_trace(c.requests, c.rate,
                              (c.prompt_len_min, c.prompt_len_max),
                              c.max_new, cfg.vocab_size, seed=c.seed,
                              temperature=c.temperature)
        run = serve_run(cfg, params, dev, trace, c.slots, S, c.seed)
        got = serve_checks(cfg, run, trace, c.max_new, cfg.name)
        solo = Request(rid=0, prompt=trace[0].prompt,
                       max_new_tokens=c.max_new)
        serve_run(cfg, params, dev, [solo], 1, S, c.seed)
        check(solo.generated[0] == trace[0].generated[0],
              f"{cfg.name}: request 0's first token alone "
              f"{solo.generated[0]} vs pooled {trace[0].generated[0]}")
        agree = sum(a == b for a, b in zip(solo.generated[1:],
                                           trace[0].generated[1:]))
        got["solo_later_tokens_agree"] = agree / (c.max_new - 1)
        got["init_s"] = t_init
        log(f"  {cfg.name}: request 0 alone in a 1-page pool: same first "
            f"token; {agree}/{c.max_new - 1} later tokens agree (reported, "
            f"not gated)")
        launches[cfg.name], nums[cfg.name] = run["launches"], got
        if c is cell.GEMMA3_SERVE_CELL:
            ref = {"insert0": run["insert0"],
                   "tokens": [list(r.generated) for r in trace]}
            tp_launches, tp_nums = phase_dense_serve_tp(dev, c, cfg, params,
                                                        ref, got)
        del params, run
        torch.cuda.empty_cache()
    return launches, nums, tp_launches, tp_nums


def phase_dense_serve_tp(dev, c, cfg, params, one_card, one_nums):
    """(c) gemma3-4b's serve cell at ``cell.SERVE_TP_SHAPE`` = (2, 2),
    megatron_sp (d_model 2560, 8/4 heads), (b)'s weights and trace: every
    page's local (W = 1024) and global (W = 2048) caches sequence-sharded
    over the 2 TP ranks.  ``serve_checks`` as in (b); request 0's insert
    within ``SERVE_TP_ULPS`` bf16 ulps of max |logit| of (b)'s one-rank
    insert and its first token equal, as phase 10 gates phi4-mini; the
    later tokens' agreement and the serve numbers beside (b)'s reported."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.models import sharding as SH
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import poisson_trace

    dp, tp = cell.SERVE_TP_SHAPE
    strat = SH.strategy(cfg, tp)
    check(strat == "megatron_sp", f"gemma3-4b at tp {tp} runs {strat}")
    S = E.page_len(cfg, c.prompt_len_max, c.max_new)
    lay = E.cache_layout(cfg, c.slots, S, dp, tp)
    check(all((x.kv, x.batch_split) == ("seq", True) for x in lay),
          f"gemma3-4b's serve-TP pool layout {lay}")
    torch.cuda.reset_peak_memory_stats()
    trace = poisson_trace(c.requests, c.rate,
                          (c.prompt_len_min, c.prompt_len_max), c.max_new,
                          cfg.vocab_size, seed=c.seed,
                          temperature=c.temperature)
    run = serve_run(cfg, params, dev, trace, c.slots, S, c.seed, dp, tp)
    what = f"{cfg.name} at (dp, tp) = {(dp, tp)}"
    nums = serve_checks(cfg, run, trace, c.max_new, what)
    nums.update(tp_against_one_rank(what, run, nums, trace, one_card,
                                    one_nums))
    nums.update({"mesh": f"{dp},{tp}", "strategy": strat})
    return run["launches"], nums


#: the gemma3 train step's bf16 loss against the plain float32 loss of the
#: same weights and batch, and each sound forward's (``g3_loss_readings``).
#: Set from readings on an H100 (``PERF.md``): the sound bf16 forward reads
#: 0.035-0.037 below float32 on seeds 0-4, the faults below 1.4 and more
#: away; the bound is under 3x the sound gap
G3_LOSS_ATOL = 0.1
#: the forward's faults that the gate must see: each config change, in bf16
#: on seed 0's weights and batch, lands further than G3_LOSS_ATOL from the
#: sound float32 loss.  Dropping qk_norm moves the loss by less than the
#: bf16 gap at random weights (0.039 against 0.037), so the loss cannot
#: see it; the CPU tests hold qk_norm to the reference
G3_FAULTS = {"embed_scale dropped": {"embed_scale": False},
             "SwiGLU for GeGLU": {"act": "swiglu"}}


def g3_loss_readings(cfg, dcfg, dev, seeds=(0, 1, 2)):
    """The gemma3 train cell's loss gap, forward only: for each seed, the
    port's bf16 ``loss_fn`` of ``init_params(cfg, seed)`` on
    ``make_batch(dcfg, seed)`` less the plain float32 ``loss_fn`` of the
    same weights (upcast); on seed 0, each fault of ``G3_FAULTS`` in bf16
    less the sound float32 loss.  Returns ({seed: (bf16, f32)},
    {fault: loss})."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import make_batch

    f32 = cfg.replace(dtype="float32")
    sound, faulty = {}, {}
    with torch.no_grad():
        for seed in seeds:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in make_batch(dcfg, seed).items()}
            params = TF.init_params(cfg, seed, dev)
            p32 = T.tree_map(lambda x: x.float(), params)
            sound[seed] = (float(TF.loss_fn(params, cfg, batch)[0]),
                           float(TF.loss_fn(p32, f32, batch)[0]))
            del p32
            if seed == seeds[0]:
                for name, kw in G3_FAULTS.items():
                    faulty[name] = float(
                        TF.loss_fn(params, cfg.replace(**kw), batch)[0])
            del params, batch
            torch.cuda.empty_cache()
    return sound, faulty


def phase_dense_train(dev):
    """(d) One train step of the gemma3-4b train cell
    (``cell.model_config("gemma3-4b")``: full width, 2 layers, p = 4,
    batch 8 x 1024, float32 wire) under ``pallas_fused`` and under
    ``bine`` from the same start: rank 0's params after the step bitwise
    equal, as phase 6 holds phi4-mini (the gate on rs_step and ag_step);
    rs_step and ag_step launched by the fused step; the step's loss finite
    and within ``G3_LOSS_ATOL`` of the plain float32 ``loss_fn`` of the
    same initial weights (upcast) on the same global batch.  The loss
    comes before any collective, so it checks the forward: the bf16
    forward's gap on three seeds (``g3_loss_readings``) must lie within
    the bound and each fault of ``G3_FAULTS`` outside it.  Not near ln V:
    gemma3 ties its head to an embedding of std 0.02 scaled by
    sqrt(d_model) on the way in, so at random weights each token's own
    logit is about sqrt(d) |e|^2 / rms(x) ~ 37 and dominates the
    logsumexp (the reference's loss at d_model 2560 is as far above ln V;
    ``PERF.md``).  Returns the fused step's launch counts and the
    numbers."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF

    cfg, dcfg, run = train_runs(dev, cell.model_config("gemma3-4b"))
    log(f"  {cfg.name} cut to {cfg.n_layers} layers: "
        f"{TF.param_count(TF.param_shapes(cfg)):,} params, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}; dp={cell.N_DP}, batch "
        f"{dcfg.global_batch}x{dcfg.seq_len}")
    counts, losses, times, peak, first = run(
        cell.train_config("pallas_fused", "float32"), cell.N_DP, 1,
        "gemma3 pallas_fused/float32", digest=True)
    launches = {k: counts[k] for k in ("rs_step", "ag_step")}
    for k, v in launches.items():
        check(v > 0, f"the gemma3 train step did not launch {k}")
    sound, faulty = g3_loss_readings(cfg, dcfg, dev)
    ref_loss = sound[0][1]
    ln_v = math.log(cfg.vocab_size)
    check(math.isfinite(losses[0]) and
          abs(losses[0] - ref_loss) <= G3_LOSS_ATOL,
          f"gemma3 first loss {losses[0]} vs the plain float32 loss "
          f"{ref_loss} (bound {G3_LOSS_ATOL})")
    for seed, (b16, f32) in sound.items():
        log(f"  gemma3 seed {seed}: bf16 forward loss {b16:.6f}, plain "
            f"float32 {f32:.6f}, gap {b16 - f32:+.6f}")
    for name, loss in faulty.items():
        log(f"  gemma3 seed 0, {name}: bf16 loss {loss:.6f}, gap "
            f"{loss - ref_loss:+.6f} to the sound float32 loss")
    for seed, (b16, f32) in sound.items():
        check(abs(b16 - f32) <= G3_LOSS_ATOL,
              f"gemma3 seed {seed}: bf16 loss {b16} vs float32 {f32}")
    for name, loss in faulty.items():
        check(abs(loss - ref_loss) > G3_LOSS_ATOL,
              f"gemma3 with {name}: loss {loss} within {G3_LOSS_ATOL} of "
              f"the sound {ref_loss}; the loss gate cannot see that fault")
    cb, lb, tb, peak_b, bine_first = run(
        cell.train_config("bine", "float32"), cell.N_DP, 1,
        "gemma3 bine/float32")
    check(sum(cb.values()) == 0, f"the bine path launched kernels: {cb}")
    check(all(torch.equal(a, b) for a, b in zip(first, bine_first)),
          "gemma3: bine and pallas_fused params differ after one float32 "
          "step")
    check(lb[0] == losses[0], f"gemma3: bine loss {lb[0]} vs pallas_fused "
          f"{losses[0]}")
    log(f"  gemma3 bine float32 step == pallas_fused float32 step, bitwise; "
        f"loss {losses[0]:.6f}, plain float32 {ref_loss:.6f} (bound "
        f"{G3_LOSS_ATOL}; ln V {ln_v:.4f}); step {times[0] * 1e3:.1f} ms "
        f"(cold), peak {peak:.1f} GiB")
    del first, bine_first
    torch.cuda.empty_cache()
    return launches, {"loss_hex": losses[0].hex(), "f32_loss": ref_loss,
                      "forward_losses": {s: list(v)
                                         for s, v in sound.items()},
                      "fault_losses": faulty,
                      "step_ms_cold": times[0] * 1e3,
                      "bine_step_ms_cold": tb[0] * 1e3, "peak_gib": peak,
                      "bine_peak_gib": peak_b,
                      "params_sha256": run.digests[
                          "gemma3 pallas_fused/float32"]}


# ---------------------------------------------------------------------------
# Phase 12: the MoE block with expert parallelism (mixtral-8x7b)
# ---------------------------------------------------------------------------

#: phase 12's loss gates, set from ``moe_loss_readings`` on an H100
#: (PERF.md, section 6).  The bf16 step's loss within MOE_LOSS_ATOL of
#: the plain float32 ``loss_fn`` of the same weights (upcast) on the same
#: batch shards, at (2, 1) (the dense dispatch) and at (2, 2) (expert
#: parallelism at n_model = 2): the gaps read +0.0003, -0.0002, +0.0013
#: on three seeds at (2, 1) and +0.0010 at (2, 2), so 0.005 is 3.8x the
#: largest.  At random weights the mean loss is ln V plus half the
#: logits' variance, which the final norm fixes whatever the layer
#: computes, so no fault of the MoE layer moves it far (top-1 routing
#: -0.0039, GeGLU -0.0010): the forward is also gated token by token, the
#: mean over tokens of |NLL - the plain float32 NLL| within
#: MOE_TOKEN_ATOL.  It read 0.0119-0.0128 sound (both meshes), 0.504 with
#: top-1 routing and 0.102 with GeGLU experts: 0.03 is 2.3x the sound
#: reading and 3.4x under the nearer fault.
MOE_LOSS_ATOL = 0.005
MOE_TOKEN_ATOL = 0.03
#: forward faults the token gate must see: the router's top-1 in place of
#: its top-2, GeGLU experts in place of SwiGLU ones
MOE_FAULTS = {"top-1 routing": {"top_k": 1},
              "GeGLU for SwiGLU": {"act": "geglu"}}


def phase_moe_small_reference(dev):
    """(a) Reduced mixtral-8x7b and phi3.5-moe (float32) at (dp, tp) =
    (2, 1) and (2, 2), one pallas_fused step: the card against the CPU,
    as phase 9 holds its small configs (loss, aux loss and grad norm rtol
    1e-4; params all but 0.1% within 1e-5, every one within 2.5 lr).
    Both reduced configs run pure_sp at (2, 2): the expert blocks are
    held whole and each TP rank takes its own."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import base
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)

    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))
    for arch in ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b"):
        cfg = base.reduced(base.get_config(arch)).replace(dtype="float32")
        dcfg = DataConfig(global_batch=8, seq_len=64,
                          vocab_size=cfg.vocab_size)
        for dp, tp in ((2, 1), (2, 2)):
            init = TF.init_params(cfg, 0, "cpu")
            if tp > 1:
                init = SH.shard_params(cfg, init, tp)
            out = {}
            for where in ("cpu", dev):
                step, _, _ = make_train_step(cfg, tcfg, dp,
                                             TF.param_shapes(cfg), where,
                                             tp=tp)
                params = [T.tree_map(lambda x: x.to(where), init)
                          for _ in range(dp)]
                state = init_train_state(cfg, tcfg, params, dp, tp)
                params, state, m = step(params, state, make_batch(dcfg, 0))
                out[str(where)] = ([float(m[k]) for k in
                                    ("loss", "aux_loss", "grad_norm")],
                                   [x.cpu() for x in T.flatten(params[0])])
            (mc, pc), (mg, pg) = out["cpu"], out[str(dev)]
            what = f"moe small reference {arch} ({dp}, {tp})"
            check(all(math.isclose(a, b, rel_tol=1e-4)
                      for a, b in zip(mc, mg)),
                  f"{what}: card {mg} vs cpu {mc}")
            diffs = [(a - b).abs() for a, b in zip(pc, pg)]
            perr = max(float(d.max()) for d in diffs)
            n_all = sum(d.numel() for d in diffs)
            n_out = sum(int((d > 1e-5).sum()) for d in diffs)
            lr = tcfg.adamw.lr
            check(perr <= 2.5 * lr and n_out <= 1e-3 * n_all,
                  f"{what}: params differ by {perr} (> {2.5 * lr}), "
                  f"{n_out} of {n_all} beyond 1e-5")
            log(f"  small {arch} at (dp, tp) = ({dp}, {tp}) "
                f"({SH.strategy(cfg, tp)}): card loss / aux / gnorm "
                f"{[round(v, 6) for v in mg]} vs cpu "
                f"{[round(v, 6) for v in mc]}, params max |diff| "
                f"{perr:.2e}, {n_out} of {n_all} beyond 1e-5")


def moe_loss_readings(cfg, dcfg, dev, tp: int, seeds=(0,), faults=None):
    """The MoE train cell's forward, as the step reports its loss: the
    mean over the DP ranks (``cell.MOE_TRAIN_CELL``'s dp of 2) of
    ``loss_fn`` on each rank's batch shard, the weights stacked over
    ``tp`` TP ranks where it is above 1 (expert parallelism), and each
    token's NLL.  For each seed: the bf16 loss of ``init_params(cfg,
    seed)`` on ``make_batch(dcfg, seed)``, the plain float32 loss of the
    same weights (upcast), and the token gap, the mean over tokens of
    |bf16 NLL - float32 NLL|; on the first seed each fault of ``faults``
    in bf16, its loss and token gap to the sound float32 run.  Returns
    ({seed: (bf16, f32, token gap)}, {fault: (loss, token gap)})."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import make_batch

    dp = 2
    f32 = cfg.replace(dtype="float32")

    def fwd(params, c, shards):
        """(the loss, every token's NLL [dp * B/dp * T])"""
        tot, nll = 0.0, []
        for sh in shards:
            loss = TF.loss_fn(params, c, sh, n_model=tp)[0]
            tot += float(loss[0] if tp > 1 else loss)
            logits, _ = TF.forward(params, c, sh["inputs"], n_model=tp)
            if tp > 1:
                logits = torch.cat(list(logits), dim=-1)[..., :c.vocab_size]
            logits = logits.float()
            nll.append((torch.logsumexp(logits, dim=-1) - torch.gather(
                logits, -1, sh["targets"][..., None].long())[..., 0]
                        ).reshape(-1))
            del logits
        return tot / dp, torch.cat(nll)

    def gap(a, b):
        return float((a - b).abs().mean())

    sound, faulty = {}, {}
    with torch.no_grad():
        for seed in seeds:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in make_batch(dcfg, seed).items()}
            shards = [{k: v.chunk(dp)[r] for k, v in batch.items()}
                      for r in range(dp)]
            params = TF.init_params(cfg, seed, dev)
            if tp > 1:
                params = SH.shard_params(cfg, params, tp)
            b16 = fwd(params, cfg, shards)
            bad = {name: fwd(params, cfg.replace(**kw), shards)
                   for name, kw in (faults or {}).items()} \
                if seed == seeds[0] else {}
            p32 = T.tree_map(lambda x: x.float(), params)
            del params
            torch.cuda.empty_cache()
            ref = fwd(p32, f32, shards)
            sound[seed] = (b16[0], ref[0], gap(b16[1], ref[1]))
            faulty.update({k: (v[0], gap(v[1], ref[1]))
                           for k, v in bad.items()})
            del p32, batch, shards, b16, bad, ref
            torch.cuda.empty_cache()
    return sound, faulty


def a2a_record():
    """The EP all_to_all calls in the obs registry since its last reset:
    {backend: (calls, payload bytes, global-link bytes)}."""
    from repro_torch.obs import metrics as OM
    reg = OM.get_registry()
    out = {}
    for i, name in enumerate(("collective_calls", "collective_payload_bytes",
                              "link_global_bytes")):
        for labels, value in reg.series(name):
            if labels.get("collective") != "alltoall":
                continue
            row = out.setdefault(labels.get("backend", "?"), [0.0] * 3)
            row[i] += value
    return {b: tuple(v) for b, v in out.items()}


def phase_moe_train(dev):
    """(b)-(d) ``cell.MOE_TRAIN_CELL``: mixtral-8x7b at full width, one
    layer, batch 8 x 1024, bf16, the float32 wire.  At each of its meshes
    ((2, 1): the dense dispatch on each DP rank; (2, 2): megatron_sp with
    expert parallelism) two pallas_fused steps then one bine step from the
    same start: rank 0's params after the first step bitwise equal (and
    the losses), rs_step and ag_step launched by the fused steps, the
    step-0 loss finite, the bf16 forward's, and within ``MOE_LOSS_ATOL``
    of the plain float32 forward of the same weights (at (2, 2) the EP
    forward at n_model = 2), its tokens' NLL within ``MOE_TOKEN_ATOL`` on
    average, as are the bf16 forward's on three seeds at (2, 1), while
    each fault of ``MOE_FAULTS`` lands outside the token gate.  At (2, 2)
    the EP all_to_all's calls, backend and global-link bytes from the obs
    record (three calls a layer a DP rank a step: the dispatch, its block
    ids, the combine).  Then the (2, 2) step's device groups, its MoE
    layer's phases and idle share from ``launch/profile_step.py``, its
    busy ms and launches (each group's over the profiled steps) read from
    the raw kineto events equal to ``key_averages``' reading of the same
    profile.  Returns the fused
    steps' launches by mesh and the numbers."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.launch import profile_step as PS
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.obs import metrics as OM

    mc = cell.MOE_TRAIN_CELL
    cfg, dcfg, run = train_runs(dev, mc.model_config())
    tokens = dcfg.global_batch * dcfg.seq_len
    log(f"  {cfg.name} cut to {cfg.n_layers} layer(s): "
        f"{TF.param_count(TF.param_shapes(cfg)):,} params, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, {cfg.n_experts} experts x {cfg.ep_blocks} blocks "
        f"of {cfg.d_ff // cfg.ep_blocks}, top-{cfg.top_k}, vocab "
        f"{cfg.vocab_size}; batch {dcfg.global_batch}x{dcfg.seq_len}")
    launches, nums = {}, {"meshes": {}}
    for dp, tp in mc.meshes:
        mesh = f"{dp},{tp}"
        tag = f"moe {mesh} pallas_fused/float32"
        OM.get_registry().reset()
        counts, losses, times, peak, first = run(
            cell.train_config("pallas_fused", "float32"), dp, 2, tag, tp=tp,
            digest=True)
        a2a = a2a_record()
        launches[mesh] = {k: counts[k] for k in ("rs_step", "ag_step")}
        for k, v in launches[mesh].items():
            check(v > 0, f"the MoE train step at ({mesh}) did not launch {k}")
        cb, lb, tb, peak_b, bine_first = run(
            cell.train_config("bine", "float32"), dp, 1,
            f"moe {mesh} bine/float32", tp=tp)
        check(sum(cb.values()) == 0, f"the bine path launched kernels: {cb}")
        check(all(torch.equal(a, b) for a, b in zip(first, bine_first)),
              f"moe ({mesh}): bine and pallas_fused params differ after one "
              f"float32 step")
        check(lb[0] == losses[0], f"moe ({mesh}): bine loss {lb[0]} vs "
              f"pallas_fused {losses[0]}")
        del first, bine_first
        torch.cuda.empty_cache()
        ep = tp > 1
        sound, faulty = moe_loss_readings(
            cfg, dcfg, dev, tp, seeds=(0,) if ep else (0, 1, 2),
            faults=None if ep else MOE_FAULTS)
        ref = sound[0][1]
        for seed, (b16, f32, tg) in sound.items():
            log(f"  moe ({mesh}) seed {seed}: bf16 forward loss {b16:.6f}, "
                f"plain float32 {f32:.6f}, gap {b16 - f32:+.6f}; token gap "
                f"{tg:.6f}")
        for name, (loss, tg) in faulty.items():
            log(f"  moe ({mesh}) seed 0, {name}: bf16 loss {loss:.6f}, gap "
                f"{loss - ref:+.6f} to the sound float32 loss; token gap "
                f"{tg:.6f}")
        check(math.isfinite(losses[0]) and
              abs(losses[0] - ref) <= MOE_LOSS_ATOL,
              f"moe ({mesh}) step-0 loss {losses[0]} vs the plain float32 "
              f"loss {ref} (bound {MOE_LOSS_ATOL})")
        # the step's loss is the bf16 forward's that the token gate reads
        check(math.isclose(losses[0], sound[0][0], rel_tol=1e-6),
              f"moe ({mesh}) step-0 loss {losses[0]} vs its bf16 forward "
              f"{sound[0][0]}")
        for seed, (b16, f32, tg) in sound.items():
            check(abs(b16 - f32) <= MOE_LOSS_ATOL and tg <= MOE_TOKEN_ATOL,
                  f"moe ({mesh}) seed {seed}: bf16 loss {b16} vs float32 "
                  f"{f32}, token gap {tg} (bounds {MOE_LOSS_ATOL}, "
                  f"{MOE_TOKEN_ATOL})")
        for name, (loss, tg) in faulty.items():
            check(tg > MOE_TOKEN_ATOL,
                  f"moe with {name}: token gap {tg} within {MOE_TOKEN_ATOL} "
                  f"of the sound float32 run; the gate cannot see that "
                  f"fault")
        if ep:
            want = 3 * dp * cfg.n_layers * 2          # 2 fused steps
            calls = sum(v[0] for v in a2a.values())
            check(set(a2a) == {"bine"} and calls == want,
                  f"moe ({mesh}): EP all_to_all record {a2a}, expected "
                  f"{want} bine calls")
            log(f"  moe ({mesh}) EP all_to_all (obs record, 2 steps): "
                + ", ".join(f"{b} x{int(c)}, payload {pb / 1e6:.1f} MB, "
                            f"global-link {gb / 1e6:.1f} MB"
                            for b, (c, pb, gb) in a2a.items()))
        else:
            check(not a2a, f"moe ({mesh}) ran an all_to_all: {a2a}")
        aux = run.aux.get(tag, [])
        log(f"  moe ({mesh}) bine float32 step == pallas_fused float32 step, "
            f"bitwise; loss {losses[0]:.6f}, plain float32 {ref:.6f} (bound "
            f"{MOE_LOSS_ATOL}), aux loss {aux}; warm step "
            f"{times[1] * 1e3:.1f} ms ({tokens / times[1]:.0f} tokens/s), "
            f"peak {peak:.1f} GiB ({SH.strategy(cfg, tp)})")
        nums["meshes"][mesh] = {
            "strategy": SH.strategy(cfg, tp), "loss_hex": losses[0].hex(),
            "losses": losses, "aux_loss": aux, "f32_loss": ref,
            "forward_losses": {s: list(v) for s, v in sound.items()},
            "fault_losses": faulty, "step_ms": [t * 1e3 for t in times],
            "warm_step_ms": times[1] * 1e3,
            "tokens_per_s": tokens / times[1], "peak_gib": peak,
            "bine_step_ms_cold": tb[0] * 1e3, "bine_peak_gib": peak_b,
            "params_sha256": run.digests[tag],
            "all_to_all": {b: list(v) for b, v in a2a.items()}}
    torch.cuda.empty_cache()
    prof = PS.profile(cfg, "pallas_fused", "float32", dev, "2,2",
                      compare=True)
    torch.cuda.empty_cache()
    nums["profile_2,2"] = {k: prof[k] for k in (
        "wall_ms", "busy_ms", "idle_share", "tokens_per_s", "groups_ms",
        "group_counts", "moe_phases_ms", "key_averages")}
    check(prof["moe_phases_ms"], "the (2, 2) profile saw no MoE phase")
    # the raw kineto events and key_averages (the older accounting)
    # account the same kernels
    old = prof["key_averages"]
    check(math.isclose(old["busy_ms"], prof["busy_ms"], rel_tol=1e-6) and
          old["group_counts"] == prof["group_counts"],
          f"the (2, 2) profile's raw events (busy {prof['busy_ms']} ms, "
          f"{prof['group_counts']}) and key_averages ({old}) disagree")
    log(f"  moe (2,2) profiled {prof['wall_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}")
    return launches, nums


# ---------------------------------------------------------------------------
# Phase 13: the recurrent blocks (xlstm-125m, zamba2-2.7b)
# ---------------------------------------------------------------------------

#: phase 13's train-cell gates, per arch: (loss, token), set from
#: ``train_loss_readings`` on an H100 (PERF.md, section 6).  The bf16
#: step's loss within the first of the plain float32 loss of the same
#: weights (upcast) on the same batch, and the mean over tokens of |bf16
#: NLL - float32 NLL| within the second, as phase 12 gates the MoE cell;
#: each fault of ``SSM_FAULTS`` must land outside the token gate.  zamba2
#: x12 read loss gaps +0.00051, +0.00003, +0.00011 and token gaps
#: 0.0256-0.0264 on seeds 0-2 (its GeGLU fault 0.061); xlstm-125m -0.0006,
#: -0.0020, -0.000001 and 0.0474-0.0500 (its mLSTM fault 0.544): each
#: gate is about 1.5x its largest token reading and 3-4x its largest loss
#: gap
SSM_GATES = {"zamba2-2.7b": (0.002, 0.04), "xlstm-125m": (0.006, 0.075)}
#: phase 13's serve gate: zamba2's bf16 prefill logits against the
#: float32 prefill of the same weights (upcast, float32 caches), the mean
#: of |bf16 - float32| over the batch's last-token logits in bf16 ulps of
#: max |logit|, within SSM_LOGIT_ULPS on three seeds, while the flash
#: kernel with its last 16 head columns zeroed lands outside it on each.
#: Set from readings on an H100 (PERF.md, section 6): sound 2.11, 2.14,
#: 2.11, the fault 3.74, 3.61, 3.63; the max over the logits separated
#: them less (sound 11.5-12.8, the fault 18.6-23.6)
SSM_LOGIT_ULPS = 2.8


def _zero_leaf(name):
    """A fault: every stacked leaf called ``name`` zeroed."""
    def fault(cfg, params):
        import torch
        from repro_torch import tree as T
        return cfg, T.map_with_path(
            lambda p, x: torch.zeros_like(x) if p and p[-1] == name else x,
            params)
    return fault


def _replace_cfg(**kw):
    def fault(cfg, params):
        return cfg.replace(**kw), params
    return fault


#: forward faults the token gate must see, per arch: (name, fault(cfg,
#: params) -> (cfg, params))
SSM_FAULTS = {
    "zamba2-2.7b": {"Mamba2's D skip dropped": _zero_leaf("D"),
                    "GeGLU for SwiGLU (shared block)":
                    _replace_cfg(act="geglu")},
    "xlstm-125m": {"sLSTM blocks' output projection zeroed":
                   _zero_leaf("out"),
                   "mLSTM's input gate weights zeroed": _zero_leaf("wgi")},
}


def phase_model_small_reference(dev, archs):
    """13a and 14a: reduced ``archs`` (float32, float32 caches), the same
    weights on the card and on the CPU: two pallas_fused train steps at p
    = 2 (the losses and step 1's grad norm within rtol 1e-4; params after
    step 1 all but 0.1% within 1e-5, every one within 2.5 lr, as phase
    12a), then ``prefill`` of 64 tokens and 4 ``decode_step``s (logits
    within 1e-4 of max |logit|); a frontend config takes ``make_batch``'s
    frames and ``np.random.RandomState(2)``'s in place of tokens.  Step
    2's grad norm is reported: a weight whose step-1 gradient is of the
    order of AdamW's eps moves by up to 2 lr between two float32 sums
    (tests/test_torch_ssm.py)."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import base
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)

    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))
    dp = 2
    for arch in archs:
        cfg = base.reduced(base.get_config(arch)).replace(
            dtype="float32", cache_dtype="float32")
        fd = cfg.frontend_dim if cfg.frontend else 0
        dcfg = DataConfig(global_batch=8, seq_len=64,
                          vocab_size=cfg.vocab_size, frontend_dim=fd)
        init = TF.init_params(cfg, 0, "cpu")
        tok = _frames(cfg, 2, 68, 2, "cpu") if fd else torch.as_tensor(
            np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 68)),
            dtype=torch.int32)
        out = {}
        for where in ("cpu", dev):
            step, _, _ = make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg),
                                         where)
            params = [T.tree_map(lambda x: x.to(where), init)
                      for _ in range(dp)]
            state = init_train_state(cfg, tcfg, params, dp)
            mets, first = [], None
            for s in range(2):
                params, state, m = step(params, state, make_batch(dcfg, s))
                mets.append([float(m["loss"]), float(m["grad_norm"])])
                if s == 0:
                    first = [x.cpu() for x in T.flatten(params[0])]
            p1 = T.tree_map(lambda x: x.to(where), init)
            with torch.no_grad():
                lg, st = TF.prefill(p1, cfg, tok[:, :64].to(where))
                logits = [lg.cpu()]
                for t in range(4):
                    lg, st = TF.decode_step(p1, cfg, st,
                                            tok[:, 64 + t:65 + t].to(where))
                    logits.append(lg.cpu())
            out[str(where)] = (mets, first, logits)
        (mc, pc, lc), (mg, pg, lgd) = out["cpu"], out[str(dev)]
        what = f"small reference {arch}"
        for (a, b), (c, d_) in zip(mc, mg):
            check(math.isclose(a, c, rel_tol=1e-4),
                  f"{what}: card loss {c} vs cpu {a}")
        check(math.isclose(mc[0][1], mg[0][1], rel_tol=1e-4),
              f"{what}: card step-1 grad norm {mg[0][1]} vs cpu {mc[0][1]}")
        diffs = [(a - b).abs() for a, b in zip(pc, pg)]
        perr = max(float(d.max()) for d in diffs)
        n_all = sum(d.numel() for d in diffs)
        n_out = sum(int((d > 1e-5).sum()) for d in diffs)
        lr = tcfg.adamw.lr
        check(perr <= 2.5 * lr and n_out <= 1e-3 * n_all,
              f"{what}: params differ by {perr} (> {2.5 * lr}), {n_out} of "
              f"{n_all} beyond 1e-5")
        lerr = max(float((a - b).abs().max() / a.abs().max())
                   for a, b in zip(lc, lgd))
        check(lerr <= 1e-4, f"{what}: prefill/decode logits differ by "
              f"{lerr} of max |logit|")
        log(f"  small {arch} (f32{', frames' if fd else ''}): card loss / "
            f"gnorm {mg} vs cpu {mc} "
            f"(step 2's gnorm reported); params max |diff| {perr:.2e}, "
            f"{n_out} of {n_all} beyond 1e-5; prefill + 4 decode logits "
            f"{lerr:.2e} of max |logit|")


def phase_ssm_flash(dev, randn, row):
    """(b) The flash kernel at head_dim 80, zamba2-2.7b's shared attention
    at its serve cell's prefill, q, k, v [4, 1024, 32, 80] causal (g = 1):
    bf16 on the wgmma kernel (head_dim 128's tiles, columns 80-127
    zero-filled by TMA) within 3e-2 of the plain version, float32 on the
    CUDA cores within 2e-5 (``flash_case``); the ``flash_attention_hd80``
    row (event ms, device ms under torch.profiler, host us, the bound by
    operations over 989 TFLOP/s against bytes over 3.35 TB/s, SDPA's
    times, its backend named)."""
    import torch
    from repro_torch.launch import cell

    cfg = cell.serve_model_config(cell.ZAMBA2_SERVE_CELL)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    B = cell.ZAMBA2_SERVE_CELL.slots
    T_ = cell.ZAMBA2_SERVE_CELL.prompt_len_max
    flash_case(dev, randn, heads, T_, None, torch.float32, B)
    kern, plain, lib, err, bound, by = flash_case(dev, randn, heads, T_,
                                                  None, torch.bfloat16, B)
    backend = sdpa_backend(lib)
    log(f"  SDPA at q [{B}, {T_}, 32, 80] bf16 causal ran: {backend}")
    row("flash_attention_hd80", err, kern, plain, bound, by, lib,
        device="flash_kernel_wgmma", sdpa_backend=backend)
    del kern, plain, lib
    torch.cuda.empty_cache()


def train_loss_readings(cfg, dcfg, dev, seeds=(0,), faults=None):
    """A train cell's forward on its whole global batch (one forward: a
    recurrent cell's sLSTM scan costs launches a call, not a row; a
    frontend cell's batch is frames): ``loss_fn``'s
    cross entropy and z-loss, and each token's NLL.  For each seed the
    bf16 loss of ``init_params(cfg, seed)`` on ``make_batch(dcfg, seed)``,
    the plain float32 loss of the same weights (upcast) and the token gap,
    the mean over tokens of |bf16 NLL - float32 NLL|; on the first seed
    each fault of ``faults`` (name -> fault(cfg, params)) in bf16, its
    loss and token gap to the sound float32 run.  Returns ({seed: (bf16,
    f32, token gap)}, {fault: (loss, token gap)})."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import make_batch

    f32 = cfg.replace(dtype="float32")

    def fwd(params, c, batch):
        """(the loss, every token's NLL)"""
        logits = TF.forward(params, c, batch["inputs"])[0].float()
        lse = torch.logsumexp(logits, dim=-1)
        tok = lse - torch.gather(logits, -1,
                                 batch["targets"][..., None].long())[..., 0]
        del logits
        return float(tok.mean() + c.z_loss * (lse * lse).mean()), \
            tok.reshape(-1)

    def gap(a, b):
        return float((a - b).abs().mean())

    sound, faulty = {}, {}
    with torch.no_grad():
        for seed in seeds:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in make_batch(dcfg, seed).items()}
            params = TF.init_params(cfg, seed, dev)
            b16 = fwd(params, cfg, batch)
            bad = {}
            if seed == seeds[0]:
                for name, fault in (faults or {}).items():
                    c2, p2 = fault(cfg, params)
                    bad[name] = fwd(p2, c2, batch)
                    del p2
            p32 = T.tree_map(lambda x: x.float(), params)
            del params
            torch.cuda.empty_cache()
            ref = fwd(p32, f32, batch)
            sound[seed] = (b16[0], ref[0], gap(b16[1], ref[1]))
            faulty.update({k: (v[0], gap(v[1], ref[1]))
                           for k, v in bad.items()})
            del p32, batch, b16, bad, ref
            torch.cuda.empty_cache()
    return sound, faulty


#: phase 13's train cells left unprofiled: xlstm's sLSTM scans make one
#: step ~1 M profiler events (48 s of profiled wall on an H100, more to
#: read them), past the smoke's time; ``launch/profile_step.py --arch
#: xlstm-125m`` reads its step
SSM_UNPROFILED = ("xlstm-125m",)


def phase_ssm_train(dev):
    """(c) ``cell.SSM_TRAIN_CELLS``: zamba2-2.7b at full width cut to 12
    of 54 Mamba2 blocks (two firings of the tied shared block) and
    xlstm-125m at full depth, p = 4, batch 8 x 1024, bf16, float32 wire:
    two pallas_fused steps and one bine step from the same start, rank
    0's params after the first bitwise equal (and the losses), rs_step
    and ag_step launched by the fused steps; the step-0 loss within its
    ``SSM_GATES`` loss bound of the plain float32 forward of the same
    weights and its tokens' NLL within its token bound on average, as are
    three seeds' bf16 forwards, while each fault of ``SSM_FAULTS`` lands
    outside the token gate.  Then, but for ``SSM_UNPROFILED``, each
    step's device groups under ``launch/profile_step.py``, and its idle
    share against the step's unprofiled wall time.  Returns the fused
    steps' launches by arch and the numbers."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.launch import profile_step as PS
    from repro_torch.models import transformer as TF

    launches, nums = {}, {}
    for tc in cell.SSM_TRAIN_CELLS:
        cfg, dcfg, run = train_runs(dev, tc.model_config())
        dp = tc.meshes[0][0]
        tokens = dcfg.global_batch * dcfg.seq_len
        n_params = TF.param_count(TF.param_shapes(cfg))
        kinds = sorted({b.kind for b, _ in TF.segments(cfg)})
        log(f"  {cfg.name}: {cfg.n_layers} blocks {kinds}, {n_params:,} "
            f"params, d_model {cfg.d_model}; p = {dp}, batch "
            f"{dcfg.global_batch}x{dcfg.seq_len}")
        tag = f"{cfg.name} pallas_fused/float32"
        counts, losses, times, peak, first = run(
            cell.train_config("pallas_fused", "float32"), dp, 2, tag,
            digest=True)
        launches[cfg.name] = {k: counts[k] for k in ("rs_step", "ag_step")}
        for k, v in launches[cfg.name].items():
            check(v > 0, f"the {cfg.name} train step did not launch {k}")
        cb, lb, tb, peak_b, bine_first = run(
            cell.train_config("bine", "float32"), dp, 1,
            f"{cfg.name} bine/float32")
        check(sum(cb.values()) == 0, f"the bine path launched kernels: {cb}")
        check(all(torch.equal(a, b) for a, b in zip(first, bine_first)),
              f"{cfg.name}: bine and pallas_fused params differ after one "
              f"float32 step")
        check(lb[0] == losses[0], f"{cfg.name}: bine loss {lb[0]} vs "
              f"pallas_fused {losses[0]}")
        del first, bine_first
        torch.cuda.empty_cache()
        loss_atol, token_atol = SSM_GATES[cfg.name]
        sound, faulty = train_loss_readings(cfg, dcfg, dev, (0, 1, 2),
                                          SSM_FAULTS[cfg.name])
        ref = sound[0][1]
        for seed, (b16, f32, tg) in sound.items():
            log(f"  {cfg.name} seed {seed}: bf16 forward loss {b16:.6f}, "
                f"plain float32 {f32:.6f}, gap {b16 - f32:+.6f}; token gap "
                f"{tg:.6f}")
        for name, (loss, tg) in faulty.items():
            log(f"  {cfg.name} seed 0, {name}: bf16 loss {loss:.6f}, gap "
                f"{loss - ref:+.6f} to the sound float32 loss; token gap "
                f"{tg:.6f}")
        check(math.isfinite(losses[0]) and
              abs(losses[0] - ref) <= loss_atol,
              f"{cfg.name} step-0 loss {losses[0]} vs the plain float32 "
              f"loss {ref} (bound {loss_atol})")
        for seed, (b16, f32, tg) in sound.items():
            check(abs(b16 - f32) <= loss_atol and tg <= token_atol,
                  f"{cfg.name} seed {seed}: bf16 loss {b16} vs float32 "
                  f"{f32}, token gap {tg} (bounds {loss_atol}, "
                  f"{token_atol})")
        for name, (loss, tg) in faulty.items():
            check(tg > token_atol,
                  f"{cfg.name} with {name}: token gap {tg} within "
                  f"{token_atol} of the sound float32 run; the gate "
                  f"cannot see that fault")
        torch.cuda.empty_cache()
        warm = times[1]
        log(f"  {cfg.name} bine float32 step == pallas_fused float32 step, "
            f"bitwise; loss {losses[0]:.6f}, plain float32 {ref:.6f} "
            f"(bounds {loss_atol} / token {token_atol}); warm step "
            f"{warm * 1e3:.1f} ms ({tokens / warm:.0f} tokens/s), peak "
            f"{peak:.1f} GiB")
        nums[cfg.name] = {
            "n_layers": cfg.n_layers, "params": n_params,
            "loss_hex": losses[0].hex(), "losses": losses,
            "gnorms": run.gnorms[tag], "f32_loss": ref,
            "forward_losses": {s: list(v) for s, v in sound.items()},
            "fault_losses": faulty, "step_ms": [t * 1e3 for t in times],
            "warm_step_ms": warm * 1e3, "tokens_per_s": tokens / warm,
            "peak_gib": peak, "bine_step_ms_cold": tb[0] * 1e3,
            "bine_peak_gib": peak_b, "params_sha256": run.digests[tag]}
        if cfg.name in SSM_UNPROFILED:
            continue
        prof = PS.profile(cfg, "pallas_fused", "float32", dev, f"{dp},1",
                          steps=2)
        torch.cuda.empty_cache()
        idle = 1 - prof["busy_ms"] / (warm * 1e3)
        log(f"  {cfg.name}: profiled {prof['wall_ms']:.1f} ms wall, "
            f"{prof['busy_ms']:.1f} ms busy: idle share {idle:.3f} of the "
            f"unprofiled step ({prof['idle_share']:.3f} under the profiler)")
        nums[cfg.name]["profile"] = {k: prof[k] for k in (
            "wall_ms", "busy_ms", "idle_share", "groups_ms",
            "group_launches")}
        nums[cfg.name]["idle_share_unprofiled"] = idle
    return launches, nums


def _planted_flash_fault(first: int = 64):
    """The flash kernel's output with its head columns from ``first`` on
    zeroed (a kernel that dropped its last panel: 64 at head_dim 80, 128
    at 160): a context manager over ``models.transformer``'s
    flash_attention."""
    import contextlib
    from repro_torch.models import transformer as TF

    @contextlib.contextmanager
    def planted():
        real = TF.flash_attention

        def broken(q, k, v, **kw):
            o = real(q, k, v, **kw).clone()
            o[..., first:] = 0
            return o
        TF.flash_attention = broken
        try:
            yield
        finally:
            TF.flash_attention = real
    return planted()


def ssm_logit_readings(cfg, dev, c, params, seeds, fault: bool) -> dict:
    """The serve cell ``c``'s bf16 prefill (its batch of prompts from
    ``np.random.RandomState(seed)``) against the float32 prefill of the
    same weights (upcast; float32 caches), for each seed (``params``: the
    first seed's weights, the others drawn from theirs), and with
    ``fault`` the bf16 prefill with the planted flash fault: the max and
    the mean of |bf16 - float32| over the batch's last-token logits, in
    bf16 ulps of max |logit|."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.models import transformer as TF

    f32 = cfg.replace(dtype="float32", cache_dtype="float32")
    out = {}
    with torch.no_grad():
        for seed in seeds:
            if params is None:
                params = TF.init_params(cfg, seed, dev)
            prompt = torch.as_tensor(np.random.RandomState(seed).randint(
                0, cfg.vocab_size, size=(c.slots, c.prompt_len_max)),
                dtype=torch.int32, device=dev)
            lb = TF.prefill(params, cfg, prompt)[0].float()
            lf = None
            if fault:
                with _planted_flash_fault():
                    lf = TF.prefill(params, cfg, prompt)[0].float()
            p32 = T.tree_map(lambda x: x.float(), params)
            params = None
            torch.cuda.empty_cache()
            l32 = TF.prefill(p32, f32, prompt)[0].float()
            del p32
            torch.cuda.empty_cache()
            ulp = float(bf16_ulp(l32.abs().max()))
            check(bool(torch.isfinite(lb).all()),
                  f"{cfg.name} seed {seed}: non-finite logits")
            r = {"max": float((lb - l32).abs().max()) / ulp,
                 "mean": float((lb - l32).abs().mean()) / ulp,
                 "max_abs_logit": float(l32.abs().max())}
            if lf is not None:
                r["fault_max"] = float((lf - l32).abs().max()) / ulp
                r["fault_mean"] = float((lf - l32).abs().mean()) / ulp
            out[seed] = r
            del lb, lf, l32
    return out


def phase_ssm_serve(dev, randn):
    """(d) ``cell.SSM_SERVE_CELLS`` through ``launch.serve.run_fixed_batch``
    (the reference's loop for the configs its pool refuses): zamba2-2.7b
    at full depth (54 Mamba2 blocks, 9 firings of the shared attention at
    head_dim 80), 4 prompts of 1024 tokens, and xlstm-125m, 8 of 1024;
    32 greedy tokens each.  The launch counts read around the loop: one
    rmsnorm per norm of the path (ln1 and each block's gated norm, the
    shared block's ln1 and ln2, the final norm) per prefill and per
    decode step, and for zamba2 9 flash_attention launches, all on wgmma,
    in the one prefill; every token in the vocabulary.  zamba2's bf16
    prefill logits within ``SSM_LOGIT_ULPS`` bf16 ulps of max |logit| (the
    mean of |bf16 - float32|) of the float32 prefill of the same weights
    (upcast; float32 caches) on three seeds, and the planted flash fault
    outside it on each (``ssm_logit_readings``); xlstm's reported in the
    same units.  Every rmsnorm shape the loop gave the kernel (prefill rows
    slots x prompt length and decode rows slots, at d_model and each
    block's gated-norm width: zamba2 2560 and 5120, xlstm 768 and 1536)
    is recorded and held to the plain version in bf16 within one ulp
    (``rmsnorm_case``).  Reports prefill ms, decode tokens/s and the peak.
    Returns the launches by arch and the numbers."""
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.rmsnorm import ops as RO
    from repro_torch.launch import cell
    from repro_torch.launch.serve import run_fixed_batch
    from repro_torch.models import transformer as TF

    launches, nums = {}, {}
    for c in cell.SSM_SERVE_CELLS:
        cfg = cell.serve_model_config(c)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = TF.init_params(cfg, c.seed, dev)
        segs = TF.segments(cfg)
        n_attn = sum(n for b, n in segs if b.kind == "shared_attn")
        # two norms a block (ln1 and the block's gated norm, or the shared
        # block's ln1 and ln2) and the final norm
        n_norm = 2 * sum(n for _, n in segs) + 1
        B, Lp, new = c.slots, c.prompt_len_max, c.max_new
        log(f"  {cfg.name}: {cfg.n_layers} blocks, {TF.param_count(params):,}"
            f" params ({cfg.dtype}), fixed batch {B} x {Lp} tokens, {new} "
            f"greedy tokens")
        shapes, real = set(), RO.rmsnorm_kernel

        def recorded(x, w, eps):
            shapes.add((*x.shape, eps, x.dtype))
            return real(x, w, eps)
        torch.cuda.synchronize()
        KB.reset_launches()
        RO.rmsnorm_kernel = recorded
        try:
            toks, got = run_fixed_batch(cfg, params, B, Lp, new,
                                        seed=c.seed, device=dev)
        finally:
            RO.rmsnorm_kernel = real
        FIXED_TOKENS[cfg.name] = toks
        counts = {k: v for k, v in KB.LAUNCHES.items() if v}
        want = {"rmsnorm": n_norm * new}
        if n_attn:
            want["flash_attention"] = want["flash_attention_wgmma"] = n_attn
        check(counts == want, f"{cfg.name} fixed batch: launches {counts}, "
              f"expected {want} ({n_norm} norms a call, {n_attn} flash in "
              f"the prefill)")
        check(toks.shape == (B, new) and int(toks.min()) >= 0 and
              int(toks.max()) < cfg.vocab_size,
              f"{cfg.name}: tokens {toks.shape} out of range")
        launches[cfg.name] = counts
        got["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        widths = sorted({d for _, d, _, _ in shapes})
        check({n for n, _, _, _ in shapes} == {B * Lp, B} and
              all(dt == torch.bfloat16 for *_, dt in shapes),
              f"{cfg.name}: rmsnorm shapes {sorted(shapes, key=str)}")
        for rows_, d, eps, dt in sorted(shapes, key=lambda t: t[:2]):
            rmsnorm_case(randn, rows_, d, eps, dt)
        log(f"  {cfg.name}: rmsnorm at the loop's {len(shapes)} shapes "
            f"(rows {B * Lp} and {B}, d {widths}, bf16) within one bf16 "
            f"ulp of plain")
        got["rmsnorm_widths"] = widths
        read = ssm_logit_readings(cfg, dev, c, params,
                                  seeds=(c.seed, c.seed + 1, c.seed + 2),
                                  fault=bool(n_attn))
        del params
        torch.cuda.empty_cache()
        got["logit_readings"] = read
        for seed, r in read.items():
            planted = (f"; with the flash kernel's last 16 head columns "
                       f"zeroed {r['fault_max']:.1f} / {r['fault_mean']:.3f}"
                       if n_attn else "")
            log(f"  {cfg.name} seed {seed}: bf16 prefill logits from "
                f"float32, in bf16 ulps of max |logit| "
                f"({r['max_abs_logit']:.3f}): max {r['max']:.1f}, mean "
                f"{r['mean']:.3f}{planted}")
        log(f"  {cfg.name}: launches {counts}; prefill "
            f"{got['prefill_ms']:.1f} ms, decode "
            f"{got['decode_tokens_per_s']:.1f} tokens/s, peak "
            f"{got['peak_gib']:.2f} GiB")
        if n_attn:
            for seed, r in read.items():
                check(r["mean"] <= SSM_LOGIT_ULPS,
                      f"{cfg.name} seed {seed}: bf16 prefill mean "
                      f"{r['mean']} (max {r['max']}) bf16 ulps from float32 "
                      f"(gate {SSM_LOGIT_ULPS})")
                check(r["fault_mean"] > SSM_LOGIT_ULPS,
                      f"{cfg.name} seed {seed}: the planted flash fault "
                      f"lands mean {r['fault_mean']} (max {r['fault_max']}) "
                      f"ulps away, within the gate")
        nums[cfg.name] = got
        torch.cuda.empty_cache()
    return launches, nums


# ---------------------------------------------------------------------------
# Phase 14: the frontend configs (pixtral-12b, musicgen-medium)
# ---------------------------------------------------------------------------

#: phase 14's gates, set from readings on an H100 (PERF.md, section 6):
#: (c) a frames prefill against ``forward`` (plain attention) on the same
#: frames, both float32 over the bf16 weights: max |diff| of the
#: last-token logits within FRAMES_LOGIT_RTOL of max |logit| (read:
#: pixtral-12b 7.1e-6, musicgen-medium 3.3e-6);
FRAMES_LOGIT_RTOL = 2e-5
#: (c) pixtral's token prefill (bf16, the wgmma kernel at 160) against the
#: float32 prefill of the same weights (upcast): the mean of |bf16 -
#: float32| over the batch's last-token logits in bf16 ulps of max
#: |logit|, within PIXTRAL_LOGIT_ULPS on three seeds (read: 0.469-0.470,
#: max 2.8-3.0), while the flash output with head columns 128-159 zeroed
#: lands outside it on each (read: 29.8-30.0);
PIXTRAL_LOGIT_ULPS = 0.75
#: (d) the musicgen train cell's step-0 loss against the plain float32
#: forward of the same weights (upcast) on the same frames, relative: both
#: run float32 (the frames promote), so they differ by float32 sums (read:
#: 0 at 16 layers, 1.2e-7 at 8, at (4, 1) and (2, 2)); the faults of
#: FRONTEND_FAULTS land outside (at 16 layers GeGLU 3.4e-4, RoPE theta
#: 5.8e-4; at 8 2.6e-4 and 7.3e-5)
FRONTEND_LOSS_RTOL = 1e-5


def _upcast_in_place(tree):
    """Every leaf of a params tree (dicts and lists) to float32, one leaf
    at a time, each bf16 leaf freed as its copy replaces it: pixtral's
    25.6 GB of bf16 weights become 51.1 GB of float32 without both whole
    trees on the card at once."""
    import torch
    keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
    for k in list(keys):
        if isinstance(tree[k], (dict, list)):
            _upcast_in_place(tree[k])
        else:
            tree[k] = tree[k].float()
    torch.cuda.empty_cache()
    return tree


def _frames(cfg, B: int, T: int, seed: int, dev):
    """``B`` prompts of ``T`` frames from ``np.random.RandomState(seed)``,
    the fixed-batch loop's first draw (``launch.serve.fixed_batch_steps``)."""
    import numpy as np
    import torch
    return torch.as_tensor(np.random.RandomState(seed).randn(
        B, T, cfg.frontend_dim), dtype=torch.float32, device=dev)


def loop_ms(fn, calls: int = 50) -> float:
    """CUDA-event ms per call over ``calls`` back-to-back calls (one sync
    at the end): the device time per call wherever it exceeds the host's,
    a check on torch.profiler's ``device_ms`` (late in a smoke run one
    session's kernels summed to under half of this, PERF.md)."""
    import torch
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


def phase_frontend_flash(dev, randn, row):
    """(b) The flash kernel at head_dim 160, pixtral-12b's prefill, q
    [4, 1024, 32, 160] over 8 K/V heads, causal: bf16 on the wgmma kernel
    (head_dim 256's tiles, columns 160-255 zero-filled by TMA) within 3e-2
    of the plain version, float32 on the CUDA cores within 2e-5 (the
    frames path's); a row each (event ms, device ms under torch.profiler,
    host us, the bound, SDPA's times: cuDNN in bf16, its float32
    backend's beside the float32 row; ``loop_ms`` of the kernel and of
    SDPA beside them).  Then float32 at musicgen's prefill (q [8, 1024,
    24, 64]) within 2e-5."""
    import torch
    from repro_torch.launch import cell

    c = cell.PIXTRAL_SERVE_CELL
    cfg = cell.serve_model_config(c)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    B, T_ = c.slots, c.prompt_len_max
    for dt, name, kernel in (
            (torch.bfloat16, "flash_attention_hd160", "flash_kernel_wgmma"),
            (torch.float32, "flash_attention_hd160_f32", "flash_kernel")):
        kern, plain, lib, err, bound, by = flash_case(dev, randn, heads, T_,
                                                      None, dt, B)
        backend = sdpa_backend(lib)
        loops = {"loop_ms": loop_ms(kern), "library_loop_ms": loop_ms(lib)}
        log(f"  SDPA at q [{B}, {T_}, 32, 160] {str(dt)[6:]} causal ran: "
            f"{backend}; 50 back-to-back calls: {ms(loops['loop_ms'])} ms "
            f"a call, SDPA {ms(loops['library_loop_ms'])} ms")
        row(name, err, kern, plain, bound, by, lib, device=kernel,
            sdpa_backend=backend, **loops)
        del kern, plain, lib
        torch.cuda.empty_cache()
    m = cell.serve_model_config(cell.MUSICGEN_SERVE_CELL)
    flash_case(dev, randn, (m.n_heads, m.n_kv_heads, m.head_dim),
               cell.MUSICGEN_SERVE_CELL.prompt_len_max, None, torch.float32,
               cell.MUSICGEN_SERVE_CELL.slots)
    torch.cuda.empty_cache()


def pixtral_token_readings(cfg, dev, c, params, seeds) -> dict:
    """pixtral's token prefill (a text-only request: ``c.slots`` prompts of
    ``c.prompt_len_max`` tokens from ``np.random.RandomState(seed)``) in
    bf16, on the wgmma flash kernel at 160, against the float32 prefill of
    the same weights (upcast in place, float32 caches), for each seed
    (``params``: the first seed's weights, then drawn from each seed), and
    the bf16 prefill with ``_planted_flash_fault(128)``: max and mean of
    |bf16 - float32| over the last-token logits in bf16 ulps of max
    |logit|.
    Consumes ``params`` (the tree is emptied).  Returns ({seed:
    readings}, the first seed's bf16 prefill's launch counts)."""
    import numpy as np
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.models import transformer as TF

    f32 = cfg.replace(dtype="float32", cache_dtype="float32")
    out, counts = {}, None
    with torch.no_grad():
        for seed in seeds:
            if params is None:
                params = TF.init_params(cfg, seed, dev)
            prompt = torch.as_tensor(np.random.RandomState(seed).randint(
                0, cfg.vocab_size, size=(c.slots, c.prompt_len_max)),
                dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            KB.reset_launches()
            t0 = time.perf_counter()
            lb = TF.prefill(params, cfg, prompt)[0].float()
            torch.cuda.synchronize()
            dt_ms = (time.perf_counter() - t0) * 1e3
            if counts is None:
                counts = {k: v for k, v in KB.LAUNCHES.items() if v}
            with _planted_flash_fault(128):
                lf = TF.prefill(params, cfg, prompt)[0].float()
            p32 = _upcast_in_place(params)
            params = None
            l32 = TF.prefill(p32, f32, prompt)[0].float()
            p32.clear()         # the caller's reference to the tree too
            del p32
            torch.cuda.empty_cache()
            ulp = float(bf16_ulp(l32.abs().max()))
            check(bool(torch.isfinite(lb).all()),
                  f"{cfg.name} seed {seed}: non-finite token logits")
            out[seed] = {"max": float((lb - l32).abs().max()) / ulp,
                         "mean": float((lb - l32).abs().mean()) / ulp,
                         "fault_max": float((lf - l32).abs().max()) / ulp,
                         "fault_mean": float((lf - l32).abs().mean()) / ulp,
                         "max_abs_logit": float(l32.abs().max()),
                         "prefill_ms": dt_ms}
            del lb, lf, l32
    return out, counts


def phase_frontend_serve(dev, randn):
    """(c) ``cell.FRONTEND_SERVE_CELLS`` through
    ``launch.serve.run_fixed_batch`` on float32 frames (the prompt and each
    step's input), 32 greedy tokens: pixtral-12b at full depth (4 x 1024
    patches) and musicgen-medium (8 x 1024 frames).  The launch counts
    read around the loop: 2 rmsnorm a layer and the final norm per
    prefill and per decode step, one float32 flash a layer in the
    prefill (the CUDA-core kernel: at head_dim 160 for pixtral, 64 for
    musicgen), no wgmma launch; every token in the vocabulary; each
    rmsnorm shape the loop gave the kernel (float32 rows, the bf16 gain
    cast) held to the plain version within rtol 1e-6.  The frames
    prefill's last-token logits within ``FRAMES_LOGIT_RTOL`` of max
    |logit| of ``forward``'s (plain attention) on the same frames.  Then
    pixtral's token prefill on the wgmma kernel at 160: its launches, and
    |bf16 - float32| within ``PIXTRAL_LOGIT_ULPS`` on three seeds with the
    planted panel fault's reading beside it (``pixtral_token_readings``).
    Reports prefill ms, decode tokens/s and the peak.  Returns the
    launches by path and the numbers."""
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.rmsnorm import ops as RO
    from repro_torch.launch import cell
    from repro_torch.launch.serve import run_fixed_batch
    from repro_torch.models import transformer as TF

    launches, nums = {}, {}
    for c in cell.FRONTEND_SERVE_CELLS:
        cfg = cell.serve_model_config(c)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_init = time.perf_counter()
        params = TF.init_params(cfg, c.seed, dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t_init
        L = cfg.n_layers
        n_norm = 2 * L + 1
        B, Lp, new = c.slots, c.prompt_len_max, c.max_new
        log(f"  {cfg.name}: {L} layers, {TF.param_count(params):,} params "
            f"({cfg.dtype}, drawn in {t_init:.1f} s), fixed batch {B} x "
            f"{Lp} frames of {cfg.frontend_dim}, {new} greedy tokens")
        shapes, real = set(), RO.rmsnorm_kernel

        def recorded(x, w, eps):
            shapes.add((*x.shape, eps, x.dtype, w.dtype))
            return real(x, w, eps)
        torch.cuda.synchronize()
        KB.reset_launches()
        RO.rmsnorm_kernel = recorded
        try:
            toks, got = run_fixed_batch(cfg, params, B, Lp, new,
                                        seed=c.seed, device=dev)
        finally:
            RO.rmsnorm_kernel = real
        FIXED_TOKENS[cfg.name] = toks
        counts = {k: v for k, v in KB.LAUNCHES.items() if v}
        want = {"rmsnorm": n_norm * new, "flash_attention": L}
        check(counts == want, f"{cfg.name} fixed batch on frames: launches "
              f"{counts}, expected {want} (float32 flash on the CUDA cores)")
        check(toks.shape == (B, new) and int(toks.min()) >= 0 and
              int(toks.max()) < cfg.vocab_size,
              f"{cfg.name}: tokens {toks.shape} out of range")
        got["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        check({n for n, *_ in shapes} == {B * Lp, B} and
              all(dt == wdt == torch.float32 for *_, dt, wdt in shapes),
              f"{cfg.name}: rmsnorm shapes {sorted(shapes, key=str)}")
        for rows_, d, eps, dt, _ in sorted(shapes, key=lambda t: t[:2]):
            rmsnorm_case(randn, rows_, d, eps, dt)
        got["rmsnorm_shapes"] = sorted([r, d] for r, d, *_ in shapes)
        # the frames prefill against forward's plain attention
        frames = _frames(cfg, B, Lp, c.seed, dev)
        with torch.no_grad():
            lp = TF.prefill(params, cfg, frames)[0][:, 0].float()
            lfw = TF.forward(params, cfg, frames)[0][:, -1].clone()
        del frames
        torch.cuda.empty_cache()
        check(lp.dtype == lfw.dtype == torch.float32 and
              bool(torch.isfinite(lp).all()),
              f"{cfg.name}: frames prefill logits not finite float32")
        rel = float((lp - lfw).abs().max() / lfw.abs().max())
        got["frames_prefill_vs_forward"] = rel
        got["frames_max_abs_logit"] = float(lfw.abs().max())
        del lp, lfw
        log(f"  {cfg.name}: launches {counts}; prefill "
            f"{got['prefill_ms']:.1f} ms, decode "
            f"{got['decode_tokens_per_s']:.1f} tokens/s, peak "
            f"{got['peak_gib']:.2f} GiB; rmsnorm at the loop's "
            f"{len(shapes)} shapes (float32) within rtol 1e-6 of plain; the "
            f"frames prefill's last-token logits {rel:.2e} of max |logit| "
            f"({got['frames_max_abs_logit']:.3f}) from forward's (plain "
            f"attention; gate {FRAMES_LOGIT_RTOL})")
        check(rel <= FRAMES_LOGIT_RTOL,
              f"{cfg.name}: frames prefill {rel} of max |logit| from forward")
        launches[f"{cfg.name} (frames)"] = counts
        if cfg.name == "pixtral-12b":
            seeds = (c.seed, c.seed + 1, c.seed + 2)
            read, tc = pixtral_token_readings(cfg, dev, c, params, seeds)
            params = None
            want = {"rmsnorm": n_norm, "flash_attention": L,
                    "flash_attention_wgmma": L}
            check(tc == want, f"{cfg.name} token prefill: launches {tc}, "
                  f"expected {want} (bf16 flash on wgmma)")
            launches[f"{cfg.name} (tokens)"] = tc
            got["token_readings"] = read
            for seed, r in read.items():
                log(f"  {cfg.name} seed {seed}: token prefill "
                    f"{r['prefill_ms']:.1f} ms; bf16 logits from float32, "
                    f"in bf16 ulps of max |logit| ({r['max_abs_logit']:.3f})"
                    f": max {r['max']:.1f}, mean {r['mean']:.3f}; with "
                    f"head columns 128-159 zeroed {r['fault_max']:.1f} / "
                    f"{r['fault_mean']:.3f}")
            for seed, r in read.items():
                check(r["mean"] <= PIXTRAL_LOGIT_ULPS,
                      f"{cfg.name} seed {seed}: bf16 token prefill mean "
                      f"{r['mean']} (max {r['max']}) bf16 ulps from float32 "
                      f"(gate {PIXTRAL_LOGIT_ULPS})")
                check(r["fault_mean"] > PIXTRAL_LOGIT_ULPS,
                      f"{cfg.name} seed {seed}: the planted panel fault "
                      f"lands mean {r['fault_mean']} ulps away, within the "
                      f"gate")
        del params
        torch.cuda.empty_cache()
        nums[cfg.name] = got
    return launches, nums


#: forward faults of the train cell that its loss gate must see: (name,
#: fault(cfg, params) -> (cfg, params))
FRONTEND_FAULTS = {"GeGLU for SwiGLU": _replace_cfg(act="geglu"),
                   "RoPE theta 1e6 for 1e4": _replace_cfg(rope_theta=1e6)}


def phase_frontend_train(dev):
    """(d) ``cell.FRONTEND_TRAIN_CELL``: musicgen-medium at full width cut
    to 16 of 48 layers, p = 4, batch 8 x 1024 float32 frames of 128, bf16,
    float32 wire, at (dp, tp) = (4, 1) and (2, 2) (megatron_sp, the
    replicated frontend_proj on each TP rank's sequence shard): two
    pallas_fused steps and, at (4, 1), one bine step from the same start,
    rank 0's params after the first bitwise equal; rs_step and ag_step
    launched; the step-0 loss within ``FRONTEND_LOSS_RTOL`` of the plain
    float32 forward of the same weights (upcast) on the same frames, as is
    the bf16 model's own forward, while each fault of ``FRONTEND_FAULTS``
    lands outside.  Warm step ms, tokens/s, peak, and the idle share from
    ``launch/profile_step.py`` (the step's unprofiled wall time against
    its profiled busy time).  Returns the launches by mesh and the
    numbers."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.launch import profile_step as PS
    from repro_torch.models import transformer as TF

    tc = cell.FRONTEND_TRAIN_CELL
    cfg, dcfg, run = train_runs(dev, tc.model_config())
    tokens = dcfg.global_batch * dcfg.seq_len
    n_params = TF.param_count(TF.param_shapes(cfg))
    log(f"  {cfg.name}: {cfg.n_layers} layers, {n_params:,} params, d_model "
        f"{cfg.d_model}; batch {dcfg.global_batch}x{dcfg.seq_len} frames of "
        f"{dcfg.frontend_dim}")
    sound, faulty = train_loss_readings(cfg, dcfg, dev, (0,),
                                        FRONTEND_FAULTS)
    b16, ref, tg0 = sound[0]
    log(f"  {cfg.name} seed 0: bf16 forward loss {b16:.6f}, plain float32 "
        f"{ref:.6f}, rel gap {(b16 - ref) / ref:+.2e}; token gap {tg0:.6f}")
    for name, (loss, tg) in faulty.items():
        log(f"  {cfg.name} seed 0, {name}: loss {loss:.6f}, rel gap "
            f"{(loss - ref) / ref:+.2e}; token gap {tg:.6f}")
        check(abs(loss - ref) > FRONTEND_LOSS_RTOL * abs(ref),
              f"{cfg.name} with {name}: loss {loss} within "
              f"{FRONTEND_LOSS_RTOL} of the sound float32 loss {ref}; the "
              f"gate cannot see that fault")
    check(abs(b16 - ref) <= FRONTEND_LOSS_RTOL * abs(ref),
          f"{cfg.name}: bf16 forward loss {b16} vs float32 {ref}")
    launches, nums = {}, {"n_layers": cfg.n_layers, "params": n_params,
                          "bf16_forward_loss": b16, "f32_loss": ref,
                          "token_gap": tg0, "fault_losses": faulty}
    for dp, tp in tc.meshes:
        mesh = f"{dp},{tp}"
        tag = f"{cfg.name} ({mesh}) pallas_fused/float32"
        counts, losses, times, peak, first = run(
            cell.train_config("pallas_fused", "float32"), dp, 2, tag, tp=tp,
            digest=True)
        launches[mesh] = {k: counts[k] for k in ("rs_step", "ag_step")}
        for k, v in launches[mesh].items():
            check(v > 0, f"the {cfg.name} ({mesh}) train step did not "
                  f"launch {k}")
        check(abs(losses[0] - ref) <= FRONTEND_LOSS_RTOL * abs(ref),
              f"{cfg.name} ({mesh}) step-0 loss {losses[0]} vs the plain "
              f"float32 loss {ref} (rel {FRONTEND_LOSS_RTOL})")
        rec = {"losses": losses, "loss_hex": losses[0].hex(),
               "gnorms": run.gnorms[tag], "step_ms": [t * 1e3 for t in times],
               "peak_gib": peak, "params_sha256": run.digests[tag]}
        if tp == 1:
            cb, lb, tb, _, bine_first = run(
                cell.train_config("bine", "float32"), dp, 1,
                f"{cfg.name} ({mesh}) bine/float32")
            check(sum(cb.values()) == 0,
                  f"the bine path launched kernels: {cb}")
            check(all(torch.equal(a, b) for a, b in zip(first, bine_first)),
                  f"{cfg.name}: bine and pallas_fused params differ after "
                  f"one float32 step")
            check(lb[0] == losses[0], f"{cfg.name}: bine loss {lb[0]} vs "
                  f"pallas_fused {losses[0]}")
            del bine_first
        del first
        torch.cuda.empty_cache()
        prof = PS.profile(cfg, "pallas_fused", "float32", dev, mesh)
        torch.cuda.empty_cache()
        warm = times[1]
        idle = 1 - prof["busy_ms"] / (warm * 1e3)
        log(f"  {cfg.name} ({mesh}): loss {losses[0]:.6f}, plain float32 "
            f"{ref:.6f} (rel gap {(losses[0] - ref) / ref:+.2e}); warm step "
            f"{warm * 1e3:.1f} ms ({tokens / warm:.0f} tokens/s), peak "
            f"{peak:.1f} GiB; profiled {prof['wall_ms']:.1f} ms wall, "
            f"{prof['busy_ms']:.1f} ms busy: idle share {idle:.3f} of the "
            f"unprofiled step ({prof['idle_share']:.3f} under the profiler)"
            + ("; bine == pallas_fused bitwise" if tp == 1 else ""))
        rec.update({"warm_step_ms": warm * 1e3, "tokens_per_s": tokens / warm,
                    "idle_share_unprofiled": idle,
                    "profile": {k: prof[k] for k in (
                        "wall_ms", "busy_ms", "idle_share", "groups_ms",
                        "group_launches")}})
        nums[mesh] = rec
    return launches, nums


# ---------------------------------------------------------------------------
# Phase 15: remat and MoE serving (queue A item 5e)
# ---------------------------------------------------------------------------

def phase_remat(dev):
    """(a) ``cfg.remat`` on the train path: the phi4-mini train cell (p =
    4) and the MoE cell at (2, 2) (expert parallelism), each trained two
    pallas_fused float32-wire steps from the same start with remat off
    and on: the losses (``float.hex``) and every rank's params after the
    second step (sha256) bitwise equal; the MoE cell's obs record the same
    both ways, its 12 ``bine`` all_to_all calls (a layer's dispatch,
    block ids and combine, 2 DP ranks, 2 steps: the recompute records
    none); the bytes autograd saves for one DP rank's loss
    (``profile_step.saved_for_backward``) fewer with remat; step ms (the
    warm one), peak GiB both ways.  Returns the launches by path and the
    numbers."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.launch import profile_step as PS
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.obs import metrics as OM
    from repro_torch.train.data import make_batch

    launches, nums = {}, {}
    for arch, base_cfg, dp, tp in (
            ("phi4-mini-3.8b", cell.model_config(), cell.N_DP, 1),
            ("mixtral-8x7b", cell.MOE_TRAIN_CELL.model_config(), 2, 2)):
        got = {}
        for remat in (False, True):
            cfg = base_cfg.replace(remat=remat)
            _, dcfg, run = train_runs(dev, cfg)
            tag = f"{arch} ({dp}, {tp}) remat {'on' if remat else 'off'}"
            OM.get_registry().reset()
            counts, losses, times, peak, _ = run(
                cell.train_config("pallas_fused", "float32"), dp, 2, tag,
                tp=tp, digest=True)
            a2a = a2a_record()
            params = TF.init_params(cfg, 0, dev)
            if tp > 1:
                params = SH.shard_params(cfg, params, tp)
            rows = dcfg.global_batch // dp
            batch = {k: torch.as_tensor(v[:rows], device=dev)
                     for k, v in make_batch(dcfg, 0).items()}
            saved = PS.saved_for_backward(cfg, params, batch, tp)
            del params, batch
            torch.cuda.empty_cache()
            launches[tag] = {k: counts[k] for k in ("rs_step", "ag_step")}
            got["on" if remat else "off"] = {
                "losses_hex": [x.hex() for x in losses],
                "params_sha256": run.digests[tag],
                "step_ms": [t * 1e3 for t in times],
                "warm_step_ms": times[1] * 1e3, "peak_gib": peak,
                "saved_for_backward_gb": saved / 1e9,
                "all_to_all": {b: list(v) for b, v in a2a.items()}}
            log(f"  {tag}: losses {[round(x, 6) for x in losses]}, warm "
                f"step {times[1] * 1e3:.1f} ms, peak {peak:.2f} GiB, "
                f"saved for backward (one DP rank) {saved / 1e9:.3f} GB, "
                f"params sha256 {run.digests[tag][:8]}")
        off, on = got["off"], got["on"]
        check(on["losses_hex"] == off["losses_hex"] and
              on["params_sha256"] == off["params_sha256"],
              f"{arch}: remat on and off differ: losses "
              f"{on['losses_hex']} / {off['losses_hex']}, params "
              f"{on['params_sha256'][:8]} / {off['params_sha256'][:8]}")
        check(on["saved_for_backward_gb"] < off["saved_for_backward_gb"],
              f"{arch}: remat saves {on['saved_for_backward_gb']} GB for "
              f"the backward, without {off['saved_for_backward_gb']}")
        check(on["all_to_all"] == off["all_to_all"],
              f"{arch}: the obs record differs with remat: "
              f"{on['all_to_all']} / {off['all_to_all']}")
        if tp > 1:
            want = 3 * dp * base_cfg.n_layers * 2
            calls = sum(v[0] for v in on["all_to_all"].values())
            check(set(on["all_to_all"]) == {"bine"} and calls == want,
                  f"{arch}: EP all_to_all record {on['all_to_all']}, "
                  f"expected {want} bine calls both ways")
        log(f"  {arch} ({dp}, {tp}): remat on == off, bitwise (losses and "
            f"params after 2 steps); warm step {on['warm_step_ms']:.1f} / "
            f"{off['warm_step_ms']:.1f} ms on / off, peak "
            f"{on['peak_gib']:.2f} / {off['peak_gib']:.2f} GiB, saved for "
            f"backward {on['saved_for_backward_gb']:.3f} / "
            f"{off['saved_for_backward_gb']:.3f} GB"
            + (f"; all_to_all {on['all_to_all']}" if tp > 1 else ""))
        nums[f"{arch} ({dp},{tp})"] = got
    return launches, nums


#: 15b's gate: mixtral-8x7b x8's bf16 prefill (the fixed-batch loop's
#: prompts) against a plain float32 ``forward`` of the same weights
#: (upcast) on the same tokens: the mean of |bf16 - float32| over the
#: batch's last-token logits in bf16 ulps of max |logit|, within
#: MOE_LOGIT_ULPS on three seeds, while each fault of ``MOE_SERVE_FAULTS``
#: lands outside it on each.  Set from readings on an H100 (PERF.md,
#: section 6): sound 0.95, 1.27, 0.59 (max 3.9-14.7: a routing flip moves
#: one token's logits), the gates not renormalised 15.6-16.5, one of two
#: expert blocks 19.7-21.0; about 1.5x the largest sound reading
MOE_LOGIT_ULPS = 2.0


def _unnormalised_route(real):
    """The router with its top-k gates left as softmax probabilities, not
    renormalised to sum to 1 (a fault)."""
    def route(router_w, cfg, xt):
        import torch
        _, gate_idx, aux = real(router_w, cfg, xt)
        probs = torch.softmax(torch.matmul(xt, router_w).to(torch.float32),
                              dim=-1)
        return torch.gather(probs, -1, gate_idx), gate_idx, aux
    return route


def _first_block_only(real):
    """The dense MoE path with only the first of each expert's
    ``ep_blocks`` column blocks summed (each later block's ``wo`` zeroed:
    a fault)."""
    def dense(p, cfg, x):
        E, nb = cfg.n_experts, cfg.ep_blocks
        wo = p["wo"].clone()
        wo.view(E, nb, *wo.shape[1:])[:, 1:] = 0
        return real(dict(p, wo=wo), cfg, x)
    return dense


#: forward faults 15b's gate must see: (name, (attribute of models.moe,
#: its replacement given the real one))
MOE_SERVE_FAULTS = {
    "top-2 gates not renormalised": ("_route", _unnormalised_route),
    "one of two expert blocks summed": ("_moe_dense", _first_block_only)}


def moe_logit_readings(cfg, dev, c, params, seeds) -> dict:
    """The MoE serve cell ``c``'s bf16 prefill (``c.slots`` prompts of
    ``c.prompt_len_max`` tokens from ``np.random.RandomState(seed)``, the
    fixed-batch loop's draw) against a plain float32 ``forward`` (plain
    attention and norms) of the same weights (upcast in place) on the
    same tokens, for each seed (``params``: the first seed's weights,
    then drawn from each seed), and each fault of ``MOE_SERVE_FAULTS`` in
    bf16: max and mean of |bf16 - float32| over the last-token logits in
    bf16 ulps of max |logit|.  Consumes ``params``.  Returns {seed:
    readings}."""
    import numpy as np
    import torch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TF

    f32 = cfg.replace(dtype="float32")
    out = {}
    with torch.no_grad():
        for seed in seeds:
            if params is None:
                params = TF.init_params(cfg, seed, dev)
            prompt = torch.as_tensor(np.random.RandomState(seed).randint(
                0, cfg.vocab_size, size=(c.slots, c.prompt_len_max)),
                dtype=torch.int32, device=dev)
            lb = TF.prefill(params, cfg, prompt)[0][:, 0].float()
            faulty = {}
            for name, (attr, make) in MOE_SERVE_FAULTS.items():
                real = getattr(M, attr)
                setattr(M, attr, make(real))
                try:
                    faulty[name] = TF.prefill(params, cfg,
                                              prompt)[0][:, 0].float()
                finally:
                    setattr(M, attr, real)
            p32 = _upcast_in_place(params)
            params = None
            l32 = TF.forward(p32, f32, prompt)[0][:, -1].clone()
            p32.clear()
            del p32
            torch.cuda.empty_cache()
            ulp = float(bf16_ulp(l32.abs().max()))
            check(bool(torch.isfinite(lb).all()),
                  f"{cfg.name} seed {seed}: non-finite prefill logits")
            r = {"max": float((lb - l32).abs().max()) / ulp,
                 "mean": float((lb - l32).abs().mean()) / ulp,
                 "max_abs_logit": float(l32.abs().max())}
            for name, lf in faulty.items():
                r[name] = float((lf - l32).abs().mean()) / ulp
            out[seed] = r
            del lb, faulty, l32
            torch.cuda.empty_cache()
    return out


def phase_moe_serve(dev, randn):
    """(b) ``cell.MOE_SERVE_CELL`` through ``launch.serve.run_fixed_batch``
    (the reference's loop: its pool refuses MoE): mixtral-8x7b at full
    width cut to 8 layers, 4 prompts of 1024 tokens, 32 greedy tokens.
    The launch counts read around the loop: 2 rmsnorm a layer and the
    final norm per prefill and per decode step, one flash_attention a
    layer in the prefill, all on wgmma (bf16 at head_dim 128); every token
    in the vocabulary; the capacity dispatch's drops counted, prefill and
    decode.  Each rmsnorm shape (rows 4096 and 4 at d 4096, bf16) held to
    the plain version within one bf16 ulp and each flash shape the
    prefill gave the kernel to its plain version (``flash_case``).  The
    bf16 prefill's last-token logits within ``MOE_LOGIT_ULPS`` of a plain
    float32 ``forward`` on three seeds, the faults of ``MOE_SERVE_FAULTS``
    outside (``moe_logit_readings``).  Reports prefill ms, decode
    tokens/s and the peak.  Returns the launches and the numbers."""
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.rmsnorm import ops as RO
    from repro_torch.launch import cell
    from repro_torch.launch.serve import run_fixed_batch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TF

    c = cell.MOE_SERVE_CELL
    cfg = cell.serve_model_config(c)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    params = TF.init_params(cfg, c.seed, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    L = cfg.n_layers
    n_norm = 2 * L + 1
    B, Lp, new = c.slots, c.prompt_len_max, c.max_new
    log(f"  {cfg.name}: {L} of 32 layers, {TF.param_count(params):,} params "
        f"({cfg.dtype}, drawn in {t_init:.1f} s), {cfg.n_experts} experts x "
        f"{cfg.ep_blocks} blocks, top-{cfg.top_k}, window {cfg.window}; "
        f"fixed batch {B} x {Lp} tokens, {new} greedy tokens")
    norms, flashes, drops = set(), set(), []
    real_norm, real_flash, real_slots = (RO.rmsnorm_kernel,
                                         TF.flash_attention, M._slots)

    def norm(x, w, eps):
        norms.add((*x.shape, eps, x.dtype))
        return real_norm(x, w, eps)

    def flash(q, k, v, **kw):
        flashes.add((tuple(q.shape), tuple(k.shape), kw.get("window"),
                     q.dtype))
        return real_flash(q, k, v, **kw)

    def slots(dest, n_dest, cap):
        out = real_slots(dest, n_dest, cap)
        drops.append((dest.numel(), cap, out[1]))
        return out
    torch.cuda.synchronize()
    KB.reset_launches()
    RO.rmsnorm_kernel, TF.flash_attention, M._slots = norm, flash, slots
    try:
        toks, got = run_fixed_batch(cfg, params, B, Lp, new, seed=c.seed,
                                    device=dev)
    finally:
        RO.rmsnorm_kernel, TF.flash_attention, M._slots = (
            real_norm, real_flash, real_slots)
    FIXED_TOKENS[cfg.name] = toks
    counts = {k: v for k, v in KB.LAUNCHES.items() if v}
    want = {"rmsnorm": n_norm * new, "flash_attention": L,
            "flash_attention_wgmma": L}
    check(counts == want, f"{cfg.name} fixed batch: launches {counts}, "
          f"expected {want} ({n_norm} norms a call, {L} flash on wgmma in "
          f"the prefill)")
    check(toks.shape == (B, new) and int(toks.min()) >= 0 and
          int(toks.max()) < cfg.vocab_size,
          f"{cfg.name}: tokens {toks.shape} out of range")
    got["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    got["init_s"] = t_init
    # the dispatches: L in the prefill (B * Lp tokens), L a decode step
    n_items = {n for n, _, _ in drops}
    check(len(drops) == L * new and n_items == {B * Lp * cfg.top_k,
                                                 B * cfg.top_k},
          f"{cfg.name}: dispatches {[(n, cap) for n, cap, _ in drops]}")
    pre = [int((~k).sum()) for n, _, k in drops if n == B * Lp * cfg.top_k]
    dec = [int((~k).sum()) for n, _, k in drops if n == B * cfg.top_k]
    got["dropped_prefill"], got["dropped_decode"] = sum(pre), sum(dec)
    got["slots_an_expert"] = sorted({cap for _, cap, _ in drops})
    del drops
    check({n for n, *_ in norms} == {B * Lp, B} and
          all(dt == torch.bfloat16 for *_, dt in norms),
          f"{cfg.name}: rmsnorm shapes {sorted(norms, key=str)}")
    for rows_, d, eps, dt in sorted(norms, key=lambda t: t[:2]):
        rmsnorm_case(randn, rows_, d, eps, dt)
    got["rmsnorm_shapes"] = sorted([r, d] for r, d, *_ in norms)
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    check(flashes == {((B, Lp, nh, hd), (B, Lp, nkv, hd), cfg.window,
                       torch.bfloat16)},
          f"{cfg.name}: flash shapes {flashes}")
    _, _, _, ferr, fbound, _ = flash_case(dev, randn, (nh, nkv, hd), Lp,
                                          cfg.window, torch.bfloat16, b=B)
    got["flash_max_abs_err"], got["flash_bound_ms"] = ferr, fbound
    log(f"  {cfg.name}: launches {counts}; prefill {got['prefill_ms']:.1f} "
        f"ms, decode {got['decode_tokens_per_s']:.1f} tokens/s, peak "
        f"{got['peak_gib']:.2f} GiB; slots an expert "
        f"{got['slots_an_expert']}, dropped (token, choice) items: prefill "
        f"{got['dropped_prefill']} of {L * B * Lp * cfg.top_k}, decode "
        f"{got['dropped_decode']} of {L * (new - 1) * B * cfg.top_k}; "
        f"rmsnorm at the loop's {len(norms)} shapes within one bf16 ulp of "
        f"plain, flash at the prefill's shape within 3e-2")
    seeds = (c.seed, c.seed + 1, c.seed + 2)
    read = moe_logit_readings(cfg, dev, c, params, seeds)
    params = None
    torch.cuda.empty_cache()
    got["logit_readings"] = read
    for seed, r in read.items():
        log(f"  {cfg.name} seed {seed}: bf16 prefill logits from a plain "
            f"float32 forward, in bf16 ulps of max |logit| "
            f"({r['max_abs_logit']:.3f}): max {r['max']:.1f}, mean "
            f"{r['mean']:.3f}; " + ", ".join(
                f"{name} {r[name]:.3f}" for name in MOE_SERVE_FAULTS))
    for seed, r in read.items():
        check(r["mean"] <= MOE_LOGIT_ULPS,
              f"{cfg.name} seed {seed}: bf16 prefill mean {r['mean']} (max "
              f"{r['max']}) bf16 ulps from float32 (gate {MOE_LOGIT_ULPS})")
        for name in MOE_SERVE_FAULTS:
            check(r[name] > MOE_LOGIT_ULPS,
                  f"{cfg.name} seed {seed}: the fault '{name}' lands mean "
                  f"{r[name]} ulps away, within the gate")
    return {f"{cfg.name} (fixed batch)": counts}, got


# ---------------------------------------------------------------------------
# Phase 16: the recurrent blocks and the fixed-batch loop over TP ranks
# ---------------------------------------------------------------------------

#: the one-rank fixed-batch loops' greedy tokens (phases 13-15), by arch,
#: which phase 16's loops over TP ranks are compared with
FIXED_TOKENS = {}

#: phase 16's serve gates: the mean over the batch's last-token logits of
#: |TP prefill - one-rank prefill| (same weights and prompt), in bf16 ulps
#: of max |logit|, per arch, on three seeds; each planted fault must land
#: outside on each.  Set at about 1.5x the largest sound reading of the
#: three seeds on an H100 (PERF.md, section 6): zamba2 2.01-2.08 (bf16;
#: its one-rank bf16 prefill reads 2.1 from float32, phase 13; faults
#: 14.4-14.9 and 3.87-3.98), mixtral 7.73-13.3 (EP drops other tokens than
#: the dense path; the flash fault 29.2-30.7), musicgen 1.07e-4-2.23e-4
#: (frames: float32 end to end; the flash fault 24.2-49.2)
FIXED_TP_ULPS = {"zamba2-2.7b": 3.1, "mixtral-8x7b": 20.0,
                 "musicgen-medium": 3.4e-4}


def _split_norm_fault():
    """A fault: every cross-rank norm over the rank's own share of its row
    (the psum of the sums of squares dropped)."""
    import contextlib
    from repro_torch.models import ssm as S

    @contextlib.contextmanager
    def planted():
        real = S.split_rmsnorm
        S.split_rmsnorm = lambda y, g, eps, n: S.L.rmsnorm(y, g, eps)
        try:
            yield
        finally:
            S.split_rmsnorm = real
    return planted()


def _own_block_fault():
    """A fault: under pure_sp each TP rank keeps the other end's sequence
    block of its whole-sequence recurrent output (rank t block n-1-t),
    not its own."""
    import contextlib
    import torch
    from repro_torch.models import transformer as TF

    def swapped(self, x):
        if not self.sp:
            return x
        k = x.shape[2] // self.n
        return torch.stack([x[t].narrow(1, (self.n - 1 - t) * k, k)
                            for t in range(self.n)])

    @contextlib.contextmanager
    def planted():
        real = TF._TP.own
        TF._TP.own = swapped
        try:
            yield
        finally:
            TF._TP.own = real
    return planted()


#: phase 16's TP-path faults, per arch: name -> context manager factory
TP_FAULTS = {
    "zamba2-2.7b": {"cross-rank norms without their psum": _split_norm_fault},
    "xlstm-125m": {"each rank keeping the other's sequence block":
                   _own_block_fault},
    "mixtral-8x7b": {},
    "musicgen-medium": {},
}


def _replicated_sum_fault():
    """A gradient fault: the TP sum of the replicated leaves' gradients
    dropped (``train.step._tp_sum_replicated``), so each TP rank updates
    its copy with its own share of the gradient."""
    import contextlib
    from repro_torch.train import step as SP

    @contextlib.contextmanager
    def planted():
        real = SP._tp_sum_replicated
        SP._tp_sum_replicated = lambda grads, mds: grads
        try:
            yield
        finally:
            SP._tp_sum_replicated = real
    return planted()


def _split_norm_backward_fault():
    """A gradient fault: every cross-rank norm's forward as it is, its
    backward through the rank's own sum of squares only (the psum's
    backward dropped)."""
    import contextlib
    import torch
    from repro_torch.collectives import stacked
    from repro_torch.models import ssm as S

    def norm(y, g, eps, n):
        yf = y.to(torch.float32)
        ss = (yf * yf).sum(dim=-1, keepdim=True)
        whole = stacked.psum(ss.unflatten(0, (n, -1))).flatten(0, 1)
        ss = ss + (whole - ss).detach()
        out = yf * torch.rsqrt(ss / (n * y.shape[-1]) + eps)
        return (out * (1.0 + g.to(torch.float32))).to(y.dtype)

    @contextlib.contextmanager
    def planted():
        real = S.split_rmsnorm
        S.split_rmsnorm = norm
        try:
            yield
        finally:
            S.split_rmsnorm = real
    return planted()


#: 16b's gradient faults (zamba2 at (2, 2)), each outside
#: ``SSM_TP_GNORM_RTOL``: name -> context manager factory
TP_GRAD_FAULTS = {
    "replicated leaves' TP sum dropped": _replicated_sum_fault,
    "cross-rank norms' backward without their psum":
        _split_norm_backward_fault}

#: 16b's gradient gate: zamba2 x12's grad norm at (2, 2) against phase
#: 13's p = 4 run of the same cell (same weights and batches), relative,
#: at steps 0 and 1.  Set at about 1.5x the larger reading on an H100
#: (PERF.md, section 6): 1.32e-4 and 7.8e-7; the faults read 6.6e-3 and
#: 1.47e-2
SSM_TP_GNORM_RTOL = 2e-4


def phase_tp_small(dev):
    """16a: reduced zamba2-2.7b and xlstm-125m at d_model 1024
    (megatron_sp: Mamba2's heads, mLSTM's heads and sLSTM's units split
    over the ranks) and xlstm-125m at 64 (pure_sp), float32 with float32
    caches, on the card: the TP forward at tp 2 against the one-rank
    forward, and ``prefill_tp`` of 64 tokens with 3 ``decode_step_tp``
    steps (the fixed-batch layout, ``engine.cache_layout``) against
    ``prefill`` and ``decode_step``, all within 1e-4 of max |logit|, 13a's
    bound (xlstm at 1024 read 2.1e-5 on the CPU: its exponential gates
    amplify the ranks' other summation order)."""
    import numpy as np
    import torch
    from repro_torch.configs import base
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as E
    from repro_torch.serve import kvcache as KV

    for arch, kw in (("zamba2-2.7b", dict(d_model=1024)),
                     ("xlstm-125m", dict(d_model=1024)),
                     ("xlstm-125m", {})):
        cfg = base.reduced(base.get_config(arch)).replace(
            dtype="float32", cache_dtype="float32", **kw)
        params = TF.init_params(cfg, 0, dev)
        tok = torch.as_tensor(np.random.RandomState(5).randint(
            0, cfg.vocab_size, (2, 67)), dtype=torch.int32, device=dev)
        lay = E.cache_layout(cfg, 2, 64, 1, 2)
        errs = []
        with torch.no_grad():
            ref = TF.forward(params, cfg, tok[:, :64])[0]
            got = TF.forward(SH.shard_params(cfg, params, 2), cfg,
                             tok[:, :64], n_model=2)[0]
            got = TF.vocab_logits(got, cfg.vocab_size)
            errs.append(float((got - ref).abs().max() / ref.abs().max()))
            lg, st1 = TF.prefill(params, cfg, tok[:, :64])
            blocks, g = TF.prefill_tp(params, cfg, tok[:, :64], 2)
            st = KV.state_from_global(cfg, g, lay)
            pairs = [(TF.vocab_logits(blocks, cfg.vocab_size), lg)]
            for t in range(3):
                x = tok[:, 64 + t:65 + t]
                lg, st1 = TF.decode_step(params, cfg, st1, x)
                blocks, st = TF.decode_step_tp(params, cfg, st, x, lay)
                pairs.append((TF.vocab_logits(blocks, cfg.vocab_size), lg))
            errs += [float((a - b).abs().max() / b.abs().max())
                     for a, b in pairs]
        what = (f"small TP {arch} d_model {cfg.d_model} "
                f"({SH.strategy(cfg, 2)})")
        check(max(errs) <= 1e-4, f"{what}: forward / prefill / decode "
              f"logits {errs} of max |logit| from one rank (bound 1e-4)")
        log(f"  {what}: forward, prefill + 3 decode logits at tp 2 within "
            f"{max(errs):.2e} of max |logit| of one rank (bound 1e-4)")
        del params, st, st1
        torch.cuda.empty_cache()


def tp_token_readings(cfg, dcfg, dev, tp: int, faults) -> dict:
    """The bf16 forward over ``tp`` TP ranks of ``init_params(cfg, 0)`` on
    ``make_batch(dcfg, 0)`` (the train cell's step-0 weights and batch),
    sound and with each fault of ``faults`` (name -> context manager)
    planted, against the plain float32 one-rank forward of the same
    weights (upcast): each run's loss (cross entropy and z-loss, as
    ``train_loss_readings``) and token gap, the mean over tokens of |NLL
    - float32 NLL|.  Returns {"f32": loss, "sound": (loss, gap), name:
    (loss, gap)}."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import make_batch

    def nll(logits, c, batch):
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        tok = lse - torch.gather(logits, -1,
                                 batch["targets"][..., None].long())[..., 0]
        return float(tok.mean() + c.z_loss * (lse * lse).mean()), \
            tok.reshape(-1)

    out = {}
    with torch.no_grad():
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in make_batch(dcfg, 0).items()}
        params = TF.init_params(cfg, 0, dev)
        p32 = T.tree_map(lambda x: x.float(), params)
        f32 = cfg.replace(dtype="float32")
        ref = nll(TF.forward(p32, f32, batch["inputs"])[0], f32, batch)
        del p32
        torch.cuda.empty_cache()
        out["f32"] = ref[0]
        sp = SH.shard_params(cfg, params, tp)
        del params
        torch.cuda.empty_cache()

        def run():
            lg = TF.vocab_logits(TF.forward(sp, cfg, batch["inputs"],
                                            n_model=tp)[0], cfg.vocab_size)
            loss, tok = nll(lg, cfg, batch)
            return loss, float((tok - ref[1]).abs().mean())
        out["sound"] = run()
        for name, fault in faults.items():
            with fault():
                out[name] = run()
        del sp, batch
        torch.cuda.empty_cache()
    return out


def tp_gradient_check(cfg, run, tag, losses, one_rank, dp, tp, loss_atol):
    """zamba2's TP gradients against phase 13's p = 4 run of the same cell
    (``one_rank[cfg.name]``): the grad norms of ``run``'s two steps
    (``tag``, their ``losses``) within ``SSM_TP_GNORM_RTOL``, the step-1 loss
    within ``loss_atol``, and each fault of ``TP_GRAD_FAULTS`` (one
    pallas_fused step) outside the grad norm gate.  Returns the
    readings."""
    from repro_torch.launch import cell

    one = one_rank.get(cfg.name)
    check(one is not None and one["n_layers"] == cfg.n_layers,
          f"{cfg.name}: no p = 4 run at {cfg.n_layers} layers to hold the "
          f"TP gradients to")
    rel = [abs(a - b) / b for a, b in zip(run.gnorms[tag], one["gnorms"])]
    step1 = abs(losses[1] - one["losses"][1])
    faults = {}
    for name, fault in TP_GRAD_FAULTS.items():
        ftag = f"{tag} ({name})"
        with fault():
            run(cell.train_config("pallas_fused", "float32"), dp, 1, ftag,
                tp=tp)
        faults[name] = abs(run.gnorms[ftag][0] - one["gnorms"][0]) \
            / one["gnorms"][0]
    log(f"  {cfg.name} at ({dp}, {tp}) against p = 4: grad norms "
        f"{run.gnorms[tag]} / {one['gnorms']}, relative " +
        ", ".join(f"{r:.3e}" for r in rel) + f" (gate {SSM_TP_GNORM_RTOL}); "
        f"step-1 loss {losses[1]:.6f} / "
        f"{one['losses'][1]:.6f}, {step1:.2e} apart (bound {loss_atol}); " +
        "; ".join(f"{k}: step-0 grad norm {v:.3e} relative"
                  for k, v in faults.items()))
    check(max(rel) <= SSM_TP_GNORM_RTOL, f"{cfg.name} at ({dp}, {tp}): grad "
          f"norms {run.gnorms[tag]} vs p = 4's {one['gnorms']}: relative "
          f"{rel} (gate {SSM_TP_GNORM_RTOL})")
    check(step1 <= loss_atol, f"{cfg.name} at ({dp}, {tp}): step-1 loss "
          f"{step1} from p = 4's (bound {loss_atol})")
    for name, r in faults.items():
        check(r > SSM_TP_GNORM_RTOL, f"{cfg.name} with {name}: grad norm "
              f"{r} from p = 4's, within the gate {SSM_TP_GNORM_RTOL}")
    return {"gnorm_rel_p4": rel, "step1_loss_gap_p4": step1,
            "grad_faults_gnorm_rel": faults}


def phase_ssm_tp_train(dev, one_rank):
    """16b: ``cell.SSM_TP_TRAIN_CELLS`` at (dp, tp) = (2, 2), bf16, float32
    wire: zamba2-2.7b x12 (megatron_sp) and xlstm-125m x4 (pure_sp).  Two
    pallas_fused steps (rs_step and ag_step launched) and one bine step
    from the same start, rank 0's params after the first bitwise equal;
    for zamba2 (remat on, the config's) the same two steps with remat off,
    its params sha256 equal.  The step-0 loss within the loss bound of
    phase 13's ``SSM_GATES`` of the plain float32 one-rank forward of the
    same weights, the TP bf16 forward's tokens within its token bound on
    average, and each TP fault of ``TP_FAULTS`` outside the token bound
    (``tp_token_readings``).  The gradients: zamba2's grad norms at steps
    0 and 1 within ``SSM_TP_GNORM_RTOL`` of phase 13's p = 4 run of the same
    cell (``one_rank``: phase 13's numbers by arch), its step-1 loss (after
    one update) within the loss bound of that run's, and each fault of
    ``TP_GRAD_FAULTS`` (one step) outside the grad norm gate.  Reports the
    warm step ms, tokens/s and peak GiB.  Returns the fused steps'
    launches by arch and the numbers."""
    import torch
    from repro_torch.launch import cell
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF

    launches, nums = {}, {}
    for tc in cell.SSM_TP_TRAIN_CELLS:
        cfg, dcfg, run = train_runs(dev, tc.model_config())
        dp, tp = tc.meshes[0]
        tokens = dcfg.global_batch * dcfg.seq_len
        log(f"  {cfg.name} x{cfg.n_layers}: (dp, tp) = ({dp}, {tp}), "
            f"{SH.strategy(cfg, tp)}, remat {cfg.remat}, batch "
            f"{dcfg.global_batch}x{dcfg.seq_len}")
        tag = f"{cfg.name} tp pallas_fused/float32"
        counts, losses, times, peak, first = run(
            cell.train_config("pallas_fused", "float32"), dp, 2, tag,
            tp=tp, digest=True)
        launches[cfg.name] = {k: counts[k] for k in ("rs_step", "ag_step")}
        for k, v in launches[cfg.name].items():
            check(v > 0, f"the {cfg.name} TP train step did not launch {k}")
        cb, lb, _, _, bine_first = run(cell.train_config("bine", "float32"),
                                       dp, 1, f"{cfg.name} tp bine/float32",
                                       tp=tp)
        check(sum(cb.values()) == 0, f"the bine path launched kernels: {cb}")
        check(all(torch.equal(a, b) for a, b in zip(first, bine_first)) and
              lb[0] == losses[0], f"{cfg.name} at ({dp}, {tp}): bine and "
              f"pallas_fused differ after one float32 step")
        del first, bine_first
        torch.cuda.empty_cache()
        rec = {}
        if cfg.remat:
            _, _, run_off = train_runs(dev, cfg.replace(remat=False))
            _, loff, toff, peak_off, _ = run_off(
                cell.train_config("pallas_fused", "float32"), dp, 2,
                tag + " remat off", tp=tp, digest=True)
            check(run_off.digests[tag + " remat off"] == run.digests[tag]
                  and loff == losses, f"{cfg.name} at ({dp}, {tp}): remat "
                  f"on and off differ (losses {losses} / {loff})")
            rec = {"remat_off_step_ms": [t * 1e3 for t in toff],
                   "remat_off_peak_gib": peak_off}
            log(f"  {cfg.name}: remat on == off after 2 steps (params "
                f"sha256 {run.digests[tag][:16]}..., losses bitwise); peak "
                f"{peak:.1f} GiB on, {peak_off:.1f} off")
            torch.cuda.empty_cache()
        loss_atol, token_atol = SSM_GATES[cfg.name]
        if cfg.name == "zamba2-2.7b":
            rec.update(tp_gradient_check(cfg, run, tag, losses, one_rank,
                                         dp, tp, loss_atol))
        read = tp_token_readings(cfg, dcfg, dev, tp, TP_FAULTS[cfg.name])
        ref = read["f32"]
        check(math.isfinite(losses[0]) and abs(losses[0] - ref) <= loss_atol,
              f"{cfg.name} at ({dp}, {tp}): step-0 loss {losses[0]} vs the "
              f"plain float32 loss {ref} (bound {loss_atol})")
        s_loss, s_gap = read["sound"]
        check(abs(s_loss - ref) <= loss_atol and s_gap <= token_atol,
              f"{cfg.name} TP bf16 forward: loss {s_loss} vs {ref}, token "
              f"gap {s_gap} (bounds {loss_atol}, {token_atol})")
        for name in TP_FAULTS[cfg.name]:
            check(read[name][1] > token_atol, f"{cfg.name} with {name}: "
                  f"token gap {read[name][1]} within {token_atol}; the gate "
                  f"cannot see that fault")
        warm = times[1]
        faults = "; ".join(f"{k}: loss {v[0]:.6f}, token gap {v[1]:.4f}"
                           for k, v in read.items()
                           if k not in ("f32", "sound"))
        log(f"  {cfg.name} TP: bine == pallas_fused bitwise; step-0 loss "
            f"{losses[0]:.6f}, plain float32 {ref:.6f}; the TP bf16 forward "
            f"{s_loss:.6f}, token gap {s_gap:.4f} (bounds {loss_atol} / "
            f"{token_atol}); {faults}; warm step {warm * 1e3:.1f} ms "
            f"({tokens / warm:.0f} tokens/s), peak {peak:.1f} GiB")
        nums[cfg.name] = dict(
            rec, n_layers=cfg.n_layers, mesh=[dp, tp],
            strategy=SH.strategy(cfg, tp), loss_hex=losses[0].hex(),
            losses=losses, gnorms=run.gnorms[tag], f32_loss=ref,
            readings=read,
            step_ms=[t * 1e3 for t in times], warm_step_ms=warm * 1e3,
            tokens_per_s=tokens / warm, peak_gib=peak,
            params_sha256=run.digests[tag])
        torch.cuda.empty_cache()
    return launches, nums


def fixed_tp_logit_readings(cfg, dev, c, params, n, seeds, faults) -> dict:
    """The serve cell ``c``'s prefill over ``n`` TP ranks against the
    one-rank prefill of the same weights on the same prompt (the
    fixed-batch loop's draw from ``np.random.RandomState(seed)``: tokens,
    or float32 frames for a frontend model), sound and with each fault of
    ``faults`` (name -> context manager factory) planted in the TP one,
    for each seed (``params``: the first seed's weights, the others drawn
    from theirs): the mean and max of |TP - one rank| over the batch's
    last-token logits, in bf16 ulps of the one-rank max |logit|.  Consumes
    ``params``.  Returns {seed: {name: (mean, max)}}."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.models import transformer as TF

    B, Lp = c.slots, c.prompt_len_max
    out = {}
    with torch.no_grad():
        for seed in seeds:
            if params is None:
                params = TF.init_params(cfg, seed, dev)
            rng = np.random.RandomState(seed)
            prompt = (torch.as_tensor(rng.randn(B, Lp, cfg.frontend_dim),
                                      dtype=torch.float32, device=dev)
                      if cfg.frontend else torch.as_tensor(
                          rng.randint(0, cfg.vocab_size, size=(B, Lp)),
                          dtype=torch.int32, device=dev))
            ref = TF.prefill(params, cfg, prompt)[0].float()
            check(bool(torch.isfinite(ref).all()),
                  f"{cfg.name} seed {seed}: non-finite prefill logits")
            ulp = float(bf16_ulp(ref.abs().max()))
            read = {}
            for name, fault in [("sound", None)] + list(faults.items()):
                with (fault() if fault else contextlib.nullcontext()):
                    lg = TF.vocab_logits(TF.prefill_tp(params, cfg, prompt,
                                                       n)[0],
                                         cfg.vocab_size).float()
                read[name] = (float((lg - ref).abs().mean()) / ulp,
                              float((lg - ref).abs().max()) / ulp)
                del lg
                torch.cuda.empty_cache()
            out[seed] = read
            params = None
            del ref
            torch.cuda.empty_cache()
    return out


def phase_fixed_tp_serve(dev, randn):
    """16c: ``cell.FIXED_TP_SERVE_CELLS`` through
    ``launch.serve.run_fixed_batch`` over ``cell.FIXED_TP`` = 2 TP ranks:
    zamba2-2.7b at full depth (4 x 1024), mixtral-8x7b x8 (4 x 1024, its
    prefill on expert parallelism) and musicgen-medium at full depth (8 x
    1024 frames), 32 greedy tokens each, on the same weights as the
    one-rank cells of phases 13-15.  The launches read around the loop:
    one rmsnorm per whole-row norm a call (ln1 and ln2, each recurrent
    block's ln1, the final norm; a split block's gated norm reduces over
    the ranks in plain ops), the flash kernel once a prefill per
    attention layer (the ranks in its batch).  Every rmsnorm and flash
    shape the loop gave the kernels (rows slots x prompt length and slots
    at d_model; q ``[n * slots, prompt, heads / n, head_dim]``) is
    recorded and held to the plain version (``rmsnorm_case``,
    ``flash_case``).  The bf16 prefill logits against the one-rank
    prefill's within ``FIXED_TP_ULPS`` bf16 ulps of max |logit| (the mean)
    on three seeds, each planted fault outside on each
    (``fixed_tp_logit_readings``: the flash kernel's last head columns
    zeroed; zamba2's cross-rank norms without their psum); the greedy
    tokens against the one-rank loop's (phases 13-15): all equal on
    musicgen's float32 frames path, the first ones and the share reported
    on the bf16 paths, where logits a few ulps apart flip near ties (and
    mixtral's EP prefill drops other tokens than the dense path).  Prefill
    ms, decode tokens/s and the peak (the cross-rank norms' share of the
    device time is ``launch/profile_serve.py --mesh 1,2``'s).  Returns the
    launches by arch and the numbers."""
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.rmsnorm import ops as RO
    from repro_torch.launch import cell
    from repro_torch.launch.serve import run_fixed_batch
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TF

    n = cell.FIXED_TP
    launches, nums = {}, {}
    for c in cell.FIXED_TP_SERVE_CELLS:
        cfg = cell.serve_model_config(c)
        torch.cuda.empty_cache()
        params = TF.init_params(cfg, c.seed, dev)
        torch.cuda.reset_peak_memory_stats()
        segs = TF.segments(cfg)
        n_attn = sum(k for b, k in segs if b.kind not in TF.RECURRENT)
        n_norm = 1 + sum(
            k * (1 if TF.recurrent_split(cfg, b.kind, n) else 2)
            if b.kind in TF.RECURRENT else 2 * k for b, k in segs)
        B, Lp, new = c.slots, c.prompt_len_max, c.max_new
        dt = torch.float32 if cfg.frontend else torch.bfloat16
        log(f"  {cfg.name} x{cfg.n_layers} over {n} TP ranks "
            f"({SH.strategy(cfg, n)}): fixed batch {B} x {Lp}, {new} greedy "
            f"tokens")
        norms, flashes = set(), set()
        real_norm, real_flash = RO.rmsnorm_kernel, TF.flash_attention

        def norm(x, w, eps):
            norms.add((*x.shape, eps, x.dtype))
            return real_norm(x, w, eps)

        def flash(q, k, v, **kw):
            flashes.add((tuple(q.shape), tuple(k.shape), kw.get("window"),
                         q.dtype))
            return real_flash(q, k, v, **kw)
        torch.cuda.synchronize()
        KB.reset_launches()
        RO.rmsnorm_kernel, TF.flash_attention = norm, flash
        try:
            toks, got = run_fixed_batch(cfg, params, B, Lp, new,
                                        seed=c.seed, device=dev, tp=n)
        finally:
            RO.rmsnorm_kernel, TF.flash_attention = real_norm, real_flash
        counts = {k: v for k, v in KB.LAUNCHES.items() if v}
        want = {"rmsnorm": n_norm * new, "flash_attention": n_attn}
        if not cfg.frontend:
            want["flash_attention_wgmma"] = n_attn
        check(counts == want, f"{cfg.name} over {n} TP ranks: launches "
              f"{counts}, expected {want} ({n_norm} whole-row norms a call, "
              f"{n_attn} flash in the prefill)")
        launches[cfg.name] = counts
        got["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        one = FIXED_TOKENS.get(cfg.name)
        check(one is not None and one.shape == toks.shape,
              f"{cfg.name}: no one-rank tokens to compare with")
        got["first_tokens_equal"] = int((toks[:, 0] == one[:, 0]).sum())
        got["tokens_agree"] = float((toks == one).mean())
        check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"{cfg.name}: tokens out of range")
        if cfg.frontend:
            check(got["tokens_agree"] == 1.0, f"{cfg.name}: float32 frames "
                  f"over {n} TP ranks gave other tokens than one rank: "
                  f"{got['tokens_agree']:.1%} agree")
        # the kernels at the shapes the loop gave them, against plain
        check(norms == {(B * Lp, cfg.d_model, cfg.norm_eps, dt),
                        (B, cfg.d_model, cfg.norm_eps, dt)},
              f"{cfg.name} over {n} TP ranks: rmsnorm shapes "
              f"{sorted(norms, key=str)}")
        for rows_, d, eps, ndt in sorted(norms, key=lambda t: t[:2]):
            rmsnorm_case(randn, rows_, d, eps, ndt)
        nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        window = {w for _, _, w, _ in flashes}
        check(len(window) == 1 and {f[:2] + f[3:] for f in flashes} == {(
            (n * B, Lp, nh // n, hd), (n * B, Lp, nkv // n, hd), dt)},
              f"{cfg.name} over {n} TP ranks: flash shapes {flashes}")
        *_, ferr, fbound, _ = flash_case(dev, randn, (nh, nkv, hd), Lp,
                                         window.pop(), dt, b=n * B, tp=n)
        got["flash_max_abs_err"], got["flash_bound_ms"] = ferr, fbound
        got["rmsnorm_shapes"] = sorted([r, d] for r, d, *_ in norms)
        log(f"  {cfg.name} over {n} TP ranks: rmsnorm at the loop's "
            f"{len(norms)} shapes and flash at q [{n * B}, {Lp}, {nh // n}, "
            f"{hd}] ({str(dt)[6:]}) held to plain")
        # the prefill logits against one rank's on three seeds, sound and
        # with faults
        faults = dict(TP_FAULTS[cfg.name])
        faults["flash kernel's last head columns zeroed"] = \
            lambda: _planted_flash_fault(cfg.head_dim * 3 // 4)
        read = fixed_tp_logit_readings(cfg, dev, c, params, n,
                                       (c.seed, c.seed + 1, c.seed + 2),
                                       faults)
        params = None
        torch.cuda.empty_cache()
        gate = FIXED_TP_ULPS[cfg.name]
        for seed, r in read.items():
            log(f"  {cfg.name} seed {seed}: prefill logits over {n} TP ranks "
                f"from one rank's, in bf16 ulps of max |logit| (mean / "
                f"max): " + "; ".join(f"{k} {v[0]:.3g} / {v[1]:.3g}"
                                      for k, v in r.items()))
        for seed, r in read.items():
            check(r["sound"][0] <= gate, f"{cfg.name} seed {seed} over {n} "
                  f"TP ranks: bf16 prefill logits mean {r['sound'][0]} (max "
                  f"{r['sound'][1]}) bf16 ulps from one rank's (gate "
                  f"{gate})")
            for name in faults:
                check(r[name][0] > gate, f"{cfg.name} seed {seed} with "
                      f"{name}: prefill logits mean {r[name][0]} ulps from "
                      f"one rank's, within the gate {gate}")
        got["logit_ulps"] = read
        log(f"  {cfg.name} over {n} TP ranks: launches {counts}; first "
            f"tokens equal {got['first_tokens_equal']}/{B}, all tokens "
            f"{got['tokens_agree']:.1%}; prefill {got['prefill_ms']:.1f} ms, "
            f"decode {got['decode_tokens_per_s']:.1f} tokens/s, peak "
            f"{got['peak_gib']:.2f} GiB")
        nums[cfg.name] = got
    return launches, nums


# ---------------------------------------------------------------------------
# Phase 17: the measurement plane (tuner probe, store, refresh, drift, CLIs)
# ---------------------------------------------------------------------------

#: the grid and preset phase 17 tunes: p = 4 and 8, 64 KiB / 1 MiB / 16
#: MiB; lumi is grouped, so bine_hier is a candidate
TUNE_GRID, TUNE_TOPOLOGY = "small", "lumi"
#: each probe cell's wall-clock budget in phase 17 (s): every cell runs on
#: a worker thread, as a budgeted tune run's do
TUNE_BUDGET_S = 60.0
#: the mis-priced cell phase 17 plants in a drift store, measured/predicted
TUNE_PLANTED = ("allgather", 8, 1 << 20, 5.0)


def _cli(main_fn, argv):
    """Run a CLI's ``main(argv)`` in process; returns (rc, stdout)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def _argmin_cells(measurements, table, topology):
    """Each fully timed (collective, p, bucket) cell's fastest backend and
    fastest (backend, wire) pair, computed here from the medians of the
    raw measurements (ties to the earlier candidate)."""
    from repro_torch.topology import CANDIDATES, wire_candidates
    times = {}
    for m in measurements:
        key = (m.collective, m.p, table.bucket_of(m.nbytes))
        times.setdefault(key, {}).setdefault(
            (m.backend, m.wire_dtype), []).append(m.time_s)
    cells, wire_cells = {}, {}
    for key, per in times.items():
        med = {bw: statistics.median(ts) for bw, ts in per.items()}
        cands = [(b, "float32") for b in CANDIDATES[key[0]]]
        if all(c in med for c in cands):
            cells[key] = min(cands, key=lambda c: med[c])[0]
        pairs = wire_candidates(key[0], topology)
        if key[0] in table.wire_entries and all(c in med for c in pairs):
            wire_cells[key] = min(pairs, key=lambda c: med[c])
    return cells, wire_cells


#: the kernels each pallas_fused probe cell must launch, by (collective,
#: wire); the float32 allreduce runs both steps
TUNE_CELL_KERNELS = {"reduce_scatter": ("rs_step",), "allgather": ("ag_step",),
                     "allreduce": ("rs_step", "ag_step")}


def _probe_shapes_vs_plain(dev, spec):
    """Every ``pallas_fused`` cell of the probe at its own shapes and on
    its own payload (``tuner.probe._payload_cached``): reduce_scatter and
    allgather on the float32, bfloat16 and int8 wires, allreduce on
    float32, each held bitwise to its stacked twin (``bine``, the same
    wire), the float32 reduce_scatter and allreduce to a float64 rank sum
    within 1e-4 (every rank alike), the float32 allgather to the
    rank-ordered blocks exactly.  Each fused call must launch its step
    kernels (``TUNE_CELL_KERNELS``; ``rs_step_q`` for the int8
    reduce_scatter).  These launches compare: the path's are read around
    the probe.  Returns (calls checked, the largest float64 error)."""
    import torch
    from repro_torch.collectives import api
    from repro_torch.kernels import build as KB
    from repro_torch.tuner import probe

    calls, worst = 0, 0.0
    for p in spec.ps:
        for nbytes in spec.sizes:
            x = probe._payload_cached(nbytes, p, dev)
            blk = x[:, :x.shape[1] // p].contiguous()
            ref = x.double().sum(0)
            for wire in ("float32", "bfloat16", "int8"):
                fused = api.CollectiveConfig(
                    backend=api.PALLAS_FUSED_BACKEND, wire_dtype=wire)
                twin = fused.replace(backend="bine")
                cases = [("reduce_scatter", api.reduce_scatter, x),
                         ("allgather", api.allgather, blk)]
                if wire == "float32":
                    cases.append(("allreduce", api.allreduce, x))
                for coll, fn, inp in cases:
                    what = f"pallas_fused {coll} p{p} {nbytes} B {wire}"
                    before = dict(KB.LAUNCHES)
                    got = fn(inp, fused)
                    torch.cuda.synchronize()
                    ran = {k for k, v in KB.LAUNCHES.items()
                           if v != before[k]}
                    want = (("rs_step_q",) if (coll, wire) ==
                            ("reduce_scatter", "int8")
                            else TUNE_CELL_KERNELS[coll])
                    check(set(want) <= ran, f"{what} launched {ran}")
                    same_bits([got], [fn(inp, twin)], what)
                    calls += 1
                    if wire != "float32":
                        continue
                    if coll == "allgather":
                        check(torch.equal(got, blk.reshape(1, -1).expand(
                            p, -1)), f"{what}: not the rank-ordered blocks")
                        continue
                    flat = got.reshape(-1) if coll == "reduce_scatter" \
                        else got[0]
                    err = float((flat.double() - ref).abs().max())
                    check(err < 1e-4 and (coll == "reduce_scatter" or all(
                        torch.equal(got[0], got[r]) for r in range(p))),
                          f"{what}: not the rank sum ({err})")
                    worst = max(worst, err)
            del x, blk, ref
    probe._payload_cache.clear()
    return calls, worst


def phase_tune(dev, obs_artifact):
    """Phase 17: ``launch/tune.py`` on the card, its store, table, drift
    store and ``--hints`` mode, ``auto`` under ``tuning="measured"``, and
    ``launch/report.py`` on phase 8's obs registry.  Returns (the step
    kernels' launches during the probe, the numbers it logs)."""
    import shutil
    import tempfile
    import torch
    from repro_torch import topology as TP
    from repro_torch.collectives import api
    from repro_torch.kernels import build as KB
    from repro_torch.launch import report, tune
    from repro_torch.obs import drift
    from repro_torch.topology.presets import PRESETS
    from repro_torch.tuner import load_all_measurements
    from repro_torch.tuner.probe import GRIDS, grid_cells

    t_phase = time.perf_counter()
    spec, topo = GRIDS[TUNE_GRID], TUNE_TOPOLOGY
    tmp_root = ROOT / "build"
    tmp_root.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="tune_smoke_", dir=tmp_root))
    env = {"REPRO_MEASURE_DIR": str(root / "measurements"),
           "REPRO_DRIFT_DIR": str(root / "drift"),
           "REPRO_MEASURED_TABLE_DIR": str(root / "tables")}
    saved = {k: os.environ.get(k) for k in env}
    out = {"grid": TUNE_GRID, "topology": topo,
           "device": torch.cuda.get_device_name(dev)}
    try:
        os.environ.update(env)
        TP.invalidate_tables()
        # (a) the tune CLI on the card, the step kernels counted around it
        torch.cuda.synchronize()
        KB.reset_launches()
        t0 = time.perf_counter()
        rc, text = _cli(tune.main, [
            "--grid", TUNE_GRID, "--topology", topo, "--device", "cuda",
            "--timestamp", "chip_smoke", "--budget-s", str(TUNE_BUDGET_S)])
        probe_s = time.perf_counter() - t0
        launches = {k: KB.LAUNCHES[k]
                    for k in ("rs_step", "ag_step", "rs_step_q")}
        check(rc == 0, f"tune exited {rc}:\n{text[-3000:]}")
        closing = json.loads(text.strip().splitlines()[-1])
        for k, v in launches.items():
            check(v > 0, f"{k} was not launched by the probe")
        sets = load_all_measurements(topology=topo)
        check(sorted(ms.p for ms in sets) == sorted(spec.ps),
              f"measurement sets at p = {[ms.p for ms in sets]}")
        want = {(n, c, b, w) for n, c, b, w in grid_cells(spec, topo)}
        cells_us, spread, n_cells = {}, {}, 0
        for ms in sets:
            prov = ms.provenance
            check(not any(k in prov for k in ("failed_cells", "skipped_ps",
                                                "aborted")),
                  f"p={ms.p}: provenance {prov}")
            check(prov["platform"] == "gpu" and ms.device_kind ==
                  out["device"], f"p={ms.p}: provenance {prov}")
            got = [(m.nbytes, m.collective, m.backend, m.wire_dtype)
                   for m in ms.measurements]
            check(len(got) == len(set(got)) and set(got) == want,
                  f"p={ms.p}: cells {sorted(set(got) ^ want)} off the grid")
            reps_us = json.loads(prov["cells_us"])
            for m in ms.measurements:
                check(math.isfinite(m.time_s) and m.time_s > 0 and
                      m.reps == spec.reps, f"cell {m}")
                lo, hi, total, wall = reps_us[
                    f"{m.collective}:{m.backend}:{m.wire_dtype}:{m.nbytes}"]
                spread[(m.p, m.collective, m.backend, m.wire_dtype,
                        m.nbytes)] = (lo, hi, total, wall)
                # median, least and most rep
                cells_us[f"p{m.p} {m.collective} {m.backend} "
                         f"{m.wire_dtype} {m.nbytes}"] = [
                             m.time_s * 1e6, lo, hi]
            n_cells += len(got)
        vs_calls, vs_err = _probe_shapes_vs_plain(dev, spec)
        log(f"  the probe's pallas_fused cells at its own shapes and "
            f"payload: {vs_calls} calls bitwise equal to stacked bine on "
            f"the same wire; float32 reduce_scatter / allreduce vs the "
            f"float64 rank sum {vs_err:.2e} (bound 1e-4)")
        out["vs_plain"] = {"calls": vs_calls, "max_abs_err_f64": vs_err}

        # (b) the table: every measured cell the argmin of its medians
        base = TP.load_table(topo)
        table = TP.load_table(topo, tuning="measured")
        flat = [m for ms in sets for m in ms.measurements]
        cells, wire_cells = _argmin_cells(flat, table, topo)
        n_full = len(spec.ps) * len(spec.sizes) * len(spec.collectives)
        check(table.measured_cell_count() == len(cells) == n_full ==
              closing["measured_cells"],
              f"measured cells {table.measured_cell_count()} / "
              f"{len(cells)} / {closing['measured_cells']}, grid {n_full}")
        chosen = {}
        for (c, p, i), b in sorted(cells.items()):
            nb = table.size_buckets[i]
            check(table.provenance_of(c, p, nb) == "measured" and
                  table.lookup(c, p, nb) == b,
                  f"({c}, {p}, {nb}): table {table.lookup(c, p, nb)}, "
                  f"argmin {b}")
            chosen[f"{c} p{p} {nb}"] = b
        for (c, p, i), bw in sorted(wire_cells.items()):
            nb = table.size_buckets[i]
            check(table.wire_provenance_of(c, p, nb) == "measured" and
                  table.lookup_wire(c, p, nb) == bw,
                  f"wire ({c}, {p}, {nb}): table "
                  f"{table.lookup_wire(c, p, nb)}, argmin {bw}")
            chosen[f"{c} p{p} {nb} wire"] = "/".join(bw)
        check(closing["analytic_overrides"] == table.overrides_vs(base),
              f"overrides {closing}")
        # how far apart the winner and the runner-up lie: a cell whose
        # runner-up's fastest rep beats the winner's slowest is a pick
        # within the reps' spread; and the share of the probe's wall in
        # the timed reps (CUDA-event sums) and in the cells (host clock)
        per = {}
        for m in flat:
            if m.wire_dtype == "float32":
                per.setdefault((m.collective, m.p, m.nbytes), []).append(
                    (m.time_s, m.backend))
        close = []
        for (c, p, nb), ts in sorted(per.items()):
            (_, b1), (_, b2) = sorted(ts)[:2]
            if (spread[(p, c, b2, "float32", nb)][0]
                    <= spread[(p, c, b1, "float32", nb)][1]):
                close.append(f"{c} p{p} {nb} {b1}/{b2}")
        timed_share = sum(v[2] for v in spread.values()) / (probe_s * 1e6)
        cell_share = sum(v[3] for v in spread.values()) / (probe_s * 1e6)
        out.update({"within_spread": close, "timed_share": timed_share,
                    "cell_share": cell_share})
        log(f"  spread: in {len(close)} of {len(per)} backend cells the "
            f"runner-up's fastest rep beats the winner's slowest "
            f"({'; '.join(close) or 'none'}); the timed reps fill "
            f"{timed_share:.1%} of the probe's wall, the cells (warmup, "
            f"reps) {cell_share:.1%}")
        log(f"  tune --grid {TUNE_GRID} --topology {topo}: {n_cells} cells "
            f"in {probe_s:.1f} s ({probe_s / n_cells * 1e3:.0f} ms a "
            f"cell), no failed cell; {closing['measured_cells']} table "
            f"cells measured, each the argmin of its medians, "
            f"{closing['analytic_overrides']} override the analytic "
            f"choice; launches {launches}")
        log("  chosen: " + "; ".join(f"{k} {v}" for k, v in chosen.items()))

        # (c) auto under tuning="measured" launches what the table names
        fused = [k for k in sorted(cells) if k[0] == "allreduce"
                 and cells[k] == api.PALLAS_FUSED_BACKEND]
        c, p, i = (fused or sorted(k for k in cells
                                   if k[0] == "allreduce"))[-1]
        nb = table.size_buckets[i]
        x = torch.randn((p, nb // 4), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(17))
        named = table.lookup(c, p, nb)
        auto = api.CollectiveConfig(backend="auto", topology=topo,
                                    tuning="measured")
        runs = {}
        for tag, cfg in (("auto", auto),
                         ("named", auto.replace(backend=named))):
            torch.cuda.synchronize()
            before = dict(KB.LAUNCHES)
            y = api.allreduce(x, cfg)
            torch.cuda.synchronize()
            runs[tag] = (y, {k: KB.LAUNCHES[k] - before[k]
                             for k in KB.LAUNCHES
                             if KB.LAUNCHES[k] != before[k]})
        check(api.resolve_backend(c, p, nb, auto) == named and
              runs["auto"][1] == runs["named"][1] and
              torch.equal(runs["auto"][0], runs["named"][0]),
              f"auto at ({c}, {p}, {nb}) launched {runs['auto'][1]}, the "
              f"table names {named} ({runs['named'][1]})")
        if named == api.PALLAS_FUSED_BACKEND:
            check(runs["auto"][1].get("rs_step", 0) > 0 and
                  runs["auto"][1].get("ag_step", 0) > 0,
                  f"auto -> pallas_fused launched {runs['auto'][1]}")
        out["auto"] = {"cell": [c, p, nb], "backend": named,
                       "launches": runs["auto"][1]}
        log(f"  auto, tuning=measured, allreduce p={p} {nb} B: "
            f"{named}, launches {runs['auto'][1]} == {named} called "
            f"directly, bitwise")
        del x, runs, y

        # (d) the probe's own drift, then a planted mis-priced cell:
        # hints flag it alone and --hints re-probes only its axes
        real = drift.load_all_drift(topology=topo)
        flagged = sum(len(drift.hints(ds)) for ds in real)
        out["drift_cells"] = sum(len(ds.cells) for ds in real)
        out["drift_flagged"] = flagged
        pc, pp, pnb, factor = TUNE_PLANTED
        (ms8,) = [ms for ms in sets if ms.p == pp]
        plant = drift.DriftSet(device_kind=ms8.device_kind, topology=topo,
                               p=pp, provenance={"source": "chip_smoke"})
        for m in ms8.measurements:
            pred = drift.predicted_time(m.collective, m.backend, pp,
                                        m.nbytes, topo, m.wire_dtype)
            check(pred is not None and pred > 0, f"no model time for {m}")
            bad = (m.collective, m.nbytes) == (pc, pnb)
            drift.observe(plant, m.collective, m.backend, m.nbytes,
                          pred * (factor if bad else 1.0), m.wire_dtype)
        pdir = str(root / "planted")
        check(drift.save_drift(plant, dir=pdir) is not None,
              "planted drift store not written")
        hs = drift.hints(plant)
        check([(h.collective, h.p, h.bucket) for h in hs] ==
              [(pc, pp, drift.payload_bucket(pnb))],
              f"hints {hs} on the planted store")
        t0 = time.perf_counter()
        rc, text = _cli(tune.main, [
            "--grid", TUNE_GRID, "--topology", topo, "--device", "cuda",
            "--hints", "--drift-dir", pdir,
            "--store-dir", str(root / "hinted"),
            "--table-out", str(root / "hinted.json")])
        hints_s = time.perf_counter() - t0
        check(rc == 0, f"tune --hints exited {rc}:\n{text[-3000:]}")
        (hms,) = load_all_measurements(dir=str(root / "hinted"))
        hint_nb = drift.bucket_bytes(drift.payload_bucket(pnb))
        got = {(m.collective, m.p, m.nbytes) for m in hms.measurements}
        check(got == {(pc, pp, hint_nb)} and len(hms.measurements) == len(
            [1 for n, cc, _, _ in grid_cells(spec, topo)
             if (n, cc) == (spec.sizes[0], pc)]),
              f"--hints probed {sorted(got)} ({len(hms.measurements)} "
              f"cells)")
        out["hints"] = {"planted": [pc, pp, pnb, factor],
                        "reprobed_cells": len(hms.measurements),
                        "seconds": hints_s}
        log(f"  drift: the probe's own residuals flag {flagged} of "
            f"{out['drift_cells']} cells against the {topo} model; the "
            f"planted {pc} p={pp} {pnb} B x{factor} cell flagged alone, "
            f"--hints re-probed its {len(hms.measurements)} cells in "
            f"{hints_s:.1f} s")

        # (e) the report CLI on phase 8's obs registry and the drift store
        art = root / "phase8_obs.json"
        art.write_text(json.dumps(obs_artifact))
        prom, trace = root / "m.prom", root / "trace.json"
        rc, text = _cli(report.main, [
            "--artifact", str(art), "--topology", topo, "--prom", str(prom),
            "--trace-out", str(trace)])
        check(rc == 0, f"report exited {rc}:\n{text[-3000:]}")
        for preset in PRESETS:
            check(f"preset={preset} p=8 nbytes=1048576 collective="
                  f"allreduce chosen=" in text,
                  f"report: no chosen line for {preset}")
        reg_rows = len([ln for ln in text.splitlines()
                        if "global_frac=" in ln])
        check(reg_rows > 0, "report: no link-byte rows")
        check(text.count("<-- RETUNE") == flagged,
              f"report marks {text.count('<-- RETUNE')} cells, the drift "
              f"store flags {flagged}")
        check(json.loads(trace.read_text())["traceEvents"] is not None and
              "collective_calls_total" in prom.read_text(),
              "report side outputs")
        out["report"] = {"link_rows": reg_rows,
                         "retune_marks": text.count("<-- RETUNE")}
        log(f"  report on phase 8's registry: {reg_rows} link-byte rows, "
            f"{len(PRESETS)} chosen lines, {out['report']['retune_marks']}"
            f" RETUNE marks, prom and trace written")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        TP.invalidate_tables()
        shutil.rmtree(root, ignore_errors=True)
    out.update({"cells_us": cells_us, "n_cells": n_cells,
                "probe_s": probe_s, "s_per_cell": probe_s / n_cells,
                "measured_cells": closing["measured_cells"],
                "analytic_overrides": closing["analytic_overrides"],
                "chosen": chosen, "launches": launches,
                "seconds": time.perf_counter() - t_phase})
    return launches, out


def main() -> int:
    # one 9.8 GB bucket buffer after another: keep the allocator's segments
    # growable so freed ones are reused (set before CUDA starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.collectives import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.qdot import kernel as QK
    from repro_torch.kernels.rmsnorm import kernel as RK

    t_all = time.perf_counter()
    log("[1/17] build")
    t0 = time.perf_counter()
    libs = KB.build()
    for src in K.SOURCES:
        K._lib(src)
    for mod in (RK, FK, QK):
        mod._lib()
    log(f"  built {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

    log("[2/17] kernels vs plain versions")
    rows, qacc_launches, row, randn = phase_kernels(dev)
    torch.cuda.empty_cache()

    log("[3/17] fused collectives vs stacked (bitwise)")
    phase_collectives(dev)

    log("[4/17] collectives API")
    api_launches = phase_api(dev)

    log("[5/17] two-tier (bine_hier)")
    hier_launches, two_tier = phase_two_tier(dev)
    torch.cuda.empty_cache()

    log("[6/17] train")
    phase_small_reference(dev)
    launches, train = phase_train(dev)
    torch.cuda.empty_cache()

    log("[7/17] serve")
    phase_serve_small_reference(dev)
    serve_launches, serve, serve_ref = phase_serve(dev)
    torch.cuda.empty_cache()

    log("[8/17] checkpoint, resume, measured tables, obs")
    run_launches, runtime, obs_artifact = phase_runtime(dev)
    torch.cuda.empty_cache()

    log("[9/17] tensor parallelism")
    phase_tp_small_reference(dev)
    tp_launches, tp = phase_tp(dev)
    torch.cuda.empty_cache()

    log("[10/17] serving under TP")
    phase_serve_tp_small_reference(dev)
    stp_launches, serve_tp = phase_serve_tp(
        dev, {"nums": serve, "ref": serve_ref})
    torch.cuda.empty_cache()

    log("[11/17] dense configs (gemma3-4b, gemma-7b, qwen3-32b)")
    t11 = time.perf_counter()
    phase_dense_flash(dev, randn, row)
    dense_launches, dense, g3tp_launches, g3tp = phase_dense_serve(dev)
    g3train_launches, g3train = phase_dense_train(dev)
    torch.cuda.empty_cache()
    dense_s = time.perf_counter() - t11
    log(f"  phase 11: {dense_s:.0f} s")

    log("[12/17] MoE train (mixtral-8x7b, expert parallelism)")
    t12 = time.perf_counter()
    phase_moe_small_reference(dev)
    moe_launches, moe = phase_moe_train(dev)
    torch.cuda.empty_cache()
    moe["seconds"] = time.perf_counter() - t12
    log(f"  phase 12: {moe['seconds']:.0f} s")

    log("[13/17] recurrent blocks (xlstm-125m, zamba2-2.7b)")
    t13 = time.perf_counter()
    phase_model_small_reference(dev, ("xlstm-125m", "zamba2-2.7b"))
    phase_ssm_flash(dev, randn, row)
    ssm_train_launches, ssm_train = phase_ssm_train(dev)
    ssm_serve_launches, ssm_serve = phase_ssm_serve(dev, randn)
    torch.cuda.empty_cache()
    ssm_s = time.perf_counter() - t13
    log(f"  phase 13: {ssm_s:.0f} s")

    log("[14/17] frontend configs (pixtral-12b, musicgen-medium)")
    t14 = time.perf_counter()
    phase_model_small_reference(dev, ("pixtral-12b", "musicgen-medium"))
    phase_frontend_flash(dev, randn, row)
    fe_serve_launches, fe_serve = phase_frontend_serve(dev, randn)
    fe_train_launches, fe_train = phase_frontend_train(dev)
    torch.cuda.empty_cache()
    fe_s = time.perf_counter() - t14
    log(f"  phase 14: {fe_s:.0f} s")

    log("[15/17] remat and MoE serving (mixtral-8x7b)")
    t15 = time.perf_counter()
    remat_launches, remat = phase_remat(dev)
    torch.cuda.empty_cache()
    moe_serve_launches, moe_serve = phase_moe_serve(dev, randn)
    torch.cuda.empty_cache()
    p15_s = time.perf_counter() - t15
    log(f"  phase 15: {p15_s:.0f} s")

    log("[16/17] recurrent blocks and the fixed-batch loop over TP ranks")
    t16 = time.perf_counter()
    phase_tp_small(dev)
    t16b = time.perf_counter()
    ssm_tp_launches, ssm_tp_train = phase_ssm_tp_train(dev, ssm_train)
    torch.cuda.empty_cache()
    t16c = time.perf_counter()
    fixed_tp_launches, fixed_tp = phase_fixed_tp_serve(dev, randn)
    del row, randn
    torch.cuda.empty_cache()
    t16d = time.perf_counter()
    p16_parts = {"16a": t16b - t16, "16b": t16c - t16b, "16c": t16d - t16c}
    p16_s = time.perf_counter() - t16
    log(f"  phase 16: {p16_s:.0f} s (" + ", ".join(
        f"{k} {v:.0f} s" for k, v in p16_parts.items()) + ")")

    log("[17/17] the measurement plane (tune, drift, report)")
    tune_launches, tune_nums = phase_tune(dev, obs_artifact)
    torch.cuda.empty_cache()
    log(f"  phase 17: {tune_nums['seconds']:.0f} s")
    # each path's own kernel launches, read around that path alone
    by_path = {"train": dict(launches), "two-axis": hier_launches,
               "runtime": run_launches, "tp": tp_launches,
               "serve": serve_launches, "serve-tp": stp_launches,
               **{f"serve {a}": n for a, n in dense_launches.items()},
               "serve-tp gemma3-4b": g3tp_launches,
               "train gemma3-4b": g3train_launches,
               **{f"train mixtral-8x7b ({m})": n
                  for m, n in moe_launches.items()},
               **{f"train {a}": n for a, n in ssm_train_launches.items()},
               **{f"serve {a} (fixed batch)": n
                  for a, n in ssm_serve_launches.items()},
               **{f"serve {a}": n for a, n in fe_serve_launches.items()},
               **{f"train musicgen-medium ({m})": n
                  for m, n in fe_train_launches.items()},
               **{f"train {t}": n for t, n in remat_launches.items()},
               **{f"serve {a}": n for a, n in moe_serve_launches.items()},
               **{f"train {a} (2, 2)": n
                  for a, n in ssm_tp_launches.items()},
               **{f"serve {a} (fixed batch, tp 2)": n
                  for a, n in fixed_tp_launches.items()},
               "tune": tune_launches}
    for path, counts in by_path.items():
        for name, n in counts.items():
            check(n > 0, f"kernel {name} was not launched on the {path} "
                  f"path")
    log("kernels by path: " + "; ".join(
        f"{path} " + ", ".join(f"{k} x{v}" for k, v in counts.items())
        for path, counts in by_path.items()))
    # the step kernels' counts from the train step's main path and its
    # two-axis path, the ring and matmul kernels' from the API run, the
    # norm and attention kernels' from the serve and serve-TP runs, qacc's
    # from the qdot op's path
    # (the float32 matmul rows count the CUDA-core kernel's launches, the
    # *_wgmma rows the tensor-core kernel's; flash's row is bf16, all of
    # whose serve launches are wgmma ones)
    for name, n in hier_launches.items():
        launches[name] += n
    for name, n in run_launches.items():
        launches[name] += n
    for name, n in tp_launches.items():
        launches[name] += n
    for name, n in g3train_launches.items():
        launches[name] += n
    for name, n in tune_launches.items():
        launches[name] += n
    for counts in list(moe_launches.values()) + list(
            ssm_train_launches.values()) + list(
            fe_train_launches.values()) + list(remat_launches.values()) + \
            list(ssm_tp_launches.values()):
        for name, n in counts.items():
            launches[name] += n
    for name in ("ring_update", "matmul_pack_wgmma", "gather_matmul_wgmma"):
        launches[name] = api_launches[name]
    for name in ("matmul_pack", "gather_matmul"):
        launches[name] = api_launches[name] - api_launches[name + "_wgmma"]
    for name in serve_launches:
        launches[name] = serve_launches[name] + stp_launches[name]
    # the dense serve paths: every norm on the rmsnorm row; flash at head
    # dim 128 (qwen3-32b) on the flash_attention row, at 256 (gemma3-4b,
    # gemma-7b, gemma3-4b under TP) on the flash_attention_hd256 row
    hd256 = [dense_launches["gemma3-4b"], dense_launches["gemma-7b"],
             g3tp_launches]
    launches["rmsnorm"] += sum(n["rmsnorm"] for n in hd256) + \
        dense_launches["qwen3-32b"]["rmsnorm"]
    launches["flash_attention_wgmma"] += \
        dense_launches["qwen3-32b"]["flash_attention_wgmma"]
    launches["flash_attention"] = launches.pop("flash_attention_wgmma")
    launches["flash_attention_hd256"] = sum(n["flash_attention_wgmma"]
                                            for n in hd256)
    # the recurrent serve paths: their norms on the rmsnorm row, zamba2's
    # shared attention (head_dim 80) on the flash_attention_hd80 row
    launches["rmsnorm"] += sum(n["rmsnorm"]
                               for n in ssm_serve_launches.values())
    launches["flash_attention_hd80"] = sum(
        n.get("flash_attention_wgmma", 0)
        for n in ssm_serve_launches.values())
    # the frontend serve paths: their norms on the rmsnorm row; pixtral's
    # token prefill (bf16, wgmma) on the flash_attention_hd160 row, its
    # frames prefill (float32, CUDA cores) on flash_attention_hd160_f32
    # (musicgen's float32 flash at head_dim 64 is in the by-path line)
    launches["rmsnorm"] += sum(n["rmsnorm"]
                               for n in fe_serve_launches.values())
    # the MoE serve path: its norms on the rmsnorm row, its bf16 flash at
    # head_dim 128 on the flash_attention row
    for n in moe_serve_launches.values():
        launches["rmsnorm"] += n["rmsnorm"]
        launches["flash_attention"] += n["flash_attention_wgmma"]
    # the fixed-batch loops over TP ranks: their norms on the rmsnorm row;
    # zamba2's shared attention (head_dim 80) on the flash_attention_hd80
    # row, mixtral's (128, bf16) on the flash_attention row (musicgen's
    # float32 flash at 64 is in the by-path line)
    for a, n in fixed_tp_launches.items():
        launches["rmsnorm"] += n["rmsnorm"]
        if a == "zamba2-2.7b":
            launches["flash_attention_hd80"] += n["flash_attention_wgmma"]
        elif a == "mixtral-8x7b":
            launches["flash_attention"] += n["flash_attention_wgmma"]
    launches["flash_attention_hd160"] = \
        fe_serve_launches["pixtral-12b (tokens)"]["flash_attention_wgmma"]
    launches["flash_attention_hd160_f32"] = \
        fe_serve_launches["pixtral-12b (frames)"]["flash_attention"]
    launches["qacc"] = qacc_launches
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on its path")
        rows[name]["launches"] = n

    log("kernels: [" + ", ".join(f"{k} x{v}" for k, v in launches.items())
        + "]")
    log(f"two-tier: {json.dumps(two_tier)}")
    log(f"serve: {json.dumps(serve)}")
    log(f"runtime: {json.dumps(runtime)}")
    log(f"tp: {json.dumps(tp)}")
    log(f"serve-tp: {json.dumps(serve_tp)}")
    log("dense: " + json.dumps({
        "serve": dense, "serve-tp gemma3-4b": g3tp,
        "train gemma3-4b": g3train, "seconds": dense_s}))
    log(f"moe: {json.dumps(moe)}")
    log("ssm: " + json.dumps({"train": ssm_train, "serve": ssm_serve,
                              "seconds": ssm_s}))
    log("frontend: " + json.dumps({"serve": fe_serve, "train": fe_train,
                                   "seconds": fe_s}))
    log("remat-moe-serve: " + json.dumps({"remat": remat,
                                          "moe_serve": moe_serve,
                                          "seconds": p15_s}))
    log("ssm-tp: " + json.dumps({"train": ssm_tp_train,
                                 "fixed_batch": fixed_tp,
                                 "seconds": p16_s,
                                 "part_seconds": p16_parts}))
    log(f"tune: {json.dumps(tune_nums)}")
    log(f"train: {json.dumps(train)}; total {time.perf_counter() - t_all:.0f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
