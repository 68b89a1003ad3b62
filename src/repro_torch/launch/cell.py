"""The configurations the port's chip runs drive, defined once.

Train: full-width phi4-mini cut to 2 of its 32 layers, 4 DP ranks stacked
on one card, global batch 8 x 1024 tokens, the table bucket size, AdamW
with a 2-step warm-up.  Remat (on, the reference's default) does not lift
the cut: the step's peak is the 4 ranks' gradients and state after the
backward, 2.6 GiB a layer with remat or without (PERF.md).  ``chip_smoke.py`` and ``launch/profile_step.py``
both build their step from here, so the profiled step is the smoked one.
``hier_train_config`` stacks the same 4 ranks as two DP axes,
``("pod", "data")`` of shape ``HIER_DP`` = (2, 2), for the two-tier path.
Tensor parallelism: the same model and batch at ``TP_SHAPE`` = (dp, tp) =
(2, 2), under megatron_sp (24 heads, d_model 3072); its small
counterparts are ``tp_small_config`` (megatron_sp: d_model 1024, 8/4
heads) and ``tp_pure_sp_config`` (the reduced width, d_model 64:
pure_sp), float32.

Serve (``SERVE_CELL``): phi4-mini at full width and full depth, an 8-page
pool, a Poisson trace of 16 greedy requests at 0.5 per decode step with
prompts of 64-512 tokens and 32 new tokens each (a page of 1024 tokens).
``launch/serve.py`` takes its defaults from here and ``chip_smoke.py``
serves it, on one rank and at ``SERVE_TP_SHAPE`` = (dp, tp) = (2, 2):
the same model, weights and trace, 4 pages a DP rank, each page's 1024
slots split 512 a TP rank (megatron_sp prefill).

MoE (``MOE_TRAIN_CELL``): mixtral-8x7b at full width cut to 1 of its 32
layers, batch 8 x 1024, the float32 wire, at (dp, tp) = (2, 1) (the dense
capacity dispatch on each DP rank) and (2, 2) (megatron_sp with expert
parallelism: the dispatch and combine on the paper's all_to_all).  Served
(``MOE_SERVE_CELL``): mixtral-8x7b at full width cut to 8 layers through
the fixed-batch loop, 4 x 1024-token prompts.

The recurrent configs (``SSM_TRAIN_CELLS``, ``SSM_SERVE_CELLS``):
zamba2-2.7b at full width cut to 12 of its 54 Mamba2 blocks and
xlstm-125m at full depth, trained at p = 4 on the train cell's batch;
served through the fixed-batch loop (zamba2 at full depth, 4 x 1024-token
prompts; xlstm 8 x 1024), 32 greedy tokens each.  Each cell's comment
says why.

Over TP ranks (``SSM_TP_TRAIN_CELLS``, ``FIXED_TP_SERVE_CELLS``):
zamba2-2.7b's train cell at (dp, tp) = (2, 2) (megatron_sp) and
xlstm-125m at full width cut to 4 blocks at (2, 2) (pure_sp); zamba2's,
mixtral's and musicgen's fixed-batch serve cells over ``FIXED_TP`` = 2 TP
ranks.

The frontend configs (``FRONTEND_SERVE_CELLS``, ``FRONTEND_TRAIN_CELL``):
pixtral-12b at full depth and musicgen-medium at full depth served
through the fixed-batch loop on float32 frames; musicgen-medium at full
width cut to 16 of 48 layers trained at (dp, tp) = (4, 1) and (2, 2).

The serve fleet (``FLEET_CELL``): the serve cell's model and weights in
3 replicas of 3 pages, 12 requests over 3 sessions, with drains and a
respawn mid-trace.

The dense configs (``DENSE_SERVE_CELLS``): gemma3-4b at full depth
(``GEMMA3_SERVE_CELL``: prompts past its 1024-token local window, pages
of 2048), gemma-7b at full depth (``GEMMA7B_SERVE_CELL``) and qwen3-32b at
full width cut to 16 of its 64 layers (``QWEN3_SERVE_CELL``); the
gemma3-4b train cell (``model_config("gemma3-4b")``) is the phi4-mini
one's cut at a second arch.  Each cell's docstring says why.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.data import DataConfig
from repro_torch.train.step import TrainConfig

ARCH = "phi4-mini-3.8b"
N_LAYERS = 2
N_DP = 4
#: the 4 ranks as (pods, data) for the two-tier (bine_hier) path
HIER_DP = (2, 2)
#: the 4 ranks as (dp, tp): 2 DP ranks of 2 tensor-parallel ranks each
TP_SHAPE = (2, 2)
GLOBAL_BATCH = 8
SEQ_LEN = 1024


def model_config(arch: str = ARCH) -> ModelConfig:
    """The train cell's model: ``arch`` at full width cut to
    ``N_LAYERS``.  Its second arch is gemma3-4b (d_model 2560, 8/4 heads
    of 256, d_ff 10240, a tied vocabulary of 262144): 859,846,144 params,
    both layers local, their 1024-token window the whole sequence, at the
    same p = 4, batch 8 x 1024 and buckets; its head and loss carry 1.31x
    phi4-mini's vocabulary."""
    return base.get_config(arch).replace(n_layers=N_LAYERS)


@dataclass(frozen=True)
class TrainCell:
    """A train cell: ``arch`` at full width cut to ``n_layers``, run at
    each (dp, tp) of ``meshes`` on ``data_config``'s batch, with the
    config's remat unless ``remat`` is False."""
    arch: str
    n_layers: int
    meshes: Tuple[Tuple[int, int], ...]
    remat: bool = True

    def model_config(self) -> ModelConfig:
        cfg = base.get_config(self.arch).replace(n_layers=self.n_layers)
        return cfg if self.remat else cfg.replace(remat=False)


#: mixtral-8x7b (arXiv:2401.04088) at full width: d_model 4096, 32/8 heads
#: of 128, 8 experts of d_ff 14336 in 2 blocks each (16 expert blocks),
#: top-2, capacity factor 1.25, an untied vocabulary of 32000; cut to 1 of
#: its 32 layers, 1,713,418,240 params (3.4 GB bf16): embedding and head
#: 2 x 131.07 M, attention 41.94 M, experts 3 x 469.76 M, router 32,768.
#: At (2, 1) each DP rank runs the dense capacity dispatch over its 4096
#: tokens; at (2, 2) the model axis runs megatron_sp attention and expert
#: parallelism, 8 expert blocks a TP rank, each rank's 2048 tokens sent to
#: the blocks' ranks and back by the collectives API's all_to_all (the
#: decision table's ``bine``).  Users train mixtral so, its experts over
#: the model axis; one layer keeps the step's weights, optimizer state and
#: EP activations on one card for both meshes.
MOE_TRAIN_CELL = TrainCell("mixtral-8x7b", 1, ((2, 1), (2, 2)))

#: zamba2-2.7b (arXiv:2411.15242) at full width: d_model 2560, Mamba2
#: blocks of d_inner 5120 (80 heads of 64, state 64, conv 4, chunk 128),
#: the shared attention block (32/32 heads of 80, d_ff 10240) after every
#: 6th, a tied vocabulary of 32000; cut to 12 of its 54 Mamba2 blocks, so
#: two firings of the tied shared block (665,381,184 params, bf16; its
#: Mamba2 A_log, D and dt_bias in float32).  Twelve keep both firings'
#: gradient sum on the path and the 4 stacked ranks' weights, ZeRO state
#: and SSD activations (intra-chunk tensors [2, 128, 128, 80] float32 per
#: chunk and layer a rank) on one card.  Users train zamba2 so:
#: data-parallel, its long-context state O(1) in the sequence.
ZAMBA2_TRAIN_CELL = TrainCell("zamba2-2.7b", 12, ((4, 1),))
#: xlstm-125m (arXiv:2405.04517) at full depth: 12 blocks of d_model 768,
#: 9 mLSTM (4 heads in the 1536-wide inner dim, chunk 128) and 3 sLSTM
#: (every 4th: a 1024-step scan over 768 units), a tied vocabulary of
#: 50304 (95,402,496 params, bf16).  Full depth because it is small; the
#: sLSTM scan is a Python loop of about 20 small launches a step, so this
#: cell measures what the host costs a recurrent model.  Without remat:
#: under it each of the loop's ops also runs the checkpoint's Python
#: saved-tensor hooks and runs again in the backward, and a step took
#: 45.8-50.0 s on an H100 against 16-20 s without (phase 13 of the smoke
#: 513 s against ~290, the whole smoke 1191 s of its 1200; PERF.md);
#: remat on == off bitwise stays held on the CPU (tests/test_torch_remat.py).
XLSTM_TRAIN_CELL = TrainCell("xlstm-125m", 12, ((4, 1),), remat=False)
SSM_TRAIN_CELLS = (ZAMBA2_TRAIN_CELL, XLSTM_TRAIN_CELL)
#: musicgen-medium (arXiv:2306.05284) at full width: d_model 1536, 24/24
#: heads of 64, d_ff 6144, an untied vocabulary of 2048 EnCodec codes, its
#: frontend stub's frontend_proj [128, 1536]; cut to 16 of its 48 layers
#: (610,518,528 params, bf16), trained on float32 frames (the batch's 8 x
#: 1024 frames of 128), so its stream, Q/K/V and logits run in float32
#: over bf16 weights, as the reference's do.  Depth cut for the smoke's
#: time, not for memory: with remat (``cfg.remat``, the reference's
#: default) the (2, 2) step peaked at 8.45 GiB at 8 layers and 14.82 at
#: 16 on an H100, 0.80 GiB a layer, against 20.62 and 40.91 (2.54 a
#: layer) without (PERF.md), so all 48 would fit near 40 GiB; 16 keep
#: its steps (~1.2-1.5 s) within the smoke's time.  At (4, 1)
#: pure data parallelism; at (2, 2) megatron_sp (24 heads over 2, d_model
#: 1536 >= 1024), the replicated frontend_proj projecting each TP rank's
#: sequence shard.  Users train musicgen so: data-parallel on EnCodec
#: frames, tensor parallel where a model outgrows a rank.
FRONTEND_TRAIN_CELL = TrainCell("musicgen-medium", 16, ((4, 1), (2, 2)))
#: the recurrent configs over TP ranks, 2 DP ranks of 2 TP ranks stacked
#: on the card.  zamba2-2.7b's cell above at (2, 2): megatron_sp (32
#: heads over 2, d_model 2560), each TP rank 40 of its 80 Mamba2 heads
#: (2560 of the 5120 channels, its share of each gated norm reduced over
#: the ranks) and 16 of the shared block's 32 attention heads; users
#: train a hybrid so where it outgrows a rank.  xlstm-125m at full width
#: cut to 4 of its 12 blocks (3 mLSTM, 1 sLSTM: each kind on the path) at
#: (2, 2): pure_sp (4 heads, d_model 768 < 1024), each TP rank running
#: every recurrent block on the whole gathered sequence and keeping its
#: own half; cut because its sLSTM scan is a Python loop of ~20 launches
#: a step, which a full-depth step (16-20 s at p = 4) would repeat past
#: the smoke's time.  Both without remat for xlstm, as its p = 4 cell.
SSM_TP_TRAIN_CELLS = (TrainCell("zamba2-2.7b", 12, ((2, 2),)),
                      TrainCell("xlstm-125m", 4, ((2, 2),), remat=False))
#: each train cell by arch (``launch/profile_step.py --arch``; the others
#: take ``model_config(arch)``)
TRAIN_CELLS = {c.arch: c for c in (MOE_TRAIN_CELL,) + SSM_TRAIN_CELLS
               + (FRONTEND_TRAIN_CELL,)}


def tp_small_config() -> ModelConfig:
    """A small megatron_sp model (the reference's test_parallel_equiv
    cfgA widths: d_model 1024, 8/4 heads, qk_norm, an untied head),
    float32."""
    return base.get_config(ARCH).replace(
        n_layers=2, d_model=1024, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=128, attn_chunk=32, qk_norm=True,
        tie_embeddings=False, rope_theta=1e6, dtype="float32")


def tp_pure_sp_config() -> ModelConfig:
    """phi4-mini at the reduced width (d_model 64 < 1024: pure_sp),
    float32."""
    return base.reduced(base.get_config(ARCH)).replace(dtype="float32")


def data_config(cfg: ModelConfig) -> DataConfig:
    """The train cells' batch: 8 x 1024 tokens, or for a frontend model
    float frames of its ``frontend_dim`` (``train.data.make_batch``)."""
    return DataConfig(global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                      vocab_size=cfg.vocab_size,
                      frontend_dim=cfg.frontend_dim if cfg.frontend else 0)


def train_config(backend: str, wire_dtype: str,
                 topology: str = "tpu_multipod") -> TrainConfig:
    return TrainConfig(backend=backend, wire_dtype=wire_dtype,
                       topology=topology,
                       adamw=AdamWConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=100))


def hier_train_config(backend: str, wire_dtype: str) -> TrainConfig:
    """``train_config`` over two DP axes: pass ``HIER_DP`` as the step's
    ``dp``."""
    return train_config(backend, wire_dtype).replace(
        dp_axes=("pod", "data"))


@dataclass(frozen=True)
class ServeCell:
    arch: str = ARCH
    #: layers kept (None: the config's full depth)
    n_layers: Optional[int] = None
    slots: int = 8
    requests: int = 16
    rate: float = 0.5            # Poisson arrivals per decode step
    prompt_len_min: int = 64
    prompt_len_max: int = 512
    max_new: int = 32
    temperature: float = 0.0     # greedy
    seed: int = 0


SERVE_CELL = ServeCell()
#: the serve cell's ranks under tensor parallelism: (dp, tp)
SERVE_TP_SHAPE = (2, 2)


#: gemma3-4b at full width and full depth (34 layers: 29 local with a
#: 1024-token window, 5 global; 3,879,925,248 params, 7.8 GB bf16), 4
#: pages, 8 greedy Poisson requests at 0.5 per decode step with prompts of
#: 1088-1984 tokens and 32 new tokens each, so pages of 2048 tokens.  Every
#: prompt passes the local window: the local layers' prefill runs the
#: windowed flash with its dead key tiles skipped and their 1024-slot ring
#: caches wrap, while the global layers hold all 2048 slots.  Users send
#: such traffic when they serve gemma3 at a context past its local window,
#: which is what the 5:1 pattern is for.
GEMMA3_SERVE_CELL = ServeCell(arch="gemma3-4b", slots=4, requests=8,
                              prompt_len_min=1088, prompt_len_max=1984)
#: gemma-7b at full width and full depth (28 layers, 8,537,680,896 params,
#: 17.1 GB bf16): multi-head attention (16 query and 16 KV heads, g = 1)
#: at head_dim 256, on SERVE_CELL's trace shape (prompts of 64-512
#: tokens, 32 new, pages of 1024) cut to 8 requests.
GEMMA7B_SERVE_CELL = ServeCell(arch="gemma-7b", requests=8)
#: qwen3-32b at full width (d_model 5120, 64/8 heads, d_ff 25600, an
#: untied head of 151936) cut to 16 of its 64 layers (9,357,403,136
#: params, 18.7 GB bf16), on SERVE_CELL's trace shape cut to 8 requests.
#: Depth cut because ``models.transformer.init_params`` draws each stacked
#: leaf whole in float32 before the cast: at 64 layers ``wi`` alone is a
#: 33.6 GB draw beside 65.5 GB of bf16 weights, more than the card holds;
#: at 16 the largest draw is 8.4 GB, and the three dense cells serve
#: within the smoke's time.
QWEN3_SERVE_CELL = ServeCell(arch="qwen3-32b", n_layers=16, requests=8)
DENSE_SERVE_CELLS = (GEMMA3_SERVE_CELL, GEMMA7B_SERVE_CELL, QWEN3_SERVE_CELL)
#: the recurrent configs, served as the reference serves them: the pool
#: refuses them (their state would integrate the padding), so one
#: lock-step batch of ``slots`` prompts of ``prompt_len_max`` tokens
#: through ``launch.serve.run_fixed_batch``, ``max_new`` greedy tokens.
#: zamba2-2.7b at full width and full depth (54 Mamba2 blocks, 9 firings
#: of the shared attention at head_dim 80; 2,340,466,848 params, 4.7 GB
#: bf16), 4 prompts of 1024 tokens: a batch of long-context requests, what
#: a hybrid is for; its prefill runs the flash kernel at head_dim 80.
ZAMBA2_SERVE_CELL = ServeCell(arch="zamba2-2.7b", slots=4, requests=4,
                              prompt_len_min=1024, prompt_len_max=1024)
#: xlstm-125m at full depth, 8 prompts of 1024 tokens: a small model
#: served in bulk, its decode state O(1) in the sequence.
XLSTM_SERVE_CELL = ServeCell(arch="xlstm-125m", slots=8, requests=8,
                             prompt_len_min=1024, prompt_len_max=1024)
SSM_SERVE_CELLS = (ZAMBA2_SERVE_CELL, XLSTM_SERVE_CELL)
#: the frontend stubs, served as the reference serves them: the pool
#: refuses them (no token stream), so ``run_fixed_batch`` with random
#: float32 frames as the prompt and as each decode step's input, 32
#: greedy tokens.  pixtral-12b (hf mistralai/Pixtral-12B-2409) at full
#: width and full depth: 40 layers of d_model 5120, 32/8 heads of 160,
#: d_ff 14336, an untied vocabulary of 131072, 1024-d ViT patch features
#: into frontend_proj (12,777,313,280 params, 25.6 GB bf16; init_params
#: draws ``wi`` whole in float32, an 11.7 GB transient, so it fits), 4
#: prompts of 1024 patches: a batch of images at the ViT's patch count.
#: Its frames run float32 over the bf16 weights, so the prefill launches
#: the CUDA-core flash kernel at head_dim 160, 40 a prefill (a text-only
#: request, a token prompt, runs the wgmma kernel at 160).
PIXTRAL_SERVE_CELL = ServeCell(arch="pixtral-12b", slots=4, requests=4,
                               prompt_len_min=1024, prompt_len_max=1024)
#: musicgen-medium at full width and full depth (48 layers,
#: 1,818,576,384 params), 8 prompts of 1024 EnCodec frames of 128: a batch
#: of audio continuations; its float32 prefill runs the CUDA-core flash
#: kernel at head_dim 64.
MUSICGEN_SERVE_CELL = ServeCell(arch="musicgen-medium", slots=8, requests=8,
                                prompt_len_min=1024, prompt_len_max=1024)
FRONTEND_SERVE_CELLS = (PIXTRAL_SERVE_CELL, MUSICGEN_SERVE_CELL)
#: mixtral-8x7b (arXiv:2401.04088) at full width (d_model 4096, 32/8 heads
#: of 128, 8 experts of d_ff 14336 in 2 blocks each, top-2, a 4096-token
#: window, an untied vocabulary of 32000), served as the reference serves
#: MoE: the pool refuses it (a token's keep or drop depends on the batch),
#: so ``run_fixed_batch``, 4 prompts of 1024 tokens and 32 greedy tokens:
#: long-context batch requests to a sparse model, how users serve
#: mixtral.  Cut to 8 of its 32 layers (11,872,309,248 params, 23.7 GB
#: bf16) because ``models.transformer.init_params`` draws each stacked
#: leaf whole in float32 before the cast: at 8 layers ``wi`` alone is a
#: 15.0 GB draw beside the bf16 weights; at 16 layers the weights and that
#: draw would need ~77 GB.  The prefill dispatches the batch's 4096 tokens
#: to 1280 slots an expert; each decode step's 4 tokens to 2 slots an
#: expert (tokens drop), and reads every expert weight.  The window lies
#: past the 1024-token prompt, so the prefill runs the causal flash kernel
#: at head_dim 128 on wgmma.
MOE_SERVE_CELL = ServeCell(arch="mixtral-8x7b", n_layers=8, slots=4,
                           requests=4, prompt_len_min=1024,
                           prompt_len_max=1024)
#: the fixed-batch loop over TP ranks: zamba2-2.7b (megatron_sp: its
#: Mamba2 heads and states split over the ranks, its shared attention's
#: heads and 1024-slot caches too), mixtral-8x7b x8 (megatron_sp, the
#: prefill's 1024 tokens a sequence on expert parallelism) and
#: musicgen-medium (megatron_sp, frames), each its one-rank cell above
#: over ``FIXED_TP`` TP ranks: how users serve a model too large or too
#: slow for one rank's memory bandwidth
FIXED_TP = 2
FIXED_TP_SERVE_CELLS = (ZAMBA2_SERVE_CELL, MOE_SERVE_CELL, MUSICGEN_SERVE_CELL)


@dataclass(frozen=True)
class FleetCell:
    """A serve fleet: ``replicas`` replicas of ``serve``'s model, each
    with ``serve.slots`` pages, over one set of engine fns and one copy of
    the weights; ``serve``'s trace tagged with ``sessions`` session ids
    (the router's affinity key); ``events`` the (tick, action, replica)
    drains and respawns fired mid-trace."""
    serve: ServeCell
    replicas: int
    sessions: int
    events: Tuple[Tuple[int, str, int], ...]


#: phi4-mini at full width and depth (SERVE_CELL's model and weights) in 3
#: replicas of 3 pages of 1024 tokens, 12 greedy Poisson requests at 1.0
#: per tick with prompts of 64-512 tokens and 16 new tokens each over 3
#: sessions, replica 1 drained at tick 4 and respawned at 9, replica 2
#: drained at 7.  Bytes: the weights held once, 3,836,021,760 params (7.67
#: GB bf16), and 9 pages x 128 MiB of bf16 K/V (32 layers x 1024 slots x
#: 8 KV heads x 128 x 2 (K and V) x 2 bytes), 1.125 GiB.  Users run a
#: fleet of data-parallel replicas behind a session-affine router when one
#: replica's pool cannot hold the traffic, and drain and respawn replicas
#: as hosts come and go.
FLEET_CELL = FleetCell(
    serve=ServeCell(slots=3, requests=12, rate=1.0, max_new=16),
    replicas=3, sessions=3,
    events=((4, "drain", 1), (9, "respawn", 1), (7, "drain", 2)))
#: each served arch's cell (``launch/profile_serve.py --arch``)
SERVE_CELLS = {c.arch: c for c in (SERVE_CELL,) + DENSE_SERVE_CELLS +
               SSM_SERVE_CELLS + FRONTEND_SERVE_CELLS + (MOE_SERVE_CELL,)}


def serve_model_config(c: ServeCell = SERVE_CELL) -> ModelConfig:
    """A serve cell's model: full depth unless the cell cuts it."""
    cfg = base.get_config(c.arch)
    return cfg if c.n_layers is None else cfg.replace(n_layers=c.n_layers)
