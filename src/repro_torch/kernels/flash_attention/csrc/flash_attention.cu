// Flash-attention kernel: causal GQA with an optional sliding window,
// online softmax (sm_90a).  Plain C interface, loaded with ctypes by
// ../kernel.py.
//
// Replaces repro/kernels/flash_attention/kernel.py:91
// (flash_attention_kernel, body :36): q [B, nkv, g, Tq, hd], k and v
// [B, nkv, Tk, hd] -> o like q, for each query row
//   s = (q . k) * scale, masked where NOT (kpos < Tk, causal: kpos <= qpos,
//       window: qpos - kpos < window) to NEG_INF = -1e30,
//   online softmax with float32 running max m, denominator l and
//   accumulator acc over the key tiles; o = acc / max(l, 1e-30), cast to
//   q's dtype.  A row with no live key gives 0, not NaN.
// The tensors may be strided views (the head dim contiguous), so the
// caller's [B, T, heads, hd] layout is read and written in place.
//
// Three kernels compute it; the wrapper's predicate (kernel.py,
// flash_uses_wgmma) and the dtype pick one, never by retrying:
//
// 1. flash_kernel_wgmma, on the tensor cores, for bf16 q, k, v with
//    head_dim in (16, 32, 64, 80, 128, 160, 256) whose strides and base
//    addresses TMA can take (multiples of 16 bytes).  Bound: the larger
//    of operations, 4 hd flops per live (query head, query, key) pair
//    over the H100's 989 TFLOP/s bf16 tensor-core peak (0.0065 ms at q
//    [1, 1024, 24, 128] causal), and bytes, q, k, v read and o written
//    once over 3.35 TB/s (0.0250 ms at zamba2's q [4, 1024, 32, 80]).
//    Design: one block of one consumer warpgroup (128 threads) per
//    (batch, query head, 64 queries; two warpgroups at head_dim 80 and
//    256, below).
//    The serve cell's 1024-token
//    prefill is then 384 blocks, two resident per SM: the causal
//    imbalance (a query tile's key count grows with its row) is spread
//    over many small blocks.  Blocks that fold a GQA group's heads (each
//    K/V tile loaded once for the group, as the TPU kernel folds g into
//    its rows) were slower at that shape on an H100 (PERF.md) and
//    pay only on grids that fill the card several times over, which no
//    path of the port launches yet.  The blocks with the most live key
//    tiles launch first.
//    Thread 0 loads by TMA: the Q tiles once, then a ring of 2 (3 at
//    256) stages of 64-key K and V tiles, each stage with a full and an
//    empty mbarrier; a stage is refilled once its tile's warpgroups have
//    released it.  A tile is
//    panels of 64 rows, one TMA box each: 64-column panels swizzled over
//    128 bytes (the whole row below head_dim 64), then, where 64 does not
//    divide head_dim, one narrower tail panel in its own swizzle and
//    tensor map: 64 + 64 + 32 columns (the tail over 64 bytes) at 160,
//    64 + 16 (over 32 bytes) at 80.  No panel holds a column past
//    head_dim, so the transaction bytes a stage waits for are the tile's
//    real bytes.  The warpgroup runs, per live key tile:
//      S = Q K^T as head_dim/16 m64n64k16 wgmmas, Q and K K-major from
//        shared memory (each k step in its panel's layout), into 32
//        float32 registers a thread;
//      the online softmax in registers, in log2 units (exp2f, log2(e)
//        folded into the scale: expf's range reduction made the softmax,
//        not the tensor cores, the limit); a row's 64 scores lie in the 4
//        lanes of a quad (two shuffles for its max and sum), and a tile
//        live for every row and key skips the masks;
//      O += P V as m64n{hd}k16 wgmmas with A from registers (at hd 256
//        two m64n128k16 over V's column halves; at 160 m64n128k16 and
//        m64n32k16 over the full and the tail panels, at 80 m64n64k16
//        and m64n16k16): the S accumulator's layout is wgmma's
//        register-A layout, so P packs to bf16 pairs with no shuffle.  P
//        is split, p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both
//        multiply the same V tile (V read MN-major through the
//        transpose-B bit): p keeps about 16 significant bits, so PV's
//        error stays near the float32 sum-order error, far below the
//        output's one bf16 rounding.  The split doubles PV's tensor-core
//        work (under 10 us at T = 1024).
//    At head_dim 80 (zamba2-2.7b's shared attention) a block holds two
//    consumer warpgroups, 128 query rows, that share the K/V ring: each
//    K/V tile is read from L2 once for both, and a warpgroup passes over
//    a tile dead for its own rows (it waits for it and releases it).
//    At head_dim 256 (gemma3-4b's and gemma-7b's inserts: 256 blocks on
//    132 SMs, one block an SM, the heaviest first) the SMs' loads are
//    already even, so the time is one warpgroup's serial chain of key
//    tiles (QK^T, softmax, PV; 32 at T = 2048 causal), and the tensor
//    pipe idles under its softmax.
//    There a block holds two consumer warpgroups (256 threads) over its
//    one 64-row Q tile, and they take the block's live key tiles in turn
//    (warpgroup w the tiles j = w mod 2 of the block's range): each chain
//    is half as long, and one warpgroup's softmax runs under the other's
//    products.  A stage's empty barrier counts only the warpgroup its tile
//    was dealt to, and that warpgroup's first thread refills it with tile
//    j + 3 (the other warpgroup's).  A stage's tiles alternate between the
//    warpgroups, so each stage has a full barrier a warpgroup: one
//    barrier's phases would let a warpgroup whose wait comes before the
//    other's tile lands read that unfinished phase's parity as its own
//    tile's.
//    Each warpgroup keeps its own online softmax (m, l, float32
//    accumulator; m = NEG_INF, l = 0 where it got no tile), and the two
//    merge through the drained ring (split_epilogue): each hands the
//    other the half of its accumulator that the other writes (64 KB in
//    all) with its m and l, then writes 128 of the 256 columns.
//    Registers: hd/2 accumulators a thread (40 at hd 80, 64 at 128, 80 at
//    160, 128 at 256) and 32 scores.  Shared memory: the Q tiles and 4
//    (6 at 256) K/V tiles of 64 x hd bf16: 61 KB at hd 80 (two blocks an
//    SM), 81 KB at 128 (two), 101 KB at 160 (two), 225 KB at 256 (one);
//    the launch bounds ask for two blocks an SM at 80 and 160
//    (Geo::MIN_BLOCKS).
//    Issuing tile j+1's QK^T before tile j's PV (its softmax under the
//    PV) measured slower at 80 and 160 on an H100, and so did one tensor
//    map a tensor in narrower swizzles (five 32- or 16-column panels) at
//    80 (PERF.md, section 6).
// 2. flash_kernel_f32, on the CUDA cores, for float32 q, k, v at every
//    head_dim.  Bound: operations, 4 hd flops per live (query head, query,
//    key) pair over the H100's 67 TFLOP/s float32 peak (0.6417 ms at
//    pixtral-12b's frames prefill, q [4, 1024, 32, 160] over 8).  What
//    limits it is the shared-memory pipe: an SM issues 128 FFMAs a clock
//    but moves 32 lane-floats of shared data a clock, and a 16-byte load
//    costs a quarter-warp's wavefront each even when the lanes share its
//    address (PERF.md: Q read as whole-warp broadcasts measured slower).
//    So the design counts the floats each lane loads per FMA (0.25 keeps
//    up with the FMAs; the old kernel's was 0.5 in QK^T).
//    One block of 8 warps (256 threads) per (batch, query head, 128 query
//    rows; 64 at head_dim 256), the blocks with the most live key tiles
//    first.  Each warp owns 16 query rows (8 at 256) outright: their
//    scores, softmax and output.  So P and the rows' rescale pass through
//    the warp's own slice of shared memory under __syncwarp, and a key
//    tile dead for the warp's rows is skipped by that warp alone.
//    Q, K and V lie row-major in shared memory, rows padded by 4 floats
//    (16-byte reads of 8 consecutive rows hit 8 different bank groups at
//    every head_dim), filled by cp.async: 16-byte copies where every base
//    and stride allows, else 4-byte ones; rows past Tq or Tk are
//    zero-filled.  Q is loaded once; K and V are one 64-key tile each,
//    and V tile j lands under tile j's QK^T while K tile j + 1 lands under
//    tile j's PV (two barriers a tile).
//    QK^T: lane (ty, tx) of a warp's TR x TC grid (4 x 8; 2 x 16 at 256)
//    holds the scores of rows ty + TR i and keys tx + TC j; a 4-deep step
//    of d reads a float4 of each (4 + 8: 0.375 floats a FMA).  Softmax in
//    log2 units (exp2f of the scores scaled by scale log2(e)), a row's
//    max across its TC lanes by shuffles; each lane keeps its own part of
//    the row sum, summed across the lanes once at the end.
//    PV: lane (uy, ux) of a TR2 x TC2 grid holds rows uy + TR2 i and
//    columns VW (ux + TC2 c) + e (e < VW); each 4 keys it reads a float4
//    of P per row (4 consecutive keys) and VW columns of each V row.  At
//    160 a lane holds all 16 rows and 5 columns (0.26 floats a FMA), at
//    80 8 rows and 5 columns, at 64 8 rows and 4.
//    Shared memory: (BQ + 2 BK) (hd + 4) + BQ (BK + TC) + 2 BQ floats:
//    201 KB at 160, 216 KB at 256, 169 KB at 128 and 121 KB at 80 (one
//    block an SM), 105 KB at 64 (two).  No spilled register.
//    Split-TF32 products on the tensor cores (mma.sync m16n8k8, three
//    products a term) measured faster only while they accumulated P V in
//    the tensor cores across all key tiles, which doubled the frames
//    prefill's logit error; summed apart they ran no faster (PERF.md).
// 3. flash_kernel_bf16, for the bf16 calls the tensor-core predicate
//    refuses (strides or base addresses TMA cannot take): one block of 256
//    threads per (batch, query head, 64-row query tile) that stages Q, K
//    and V as float32 through shared memory (rows padded by one float) and
//    walks the live 64-key tiles; thread (ty, tx) of the 16 x 16 grid
//    holds the scores of rows 4ty..4ty+3 and keys tx + 16j (j < 4) and the
//    accumulator of those rows for columns tx + 16c (c < hd/16).  Shared
//    memory BQ (hd+1) + 2 BK (hd+1) + BQ (BK+4) floats (210 KB at 256).
//
// Numerics: no fast math; exp2f of log2(e)-scaled scores (expf in
// flash_kernel_bf16), IEEE division; sums in another order than the
// plain version's, so results agree within float32 rounding (2e-5) and,
// for bf16 inputs, within bf16 rounding (3e-2).
// Kernels launch on the caller's stream and allocate nothing; each C
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long qb, qn, qg, qt;   // q [B, nkv, g, Tq, hd]
  long long kb, kn, kt;       // k [B, nkv, Tk, hd]
  long long vb, vn, vt;       // v
  long long ob, on, og, ot;   // o like q
};

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace cc {

template <int HD>
struct Geo {
  static constexpr int WM = HD == 256 ? 8 : 16;   // query rows a warp
  static constexpr int NW = 8;                     // warps a block
  static constexpr int THREADS = 32 * NW;
  static constexpr int BQ = WM * NW;               // query rows a block
  static constexpr int BK = 64;                    // keys a tile
  static constexpr int RS = HD + 4;                // padded Q, K, V row
  // QK^T: a warp's WM x BK scores on a TR x TC lane grid, SR x SK a lane
  static constexpr int TR = WM / 4;
  static constexpr int TC = 32 / TR;
  static constexpr int SR = WM / TR;
  static constexpr int SK = BK / TC;
  // P's row pitch: PS = TC mod 32 makes the lanes' stores hit 32 banks,
  // and rows 2 or 4 float4s apart keep PV's P reads conflict-free
  static constexpr int PS = BK + TC;
  // PV: a warp's WM x HD output on a TR2 x TC2 lane grid, OR x OC a lane,
  // read from V in vectors of VW columns
  static constexpr int TC2 = HD == 16 || HD == 32 ? 8
                             : HD == 64 || HD == 80 ? 16
                                                    : 32;
  static constexpr int TR2 = 32 / TC2;
  static constexpr int OR = WM / TR2;
  static constexpr int OC = HD / TC2;
  static constexpr int VW = OC % 4 == 0 ? 4 : OC % 2 == 0 ? 2 : 1;
  // the d loop's unroll: as deep as the registers hold without spilling
  static constexpr int UNROLL = HD <= 64 || HD == 160 ? 2 : 4;
  // Q, K, V, the warps' P slices, then each row's rescale and sum
  static constexpr int FLOATS = (BQ + 2 * BK) * RS + BQ * PS + 2 * BQ;
  // two blocks an SM at 64 (registers <= 128), one elsewhere (at 16 and
  // 32 the launch bounds' cap of 128 registers spilled)
  static constexpr int MIN_BLOCKS = HD == 64 ? 2 : 1;
  static_assert(HD % 16 == 0 && TR * TC == 32 && SR * TR == WM &&
                    SK * TC == BK && SR * SK <= 32,
                "QK^T lane grid");
  static_assert(TR2 * TC2 == 32 && OR * TR2 == WM && OC * TC2 == HD &&
                    TR2 <= 4,
                "PV lane grid");
  static_assert(PS % 32 == TC && (BQ * HD / 4) % THREADS == 0 &&
                    (BK * HD / 4) % THREADS == 0,
                "shared layout");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows t0 .. t0 + ROWS - 1 of a [T, HD] view (row stride ``stride``) into
// ``dst`` [ROWS][HD + 4], rows from ``n`` on as zeros: 16-byte copies when
// ``vec`` (every base and stride a multiple of 16 bytes), else 4-byte ones
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int t0, int n,
                                          bool vec) {
  constexpr int CH = HD / 4;   // 16-byte pieces a row
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / CH, x = (c % CH) * 4, t = t0 + r;
    const bool in = t < n;
    const float* g = in ? src + t * stride + x : src;
    float* s = dst + r * (HD + 4) + x;
    if (vec) {
      cp_async16(s, g, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(s + e, in ? g + e : src, in);
    }
  }
}

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// VW consecutive floats at p (16-, 8- or 4-byte aligned) into r
template <int VW>
__device__ __forceinline__ void load_vec(float (&r)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x;
    r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

template <int HD>
__global__ void __launch_bounds__(Geo<HD>::THREADS, Geo<HD>::MIN_BLOCKS)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int nkv,
                 int g, int Tq, int Tk, Strides st, int window, int causal,
                 float scale, int vec) {
  using G = Geo<HD>;
  constexpr int WM = G::WM, BK = G::BK, RS = G::RS, PS = G::PS;
  constexpr int TR = G::TR, TC = G::TC, SR = G::SR, SK = G::SK;
  constexpr int TR2 = G::TR2, TC2 = G::TC2, OR = G::OR, OC = G::OC;
  constexpr int VW = G::VW;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][RS]
  float* Ks = Qs + G::BQ * RS;                    // [BK][RS]
  float* Vs = Ks + BK * RS;                       // [BK][RS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Ps = Vs + BK * RS + warp * WM * PS;      // this warp's [WM][PS]
  float* Al = Vs + BK * RS + G::BQ * PS + warp * WM;   // its rows' rescale
  float* Ls = Al + G::BQ;                              // its rows' sums

  const int head = blockIdx.x;
  const int hg = head % g, hn = (head / g) % nkv, b = head / (g * nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::BQ;   // heaviest first
  const float* qp = q + b * st.qb + hn * st.qn + hg * st.qg;
  const float* kp = k + b * st.kb + hn * st.kn;
  const float* vp = v + b * st.vb + hn * st.vn;

  // the block's live key tiles (the TPU kernel's block skipping,
  // kernel.py:49-54), then this warp's: none past Tq
  const int q_last = min(q0 + G::BQ - 1, Tq - 1);
  int kt_end = (Tk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int wq0 = q0 + warp * WM, wq_last = min(wq0 + WM - 1, Tq - 1);
  int w_begin = 0;
  if (window > 0 && wq0 - window + 1 > 0) w_begin = (wq0 - window + 1) / BK;
  const int w_end = wq0 >= Tq ? 0 : causal ? min(kt_end, wq_last / BK + 1)
                                           : kt_end;

  load_rows<HD, G::BQ, G::THREADS>(Qs, qp, st.qt, q0, Tq, vec);
  if (kt_begin < kt_end)
    load_rows<HD, BK, G::THREADS>(Ks, kp, st.kt, kt_begin * BK, Tk, vec);

  // QK^T lane (ty, tx): rows ty + TR i, keys tx + TC j of the warp's tile;
  // PV lane (uy, ux): rows uy + TR2 i, columns VW (ux + TC2 c) + e
  const int ty = lane / TC, tx = lane % TC;
  const int uy = lane / TC2, ux = lane % TC2;
  const float c2 = scale * 1.4426950408889634f;   // log2(e) folded in
  float acc[OR][OC];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  // each row's running max (log2 units) and this lane's part of its sum
  float mrow[SR], lrow[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    __syncthreads();   // K tile kt (and Q) landed; V's last readers done
    load_rows<HD, BK, G::THREADS>(Vs, vp, st.vt, k0, Tk, vec);
    const bool live = kt >= w_begin && kt < w_end;
    if (live) {
      float s[SR][SK];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) s[i][j] = 0.0f;
      const float* qr = Qs + (warp * WM + ty) * RS;
      const float* kr = Ks + tx * RS;
#pragma unroll (G::UNROLL)
      for (int d = 0; d < HD; d += 4) {
        float4 a[SR];
#pragma unroll
        for (int i = 0; i < SR; ++i)
          a[i] = *reinterpret_cast<const float4*>(qr + i * TR * RS + d);
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kr + j * TC * RS + d);
#pragma unroll
          for (int i = 0; i < SR; ++i) {
            s[i][j] = fmaf(a[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(a[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(a[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(a[i].w, kv.w, s[i][j]);
          }
        }
      }

      // online softmax, the plain version's masks; a tile live for every
      // (row, key) of the warp skips them
      uint32_t ok = 0xffffffffu;
      if (!(k0 + BK <= Tk && (!causal || k0 + BK - 1 <= wq0) &&
            (window <= 0 || wq_last - k0 < window))) {
        ok = 0;
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          const int tq = wq0 + ty + TR * i;
#pragma unroll
          for (int j = 0; j < SK; ++j) {
            const int tk = k0 + tx + TC * j;
            const bool in = tk < Tk && (!causal || tk <= tq) &&
                            (window <= 0 || tq - tk < window);
            ok |= static_cast<uint32_t>(in) << (i * SK + j);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < SK; ++j)
          if ((ok >> (i * SK + j)) & 1u) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int off = TC / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(mrow[i], mx * c2);
        float rs = 0.0f;
        float* prow = Ps + (ty + TR * i) * PS + tx;
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          const float p = (ok >> (i * SK + j)) & 1u
                              ? exp2f(fmaf(s[i][j], c2, -mn))
                              : 0.0f;
          rs += p;
          prow[TC * j] = p;
        }
        const float alpha = exp2f(mrow[i] - mn);
        lrow[i] = lrow[i] * alpha + rs;
        mrow[i] = mn;
        if (tx == 0) Al[ty + TR * i] = alpha;
      }
      __syncwarp();
    }
    cp_async_wait_all();
    __syncthreads();   // V tile kt landed; K's readers done
    if (kt + 1 < kt_end)
      load_rows<HD, BK, G::THREADS>(Ks, kp, st.kt, k0 + BK, Tk, vec);
    if (live) {
#pragma unroll
      for (int i = 0; i < OR; ++i) {
        const float a = Al[uy + TR2 * i];
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] *= a;
      }
      const float* pr = Ps + uy * PS;
      const float* vr = Vs + VW * ux;
#pragma unroll 2
      for (int kk = 0; kk < BK; kk += 4) {
        float4 p[OR];
#pragma unroll
        for (int i = 0; i < OR; ++i)
          p[i] = *reinterpret_cast<const float4*>(pr + i * TR2 * PS + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int cv = 0; cv < OC / VW; ++cv) {
            float w[VW];
            load_vec<VW>(w, vr + (kk + e) * RS + cv * VW * TC2);
#pragma unroll
            for (int x = 0; x < VW; ++x)
#pragma unroll
              for (int i = 0; i < OR; ++i)
                acc[i][cv * VW + x] =
                    fmaf(elem(p[i], e), w[x], acc[i][cv * VW + x]);
          }
        }
      }
    }
  }
  cp_async_wait_all();   // nothing in flight at the end (no live tile)

  // o = acc / max(l, 1e-30): 0 for a row with no live key
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    float l = lrow[i];
#pragma unroll
    for (int off = TC / 2; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (tx == 0) Ls[ty + TR * i] = l;
  }
  __syncwarp();
  float* op = o + b * st.ob + hn * st.on + hg * st.og;
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    const int r = uy + TR2 * i, tq = wq0 + r;
    if (tq >= Tq) continue;
    const float li = fmaxf(Ls[r], 1e-30f);
#pragma unroll
    for (int cv = 0; cv < OC / VW; ++cv)
#pragma unroll
      for (int x = 0; x < VW; ++x)
        op[tq * st.ot + VW * (ux + TC2 * cv) + x] = acc[i][cv * VW + x] / li;
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(Geo<HD>::FLOATS) * sizeof(float);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int nkv, int g, int Tq, int Tk, const Strides& st, int window,
           int causal, float scale, cudaStream_t stream) {
  using G = Geo<HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every base and stride allows them
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const long long strides = st.qb | st.qn | st.qg | st.qt | st.kb | st.kn |
                            st.kt | st.vb | st.vn | st.vt;
  const int vec = bases % 16 == 0 && strides % 4 == 0;
  const dim3 grid(B * nkv * g, (Tq + G::BQ - 1) / G::BQ);
  flash_kernel_f32<HD><<<grid, G::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), nkv, g, Tq, Tk,
      st, window, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// blocks an SM, shared memory a block, registers a thread, local (spilled)
// bytes a thread and threads a block of flash_kernel_f32<HD>
template <int HD>
int residency(int* out) {
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_kernel_f32<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], kern, Geo<HD>::THREADS, smem);
  }
  out[1] = static_cast<int>(smem);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = Geo<HD>::THREADS;
  return static_cast<int>(err);
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16 on the CUDA cores, for the calls TMA cannot take
// ---------------------------------------------------------------------------

namespace bf {

constexpr int kThreads = 256;
constexpr int BQ = 64;   // query rows a block
constexpr int BK = 64;   // keys a tile
constexpr int PS = BK + 4;

template <int HD>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * PS) *
         sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int nkv, int g, int Tq,
                  int Tk, Strides st, int window, int causal, float scale) {
  constexpr int RS = HD + 1;       // padded row of Q, K, V in shared memory
  constexpr int CPT = HD / 16;     // accumulator columns a thread
  extern __shared__ float sm[];
  float* Qs = sm;                  // [BQ][RS]
  float* Ks = Qs + BQ * RS;        // [BK][RS]
  float* Vs = Ks + BK * RS;        // [BK][RS]
  float* Ps = Vs + BK * RS;        // [BQ][PS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.y;
  const int hg = head % g, hn = (head / g) % nkv, b = head / (g * nkv);
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qp = q + b * st.qb + hn * st.qn + hg * st.qg;
  const __nv_bfloat16* kp = k + b * st.kb + hn * st.kn;
  const __nv_bfloat16* vp = v + b * st.vb + hn * st.vn;
  __nv_bfloat16* op = o + b * st.ob + hn * st.on + hg * st.og;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD, t = q0 + r;
    Qs[r * RS + c] = t < Tq ? __bfloat162float(qp[t * st.qt + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  // the live key tiles: dead ones (causal: the tile starts after the last
  // query row; window: it ends before the first row's window) are skipped
  const int q_last = min(q0 + BQ - 1, Tq - 1);
  int kt_end = (Tk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    if (lo > 0) kt_begin = lo / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's readers are done
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD, t = k0 + r;
      const bool in = t < Tk;
      Ks[r * RS + c] = in ? __bfloat162float(kp[t * st.kt + c]) : 0.0f;
      Vs[r * RS + c] = in ? __bfloat162float(vp[t * st.vt + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * RS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tq = q0 + ty * 4 + i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tk = k0 + tx + 16 * j;
        live[j] = tk < Tk && (!causal || tk <= tq) &&
                  (window <= 0 || tq - tk < window);
        s[i][j] = live[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - mn) : 0.0f;
        rs += p;
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - mn);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) vv[cc] = Vs[c * RS + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
          acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tq = q0 + ty * 4 + i;
    if (tq >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      op[tq * st.ot + tx + 16 * cc] = __float2bfloat16_rn(acc[i][cc] / li);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int nkv, int g, int Tq, int Tk, const Strides& st, int window,
           int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, B * nkv * g);
  flash_kernel_bf16<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      nkv, g, Tq, Tk, st, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf

// f(std::integral_constant<int, hd>) for hd one of the kernels' head
// dims, else cudaErrorInvalidValue
template <typename F>
int by_head_dim(int hd, F f) {
  switch (hd) {
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 80:
      return f(std::integral_constant<int, 80>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    case 160:
      return f(std::integral_constant<int, 160>{});
    case 256:
      return f(std::integral_constant<int, 256>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma), for calls the wrapper's predicate sends
// here (bf16 q, k, v; head_dim % 16 == 0; TMA-legal strides)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

template <int HD>
struct Geo {
  // a tile's columns: NM panels of PW columns, swizzled over SW bytes
  // (128: 64 columns, or the whole row below head_dim 64), then, where
  // PW does not divide HD, one tail panel of TW columns over 2 TW bytes
  // (32 columns at 160, 16 at 80); no panel holds a column past HD
  static constexpr int SW = HD >= 64 ? 128 : 2 * HD;
  static constexpr int PW = SW / 2;          // bf16 per swizzled row
  static constexpr int NM = HD / PW;         // full panels a tile
  static constexpr int TW = HD % PW;         // tail panel's columns, or 0
  static constexpr int TSW = 2 * TW;         // its swizzle, bytes
  static constexpr int NACC = HD / 2;        // O accumulator registers
  static constexpr int PANEL = 64 * SW;      // one 64-row panel, bytes
  static constexpr int TILE = NM * PANEL + 64 * TSW;   // one 64 x HD tile
  static constexpr int LAYOUT = desc_layout(SW);
  static constexpr int NMAPS = TW > 0 ? 6 : 3;   // tensor maps: q, k, v
  // consumer warpgroups a block (WGS) sharing one K/V ring, and its
  // 64-row query tiles (QT): at head_dim 80 two warpgroups of 64 rows
  // each (each K/V tile read once for 128 rows); at 256 two warpgroups
  // over one 64-row tile that deal its key tiles between them (KSPLIT:
  // each chain half as long) and merge their partial softmax at the end.
  // K/V tiles in flight (STAGES), and the blocks an SM the launch bounds
  // ask for: as many as shared memory allows at 80 (2 x 61 KB) and 160
  // (2 x 101 KB)
  static constexpr int WGS = HD == 80 || HD == 256 ? 2 : 1;
  static constexpr int QT = HD == 80 ? 2 : 1;
  static constexpr bool KSPLIT = WGS > QT;
  static constexpr int STAGES = KSPLIT ? 3 : 2;
  // full barriers a stage: one a warpgroup where they deal the tiles, so
  // a warpgroup's barrier carries only its own tiles' phases
  static constexpr int FULLS = KSPLIT ? WGS : 1;
  // (a barrier's tiles then come every STAGES x FULLS tiles)
  static_assert(!KSPLIT || (WGS == 2 && STAGES % 2 == 1),
                "the warpgroups' full barriers need an odd ring");
  static constexpr int MIN_BLOCKS = HD == 80 || HD == 160 ? 2 : 1;
  static constexpr int THREADS = 128 * WGS;
};

// q, k, v's tensor maps (boxes of one full panel), then their tail
// panel's
struct Maps3 {
  CUtensorMap t[3];
};
struct Maps6 {
  CUtensorMap t[6];
};
template <int HD>
using Maps = std::conditional_t<Geo<HD>::NMAPS == 6, Maps6, Maps3>;

template <int HD>
constexpr size_t smem_bytes() {
  // the Q tiles, the K/V ring, its barriers and Q's, 1 KB alignment slack
  // (at 256: 32 KB + 3 x 64 KB + 1104 bytes = 230,480 of the 232,448 a
  // block may opt into)
  using G = Geo<HD>;
  return static_cast<size_t>(G::QT + 2 * G::STAGES) * G::TILE +
         (1 + (G::FULLS + 1) * G::STAGES) * 8 + 1024;
}

// shared-memory descriptor of k step kk (16 deep) of a K-major 64 x HD tile
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using G = Geo<HD>;
  constexpr int STEPS = G::PW / 16;          // k steps a panel row holds
  if (kk < G::NM * STEPS)
    return make_desc(tile + (kk / STEPS) * G::PANEL + (kk % STEPS) * 32, 16,
                     8 * G::SW, G::LAYOUT);
  return make_desc(tile + G::NM * G::PANEL + (kk - G::NM * STEPS) * 32, 16,
                   8 * G::TSW, desc_layout(G::TSW));
}

// D[64 x N] += A (registers) * B (shared, MN-major), D at ``d``
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  using D = float[N / 2];
  D& r = *reinterpret_cast<D*>(d);
  if constexpr (N == 128) {
    wgmma_rs_m64n128(r, a, db, 1);
  } else if constexpr (N == 64) {
    wgmma_rs_m64n64(r, a, db, 1);
  } else if constexpr (N == 32) {
    wgmma_rs_m64n32(r, a, db, 1);
  } else {
    static_assert(N == 16, "no wgmma of this width");
    wgmma_rs_m64n16(r, a, db, 1);
  }
}

// O += P V for 16-key step kk of the V tile at shared address ``vtile``
template <int HD>
__device__ __forceinline__ void pv_wgmma(float (&o)[Geo<HD>::NACC],
                                         const uint32_t (&a)[4],
                                         uint32_t vtile, int kk) {
  using G = Geo<HD>;
  const uint32_t vaddr = vtile + kk * 16 * G::SW;
  const uint64_t db = make_desc(vaddr, G::PANEL, 8 * G::SW, G::LAYOUT);
  if constexpr (HD == 256) {
    // two m64n128 over V's column halves (two panels each): an n = 256
    // accumulator holds columns 0-127 in registers 0-63 as n = 128 does
    wgmma_rs<128>(o, a, db);
    wgmma_rs<128>(o + 64, a, make_desc(vaddr + 2 * G::PANEL, G::PANEL,
                                       8 * G::SW, G::LAYOUT));
  } else {
    wgmma_rs<G::NM * G::PW>(o, a, db);
    if constexpr (G::TW > 0) {
      // the tail panel's columns, after the full panels' in the registers
      // (m64n32k16 at 160, m64n16k16 at 80)
      wgmma_rs<G::TW>(o + G::NM * G::PW / 2, a,
                      make_desc(vtile + G::NM * G::PANEL + kk * 16 * G::TSW,
                                64 * G::TSW, 8 * G::TSW,
                                desc_layout(G::TSW)));
    }
  }
}

// the full barrier of K/V tile j (stage j % STAGES; at 256 the barrier of
// the warpgroup it is dealt to, j % 2)
template <int HD>
__device__ __forceinline__ uint64_t* full_bar(uint64_t* full, int j) {
  using G = Geo<HD>;
  return &full[(j % G::STAGES) * G::FULLS + j % G::FULLS];
}

// K/V tile j (key tile kt) into stage j % STAGES, completing on its full
// barrier: each panel one box, the tail panel through the tail maps
template <int HD>
__device__ __forceinline__ void load_kv(uint8_t* Ks, uint8_t* Vs,
                                        const Maps<HD>& m, uint64_t* full,
                                        int j, int kt, int hn, int b) {
  using G = Geo<HD>;
  const int s = j % G::STAGES;
  uint64_t* bar = full_bar<HD>(full, j);
  mbar_expect_tx(bar, 2 * G::TILE);
#pragma unroll
  for (int p = 0; p < G::NM; ++p) {
    tma_load_4d(Ks + s * G::TILE + p * G::PANEL, &m.t[1], bar, p * G::PW,
                kt * 64, hn, b);
    tma_load_4d(Vs + s * G::TILE + p * G::PANEL, &m.t[2], bar, p * G::PW,
                kt * 64, hn, b);
  }
  if constexpr (G::TW > 0) {
    tma_load_4d(Ks + s * G::TILE + G::NM * G::PANEL, &m.t[4], bar,
                G::NM * G::PW, kt * 64, hn, b);
    tma_load_4d(Vs + s * G::TILE + G::NM * G::PANEL, &m.t[5], bar,
                G::NM * G::PW, kt * 64, hn, b);
  }
}

// The merge of head_dim 256's two chains.  Warpgroup w holds, for this
// thread's rows row and row + 8, its own m (log2 units), l and float32
// accumulator over the key tiles dealt to it (m = NEG_INF, l = 0, acc = 0
// where it got none) and writes o's columns 128 w .. 128 w + 127; the other
// warpgroup hands it that half of its accumulator and its m and l through
// shared memory, float i * 128 + t for element i of thread t (a warp's
// 32 floats in 32 banks).  With m = max(m_0, m_1), each half is scaled by
// exp2(m_w - m): a warpgroup that saw no live key of the row is scaled by
// 0 and the other by exactly 1, so the result is the other's bit for bit,
// and a row with no live key at all gives 0 / 1e-30 = 0.

// element i of thread t's accumulator half H (columns 128 H ..) to x[i * 128]
template <int H>
__device__ __forceinline__ void put_half(float* x, const float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) x[i * 128] = acc[64 * H + i];
}

// o's columns 128 H .. 128 H + 127 at rows row and row + 8: this
// warpgroup's half H times a, plus the other's (x) times b, over li
template <int H>
__device__ __forceinline__ void merge_half(__nv_bfloat16* op,
                                           const float (&acc)[128],
                                           const float* x, const float (&a)[2],
                                           const float (&b)[2],
                                           const float (&li)[2], int row,
                                           int Tq, long long ot, int cq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tqp = row + 8 * r;
    if (tqp >= Tq) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int i = 4 * c + 2 * r;
      *reinterpret_cast<uint32_t*>(op + tqp * ot + 128 * H + 8 * c + cq) =
          pack_bf16((acc[64 * H + i] * a[r] + x[i * 128] * b[r]) / li[r],
                    (acc[64 * H + i + 1] * a[r] + x[(i + 1) * 128] * b[r]) /
                        li[r]);
    }
  }
}

// the merge, into the drained ring at xch: per warpgroup 64 floats of the
// half the other writes, then its m and l of 2 rows (68 x 128 floats)
__device__ __forceinline__ void split_epilogue(
    float* xch, const float (&acc)[128], const float (&mrow)[2],
    const float (&lrow)[2], int wg, __nv_bfloat16* op, int row, int Tq,
    long long ot, int cq) {
  constexpr int X = 68 * 128;
  const int t = threadIdx.x % 128;
  // both chains are done: every K/V tile consumed, every wgmma waited for
  __syncthreads();
  float* give = xch + wg * X + t;
  if (wg == 0) {
    put_half<1>(give, acc);
  } else {
    put_half<0>(give, acc);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    give[(64 + r) * 128] = mrow[r];
    give[(66 + r) * 128] = lrow[r];
  }
  __syncthreads();
  const float* take = xch + (1 - wg) * X + t;
  float a[2], b[2], li[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mo = take[(64 + r) * 128];
    const float mm = fmaxf(mrow[r], mo);
    a[r] = exp2f(mrow[r] - mm);
    b[r] = exp2f(mo - mm);
    li[r] = fmaxf(lrow[r] * a[r] + take[(66 + r) * 128] * b[r], 1e-30f);
  }
  if (wg == 0) {
    merge_half<0>(op, acc, take, a, b, li, row, Tq, ot, cq);
  } else {
    merge_half<1>(op, acc, take, a, b, li, row, Tq, ot, cq);
  }
}

template <int HD>
__global__ void __launch_bounds__(Geo<HD>::THREADS, Geo<HD>::MIN_BLOCKS)
flash_kernel_wgmma(const __grid_constant__ Maps<HD> m,
                   __nv_bfloat16* __restrict__ o, int nkv, int Tq, int Tk,
                   long long ob, long long on, long long og,
                   long long ot, int window, int causal, float scale) {
  using G = Geo<HD>;
  constexpr int NS = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;                              // [QT] tiles
  uint8_t* Ks = Qs + G::QT * G::TILE;              // [NS] tiles
  uint8_t* Vs = Ks + NS * G::TILE;                 // [NS] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + NS * G::TILE);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;                       // [NS][FULLS]
  uint64_t* empty = full + NS * G::FULLS;          // [NS]

  const int b = blockIdx.x / nkv, hn = blockIdx.x % nkv;
  const int qh = blockIdx.y;                       // query head in the group
  // the block's 64 QT query rows from qb, heaviest first; this
  // warpgroup's query tile qw, its 64 rows from q0 (at 256 both
  // warpgroups hold the block's one tile)
  const int qb = (gridDim.z - 1 - blockIdx.z) * 64 * G::QT;
  const int wg = G::WGS > 1 ? threadIdx.x / 128 : 0;
  const int qw = G::KSPLIT ? 0 : wg;
  const int q0 = qb + 64 * qw;

  // the block's live key tiles (the TPU kernel's block skipping,
  // kernel.py:49-54); at 80 each warpgroup passes over a tile dead for
  // its own rows (it waits for it and releases it)
  const int q_last = min(qb + 64 * G::QT - 1, Tq - 1);
  int kt_end = (Tk + 63) / 64;
  if (causal) kt_end = min(kt_end, q_last / 64 + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = qb - window + 1;
    if (lo > 0) kt_begin = lo / 64;
  }
  const int ntiles = max(0, kt_end - kt_begin);

  // a stage is released by the warpgroups that consume its tile: all of
  // them, or at 256 the one it was dealt to
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      for (int w = 0; w < G::FULLS; ++w)
        mbar_init(&full[s * G::FULLS + w], 1);
      mbar_init(&empty[s], G::KSPLIT ? 128 : G::THREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0 loads the Q tiles once and the first NS K/V tiles; K/V tile
  // j + NS goes into stage j % NS as soon as tile j's consumers have
  // released it, issued by thread 0 (at 256 by the releasing warpgroup's
  // first thread: the other warpgroup's next tile but one)
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, G::QT * G::TILE);
#pragma unroll
    for (int w = 0; w < G::QT; ++w) {
      uint8_t* qs = Qs + w * G::TILE;
#pragma unroll
      for (int p = 0; p < G::NM; ++p)
        tma_load_5d(qs + p * G::PANEL, &m.t[0], qbar, p * G::PW, qb + 64 * w,
                    qh, hn, b);
      if constexpr (G::TW > 0) {
        tma_load_5d(qs + G::NM * G::PANEL, &m.t[3], qbar, G::NM * G::PW,
                    qb + 64 * w, qh, hn, b);
      }
    }
    for (int j = 0; j < min(NS, ntiles); ++j)
      load_kv<HD>(Ks, Vs, m, full, j, kt_begin + j, hn, b);
  }
  __syncwarp();

  // this thread's rows of the warpgroup's 64: ra and ra + 8; accumulator
  // element 4c + 2h + e is row ra + 8h, column 8c + 2 (lane % 4) + e
  const int lane = threadIdx.x % 32;
  const int ra = ((threadIdx.x / 32) % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float acc[G::NACC];
#pragma unroll
  for (int i = 0; i < G::NACC; ++i) acc[i] = 0.0f;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.0f, 0.0f};
  const uint32_t qtile = smem_u32(Qs + qw * G::TILE);
  const float scale_log2 = scale * 1.4426950408889634f;   // log2(e) folded in
  // the key tiles live for this warpgroup's rows (none past Tq)
  int my_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) my_begin = (q0 - window + 1) / 64;
  const int my_end = q0 >= Tq ? 0 : causal ? min(kt_end, q0 / 64 + 1)
                                           : kt_end;

  mbar_wait(qbar, 0);
  // at 256 warpgroup wg walks the block's tiles j = wg, wg + 2, ...
  constexpr int STEP = G::KSPLIT ? G::WGS : 1;
  for (int j = G::KSPLIT ? wg : 0; j < ntiles; j += STEP) {
    const int s = j % NS, kt = kt_begin + j, k0 = kt * 64;
    // tile j is the (j / (NS FULLS))-th on its barrier; at 256 the
    // stage's last tile was the other warpgroup's, on the other barrier
    mbar_wait(full_bar<HD>(full, j), (j / (NS * G::FULLS)) & 1);
    // at 80 a tile dead for this warpgroup's rows is waited for and
    // released
    if (G::WGS == 1 || G::KSPLIT || (kt >= my_begin && kt < my_end)) {
      // S = Q K^T: m64n64k16 over head_dim, Q and K both K-major
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      const uint32_t ktile = smem_u32(Ks + s * G::TILE);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_m64n64<0>(sc, kmajor_desc<HD>(qtile, kk),
                           kmajor_desc<HD>(ktile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax over the tile, the plain version's masks; scores in
      // log2 units (exp2f); a row's 64 keys live in the 4 lanes of a quad.
      // A tile live for every (row, key) of the warpgroup skips the masks.
      uint32_t live = 0xffffffffu;
      float mx[2] = {NEG_INF, NEG_INF};
      if (k0 + 63 < Tk && (!causal || k0 + 63 <= q0) &&
          (window <= 0 || q0 + 63 - k0 < window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] *= scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        }
      } else {
        live = 0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          const int tqp = q0 + ra + 8 * h;
          const int tkp = k0 + 8 * (i / 4) + cq + (i & 1);
          const bool ok = tkp < Tk && (!causal || tkp <= tqp) &&
                          (window <= 0 || tqp - tkp < window);
          live |= static_cast<uint32_t>(ok) << i;
          sc[i] = ok ? sc[i] * scale_log2 : NEG_INF;
          mx[h] = fmaxf(mx[h], sc[i]);
        }
      }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mx[h] = fmaxf(mrow[h], mx[h]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = (live >> i) & 1u ? exp2f(sc[i] - mx[h]) : 0.0f;
        rs[h] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        alpha[h] = exp2f(mrow[h] - mx[h]);
        lrow[h] = lrow[h] * alpha[h] + rs[h];
        mrow[h] = mx[h];
      }
#pragma unroll
      for (int i = 0; i < G::NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V with P = p_hi + p_lo, two bf16 terms from the registers
      // (the accumulator layout of S is wgmma's register-A layout); V is
      // read MN-major through the transpose-B bit
      const uint32_t vtile = smem_u32(Vs + s * G::TILE);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float x0 = sc[8 * kk + 2 * t], x1 = sc[8 * kk + 2 * t + 1];
          hi[t] = pack_bf16(x0, x1);
          const __nv_bfloat162 hb = *reinterpret_cast<__nv_bfloat162*>(&hi[t]);
          lo[t] = pack_bf16(x0 - __bfloat162float(hb.x),
                            x1 - __bfloat162float(hb.y));
        }
        pv_wgmma<HD>(acc, hi, vtile, kk);
        pv_wgmma<HD>(acc, lo, vtile, kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }

    mbar_arrive(&empty[s]);
    const bool issuer = G::KSPLIT ? threadIdx.x % 128 == 0 : threadIdx.x == 0;
    if (issuer && j + NS < ntiles) {
      mbar_wait(&empty[s], (j / NS) & 1);
      load_kv<HD>(Ks, Vs, m, full, j + NS, kt_begin + j + NS, hn, b);
    }
    __syncwarp();
  }

  __nv_bfloat16* op = o + b * ob + hn * on + qh * og;
  if constexpr (G::KSPLIT) {
    split_epilogue(reinterpret_cast<float*>(Ks), acc, mrow, lrow, wg, op,
                   q0 + ra, Tq, ot, cq);
  } else {
    // o = acc / max(l, 1e-30): 0 for a row with no live key
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tqp = q0 + ra + 8 * r;
      if (tqp >= Tq) continue;
      const float li = fmaxf(lrow[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        *reinterpret_cast<uint32_t*>(op + tqp * ot + 8 * c + cq) = pack_bf16(
            acc[4 * c + 2 * r] / li, acc[4 * c + 2 * r + 1] / li);
      }
    }
  }
}

template <int HD>
int launch(const Maps<HD>& m, void* o, int B, int nkv, int g, int Tq, int Tk,
           const Strides& st, int window, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_kernel_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int threads = Geo<HD>::THREADS, rows = 64 * Geo<HD>::QT;
  const dim3 grid(B * nkv, g, (Tq + rows - 1) / rows);
  kern<<<grid, threads, smem, stream>>>(
      m, static_cast<__nv_bfloat16*>(o), nkv, Tq, Tk, st.ob, st.on, st.og,
      st.ot, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int run(const void* q, const void* k, const void* v, void* o, int B, int nkv,
        int g, int Tq, int Tk, const Strides& st, int window, int causal,
        float scale, cudaStream_t s) {
  using G = Geo<HD>;
  // q [B, nkv, g, Tq, HD] and k, v [B, nkv, Tk, HD], innermost first, in
  // the caller's strides (bytes); a box is one head's 64 rows x one panel
  const uint64_t dq[5] = {HD, static_cast<uint64_t>(Tq),
                          static_cast<uint64_t>(g),
                          static_cast<uint64_t>(nkv),
                          static_cast<uint64_t>(B)};
  const uint64_t sq[4] = {static_cast<uint64_t>(st.qt) * 2,
                          static_cast<uint64_t>(st.qg) * 2,
                          static_cast<uint64_t>(st.qn) * 2,
                          static_cast<uint64_t>(st.qb) * 2};
  const uint64_t dk[4] = {HD, static_cast<uint64_t>(Tk),
                          static_cast<uint64_t>(nkv),
                          static_cast<uint64_t>(B)};
  const uint64_t sk[3] = {static_cast<uint64_t>(st.kt) * 2,
                          static_cast<uint64_t>(st.kn) * 2,
                          static_cast<uint64_t>(st.kb) * 2};
  const uint64_t sv[3] = {static_cast<uint64_t>(st.vt) * 2,
                          static_cast<uint64_t>(st.vn) * 2,
                          static_cast<uint64_t>(st.vb) * 2};
  Maps<HD> m;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < G::NMAPS && err == cudaSuccess; ++i) {
    // maps 0-2 in boxes of one full panel, 3-5 of the tail panel
    const bool tail = i >= 3;
    const uint32_t box[5] = {static_cast<uint32_t>(tail ? G::TW : G::PW), 64,
                             1, 1, 1};
    const int sw = tail ? G::TSW : G::SW;
    err = i % 3 == 0 ? encode_tiled_bf16(&m.t[i], q, 5, dq, sq, box, sw)
          : i % 3 == 1 ? encode_tiled_bf16(&m.t[i], k, 4, dk, sk, box, sw)
                       : encode_tiled_bf16(&m.t[i], v, 4, dk, sv, box, sw);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<HD>(m, o, B, nkv, g, Tq, Tk, st, window, causal, scale, s);
}

// blocks an SM, shared memory a block, registers a thread, local
// (spilled) bytes a thread and threads a block of flash_kernel_wgmma<HD>
template <int HD>
int residency(int* out) {
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_kernel_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], kern, Geo<HD>::THREADS, smem);
  }
  out[1] = static_cast<int>(smem);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = Geo<HD>::THREADS;
  return static_cast<int>(err);
}

}  // namespace wg

extern "C" {

// q, k, v, o: device pointers; strides in elements (the head dim has
// stride 1): q and o [B, nkv, g, T, hd] as (b, n, g, t), k and v
// [B, nkv, Tk, hd] as (b, n, t); hd in {16, 32, 64, 80, 128, 160, 256};
// window <= 0 for none.  On the CUDA cores: bf16 selects __nv_bfloat16
// inputs and output (flash_kernel_bf16), else float32 (flash_kernel_f32).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int nkv, int g, int Tq, int Tk,
                          int hd, long long qb, long long qn, long long qg,
                          long long qt, long long kb, long long kn,
                          long long kt, long long vb, long long vn,
                          long long vt, long long ob, long long on,
                          long long og, long long ot, int window, int causal,
                          float scale, int bf16, void* stream) {
  const Strides st{qb, qn, qg, qt, kb, kn, kt, vb, vn, vt, ob, on, og, ot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    return bf16 ? bf::launch<HD>(q, k, v, o, B, nkv, g, Tq, Tk, st, window,
                                 causal, scale, s)
                : cc::launch<HD>(q, k, v, o, B, nkv, g, Tq, Tk, st, window,
                                 causal, scale, s);
  });
}

// the same arguments for bf16 on the tensor cores (the wrapper's
// predicate: bf16, strides multiples of 8 elements, 16-byte aligned q, k,
// v; hd in {16, 32, 64, 80, 128, 160, 256})
int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                void* o, int B, int nkv, int g, int Tq,
                                int Tk, int hd, long long qb, long long qn,
                                long long qg, long long qt, long long kb,
                                long long kn, long long kt, long long vb,
                                long long vn, long long vt, long long ob,
                                long long on, long long og, long long ot,
                                int window, int causal, float scale,
                                void* stream) {
  const Strides st{qb, qn, qg, qt, kb, kn, kt, vb, vn, vt, ob, on, og, ot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(hd, [&](auto h) {
    return wg::run<decltype(h)::value>(q, k, v, o, B, nkv, g, Tq, Tk, st,
                                       window, causal, scale, s);
  });
}

// a kernel's residency at hd: out[0] its blocks an SM (the occupancy API
// at its shared memory), out[1] shared bytes a block, out[2] registers a
// thread, out[3] local (spilled) bytes a thread, out[4] threads a block;
// of the tensor-core kernel, then of the float32 CUDA-core kernel
int repro_flash_attention_wgmma_residency(int hd, int* out) {
  return by_head_dim(
      hd, [&](auto h) { return wg::residency<decltype(h)::value>(out); });
}

int repro_flash_attention_f32_residency(int hd, int* out) {
  return by_head_dim(
      hd, [&](auto h) { return cc::residency<decltype(h)::value>(out); });
}

}  // extern "C"
