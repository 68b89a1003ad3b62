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
// Two kernels compute it; the wrapper's predicate (kernel.py,
// flash_uses_wgmma) picks one by dtype, head_dim and strides, never by
// retrying:
//
// 1. flash_kernel_wgmma, on the tensor cores, for bf16 q, k, v with
//    head_dim in (16, 32, 64, 80, 128, 160, 256) whose strides and base
//    addresses TMA can take (multiples of 16 bytes).  Bound: operations, 4 hd flops
//    per live (query head, query, key) pair over the H100's 989 TFLOP/s
//    bf16 tensor-core peak (0.0065 ms at q [1, 1024, 24, 128] causal).
//    Design: one block of one consumer warpgroup (128 threads) per
//    (batch, query head, 64 queries).  The serve cell's 1024-token
//    prefill is then 384 blocks, two resident per SM: the causal
//    imbalance (a query tile's key count grows with its row) is spread
//    over many small blocks.  Blocks that fold a GQA group's heads (each
//    K/V tile loaded once for the group, as the TPU kernel folds g into
//    its rows) were slower at that shape on an H100 (PERF.md) and
//    pay only on grids that fill the card several times over, which no
//    path of the port launches yet.  The blocks with the most live key
//    tiles launch first.
//    Thread 0 loads by TMA (swizzled to the row width: 128 bytes, or
//    64 / 32 at head_dim 32 / 16): the Q tile once, then a ring of
//    kStages (2) 64-key K and V tiles, each stage with a full and an
//    empty mbarrier; it refills a stage once the warpgroup has released
//    it.  The warpgroup runs, per live key tile:
//      S = Q K^T as head_dim/16 m64n64k16 wgmmas, Q and K K-major from
//        shared memory, into 32 float32 registers a thread;
//      the online softmax in registers, in log2 units (exp2f, log2(e)
//        folded into the scale: expf's range reduction made the softmax,
//        not the tensor cores, the limit); a row's 64 scores lie in the 4
//        lanes of a quad (two shuffles for its max and sum), and a tile
//        live for every row and key skips the masks;
//      O += P V as m64n{hd}k16 wgmmas with A from registers: the S
//        accumulator's layout is wgmma's register-A layout, so P packs to
//        bf16 pairs with no shuffle.  P is split, p_hi = bf16(p) and
//        p_lo = bf16(p - p_hi), and both multiply the same V tile (V read
//        MN-major through the transpose-B bit): p keeps about 16
//        significant bits, so PV's error stays near the float32
//        sum-order error, far below the output's one bf16 rounding.  The
//        split doubles PV's tensor-core work (under 10 us at T = 1024).
//    Registers: HDP/2 accumulators (64 at hd 128, 128 at hd 160 and 256), 32
//    scores and 8 packed P words a thread.  Shared memory: 5 tiles of
//    64 x hd bf16 (Q and the K/V ring; 80 KB at hd 128, so two blocks fit
//    an SM; 160 KB at hd 256, one).  At hd 256 PV is two m64n128k16 a
//    16-key step, over V's column halves of two 128-byte panels each.
//    Head_dim 80 (zamba2's shared attention) keeps head_dim 128's tiles:
//    two 64-column, 128-byte-swizzled panels, the tensor maps given the
//    real inner dim 80, so TMA zero-fills columns 80-127 of Q, K and V
//    (and counts them in the transaction bytes). QK^T runs its 5 k steps
//    (columns 0-79: the fifth reads panel 1's first 16), PV the m64n128k16
//    of head_dim 128 (columns 80-127 accumulate zeros, never stored): 1.6x
//    PV's tensor-core work at 80, no new wgmma shape, no new swizzle.
//    Head_dim 160 (pixtral-12b) takes the same route in head_dim 256's
//    tiles: four 128-byte panels, the tensor maps' inner dim 160 (rows of
//    320 bytes), so TMA zero-fills columns 160-191 of panel 2, and panel
//    3 (columns 192-255) lies wholly out of bounds: TMA zero-fills it too,
//    and its bytes count in the transaction bytes like any box's, so the
//    barriers expect whole tiles as at 256.  QK^T runs 10 k steps (panels
//    0-2, panel 2's first 32 columns), PV the two m64n128k16 of 256 (the
//    second over columns 128-255, three quarters zeros, never stored):
//    1.6x PV's tensor-core work at 160 and 160 KB of shared memory, one
//    block an SM.
// 2. flash_kernel, on the CUDA cores, for float32 (where it beats SDPA)
//    and any other call: one block of 256 threads per (batch, query head,
//    64-row query tile); GQA maps the query head to its kv head.  The Q
//    tile is staged once in shared memory as float32; the block walks only
//    the live 64-key tiles (the causal and window bounds of the tile, the
//    TPU kernel's block-level skipping at kernel.py:49-54), staging K and
//    V through shared memory.  QK^T and PV run in float32: thread (ty, tx)
//    of the 16 x 16 grid holds the scores of rows 4ty..4ty+3 and keys
//    tx + 16j (j < 4) and the accumulator of those rows for columns
//    tx + 16c (c < hd/16); the row max and sum are reduced across the 16
//    threads of a row by shuffles.  Shared rows are padded so the reads
//    are free of bank conflicts.  Shared memory is
//    BQ (hd+1) + 2 BK (hd+1) + BQ (BK+4) floats: 210 KB at hd 256 and
//    138 KB at 160, under the 227 KB a block may opt into, so one block
//    an SM.  Bound:
//    operations, over 67 TFLOP/s float32.
//
// Numerics: no fast math; expf (CUDA cores) or exp2f of log2(e)-scaled
// scores (tensor cores), IEEE division; sums in another order than the
// plain version's, so results agree within float32 rounding (2e-5) and,
// for bf16 inputs, within bf16 rounding (3e-2).
// Kernels launch on the caller's stream and allocate nothing; each C
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;   // query rows a block
constexpr int BK = 64;   // keys a tile
constexpr int PS = BK + 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

struct Strides {
  long long qb, qn, qg, qt;   // q [B, nkv, g, Tq, hd]
  long long kb, kn, kt;       // k [B, nkv, Tk, hd]
  long long vb, vn, vt;       // v
  long long ob, on, og, ot;   // o like q
};

template <int HD>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * PS) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int nkv, int g,
             int Tq, int Tk, Strides st, int window, int causal,
             float scale) {
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
  const T* qp = q + b * st.qb + hn * st.qn + hg * st.qg;
  const T* kp = k + b * st.kb + hn * st.kn;
  const T* vp = v + b * st.vb + hn * st.vn;
  T* op = o + b * st.ob + hn * st.on + hg * st.og;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD, t = q0 + r;
    Qs[r * RS + c] = t < Tq ? to_f(qp[t * st.qt + c]) : 0.0f;
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
      Ks[r * RS + c] = in ? to_f(kp[t * st.kt + c]) : 0.0f;
      Vs[r * RS + c] = in ? to_f(vp[t * st.vt + c]) : 0.0f;
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
      store(op + tq * st.ot + tx + 16 * cc, acc[i][cc] / li);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int nkv, int g, int Tq, int Tk, const Strides& st, int window,
           int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BQ - 1) / BQ, B * nkv * g);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nkv, g, Tq, Tk, st,
      window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int B, int nkv, int g, int Tq, int Tk, const Strides& st,
             int window, int causal, float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                           scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                           scale, s);
    case 80:
      return launch<T, 80>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, nkv, g, Tq, Tk, st, window,
                            causal, scale, s);
    case 160:
      return launch<T, 160>(q, k, v, o, B, nkv, g, Tq, Tk, st, window,
                            causal, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, o, B, nkv, g, Tq, Tk, st, window,
                            causal, scale, s);
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

constexpr int kStages = 2;     // K/V tiles in flight

template <int HD>
struct Geo {
  // the tiles' columns: 80 in 128's tiles, 160 in 256's
  static constexpr int HDP = HD == 80 ? 128 : HD == 160 ? 256 : HD;
  static constexpr int SW = HDP * 2 < 128 ? HDP * 2 : 128;  // swizzle, bytes
  static constexpr int PW = SW / 2;          // bf16 per swizzled row
  static constexpr int NP = HDP / PW;        // panels a tile (2 at HD=128)
  static constexpr int NACC = HDP / 2;       // O accumulator registers
  static constexpr int PANEL = 64 * SW;      // one 64-row panel, bytes
  static constexpr int TILE = NP * PANEL;    // one 64 x HD tile, bytes
  static constexpr int LAYOUT = desc_layout(SW);
};

template <int HD>
constexpr size_t smem_bytes() {
  // the Q tile, the K/V ring, its barriers and Q's, 1 KB alignment slack
  return static_cast<size_t>(1 + 2 * kStages) * Geo<HD>::TILE +
         (1 + 2 * kStages) * 8 + 1024;
}

// shared-memory descriptor of k step kk (16 deep) of a K-major 64 x HD tile
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using G = Geo<HD>;
  constexpr int STEPS = G::PW / 16;          // k steps a panel row holds
  return make_desc(tile + (kk / STEPS) * G::PANEL + (kk % STEPS) * 32, 16,
                   8 * G::SW, G::LAYOUT);
}

// O += P V for one 16-key step, V's rows at shared address ``vaddr``
template <int HD>
__device__ __forceinline__ void pv_wgmma(float (&o)[Geo<HD>::NACC],
                                         const uint32_t (&a)[4],
                                         uint32_t vaddr) {
  using G = Geo<HD>;
  const uint64_t db = make_desc(vaddr, G::PANEL, 8 * G::SW, G::LAYOUT);
  if constexpr (HD == 256 || HD == 160) {
    // two m64n128 over V's column halves (two panels each): an n = 256
    // accumulator holds columns 0-127 in registers 0-63 as n = 128 does
    using Half = float[64];
    const uint64_t db2 =
        make_desc(vaddr + 2 * G::PANEL, G::PANEL, 8 * G::SW, G::LAYOUT);
    wgmma_rs_m64n128(*reinterpret_cast<Half*>(o), a, db, 1);
    wgmma_rs_m64n128(*reinterpret_cast<Half*>(o + 64), a, db2, 1);
  } else if constexpr (HD == 128 || HD == 80) {
    wgmma_rs_m64n128(o, a, db, 1);
  } else if constexpr (HD == 64) {
    wgmma_rs_m64n64(o, a, db, 1);
  } else if constexpr (HD == 32) {
    wgmma_rs_m64n32(o, a, db, 1);
  } else {
    wgmma_rs_m64n16(o, a, db, 1);
  }
}

// K/V tile j (key tile kt) into stage j % kStages, completing on its full
// barrier
template <int HD>
__device__ __forceinline__ void load_kv(uint8_t* Ks, uint8_t* Vs,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint64_t* full,
                                        int j, int kt, int hn, int b) {
  using G = Geo<HD>;
  const int s = j % kStages;
  mbar_expect_tx(&full[s], 2 * G::TILE);
#pragma unroll
  for (int p = 0; p < G::NP; ++p) {
    tma_load_4d(Ks + s * G::TILE + p * G::PANEL, tk, &full[s], p * G::PW,
                kt * 64, hn, b);
    tma_load_4d(Vs + s * G::TILE + p * G::PANEL, tv, &full[s], p * G::PW,
                kt * 64, hn, b);
  }
}

template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int nkv, int Tq, int Tk,
                   long long ob, long long on, long long og,
                   long long ot, int window, int causal, float scale) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;                              // one tile
  uint8_t* Ks = Qs + G::TILE;                      // [kStages] tiles
  uint8_t* Vs = Ks + kStages * G::TILE;            // [kStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * G::TILE);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;                       // [kStages]
  uint64_t* empty = full + kStages;                // [kStages]

  const int b = blockIdx.x / nkv, hn = blockIdx.x % nkv;
  const int qh = blockIdx.y;                       // query head in the group
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;   // heaviest tiles first

  // the live key tiles (the TPU kernel's block skipping, kernel.py:49-54)
  const int q_last = min(q0 + 63, Tq - 1);
  int kt_end = (Tk + 63) / 64;
  if (causal) kt_end = min(kt_end, q_last / 64 + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    if (lo > 0) kt_begin = lo / 64;
  }
  const int ntiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0 issues every load: Q once, then K/V tile j into stage
  // j % kStages as soon as the warpgroup has released tile j - kStages
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, G::TILE);
#pragma unroll
    for (int p = 0; p < G::NP; ++p)
      tma_load_5d(Qs + p * G::PANEL, &tq, qbar, p * G::PW, q0, qh, hn, b);
    for (int j = 0; j < min(kStages, ntiles); ++j)
      load_kv<HD>(Ks, Vs, &tk, &tv, full, j, kt_begin + j, hn, b);
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
  const uint32_t qtile = smem_u32(Qs);
  const float scale_log2 = scale * 1.4426950408889634f;   // log2(e) folded in

  mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages, k0 = (kt_begin + j) * 64;
    mbar_wait(&full[s], (j / kStages) & 1);

    // S = Q K^T: m64n64k16 over head_dim (not the padded columns), Q
    // and K both K-major
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
    // A tile live for every (row, key) of the block skips the masks.
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
      pv_wgmma<HD>(acc, hi, vtile + kk * 16 * G::SW);
      pv_wgmma<HD>(acc, lo, vtile + kk * 16 * G::SW);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && j + kStages < ntiles) {
      mbar_wait(&empty[s], (j / kStages) & 1);
      load_kv<HD>(Ks, Vs, &tk, &tv, full, j + kStages, kt_begin + j + kStages,
                  hn, b);
    }
    __syncwarp();
  }

  // o = acc / max(l, 1e-30): 0 for a row with no live key
  __nv_bfloat16* op = o + b * ob + hn * on + qh * og;
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

template <int HD>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, void* o, int B, int nkv, int g, int Tq,
           int Tk, const Strides& st, int window, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_kernel_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * nkv, g, (Tq + 63) / 64);
  kern<<<grid, 128, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), nkv, Tq, Tk, st.ob, st.on,
      st.og, st.ot, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int run(const void* q, const void* k, const void* v, void* o, int B, int nkv,
        int g, int Tq, int Tk, const Strides& st, int window, int causal,
        float scale, cudaStream_t s) {
  using G = Geo<HD>;
  // q [B, nkv, g, Tq, HD] and k, v [B, nkv, Tk, HD], innermost first, in
  // the caller's strides (bytes); a box is one head's 64 rows x one panel
  // (past the real head_dim, at 80 and 160, zero-filled: at 160 the last
// panel's box lies wholly past it)
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
  const uint32_t box[5] = {G::PW, 64, 1, 1, 1};
  CUtensorMap mq, mk, mv;
  cudaError_t err = encode_tiled_bf16(&mq, q, 5, dq, sq, box, G::SW);
  if (err == cudaSuccess) {
    err = encode_tiled_bf16(&mk, k, 4, dk, sk, box, G::SW);
  }
  if (err == cudaSuccess) {
    err = encode_tiled_bf16(&mv, v, 4, dk, sv, box, G::SW);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<HD>(mq, mk, mv, o, B, nkv, g, Tq, Tk, st, window, causal,
                    scale, s);
}

}  // namespace wg

extern "C" {

// q, k, v, o: device pointers; strides in elements (the head dim has
// stride 1): q and o [B, nkv, g, T, hd] as (b, n, g, t), k and v
// [B, nkv, Tk, hd] as (b, n, t); hd in {16, 32, 64, 80, 128, 160, 256};
// window <= 0
// for none; bf16 selects __nv_bfloat16 inputs and output (else float32).
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
  if (bf16) {
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, nkv, g, Tq, Tk, st,
                                   window, causal, scale, s);
  }
  return dispatch<float>(hd, q, k, v, o, B, nkv, g, Tq, Tk, st, window,
                         causal, scale, s);
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
  switch (hd) {
    case 16:
      return wg::run<16>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                         scale, s);
    case 32:
      return wg::run<32>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                         scale, s);
    case 64:
      return wg::run<64>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                         scale, s);
    case 80:
      return wg::run<80>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                         scale, s);
    case 128:
      return wg::run<128>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                          scale, s);
    case 160:
      return wg::run<160>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                          scale, s);
    case 256:
      return wg::run<256>(q, k, v, o, B, nkv, g, Tq, Tk, st, window, causal,
                          scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
