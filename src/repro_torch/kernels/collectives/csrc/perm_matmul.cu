// Row-block-permuted matmul for the fused tensor-parallel collectives
// (sm_90a).  Plain C interface, loaded with ctypes by ../kernel.py.
//
// Replaces repro/kernels/collectives/kernel.py:412 (matmul_pack_kernel)
// and :426 (gather_matmul_kernel), both through _mm_call (:374, body
// :358): a tiled x @ w with float32 accumulation whose row blocks are
// permuted in the tile index arithmetic, never materialised.  Stacked
// form: x [p, m, k], w [p, k, n] (each rank's weight shard), out [p, m, n]
// in result_type(x, w); perm int32 [nb], one for all ranks, row blocks of
// rows = m / nb.
//   lhs_perm = 1 (gather_matmul): output row o reads x row
//              perm[o / rows] * rows + o % rows;
//   lhs_perm = 0 (matmul_pack):   x row i is written to output row
//              perm[i / rows] * rows + i % rows, where the wrapper passes
//              the INVERSE of the block order (kernel.py:421).
// Both give: output row-block b = (x @ w) row-block order[b].
//
// Two kernels compute it; the wrapper's predicate (kernel.py,
// perm_matmul_uses_wgmma) picks one by dtype and shape, never by retrying:
//
// 1. perm_matmul_wgmma, on the tensor cores, for x and w both bf16 with
//    rows = m / nb a multiple of 64, k and n multiples of 8 (TMA's 16-byte
//    stride rule) and 16-byte aligned x and w.  A bf16 product is exact in
//    float32, so wgmma with a float32 accumulator computes the reference's
//    float32 sums (kernel.py:358-371), in another order; one rounding to
//    bf16 at the end.  Bound: operations, 2*p*m*n*k FLOPs over the H100's
//    989 TFLOP/s bf16 tensor-core peak (0.417 ms at the fused TP shapes).
//    Design: a 128 x 256 output tile per block of 384 threads.  One
//    producer thread (warpgroup 2, its registers cut to 40 by setmaxnreg)
//    keeps a 4-stage ring of A (128 x 64) and B (64 x 256) tiles filled by
//    TMA (48 KB a stage, 128-byte swizzle), each stage with a full and an
//    empty mbarrier.  Two consumer warpgroups (232 registers each) issue
//    m64n256k16 for their 64 rows: A K-major from x's rows, B MN-major
//    from w's n-contiguous rows (the transpose-B bit), 128 float32
//    accumulators a thread; one wgmma group stays in flight while the
//    previous stage is released.  3-D tensor maps over [p, m, k] and
//    [p, k, n] serve every rank with one descriptor each, and TMA
//    zero-fills the ragged k and n edges.  The permutation never
//    materialises: with lhs_perm each 64-row A sub-tile's source row goes
//    through perm (a sub-tile lies in one row block, since rows % 64 ==
//    0); without, the epilogue's destination rows go through it.  The
//    epilogue stores bf16 pairs straight from the registers.
// 2. perm_matmul_kernel, on the CUDA cores, for every other call: float32,
//    mixed dtypes, and ragged bf16 shapes, at any m, n and k.  Every
//    input is widened to float32 and multiplied and summed in float32
//    (fmaf; no TF32: the reference casts to f32 before a HIGHEST-precision
//    dot), one rounding to bf16 at the end for a bf16 result.  Bound:
//    2*m*n*k*p FLOPs over the 67 TFLOP/s float32 CUDA-core peak (6.154 ms
//    at the fused TP shapes).  The first version reached 44% of it: no
//    double buffering (each 16-deep k step loaded, waited at a barrier,
//    computed and waited again), scalar global loads, and a 2-way bank
//    conflict on A's transposing store.  This design: a 128 x 256 output
//    tile per block of 256 threads, each thread an 8 x 16 register tile
//    (128 FMAs per 6 shared-memory float4 reads: two broadcast A reads,
//    four contiguous B reads a warp); k in steps of 16 through two shared
//    stages (48 KB).  The next step's tiles are loaded into registers
//    (16-byte float32 / 8-byte bf16 vectors where k or n is a multiple of
//    4 and the operand aligned, else element by element, bounds-checked,
//    0 beyond the edge) while this step computes, then stored, widened,
//    to the other stage: one barrier a step.  A is stored transposed with
//    an XOR swizzle (row bits 3-4 ^ k / 4), so neither its stores nor its
//    float4 reads conflict.  Each thread's two A source rows go through
//    perm once, before the k loop (lhs_perm); without it the epilogue's
//    destination rows do.  nvcc -Xptxas -v: 245 registers (float32),
//    231 (bf16), 241 / 243 (mixed), no spills; one block (8 warps) an SM.
//    The wider tile was chosen over a 128 x 128 one (8 x 8 a thread, 128
//    registers, two blocks an SM), which ran slower at the TP shapes.
//
// Both sum in another order than the plain version's torch.matmul, so the
// two agree within a bound stated from k, not bitwise.  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kBM = 128;      // output rows a block
constexpr int kBK = 16;       // k a stage
constexpr int kThreads = 256;
constexpr int kNB = 4;        // output columns a block: kNB groups of 64
constexpr int kBN = 64 * kNB;
constexpr int kQuads = kBN / 4;              // 4-column quads a k row of B
constexpr int kKStep = kThreads / kQuads;    // k rows of B a load pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ long long mapped(long long i, const int* perm,
                                            long long rows) {
  return static_cast<long long>(perm[i / rows]) * rows + i % rows;
}

// Four consecutive elements as loaded from device memory, not yet widened:
// the load's result is first needed at the shared-memory store, after the
// stage's products, so its latency hides behind them.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  uint4 u;
};
template <>
struct Raw<__nv_bfloat16> {
  uint2 u;
};

// p[0, 4) with a 16-byte (float32) or 8-byte (bf16) load when vec (the
// caller checked alignment and avail == 4 or 0); else one element at a
// time; elements from avail on read 0.
__device__ __forceinline__ Raw<float> load4(const float* p, bool vec,
                                            int avail) {
  Raw<float> r{make_uint4(0u, 0u, 0u, 0u)};
  if (vec) {
    if (avail > 0) r.u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    if (avail > 0) r.u.x = __ldg(q);
    if (avail > 1) r.u.y = __ldg(q + 1);
    if (avail > 2) r.u.z = __ldg(q + 2);
    if (avail > 3) r.u.w = __ldg(q + 3);
  }
  return r;
}
__device__ __forceinline__ Raw<__nv_bfloat16> load4(const __nv_bfloat16* p,
                                                    bool vec, int avail) {
  Raw<__nv_bfloat16> r{make_uint2(0u, 0u)};
  if (vec) {
    if (avail > 0) r.u = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    if (avail > 0) r.u.x = __ldg(q);
    if (avail > 1) r.u.x |= static_cast<unsigned>(__ldg(q + 1)) << 16;
    if (avail > 2) r.u.y = __ldg(q + 2);
    if (avail > 3) r.u.y |= static_cast<unsigned>(__ldg(q + 3)) << 16;
  }
  return r;
}

// Widen to float32 (exact for bf16: its bits are a float32's top half).
__device__ __forceinline__ float4 widen(const Raw<float>& r) {
  return make_float4(__uint_as_float(r.u.x), __uint_as_float(r.u.y),
                     __uint_as_float(r.u.z), __uint_as_float(r.u.w));
}
__device__ __forceinline__ float4 widen(const Raw<__nv_bfloat16>& r) {
  return make_float4(__uint_as_float(r.u.x << 16),
                     __uint_as_float(r.u.x & 0xffff0000u),
                     __uint_as_float(r.u.y << 16),
                     __uint_as_float(r.u.y & 0xffff0000u));
}

// dst[0, 4) <- v, one 16-byte (float32) or 8-byte (bf16) store when vec,
// else element by element up to avail.
__device__ __forceinline__ void store4(float* dst, float4 v, bool vec,
                                       int avail) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < avail) dst[j] = e[j];
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v, bool vec,
                                       int avail) {
  const __nv_bfloat16 e[4] = {__float2bfloat16_rn(v.x),
                              __float2bfloat16_rn(v.y),
                              __float2bfloat16_rn(v.z),
                              __float2bfloat16_rn(v.w)};
  if (vec) {
    uint2 u;
    u.x = static_cast<unsigned>(__bfloat16_as_ushort(e[0])) |
          (static_cast<unsigned>(__bfloat16_as_ushort(e[1])) << 16);
    u.y = static_cast<unsigned>(__bfloat16_as_ushort(e[2])) |
          (static_cast<unsigned>(__bfloat16_as_ushort(e[3])) << 16);
    *reinterpret_cast<uint2*>(dst) = u;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < avail) dst[j] = e[j];
}

// The A tile is stored transposed, As[k][row], with the row's bits 3-4
// XORed with the k quad (k / 4): a warp's transposing store (8 rows x 4
// quads) then hits 32 distinct banks, and a float4 read of 4 consecutive
// rows at one k stays contiguous and 16-byte aligned.
__device__ __forceinline__ int swz(int row, int kk) {
  return row ^ ((kk >> 2) << 3);
}

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
perm_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TO* __restrict__ out, const int* __restrict__ perm,
                   int lhs_perm, int m, int n, int k, int rows, int vec_x,
                   int vec_w, int vec_o) {
  __shared__ __align__(16) float As[2][kBK][kBM];  // [stage][k][row ^ swz]
  __shared__ __align__(16) float Bs[2][kBK][kBN];   // [stage][k][col]
  const long long r = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int t = threadIdx.x;

  // A loads: rows t / 4 and 64 + t / 4 of the tile, k quad t % 4; each
  // row's source (through perm with lhs_perm) is fixed for the k loop.
  const int a_row = t >> 2;
  const int a_q = t & 3;
  const TX* a_src[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int gr = row0 + a_row + 64 * c;
    a_src[c] = nullptr;
    if (gr < m) {
      const long long src = lhs_perm ? mapped(gr, perm, rows) : gr;
      a_src[c] = x + (r * m + src) * k + 4 * a_q;
    }
  }
  // B loads: k rows t / kQuads + kKStep c of the stage (c < kNB),
  // column quad t % kQuads
  const int b_k = t / kQuads;
  const int b_col = col0 + 4 * (t % kQuads);
  const int b_avail = min(4, n - b_col);
  const TW* b_src = w + r * k * static_cast<long long>(n) +
                    static_cast<long long>(b_k) * n + b_col;

  Raw<TX> ra[2];
  Raw<TW> rb[kNB];
  auto gload = [&](int k0) {
    const int a_avail = min(4, k - (k0 + 4 * a_q));
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      ra[c] = load4(a_src[c] + k0, vec_x != 0,
                    a_src[c] != nullptr ? a_avail : 0);
    }
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
      const int kr = k0 + b_k + kKStep * c;
      rb[c] = load4(b_src + static_cast<long long>(k0 + kKStep * c) * n,
                    vec_w != 0, kr < k ? b_avail : 0);
    }
  };
  auto sstore = [&](int s) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 a = widen(ra[c]);
      const int rr = swz(a_row + 64 * c, 4 * a_q);
      As[s][4 * a_q + 0][rr] = a.x;
      As[s][4 * a_q + 1][rr] = a.y;
      As[s][4 * a_q + 2][rr] = a.z;
      As[s][4 * a_q + 3][rr] = a.w;
    }
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
      *reinterpret_cast<float4*>(&Bs[s][b_k + kKStep * c][4 * (t % kQuads)]) =
          widen(rb[c]);
    }
  };

  // Thread t owns output rows {tr*4 + i, 64 + tr*4 + i}, i < 4, and
  // columns {64 h + tc*4 + j}, h < kNB, j < 4 (tr = t / 16, tc = t % 16): a
  // warp's A reads are 2 broadcast float4s, its B reads 16 contiguous ones.
  const int tr = t >> 4;
  const int tc = t & 15;
  float acc[8][4 * kNB];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * kNB; ++j) acc[i][j] = 0.0f;
  }

  const int ktiles = (k + kBK - 1) / kBK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) gload((kt + 1) * kBK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&As[s][kk][swz(tr * 4, kk)]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[s][kk][swz(64 + tr * 4, kk)]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[4 * kNB];
#pragma unroll
      for (int h = 0; h < kNB; ++h) {
        const float4 bh =
            *reinterpret_cast<const float4*>(&Bs[s][kk][64 * h + tc * 4]);
        b[4 * h] = bh.x;
        b[4 * h + 1] = bh.y;
        b[4 * h + 2] = bh.z;
        b[4 * h + 3] = bh.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4 * kNB; ++j) {
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    // the other stage was last read before the previous barrier, so one
    // barrier a stage suffices
    if (more) sstore(s ^ 1);
    __syncthreads();
  }

  // epilogue: the destination row goes through perm without lhs_perm
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? 0 : 64) + tr * 4 + (i & 3);
    if (gr >= m) continue;
    const long long dr = lhs_perm ? gr : mapped(gr, perm, rows);
    TO* dst = out + (r * m + dr) * n;
#pragma unroll
    for (int h = 0; h < kNB; ++h) {
      const int gc = col0 + 64 * h + tc * 4;
      if (gc < n) {
        store4(dst + gc,
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]),
               vec_o != 0, min(4, n - gc));
      }
    }
  }
}

template <typename T>
bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* w, void* out, const void* perm,
           int lhs_perm, long long p, long long m, long long n, long long k,
           long long nb, void* stream) {
  if (p > 0 && m > 0 && n > 0) {
    // 4-element vectors where every row of the operand starts aligned
    const int vec_x = k % 4 == 0 && aligned<TX>(x);
    const int vec_w = n % 4 == 0 && aligned<TW>(w);
    const int vec_o = n % 4 == 0 && aligned<TO>(out);
    const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                    static_cast<unsigned>((m + kBM - 1) / kBM),
                    static_cast<unsigned>(p));
    perm_matmul_kernel<TX, TW, TO><<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<TO*>(out), static_cast<const int*>(perm), lhs_perm,
        static_cast<int>(m), static_cast<int>(n), static_cast<int>(k),
        static_cast<int>(m / nb), vec_x, vec_w, vec_o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 x bf16 -> bf16 on the tensor cores (wgmma), for calls the wrapper's
// predicate sends here (rows = m / nb a multiple of 64, k and n multiples
// of 8, 16-byte aligned x and w)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BM = 128;                 // output rows a block: 2 x 64
constexpr int BN = 256;                 // output columns a block
constexpr int BK = 64;                  // k a stage: one 128-byte row
constexpr int STAGES = 4;               // A/B stages in the ring
constexpr int SUB = 64 * BK * 2;        // one 64-row A sub-tile, bytes
constexpr int PANEL = BK * 64 * 2;      // one 64-column B panel, bytes
constexpr int kThreads = 384;           // 2 consumer warpgroups + producer

constexpr int STAGE = 2 * SUB + (BN / 64) * PANEL;   // 48 KB
// the ring, its full and empty barriers, 1 KB alignment slack
constexpr size_t kSmem =
    static_cast<size_t>(STAGES) * STAGE + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
perm_matmul_wgmma(const __grid_constant__ CUtensorMap tma,
                  const __grid_constant__ CUtensorMap tmb,
                  __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ order, int lhs_perm, int m, int n,
                  int k, int rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int wgi = threadIdx.x / 128;
  const int r = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ktiles = (k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // producer: one thread keeps the ring of A/B stages filled by TMA
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int src[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gr = row0 + 64 * c;   // a sub-tile lies in one row block
        src[c] = gr >= m ? m
                 : lhs_perm ? order[gr / rows] * rows + gr % rows
                            : gr;
      }
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* st = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          tma_load_3d(st + c * SUB, &tma, &full[s], kt * BK, src[c], r);
#pragma unroll
        for (int i = 0; i < BN / 64; ++i)
          tma_load_3d(st + 2 * SUB + i * PANEL, &tmb, &full[s], col0 + 64 * i,
                      kt * BK, r);
      }
    }
  } else {
    // consumers: warpgroup wgi multiplies rows [64 wgi, 64 wgi + 64)
    setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * STAGE + wgi * SUB);
      const uint32_t b = smem_u32(smem + s * STAGE + 2 * SUB);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A K-major (x rows), B MN-major (w's n-contiguous rows)
        const uint64_t da = make_desc(a + 32 * kk, 16, 1024, 1);
        const uint64_t db = make_desc(b + 2048 * kk, PANEL, 1024, 1);
        wgmma_ss_m64n256<1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();           // the previous stage's products are done
      fence_regs(acc);
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: accumulator element 4c + 2h + e is row lr + 8h, column
    // 8c + 2 (lane % 4) + e of the warp's 16 x BN slice
    const int lane = threadIdx.x % 32;
    const int lr = wgi * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + lr + 8 * h;
      if (gr >= m) continue;
      const long long dr =
          lhs_perm ? gr
                   : static_cast<long long>(order[gr / rows]) * rows +
                         gr % rows;
      __nv_bfloat16* dst =
          out + (static_cast<long long>(r) * m + dr) * n;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int col = col0 + 8 * c + 2 * (lane % 4);
        if (col < n) {
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
        }
      }
    }
  }
}

int launch(const void* x, const void* w, void* out, const void* order,
           int lhs_perm, long long p, long long m, long long n, long long k,
           long long nb, cudaStream_t stream) {
  if (p <= 0 || m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  // x [p, m, k] and w [p, k, n], innermost first; 64 x 64 boxes of one rank
  CUtensorMap ta, tb;
  const uint64_t da[3] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m),
                          static_cast<uint64_t>(p)};
  const uint64_t sa[2] = {static_cast<uint64_t>(k) * 2,
                          static_cast<uint64_t>(m * k) * 2};
  const uint64_t db[3] = {static_cast<uint64_t>(n), static_cast<uint64_t>(k),
                          static_cast<uint64_t>(p)};
  const uint64_t sb[2] = {static_cast<uint64_t>(n) * 2,
                          static_cast<uint64_t>(k * n) * 2};
  const uint32_t box[3] = {64, 64, 1};
  cudaError_t err = encode_tiled_bf16(&ta, x, 3, da, sa, box, 128);
  if (err == cudaSuccess) err = encode_tiled_bf16(&tb, w, 3, db, sb, box, 128);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(perm_matmul_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>(p));
  perm_matmul_wgmma<<<grid, kThreads, kSmem, stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(order), lhs_perm, static_cast<int>(m),
      static_cast<int>(n), static_cast<int>(k), static_cast<int>(m / nb));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  out is float32 unless both
// inputs are bf16 (result_type).
int repro_perm_matmul(const void* x, const void* w, void* out,
                      const void* perm, int lhs_perm, int x_bf16, int w_bf16,
                      long long p, long long m, long long n, long long k,
                      long long nb, void* stream) {
  using bf = __nv_bfloat16;
  if (!x_bf16 && !w_bf16) {
    return launch<float, float, float>(x, w, out, perm, lhs_perm, p, m, n, k,
                                       nb, stream);
  }
  if (x_bf16 && w_bf16) {
    return launch<bf, bf, bf>(x, w, out, perm, lhs_perm, p, m, n, k, nb,
                              stream);
  }
  if (x_bf16) {
    return launch<bf, float, float>(x, w, out, perm, lhs_perm, p, m, n, k, nb,
                                    stream);
  }
  return launch<float, bf, float>(x, w, out, perm, lhs_perm, p, m, n, k, nb,
                                  stream);
}

// bf16 x [p, m, k], w [p, k, n] -> out [p, m, n] bf16 on the tensor cores;
// needs m / nb % 64 == 0, k % 8 == 0, n % 8 == 0, 16-byte aligned x and w
// (the wrapper's predicate)
int repro_perm_matmul_wgmma(const void* x, const void* w, void* out,
                            const void* perm, int lhs_perm, long long p,
                            long long m, long long n, long long k,
                            long long nb, void* stream) {
  return wg::launch(x, w, out, perm, lhs_perm, p, m, n, k, nb,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
