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
// Arithmetic: every input is widened to float32 and multiplied and summed
// in float32 on the CUDA cores (fmaf; no TF32: the reference casts to f32
// before a HIGHEST-precision dot), one rounding to bf16 at the end for a
// bf16 result.  The sum runs in another order than the plain version's
// torch.matmul, so the two agree within a bound stated from k, not
// bitwise.
//
// Bound: operations.  2*m*n*k*p FLOPs over the H100's 67 TFLOP/s float32
// CUDA-core peak for float32 inputs; for bf16 inputs over 989 TFLOP/s, the
// rate of a later tensor-core version of the same function (bf16 products
// are exact in f32).  What the design does about it: a 128 x 128 output
// tile per block of 256 threads, each thread an 8 x 8 register tile, k in
// steps of 16 staged through shared memory (A transposed so both operands
// are read as float4), 64 FMAs per 4 shared-memory float4 reads.  A first,
// simple version: no double buffering, no tensor cores.
//
// Any m, n, k: loads and stores are bounds-checked; out-of-range loads
// read 0.  Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;  // keeps each shared row 16-byte aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ long long mapped(long long i, const int* perm,
                                            long long rows) {
  return static_cast<long long>(perm[i / rows]) * rows + i % rows;
}

// Thread t owns output rows {tr*4 + i, 64 + tr*4 + i} and columns
// {tc*4 + j, 64 + tc*4 + j}, i, j < 4 (tr = t / 16, tc = t % 16), so a
// warp's float4 reads of a shared row are contiguous.
__device__ __forceinline__ int sub(int t4, int i) {
  return (i < 4 ? 0 : 64) + t4 * 4 + (i & 3);
}

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
perm_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TO* __restrict__ out, const int* __restrict__ perm,
                   int lhs_perm, long long m, long long n, long long k,
                   long long rows) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];  // [k][row]
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];  // [k][col]
  const long long r = blockIdx.z;
  const TX* xr = x + r * m * k;
  const TW* wr = w + r * k * n;
  TO* orr = out + r * m * n;
  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long col0 = static_cast<long long>(blockIdx.x) * kBN;
  const int t = threadIdx.x;
  const int tr = t / 16;
  const int tc = t % 16;

  // A tile loads: thread t reads 8 consecutive k of tile row t / 2; its
  // source row is fixed for the whole k loop.
  const int a_row = t / 2;
  const int a_k = (t % 2) * 8;
  const long long ga = row0 + a_row;
  const TX* a_src = nullptr;
  if (ga < m) {
    a_src = xr + (lhs_perm ? mapped(ga, perm, rows) : ga) * k;
  }
  // B tile loads: thread t reads 8 consecutive columns of tile k row t / 16.
  const int b_k = t / 16;
  const int b_col = (t % 16) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  for (long long k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const long long gk = k0 + a_k + e;
      As[a_k + e][a_row] =
          (a_src != nullptr && gk < k) ? to_f(a_src[gk]) : 0.0f;
    }
    {
      const long long gk = k0 + b_k;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const long long gc = col0 + b_col + e;
        Bs[b_k][b_col + e] =
            (gk < k && gc < n) ? to_f(wr[gk * n + gc]) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tc * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gr = row0 + sub(tr, i);
    if (gr >= m) continue;
    TO* dst = orr + (lhs_perm ? gr : mapped(gr, perm, rows)) * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long gc = col0 + sub(tc, j);
      if (gc < n) store(dst + gc, acc[i][j]);
    }
  }
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* w, void* out, const void* perm,
           int lhs_perm, long long p, long long m, long long n, long long k,
           long long nb, void* stream) {
  if (p > 0 && m > 0 && n > 0) {
    const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                    static_cast<unsigned>((m + kBM - 1) / kBM),
                    static_cast<unsigned>(p));
    perm_matmul_kernel<TX, TW, TO><<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<TO*>(out), static_cast<const int*>(perm), lhs_perm, m, n,
        k, m / nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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

}  // extern "C"
