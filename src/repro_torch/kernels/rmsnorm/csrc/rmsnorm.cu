// Fused RMSNorm kernel (sm_90a).  Plain C interface, loaded with ctypes by
// ../kernel.py.
//
// Replaces repro/kernels/rmsnorm/kernel.py:26 (rmsnorm_kernel, body :18):
//   y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// in float32, cast to x's dtype; x [N, d] row-major, w [d], y like x.
//
// Design: one block per row.  Each thread loads its share of the row once
// from device memory (16-byte vectors where the row and pointers allow
// it), keeps it in shared memory as float32 and sums its squares; a warp
// shuffle and then a shared-memory pass reduce the block's partial sums;
// then every thread scales its share from shared memory and writes y.  So
// x and w are read once and y written once.
//
// Bound: memory.  The least time is (N d + d) reads plus N d writes of
// the element size over the card's 3.35 TB/s; there is one multiply-add
// per element, far below the compute roof.
//
// Numerics: the square is rounded (__fmul_rn) and added in float32; the
// mean multiplies the sum by the float32 1/d, as torch's mean does on the
// card; the inverse root is rsqrtf (the function torch.rsqrt calls on the
// card, within 2 ulp), not 1.0f/sqrtf.  The sum runs in another order than
// torch.mean's, so results agree to float32 rounding (rtol 1e-6), and a
// bf16 output to one bf16 ulp.  No fast math.  Kernels launch on the
// caller's stream and allocate nothing; each C entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float from_f(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// VEC elements per access: 16 bytes (4 float32 or 8 bf16) on the vector
// path, 1 otherwise.
template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ w, T* __restrict__ y,
                               int d, float eps) {
  extern __shared__ float smem[];
  float* row = smem;                 // [d] the row as float32
  float* part = smem + d;            // [32] one partial sum per warp
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x + base);
  const int nv = d / VEC;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const Pack<T, VEC> pk = xv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(pk.v[j]);
      row[i * VEC + j] = f;
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
  // block reduction: warps by shuffle, then the first warp over the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    float t = lane < nw ? part[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float ms = __fmul_rn(part[0], 1.0f / static_cast<float>(d));
  const float r = rsqrtf(__fadd_rn(ms, eps));

  const Pack<T, VEC>* wv = reinterpret_cast<const Pack<T, VEC>*>(w);
  Pack<T, VEC>* yv = reinterpret_cast<Pack<T, VEC>*>(y + base);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const Pack<T, VEC> wk = wv[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float g = __fadd_rn(1.0f, to_f(wk.v[j]));
      out.v[j] = from_f(__fmul_rn(__fmul_rn(row[i * VEC + j], r), g),
                        static_cast<T*>(nullptr));
    }
    yv[i] = out;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* y, long long n, int d,
           float eps, int threads, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(d) + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(rmsnorm_kernel<T, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  rmsnorm_kernel<T, VEC><<<static_cast<unsigned>(n), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, w, y: device pointers; n rows of d; bf16 selects __nv_bfloat16 (else
// float32); vec selects the 16-byte path (the wrapper checks d and the
// alignment); threads: the block size, a multiple of 32 up to 1024.
int repro_rmsnorm(const void* x, const void* w, void* y, long long n, int d,
                  float eps, int bf16, int vec, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return vec ? launch<__nv_bfloat16, 8>(x, w, y, n, d, eps, threads, s)
               : launch<__nv_bfloat16, 1>(x, w, y, n, d, eps, threads, s);
  }
  return vec ? launch<float, 4>(x, w, y, n, d, eps, threads, s)
             : launch<float, 1>(x, w, y, n, d, eps, threads, s);
}

}  // extern "C"
