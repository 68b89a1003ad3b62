// Dequantize-accumulate kernel (sm_90a).  Plain C interface, loaded with
// ctypes by ../kernel.py.
//
// Replaces repro/kernels/qdot/kernel.py:27 (qacc_kernel, body :21):
//   out = acc + float(q) * scale[row]
// q [C, chunk] int8, scales [C, 1] float32, acc [C, chunk] float32 -> out
// [C, chunk] float32 (a new tensor, as the reference's out_shape).
//
// Design: one elementwise pass, a grid-stride loop.  On the vector path
// (chunk % 16 == 0, 16-byte aligned pointers) a thread takes 16 elements:
// one 16-byte load of q, four of acc, one scale (the 16 lie in one chunk),
// four 16-byte stores.
//
// Bound: memory.  C chunk (1 + 4 + 4) + 4 C bytes over the card's
// 3.35 TB/s.
//
// Numerics: __fmul_rn then __fadd_rn, two roundings and no contraction
// into an FMA, like the plain version's multiply and add, so the two are
// bitwise equal.  Kernels launch on the caller's stream and allocate
// nothing; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

unsigned blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b);
}

__device__ __forceinline__ float qa(float a, int8_t q, float s) {
  return __fadd_rn(a, __fmul_rn(static_cast<float>(q), s));
}

__global__ void qacc_vec_kernel(const int8_t* __restrict__ q,
                                const float* __restrict__ scales,
                                const float* __restrict__ acc,
                                float* __restrict__ out, long long n16,
                                long long chunk16) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n16; i += stride) {
    const float s = scales[i / chunk16];
    const int4 qv = reinterpret_cast<const int4*>(q)[i];
    const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
    const float4* av = reinterpret_cast<const float4*>(acc) + 4 * i;
    float4* ov = reinterpret_cast<float4*>(out) + 4 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = av[j];
      float4 o;
      o.x = qa(a.x, qb[4 * j + 0], s);
      o.y = qa(a.y, qb[4 * j + 1], s);
      o.z = qa(a.z, qb[4 * j + 2], s);
      o.w = qa(a.w, qb[4 * j + 3], s);
      ov[j] = o;
    }
  }
}

__global__ void qacc_kernel(const int8_t* __restrict__ q,
                            const float* __restrict__ scales,
                            const float* __restrict__ acc,
                            float* __restrict__ out, long long n,
                            long long chunk) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = qa(acc[i], q[i], scales[i / chunk]);
  }
}

}  // namespace

extern "C" {

// q, scales, acc, out: device pointers; c rows of chunk; vec selects the
// 16-element path (the wrapper checks chunk % 16 and the alignment).
int repro_qacc(const void* q, const void* scales, const void* acc, void* out,
               long long c, long long chunk, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = c * chunk;
  if (vec) {
    qacc_vec_kernel<<<blocks_for(n / 16), kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<const float*>(acc), static_cast<float*>(out), n / 16,
        chunk / 16);
  } else {
    qacc_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<const float*>(acc), static_cast<float*>(out), n, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
