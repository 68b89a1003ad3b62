// Dequantize-accumulate kernel (sm_90a).  Plain C interface, loaded with
// ctypes by ../kernel.py.
//
// Replaces repro/kernels/qdot/kernel.py:27 (qacc_kernel, body :21):
//   out = acc + float(q) * scale[row]
// q [C, chunk] int8, scales [C, 1] float32, acc [C, chunk] float32 -> out
// [C, chunk] float32 (a new tensor, as the reference's out_shape).
//
// Bound: memory.  C chunk (1 + 4 + 4) + 4 C bytes over the card's
// 3.35 TB/s.
//
// Design: one elementwise pass laid out for the card's memory system.  On
// the vector path (chunk % 4 == 0, acc and out 16-byte and q 4-byte
// aligned) lane k of a warp takes float4 k of a contiguous 512-byte run of
// acc and out and the matching 4 bytes of q, so every warp instruction
// reads and writes whole lines; kUnroll such vectors a thread are in
// flight, every load issued before any store.  A vector lies in one row
// (chunk % 4 == 0), so it has one scale: its row is a shift when chunk is
// a power of two (256, the wire's codec chunk, in every caller), else one
// division a vector.  From chunk 128 up a warp's 32 vectors lie in one row
// and the scale load is a broadcast.  Other chunks and pointers take the
// element-wise kernel, lane-consecutive elements.  The wrapper sizes the
// grid to QACC_WAVES waves of resident blocks (repro_qacc_blocks_per_sm);
// indices are 32-bit while C * chunk < 2**31.  Loads stream (evict-first):
// q and acc are read once.
//
// Numerics: __fmul_rn then __fadd_rn, two roundings and no contraction
// into an FMA, like the plain version's multiply and add, so the two are
// bitwise equal (torch.addcmul contracts into an FMA, so it is not).
// Kernels launch on the caller's stream and allocate nothing; each C entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// float4 vectors a thread holds (kernel.py QACC_UNROLL)
constexpr int kUnroll = 4;

__device__ __forceinline__ float qa(float a, int q, float s) {
  return __fadd_rn(a, __fmul_rn(static_cast<float>(q), s));
}

// The vector kernel.  I: the index type; shift >= 0: log2(chunk), else the
// row of element e is e / chunk.
template <typename I>
__global__ void __launch_bounds__(kThreads)
qacc_vec_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                const float* __restrict__ acc, float* __restrict__ out, I n4,
                I chunk, int shift) {
  const float4* av = reinterpret_cast<const float4*>(acc);
  const unsigned* qv = reinterpret_cast<const unsigned*>(q);
  float4* ov = reinterpret_cast<float4*>(out);
  const I step = static_cast<I>(gridDim.x) * (kThreads * kUnroll);
  for (I i0 = static_cast<I>(blockIdx.x) * (kThreads * kUnroll) + threadIdx.x;
       i0 < n4; i0 += step) {
    float4 a[kUnroll];
    unsigned w[kUnroll];
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // every load before any store
      const I i = i0 + u * kThreads;
      if (i < n4) {
        a[u] = __ldcs(av + i);
        w[u] = __ldcs(qv + i);
        const I e = 4 * i;
        s[u] = scales[shift >= 0 ? (e >> shift) : (e / chunk)];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I i = i0 + u * kThreads;
      if (i < n4) {
        const int b0 = static_cast<int8_t>(w[u]);
        const int b1 = static_cast<int8_t>(w[u] >> 8);
        const int b2 = static_cast<int8_t>(w[u] >> 16);
        const int b3 = static_cast<int8_t>(w[u] >> 24);
        ov[i] = make_float4(qa(a[u].x, b0, s[u]), qa(a[u].y, b1, s[u]),
                            qa(a[u].z, b2, s[u]), qa(a[u].w, b3, s[u]));
      }
    }
  }
}

// The element-wise kernel: any chunk, any alignment.
template <typename I>
__global__ void __launch_bounds__(kThreads)
qacc_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
            const float* __restrict__ acc, float* __restrict__ out, I n,
            I chunk) {
  const I step = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += step) {
    out[i] = qa(acc[i], q[i], scales[i / chunk]);
  }
}

template <typename I>
void launch(const void* q, const void* scales, const void* acc, void* out,
            long long n, long long chunk, int vec, int shift, int grid,
            cudaStream_t st) {
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  const float* ap = static_cast<const float*>(acc);
  float* op = static_cast<float*>(out);
  if (vec) {
    qacc_vec_kernel<I><<<grid, kThreads, 0, st>>>(
        qp, sp, ap, op, static_cast<I>(n / 4), static_cast<I>(chunk), shift);
  } else {
    qacc_kernel<I><<<grid, kThreads, 0, st>>>(
        qp, sp, ap, op, static_cast<I>(n), static_cast<I>(chunk));
  }
}

}  // namespace

extern "C" {

// q, scales, acc, out: device pointers; c rows of chunk.  vec selects the
// vector kernel (kernel.py qacc_launch checks chunk % 4 and the
// alignment), shift = log2(chunk) for a power-of-two chunk, else -1;
// grid: blocks.
int repro_qacc(const void* q, const void* scales, const void* acc, void* out,
               long long c, long long chunk, int vec, int shift, int grid,
               void* stream) {
  const long long n = c * chunk;
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // 32-bit indices while every index and i0 + step stay below 2**32
    if (n < (1LL << 31)) {
      launch<unsigned>(q, scales, acc, out, n, chunk, vec, shift, grid, st);
    } else {
      launch<long long>(q, scales, acc, out, n, chunk, vec, shift, grid, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// *blocks = resident blocks per SM of the 32-bit vector (vec = 1) or
// element-wise kernel at kThreads a block; the wrapper's grid spans
// QACC_WAVES such waves.
int repro_qacc_blocks_per_sm(int vec, int* blocks) {
  const void* fn =
      vec ? reinterpret_cast<const void*>(qacc_vec_kernel<unsigned>)
          : reinterpret_cast<const void*>(qacc_kernel<unsigned>);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0));
}

}  // extern "C"
