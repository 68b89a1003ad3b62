// Fused RMSNorm kernel (sm_90a).  Plain C interface, loaded with ctypes by
// ../kernel.py.
//
// Replaces repro/kernels/rmsnorm/kernel.py:26 (rmsnorm_kernel, body :18):
//   y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// in float32, cast to x's dtype; x [N, d] row-major, w [d], y like x.
//
// Bound: memory.  The least time is (N d + d) reads plus N d writes of the
// element size over the card's 3.35 TB/s (3.8 us for bf16 [1024, 3072]);
// there is one multiply-add per element, far below the compute roof.
//
// What held the first version back (one block per row, the row copied to
// shared memory as float32): 12 KB of shared-memory traffic each way per
// row, two barriers per row, one 16-byte load in flight per thread before
// the reduction, and w read again for every row.  This design:
//
// - The row stays in registers.  A thread holds VPT vectors of 16 bytes
//   (8 bf16 or 4 float32; 1 element where d is not a multiple of those)
//   and issues all of its loads before any arithmetic: at bf16 d = 3072 a
//   128-thread block holds the row as 3 vectors a thread, so the whole
//   6 KB row is in flight at once.  Where an address is not 16-byte
//   aligned the same vectors are read element by element: a row's sum is
//   taken in one order whatever its alignment, and (one block a row, the
//   launch shape a function of d alone) whatever the batch, so a row's
//   bits are the same alone or in any batch.
// - w is loaded once per block into registers (VPT vectors, kept packed)
//   and reused for every row the block walks.
// - One barrier per row: each warp reduces its sum of squares by shuffle,
//   lane 0 writes it to a two-slot shared array indexed by the row's
//   parity, and after the barrier every thread sums the warps' partials in
//   the same order (so every thread computes the same scale).  The
//   parity slot makes a second barrier unnecessary: a warp writes row
//   j + 2's slot only after the barrier of row j + 1, which every thread
//   reaches only after reading row j's.
// - A grid of one wave, min(N, blocks per SM x SMs) (the wrapper asks the
//   occupancy once per launch shape); each block walks rows with a stride.
// - The launch shape (threads, VPT) comes from the wrapper's launch_shape:
//   threads about a third of the row's vectors (a multiple of 32, 32 to
//   512), VPT = vectors / threads rounded up, at most 4.  Blocks stop at
//   512 threads so that a thread may take 128 registers: at 1024 threads
//   (64 registers) the bf16 VPT = 3 and 4 instances spilled.  A row
//   longer than 512 x 4 vectors (bf16 d > 16384, float32 d > 8192, or an
//   unvectorised d > 2048) does not fit that budget, so VPT = 0 selects a
//   loop over the row in two passes: the sum of squares, then the scaled
//   write, which reads x a second time (from L2 at these sizes).  No path
//   of the port's models runs that variant (phi4-mini's rows are
//   d = 3072).
//
// Numerics: the square is rounded (__fmul_rn) and added in float32; the
// mean multiplies the sum by the float32 1/d, as torch's mean does on the
// card; the inverse root is rsqrtf (the function torch.rsqrt calls on the
// card, within 2 ulp), not 1.0f/sqrtf; then (x * r) * (1 + w), each
// product rounded, as the plain version.  The sum runs in another order
// than torch.mean's, so results agree to float32 rounding (rtol 1e-6), and
// a bf16 output to one bf16 ulp.  No fast math.
//
// Registers and occupancy (nvcc -Xptxas -v, sm_90a): no instance spills;
// 26 to 126 registers.  The serve cell's instance (bf16, 8-wide vectors,
// VPT 3, 128 threads) takes 95, so 5 blocks an SM: a wave of 660 blocks
// for the insert's 1024 rows.  Capping it at 64 registers (two 512-thread
// blocks an SM) made it spill 88 bytes and run slower.
// Kernels launch on the caller's stream and allocate nothing; each C entry
// point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // kernel.py MAX_THREADS
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float from_f(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// VEC elements per access: 16 bytes (4 float32 or 8 bf16) on the vector
// path, 1 otherwise; aligned to its size so a vector is one 16-byte access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// The block's sum of the threads' ss, one barrier: see the header.
__device__ __forceinline__ float block_sum(float ss, float (*part)[kMaxWarps],
                                           int par) {
  ss = warp_sum(ss);
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) part[par][threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.0f;
  for (int i = 0; i < nw; ++i) tot = __fadd_rn(tot, part[par][i]);
  return tot;
}

// y = (x * r) * (1 + w) for one vector, x already widened to float32
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> scale(const float* xf,
                                              const Pack<T, VEC>& ws,
                                              float r) {
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float g = __fadd_rn(1.0f, to_f(ws.v[j]));
    out.v[j] = from_f(__fmul_rn(__fmul_rn(xf[j], r), g),
                      static_cast<T*>(nullptr));
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void widen(const Pack<T, VEC>& p, float* xf) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) xf[j] = to_f(p.v[j]);
}

// Vector i of a row: one 16-byte access when ALIGNED, else VEC element
// accesses into the same registers (a view off 16 bytes), so both give the
// row the same threads, the same partial sums and the same bits.
template <typename T, int VEC, bool ALIGNED>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p, int i) {
  if constexpr (ALIGNED) {
    return reinterpret_cast<const Pack<T, VEC>*>(p)[i];
  } else {
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.v[j] = p[i * VEC + j];
    return out;
  }
}

template <typename T, int VEC, bool ALIGNED>
__device__ __forceinline__ void store_pack(T* p, int i,
                                           const Pack<T, VEC>& v) {
  if constexpr (ALIGNED) {
    reinterpret_cast<Pack<T, VEC>*>(p)[i] = v;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[i * VEC + j] = v.v[j];
  }
}

// VPT > 0: the row in registers, VPT vectors a thread; VPT == 0: the loop
// over the row in two passes (rows beyond the register budget).  ALIGNED:
// x, w and y are 16-byte aligned (see load_pack).
template <typename T, int VEC, int VPT, bool ALIGNED>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, long long n, int d, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float part[2][kMaxWarps];
  const int nv = d / VEC;            // VEC divides d (the wrapper's rule)
  const int t = threadIdx.x;
  const float inv_d = 1.0f / static_cast<float>(d);
  int par = 0;

  if constexpr (VPT == 0) {
    for (long long row = blockIdx.x; row < n; row += gridDim.x, par ^= 1) {
      const T* xr = x + row * d;
      float ss = 0.0f;
      for (int i = t; i < nv; i += blockDim.x) {
        const P xs = load_pack<T, VEC, ALIGNED>(xr, i);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f(xs.v[j]);
          ss = __fadd_rn(ss, __fmul_rn(f, f));
        }
      }
      const float tot = block_sum(ss, part, par);
      const float r = rsqrtf(__fadd_rn(__fmul_rn(tot, inv_d), eps));
      T* yr = y + row * d;
      for (int i = t; i < nv; i += blockDim.x) {
        float xf[VEC];
        widen(load_pack<T, VEC, ALIGNED>(xr, i), xf);
        store_pack<T, VEC, ALIGNED>(
            yr, i, scale(xf, load_pack<T, VEC, ALIGNED>(w, i), r));
      }
    }
  } else {
    P ws[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = t + i * blockDim.x;
      if (idx < nv) ws[i] = load_pack<T, VEC, ALIGNED>(w, idx);
    }
    for (long long row = blockIdx.x; row < n; row += gridDim.x, par ^= 1) {
      const T* xr = x + row * d;
      P xs[VPT];
#pragma unroll
      for (int i = 0; i < VPT; ++i) {   // every load before any arithmetic
        const int idx = t + i * blockDim.x;
        if (idx < nv) xs[i] = load_pack<T, VEC, ALIGNED>(xr, idx);
      }
      // widened once: the packed loads die here, so x is held once, as
      // float32, across the reduction
      float xf[VPT][VEC];
      float ss = 0.0f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        widen(xs[i], xf[i]);
        if (t + i * static_cast<int>(blockDim.x) < nv) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            ss = __fadd_rn(ss, __fmul_rn(xf[i][j], xf[i][j]));
          }
        }
      }
      const float tot = block_sum(ss, part, par);
      const float r = rsqrtf(__fadd_rn(__fmul_rn(tot, inv_d), eps));
      T* yr = y + row * d;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int idx = t + i * blockDim.x;
        if (idx < nv) {
          store_pack<T, VEC, ALIGNED>(yr, idx, scale(xf[i], ws[i], r));
        }
      }
    }
  }
}

// The kernel instance for (T, VEC, vpt, ALIGNED), vpt in 0..4 (kernel.py
// MAX_VPT).
template <typename T, int VEC, bool ALIGNED>
const void* pick(int vpt) {
  switch (vpt) {
    case 0:
      return reinterpret_cast<const void*>(rmsnorm_kernel<T, VEC, 0, ALIGNED>);
    case 1:
      return reinterpret_cast<const void*>(rmsnorm_kernel<T, VEC, 1, ALIGNED>);
    case 2:
      return reinterpret_cast<const void*>(rmsnorm_kernel<T, VEC, 2, ALIGNED>);
    case 3:
      return reinterpret_cast<const void*>(rmsnorm_kernel<T, VEC, 3, ALIGNED>);
    case 4:
      return reinterpret_cast<const void*>(rmsnorm_kernel<T, VEC, 4, ALIGNED>);
    default: return nullptr;
  }
}

// vec: 0 one element a vector, 1 the 16-byte vectors, 2 the vectors' layout
// with element accesses (d a multiple of the lanes, a pointer off 16
// bytes).
const void* kernel_for(int bf16, int vec, int vpt) {
  if (bf16) {
    return vec == 1 ? pick<__nv_bfloat16, 8, true>(vpt)
           : vec == 2 ? pick<__nv_bfloat16, 8, false>(vpt)
                      : pick<__nv_bfloat16, 1, true>(vpt);
  }
  return vec == 1 ? pick<float, 4, true>(vpt)
         : vec == 2 ? pick<float, 4, false>(vpt)
                    : pick<float, 1, true>(vpt);
}

}  // namespace

extern "C" {

// x, w, y: device pointers; n rows of d; bf16 selects __nv_bfloat16 (else
// float32); vec selects the layout (kernel_for: the wrapper checks d and
// the alignment); vpt: vectors a thread holds (1-4), or 0 for the loop over
// the row; threads: the block size, a multiple of 32 up to 512; grid:
// blocks, each walking rows with a stride of grid.
int repro_rmsnorm(const void* x, const void* w, void* y, long long n, int d,
                  float eps, int bf16, int vec, int vpt, int threads,
                  int grid, void* stream) {
  const void* fn = kernel_for(bf16, vec, vpt);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {const_cast<void*>(static_cast<const void*>(&x)),
                  const_cast<void*>(static_cast<const void*>(&w)), &y, &n,
                  &d, &eps};
  cudaError_t err = cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// *blocks = resident blocks of that kernel instance per SM at threads a
// block (the wrapper's one-wave grid is this times the SM count).
int repro_rmsnorm_blocks_per_sm(int bf16, int vec, int vpt, int threads,
                                int* blocks) {
  const void* fn = kernel_for(bf16, vec, vpt);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads, 0));
}

}  // extern "C"
