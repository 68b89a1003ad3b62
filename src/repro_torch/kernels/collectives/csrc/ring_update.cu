// Ring-step kernel for the stacked-rank ring collectives (sm_90a).
// Plain C interface, loaded with ctypes by ../kernel.py.
//
// Replaces repro/kernels/collectives/kernel.py:300 (ring_update_kernel,
// bodies :289 and :296): one ring step's read-modify-write of the block
// the step receives into.  Stacked form: v [p, P*b] updated IN PLACE,
// recv [p, b], ridx int32 [p] on the device.  Row r's block ridx[r] gets
//   accumulate:  cur + recv   (reduce-scatter; optionally also written to
//                               send [p, b], the next ring step's send)
//   write:       recv         (allgather)
// and the other P-1 blocks of every row are never read or written — what
// the TPU kernel gets from input_output_aliases.  Grid: blockIdx.y = rank,
// a grid-stride loop over the block in x; each rank reads its block
// offset ridx[r] inside the kernel.
//
// Bound: memory.  Accumulate moves (block read + recv read + block write
// [+ send write]) x p bytes, write (recv read + block write) x p; the
// least time is that over the card's 3.35 TB/s.  What the design does
// about it: one pass, 16-byte vector loads and stores wherever the block
// and the pointers allow it (b * itemsize % 16 == 0), and the next send
// written from the same registers as the block, so it never makes a
// second round trip.
//
// Bitwise parity with the plain version: the add is __fadd_rn in float32
// (no contraction, no fast math); a bf16 add is computed in float32 and
// rounded once to bf16 (__float2bfloat16_rn, half to even), as torch and
// XLA do.  Kernels launch on the caller's stream and allocate nothing;
// each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 1LL << 20;

dim3 grid_for(long long n, long long p) {
  long long bx = (n + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(p));
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* o, float v) { *o = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Accumulate, one element a thread.
template <typename T>
__global__ void ring_acc_kernel(T* __restrict__ v, const T* __restrict__ recv,
                                T* __restrict__ send,
                                const int* __restrict__ ridx,
                                long long row_len, long long b) {
  const long long r = blockIdx.y;
  T* blk = v + r * row_len + static_cast<long long>(ridx[r]) * b;
  const T* rv = recv + r * b;
  T* sd = send == nullptr ? nullptr : send + r * b;
  for (long long j = first_index(); j < b; j += stride()) {
    T o;
    from_f(&o, __fadd_rn(to_f(blk[j]), to_f(rv[j])));
    blk[j] = o;
    if (sd != nullptr) sd[j] = o;
  }
}

// Accumulate, 16 bytes a thread (4 float32 or 8 bf16 lanes); needs
// b * sizeof(T) % 16 == 0 and 16-byte aligned base pointers.
template <typename T>
__global__ void ring_acc_vec_kernel(T* __restrict__ v,
                                    const T* __restrict__ recv,
                                    T* __restrict__ send,
                                    const int* __restrict__ ridx,
                                    long long row_len, long long b) {
  constexpr int kLanes = 16 / sizeof(T);
  const long long r = blockIdx.y;
  uint4* blk = reinterpret_cast<uint4*>(
      v + r * row_len + static_cast<long long>(ridx[r]) * b);
  const uint4* rv = reinterpret_cast<const uint4*>(recv + r * b);
  uint4* sd = send == nullptr ? nullptr
                              : reinterpret_cast<uint4*>(send + r * b);
  const long long nv = b / kLanes;
  for (long long j = first_index(); j < nv; j += stride()) {
    const uint4 a = blk[j];
    const uint4 c = rv[j];
    uint4 o;
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* ce = reinterpret_cast<const T*>(&c);
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int e = 0; e < kLanes; ++e) {
      from_f(oe + e, __fadd_rn(to_f(ae[e]), to_f(ce[e])));
    }
    blk[j] = o;
    if (sd != nullptr) sd[j] = o;
  }
}

// Write: a placement pass over raw units U of the block.
template <typename U>
__global__ void ring_write_kernel(U* __restrict__ v,
                                  const U* __restrict__ recv,
                                  const int* __restrict__ ridx,
                                  long long row_units, long long bu) {
  const long long r = blockIdx.y;
  U* blk = v + r * row_units + static_cast<long long>(ridx[r]) * bu;
  const U* rv = recv + r * bu;
  for (long long j = first_index(); j < bu; j += stride()) blk[j] = rv[j];
}

template <typename U>
void launch_write(void* v, const void* recv, const void* ridx, long long p,
                  long long row_units, long long bu, cudaStream_t st) {
  ring_write_kernel<U><<<grid_for(bu, p), kThreads, 0, st>>>(
      static_cast<U*>(v), static_cast<const U*>(recv),
      static_cast<const int*>(ridx), row_units, bu);
}

template <typename T>
int launch_acc(void* v, const void* recv, void* send, const void* ridx,
               long long p, long long row_len, long long b, void* stream) {
  if (p > 0 && b > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uintptr_t a = reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(recv) |
                        reinterpret_cast<uintptr_t>(send);
    T* vt = static_cast<T*>(v);
    const T* rt = static_cast<const T*>(recv);
    T* stt = static_cast<T*>(send);
    const int* ri = static_cast<const int*>(ridx);
    if ((b * static_cast<long long>(sizeof(T))) % 16 == 0 && a % 16 == 0) {
      const long long nv = b * static_cast<long long>(sizeof(T)) / 16;
      ring_acc_vec_kernel<T><<<grid_for(nv, p), kThreads, 0, st>>>(
          vt, rt, stt, ri, row_len, b);
    } else {
      ring_acc_kernel<T><<<grid_for(b, p), kThreads, 0, st>>>(
          vt, rt, stt, ri, row_len, b);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v [p, row_len] in place; recv [p, b]; send [p, b] or null; ridx [p].
int repro_ring_acc_f32(void* v, const void* recv, void* send,
                       const void* ridx, long long p, long long row_len,
                       long long b, void* stream) {
  return launch_acc<float>(v, recv, send, ridx, p, row_len, b, stream);
}

int repro_ring_acc_bf16(void* v, const void* recv, void* send,
                        const void* ridx, long long p, long long row_len,
                        long long b, void* stream) {
  return launch_acc<__nv_bfloat16>(v, recv, send, ridx, p, row_len, b,
                                   stream);
}

// Any element size: lengths in elements, elem_bytes in {1, 2, 4, 8}.
int repro_ring_write(void* v, const void* recv, const void* ridx,
                     long long p, long long row_len, long long b,
                     long long elem_bytes, void* stream) {
  const long long nbytes = b * elem_bytes;
  const long long row_bytes = row_len * elem_bytes;
  if (p > 0 && nbytes > 0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(recv);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (nbytes % 16 == 0 && a % 16 == 0) {
      launch_write<uint4>(v, recv, ridx, p, row_bytes / 16, nbytes / 16, st);
    } else if (nbytes % 8 == 0 && a % 8 == 0) {
      launch_write<uint2>(v, recv, ridx, p, row_bytes / 8, nbytes / 8, st);
    } else if (nbytes % 4 == 0 && a % 4 == 0) {
      launch_write<uint32_t>(v, recv, ridx, p, row_bytes / 4, nbytes / 4, st);
    } else if (nbytes % 2 == 0 && a % 2 == 0) {
      launch_write<uint16_t>(v, recv, ridx, p, row_bytes / 2, nbytes / 2, st);
    } else {
      launch_write<uint8_t>(v, recv, ridx, p, row_bytes, nbytes, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
