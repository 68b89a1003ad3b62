// Fused butterfly-step kernels for the stacked-rank Bine collectives
// (sm_90a).  Plain C interface, loaded with ctypes by ../kernel.py.
//
// Every kernel takes the stacked form of one schedule step over all p
// ranks at once: buf [p, 2h], recv [p, h], per-rank c / c_next int32 [p]
// on the device.  Grid: blockIdx.y = rank, a grid-stride loop over the
// row in x.  Each rank's kept half is read at its dynamic offset c[r]*h
// inside the kernel, so no slice is ever materialised.  Kernels launch on
// the caller's stream and allocate nothing; each C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Bound: all three are memory-bound (a few flops per element at most), so
// the least time is the bytes they must move over the card's 3.35 TB/s.
// What the design does about it: one pass per step — the kept half is
// read once, the received half is read once, and the new window and the
// next step's send half are written from the same registers, so neither
// makes a separate round trip through device memory.
//
// Bitwise parity with the plain versions rests on: no fast-math flags
// (IEEE division, no flush to zero), rintf rounding half to even as
// torch.round does, and explicit __fadd_rn/__fmul_rn so the compiler
// contracts nothing into an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 1LL << 20;

// Codec chunk of the send half; the send variant of rs_step_q handles
// exactly one chunk per block.
constexpr int kWireChunk = 256;

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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// rs_step: new = buf[c*h : (c+1)*h] + recv (+ send = new[(1-c_next)*h/2 :+h/2])
// Replaces repro/kernels/collectives/kernel.py:78 (rs_step_kernel).
// bf16 adds are computed in f32 and rounded once to bf16, as torch does.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void rs_step_kernel(const T* __restrict__ buf,
                               const T* __restrict__ recv,
                               T* __restrict__ out, T* __restrict__ send,
                               const int* __restrict__ c,
                               const int* __restrict__ c_next, long long h) {
  const long long r = blockIdx.y;
  const T* kept = buf + r * 2 * h + static_cast<long long>(c[r]) * h;
  const T* rv = recv + r * h;
  T* o = out + r * h;
  const long long q = h / 2;
  long long w0 = 0;
  T* s = nullptr;
  if (send != nullptr) {
    w0 = static_cast<long long>(1 - c_next[r]) * q;
    s = send + r * q;
  }
  for (long long j = first_index(); j < h; j += stride()) {
    const float v = __fadd_rn(load_f(kept + j), load_f(rv + j));
    store_f(o + j, v);
    if (s != nullptr && j >= w0 && j < w0 + q) store_f(s + (j - w0), v);
  }
}

template <typename T>
int launch_rs_step(const void* buf, const void* recv, void* out, void* send,
                   const void* c, const void* c_next, long long p,
                   long long h, void* stream) {
  if (p > 0 && h > 0) {
    rs_step_kernel<T><<<grid_for(h, p), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(buf), static_cast<const T*>(recv),
        static_cast<T*>(out), static_cast<T*>(send),
        static_cast<const int*>(c), static_cast<const int*>(c_next), h);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// ag_step: out[2h] = [buf, recv] if c == 0 else [recv, buf]
// Replaces repro/kernels/collectives/kernel.py:258 (ag_step_kernel).
// A pure placement pass over raw bytes, in 16-byte units where the row and
// the pointers allow it, so one kernel serves f32, bf16 and int8.
// ---------------------------------------------------------------------------

template <typename U>
__global__ void ag_step_kernel(const U* __restrict__ buf,
                               const U* __restrict__ recv,
                               U* __restrict__ out,
                               const int* __restrict__ c, long long hu) {
  const long long r = blockIdx.y;
  const bool own_first = c[r] == 0;
  const U* first = (own_first ? buf : recv) + r * hu;
  const U* second = (own_first ? recv : buf) + r * hu;
  U* o = out + r * 2 * hu;
  for (long long j = first_index(); j < 2 * hu; j += stride()) {
    o[j] = j < hu ? first[j] : second[j - hu];
  }
}

template <typename U>
void launch_ag(const void* buf, const void* recv, void* out, const void* c,
               long long p, long long hu, cudaStream_t stream) {
  ag_step_kernel<U><<<grid_for(2 * hu, p), kThreads, 0, stream>>>(
      static_cast<const U*>(buf), static_cast<const U*>(recv),
      static_cast<U*>(out), static_cast<const int*>(c), hu);
}

// ---------------------------------------------------------------------------
// rs_step_q: int8-wire RS step.  new = kept + recv_q * recv_s (f32), and
// with c_next the next send half re-quantized per 256-element chunk with a
// power-of-two scale.  Replaces repro/kernels/collectives/kernel.py:166
// (rs_step_kernel_q).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float pow2_scale(float t) {
  // collectives/compression.py pow2_scale: the exponent-bit ceiling
  const int bits = __float_as_int(t);
  const int frac = bits & 0x7FFFFF;
  const int up = frac == 0 ? bits : (((bits >> 23) & 0xFF) + 1) << 23;
  return t > 0.0f ? __int_as_float(up) : 1.0f;
}

// max that keeps NaN, as torch.amax and jnp.max do (fmaxf drops it): a
// chunk holding a NaN gets scale 1.0, as in the plain version
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7FC00000) : fmaxf(a, b);
}

// clip(round(v), -127, 127) cast to int8, with NaN -> 0 as XLA's and the
// plain version's float-to-int8 conversion give (fmaxf would clip it to
// -127)
__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return r != r ? 0 : static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__global__ void rs_step_q_kernel(const float* __restrict__ buf,
                                 const int8_t* __restrict__ rq,
                                 const float* __restrict__ rs,
                                 float* __restrict__ out,
                                 const int* __restrict__ c, long long h,
                                 long long ch_r) {
  const long long r = blockIdx.y;
  const float* kept = buf + r * 2 * h + static_cast<long long>(c[r]) * h;
  const int8_t* q = rq + r * h;
  const float* s = rs + r * (h / ch_r);
  float* o = out + r * h;
  for (long long j = first_index(); j < h; j += stride()) {
    o[j] = __fadd_rn(kept[j],
                     __fmul_rn(static_cast<float>(q[j]), s[j / ch_r]));
  }
}

// One block of kWireChunk threads per 256-element chunk of the row, so the
// max-abs reduction of a codec chunk stays inside the block (warp
// shuffles, then shared memory).  Needs h % 512 == 0: the send half w = h/2
// is then a whole number of chunks and every chunk lies wholly inside or
// outside it.
__global__ void rs_step_q_send_kernel(
    const float* __restrict__ buf, const int8_t* __restrict__ rq,
    const float* __restrict__ rs, float* __restrict__ out,
    int8_t* __restrict__ sq, float* __restrict__ ss,
    const int* __restrict__ c, const int* __restrict__ c_next, long long h,
    long long ch_r) {
  __shared__ float warp_max[kWireChunk / 32];
  const long long r = blockIdx.y;
  const float* kept = buf + r * 2 * h + static_cast<long long>(c[r]) * h;
  const int8_t* q = rq + r * h;
  const float* s = rs + r * (h / ch_r);
  float* o = out + r * h;
  const long long w = h / 2;
  const long long w0 = static_cast<long long>(1 - c_next[r]) * w;
  int8_t* oq = sq + r * w;
  float* os = ss + r * (w / kWireChunk);
  const long long n_chunks = h / kWireChunk;
  for (long long b = blockIdx.x; b < n_chunks; b += gridDim.x) {
    const long long base = b * kWireChunk;
    const long long j = base + threadIdx.x;
    const float v = __fadd_rn(kept[j],
                              __fmul_rn(static_cast<float>(q[j]), s[j / ch_r]));
    o[j] = v;
    if (base >= w0 && base < w0 + w) {  // uniform across the block
      float a = fabsf(v);
      for (int off = 16; off > 0; off >>= 1) {
        a = nan_max(a, __shfl_xor_sync(0xffffffffu, a, off));
      }
      if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = a;
      __syncthreads();
      float m = warp_max[0];
      for (int k = 1; k < kWireChunk / 32; ++k) m = nan_max(m, warp_max[k]);
      __syncthreads();  // warp_max is reused by the next chunk
      const float scale = pow2_scale(__fdiv_rn(m, 127.0f));
      oq[j - w0] = quantize(v, scale);
      if (threadIdx.x == 0) os[(base - w0) / kWireChunk] = scale;
    }
  }
}

}  // namespace

extern "C" {

int repro_rs_step_f32(const void* buf, const void* recv, void* out,
                      void* send, const void* c, const void* c_next,
                      long long p, long long h, void* stream) {
  return launch_rs_step<float>(buf, recv, out, send, c, c_next, p, h, stream);
}

int repro_rs_step_bf16(const void* buf, const void* recv, void* out,
                       void* send, const void* c, const void* c_next,
                       long long p, long long h, void* stream) {
  return launch_rs_step<__nv_bfloat16>(buf, recv, out, send, c, c_next, p, h,
                                       stream);
}

int repro_ag_step(const void* buf, const void* recv, void* out,
                  const void* c, long long p, long long h,
                  long long elem_bytes, void* stream) {
  const long long nbytes = h * elem_bytes;
  if (p > 0 && nbytes > 0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(buf) |
                        reinterpret_cast<uintptr_t>(recv) |
                        reinterpret_cast<uintptr_t>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (nbytes % 16 == 0 && a % 16 == 0) {
      launch_ag<uint4>(buf, recv, out, c, p, nbytes / 16, st);
    } else if (nbytes % 4 == 0 && a % 4 == 0) {
      launch_ag<uint32_t>(buf, recv, out, c, p, nbytes / 4, st);
    } else if (nbytes % 2 == 0 && a % 2 == 0) {
      launch_ag<uint16_t>(buf, recv, out, c, p, nbytes / 2, st);
    } else {
      launch_ag<uint8_t>(buf, recv, out, c, p, nbytes, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_rs_step_q(const void* buf, const void* recv_q, const void* recv_s,
                    void* out, void* send_q, void* send_s, const void* c,
                    const void* c_next, long long p, long long h,
                    long long ch_r, void* stream) {
  if (p > 0 && h > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* b = static_cast<const float*>(buf);
    const int8_t* q = static_cast<const int8_t*>(recv_q);
    const float* s = static_cast<const float*>(recv_s);
    float* o = static_cast<float*>(out);
    if (send_q == nullptr) {
      rs_step_q_kernel<<<grid_for(h, p), kThreads, 0, st>>>(
          b, q, s, o, static_cast<const int*>(c), h, ch_r);
    } else {
      long long bx = h / kWireChunk;
      if (bx > kMaxBlocksX) bx = kMaxBlocksX;
      rs_step_q_send_kernel<<<dim3(static_cast<unsigned>(bx),
                                   static_cast<unsigned>(p)),
                              kWireChunk, 0, st>>>(
          b, q, s, o, static_cast<int8_t*>(send_q),
          static_cast<float*>(send_s), static_cast<const int*>(c),
          static_cast<const int*>(c_next), h, ch_r);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
