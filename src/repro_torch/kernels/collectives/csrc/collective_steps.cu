// Fused butterfly-step kernels for the stacked-rank Bine collectives
// (sm_90a).  Plain C interface, loaded with ctypes by ../kernel.py.
//
// Every kernel takes the stacked form of one schedule step over all p
// ranks at once: buf [p, 2h], recv [p, h], per-rank c / c_next int32 [p]
// on the device.  Grid: blockIdx.y = rank, a grid-stride loop over the
// row in x (ag_step: one row of blocks over the tiles of every rank's
// output row).  Each rank's kept half is read at its dynamic offset c[r]*h
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
// rs_step, ag_step and rs_step_q (TPU kernels 1-3) are laid out for the
// card's memory system:
// - rs_step moves 16-byte vectors (4 float32 or 8 bf16) of the kept half,
//   recv, new and send, kUnroll of them a thread in flight: every load is
//   issued before any add.  The send window starts at a whole vector when
//   h/2 is a multiple of the lanes, so it is tested per vector.  Rows or
//   pointers off that rule take the element-wise kernel.
// - ag_step copies tiles that each lie in one half of one rank's output
//   row, so a block reads one source with no per-element select, in the
//   widest unit (16, 4, 2 or 1 bytes) the row and the pointers allow,
//   kUnroll units a thread in flight, 32-bit offsets, a block a tile in
//   output order.
// - rs_step_q gives one warp to each 256-element codec chunk, 8
//   consecutive elements a lane (two float4 of the kept half, one 8-byte
//   int8 load, the chunk's one scale), and reduces the chunk's max-abs
//   with shuffles alone.  The scale index is a shift (the codec chunk is
//   a power of two); codec chunks under 8 elements take the element-wise
//   kernel.  Quantizing multiplies by the scale's exact reciprocal.
// - The wrapper sizes the grids of rs_step and rs_step_q to a few waves
//   of resident blocks (the occupancy from repro_step_blocks_per_sm), and
//   their loads stream (evict-first): at the train step's 64 MiB buckets
//   nothing a call reads is read again from the 50 MB L2.
//
// Bitwise parity with the plain versions rests on: no fast-math flags
// (no flush to zero), rintf rounding half to even as torch.round does,
// explicit __fadd_rn/__fmul_rn so the compiler contracts nothing into an
// FMA, and a power-of-two scale: v * (1/scale) is then the same correctly
// rounded number as v / scale (1/scale is exact for every scale the codec
// makes, 2^-126 to 2^122, and is 0 for scale = inf, so NaN and inf give
// what the division gives).  The chunk max is exact whatever the order of
// its reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// 16-byte vectors a thread of the rs_step vector kernel holds per stream,
// and units a thread of ag_step holds (kernel.py RS_UNROLL)
constexpr int kUnroll = 4;

// Codec chunk of the send half; rs_step_q's warp kernel gives each warp
// one chunk of the row at a time, 8 elements a lane.
constexpr int kWireChunk = 256;
constexpr int kLaneElems = kWireChunk / 32;

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
// bf16 adds are computed in float32 and rounded once to bf16, as torch
// does.
// ---------------------------------------------------------------------------

// Elements of T in one 16-byte vector.
template <typename T>
struct Lanes {
  static constexpr int n = 16 / sizeof(T);
};

// A 16-byte vector widened to float32 (bf16 -> float32 is exact: the bits
// shifted into the high half), and narrowed back with one rounding.
__device__ __forceinline__ void widen16(const uint4& u, float* f, float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen16(const uint4& u, float* f,
                                        __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ uint4 narrow16(const float* f, float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint4 narrow16(const float* f, __nv_bfloat16*) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = bf16_bits(f[2 * k]) | (bf16_bits(f[2 * k + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The vector kernel: h a multiple of Lanes<T>::n (and, with send, h/2
// too), every pointer 16-byte aligned.  A block-iteration covers
// kThreads * kUnroll vectors of the row, neighbouring threads on
// neighbouring vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rs_step_vec_kernel(const T* __restrict__ buf, const T* __restrict__ recv,
                   T* __restrict__ out, T* __restrict__ send,
                   const int* __restrict__ c,
                   const int* __restrict__ c_next, long long h) {
  constexpr int L = Lanes<T>::n;
  const long long r = blockIdx.y;
  const long long nv = h / L;
  const uint4* kept = reinterpret_cast<const uint4*>(
      buf + r * 2 * h + static_cast<long long>(c[r]) * h);
  const uint4* rv = reinterpret_cast<const uint4*>(recv + r * h);
  uint4* o = reinterpret_cast<uint4*>(out + r * h);
  const long long qv = nv / 2;       // the send window, in vectors
  long long w0 = 0;
  uint4* s = nullptr;
  if (send != nullptr) {
    w0 = static_cast<long long>(1 - c_next[r]) * qv;
    s = reinterpret_cast<uint4*>(send + r * (h / 2));
  }
  const long long step = static_cast<long long>(gridDim.x) * kThreads *
                         kUnroll;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kThreads *
                          kUnroll + threadIdx.x;
       i0 < nv; i0 += step) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // every load before any add
      const long long i = i0 + u * kThreads;
      if (i < nv) {
        a[u] = __ldcs(kept + i);
        b[u] = __ldcs(rv + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < nv) {
        float x[L], y[L];
        widen16(a[u], x, static_cast<T*>(nullptr));
        widen16(b[u], y, static_cast<T*>(nullptr));
#pragma unroll
        for (int k = 0; k < L; ++k) x[k] = __fadd_rn(x[k], y[k]);
        const uint4 v = narrow16(x, static_cast<T*>(nullptr));
        o[i] = v;
        if (s != nullptr && i >= w0 && i < w0 + qv) s[i - w0] = v;
      }
    }
  }
}

// The element-wise kernel: any h, any alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rs_step_kernel(const T* __restrict__ buf, const T* __restrict__ recv,
               T* __restrict__ out, T* __restrict__ send,
               const int* __restrict__ c, const int* __restrict__ c_next,
               long long h) {
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
                   long long h, int vec, int grid, void* stream) {
  if (p > 0 && h > 0) {
    const dim3 g(static_cast<unsigned>(grid), static_cast<unsigned>(p));
    auto kernel = vec ? rs_step_vec_kernel<T> : rs_step_kernel<T>;
    kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(buf), static_cast<const T*>(recv),
        static_cast<T*>(out), static_cast<T*>(send),
        static_cast<const int*>(c), static_cast<const int*>(c_next), h);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// ag_step: out[2h] = [buf, recv] if c == 0 else [recv, buf]
// Replaces repro/kernels/collectives/kernel.py:258 (ag_step_kernel).
// A pure placement pass over raw bytes, so one kernel serves f32, bf16 and
// int8.  The output [p, 2, n] (n units a row half) is cut into tiles of
// kThreads * kUnroll units, each inside one row half, so a block copies a
// tile from one source and no element carries a select.  The blocks take
// the tiles in output order (tile t, t + gridDim.x, ...), so the blocks
// resident at once cover one stretch of the output and of each source.
// The wrapper launches a block a tile (kernel.py ag_step_launch): a grid
// of a few waves of resident blocks, as rs_step's, ran 3% slower on an
// H100 on this pure copy, its last pass leaving SMs idle.  U is the unit
// the row and every pointer allow: a 16-byte vector on the main path,
// else 4, 2 or 1 bytes.  kUnroll units a thread in flight, every load
// issued before any store, neighbouring threads on neighbouring units;
// I the index type (32 bits below 2**31 units and tiles).  Plain loads
// and stores: below the L2's size the next step reads this step's output
// from the L2, and at 64 MiB streaming hints moved the step by less than
// a run's spread on an H100.
// ---------------------------------------------------------------------------

constexpr int kTile = kThreads * kUnroll;

template <typename U, typename I>
__global__ void __launch_bounds__(kThreads)
ag_step_kernel(const U* __restrict__ buf, const U* __restrict__ recv,
               U* __restrict__ out, const int* __restrict__ c, I n,
               I tiles, I total) {
  for (I t = blockIdx.x; t < total; t += gridDim.x) {
    const I rh = t / tiles;      // the row half: rank rh / 2, half rh % 2
    const I i0 = (t - rh * tiles) * kTile + threadIdx.x;
    const long long r = static_cast<long long>(rh >> 1);
    // half 0 takes buf when c == 0, half 1 takes it when c == 1
    const bool from_buf = (c[r] == 0) == ((rh & 1) == 0);
    const U* src = (from_buf ? buf : recv) + r * static_cast<long long>(n);
    U* dst = out + static_cast<long long>(rh) * static_cast<long long>(n);
    U v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // every load before any store
      const I i = i0 + u * kThreads;
      if (i < n) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const I i = i0 + u * kThreads;
      if (i < n) dst[i] = v[u];
    }
  }
}

template <typename U, typename I>
void launch_ag(const void* buf, const void* recv, void* out, const void* c,
               long long p, long long n, long long tiles, int grid,
               cudaStream_t st) {
  ag_step_kernel<U, I><<<grid, kThreads, 0, st>>>(
      static_cast<const U*>(buf), static_cast<const U*>(recv),
      static_cast<U*>(out), static_cast<const int*>(c), static_cast<I>(n),
      static_cast<I>(tiles), static_cast<I>(2 * p * tiles));
}

template <typename U>
void launch_ag_unit(const void* buf, const void* recv, void* out,
                    const void* c, long long p, long long n, int grid,
                    cudaStream_t st) {
  // one row of blocks walks the tiles of all p ranks; 32-bit indices
  // while every unit index and tile index, plus one step of the loop,
  // stays below 2**32
  const long long tiles = (n + kTile - 1) / kTile;
  if (n >= (1LL << 31) || 2 * p * tiles >= (1LL << 31)) {
    launch_ag<U, long long>(buf, recv, out, c, p, n, tiles, grid, st);
  } else {
    launch_ag<U, unsigned>(buf, recv, out, c, p, n, tiles, grid, st);
  }
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

// clip(round(v * inv), -127, 127) cast to int8, inv the exact reciprocal of
// a power-of-two scale (v * inv is v / scale rounded once, see the
// header), with NaN -> 0 as XLA's and the plain version's float-to-int8
// conversion give (fmaxf would clip it to -127)
__device__ __forceinline__ int quantize(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return r != r ? 0 : static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// The element-wise no-send kernel: codec chunks under 8 elements (odd or
// small h), where a lane's 8 elements would straddle scales.
__global__ void __launch_bounds__(kThreads)
rs_step_q_scalar_kernel(const float* __restrict__ buf,
                        const int8_t* __restrict__ rq,
                        const float* __restrict__ rs,
                        float* __restrict__ out,
                        const int* __restrict__ c, long long h, int shift) {
  const long long r = blockIdx.y;
  const float* kept = buf + r * 2 * h + static_cast<long long>(c[r]) * h;
  const int8_t* q = rq + r * h;
  const float* s = rs + r * (h >> shift);
  float* o = out + r * h;
  for (long long j = first_index(); j < h; j += stride()) {
    o[j] = __fadd_rn(kept[j],
                     __fmul_rn(static_cast<float>(q[j]), s[j >> shift]));
  }
}

// The warp kernel: codec chunks of 8 elements or more (so h % 8 == 0 and a
// lane's 8 elements share one scale).  Each warp takes 256 elements of the
// row at a time, kLaneElems consecutive ones a lane; VEC loads and stores
// them as vectors (buf, out 16-byte and recv_q, send_q 8-byte aligned),
// otherwise element by element in the same layout.  With SEND (h % 512 ==
// 0, so the codec chunk is 256 and every warp's 256 elements are one
// chunk, wholly inside or outside the send half) the warp also
// re-quantizes its chunk when it lies in the send half: the max-abs by
// shuffles, the scale, the 8 int8 of each lane in one 8-byte store.
template <bool VEC, bool SEND>
__global__ void __launch_bounds__(kThreads)
rs_step_q_kernel(const float* __restrict__ buf,
                 const int8_t* __restrict__ rq, const float* __restrict__ rs,
                 float* __restrict__ out, int8_t* __restrict__ sq,
                 float* __restrict__ ss, const int* __restrict__ c,
                 const int* __restrict__ c_next, long long h, int shift) {
  const long long r = blockIdx.y;
  const float* kept = buf + r * 2 * h + static_cast<long long>(c[r]) * h;
  const int8_t* q = rq + r * h;
  const float* s = rs + r * (h >> shift);
  float* o = out + r * h;
  long long w = 0, w0 = 0;
  int8_t* oq = nullptr;
  float* os = nullptr;
  if constexpr (SEND) {
    w = h / 2;
    w0 = static_cast<long long>(1 - c_next[r]) * w;
    oq = sq + r * w;
    os = ss + r * (w / kWireChunk);
  }
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long base = warp * kWireChunk; base < h;
       base += warps * kWireChunk) {
    const long long j = base + lane * kLaneElems;
    float v[kLaneElems] = {};
    if (j < h) {   // h % 8 == 0: a lane's elements lie wholly in the row
      float k[kLaneElems];
      int qi[kLaneElems];
      if constexpr (VEC) {
        const float4 k0 = __ldcs(reinterpret_cast<const float4*>(kept + j));
        const float4 k1 =
            __ldcs(reinterpret_cast<const float4*>(kept + j + 4));
        const uint2 qw = __ldcs(reinterpret_cast<const uint2*>(q + j));
        k[0] = k0.x; k[1] = k0.y; k[2] = k0.z; k[3] = k0.w;
        k[4] = k1.x; k[5] = k1.y; k[6] = k1.z; k[7] = k1.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qi[e] = static_cast<int8_t>(qw.x >> (8 * e));
          qi[e + 4] = static_cast<int8_t>(qw.y >> (8 * e));
        }
      } else {
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) {
          k[e] = kept[j + e];
          qi[e] = q[j + e];
        }
      }
      const float sc = s[j >> shift];
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e) {
        v[e] = __fadd_rn(k[e], __fmul_rn(static_cast<float>(qi[e]), sc));
      }
      if constexpr (VEC) {
        reinterpret_cast<float4*>(o + j)[0] =
            make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(o + j)[1] =
            make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) o[j + e] = v[e];
      }
    }
    if constexpr (SEND) {
      if (base >= w0 && base < w0 + w) {  // uniform across the warp
        float a = fabsf(v[0]);
#pragma unroll
        for (int e = 1; e < kLaneElems; ++e) a = nan_max(a, fabsf(v[e]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a = nan_max(a, __shfl_xor_sync(0xffffffffu, a, off));
        }
        const float scale = pow2_scale(__fdiv_rn(a, 127.0f));
        const float inv = __frcp_rn(scale);
        int8_t* dst = oq + (j - w0);
        if constexpr (VEC) {
          unsigned lo = 0, hi = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lo |= (static_cast<unsigned>(quantize(v[e], inv)) & 0xFFu)
                  << (8 * e);
            hi |= (static_cast<unsigned>(quantize(v[e + 4], inv)) & 0xFFu)
                  << (8 * e);
          }
          *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
        } else {
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e) {
            dst[e] = static_cast<int8_t>(quantize(v[e], inv));
          }
        }
        if (lane == 0) os[(base - w0) / kWireChunk] = scale;
      }
    }
  }
}

template <bool VEC, bool SEND>
void launch_q(dim3 g, cudaStream_t st, const float* b, const int8_t* q,
              const float* s, float* o, void* sq, void* ss, const void* c,
              const void* c_next, long long h, int shift) {
  rs_step_q_kernel<VEC, SEND><<<g, kThreads, 0, st>>>(
      b, q, s, o, static_cast<int8_t*>(sq), static_cast<float*>(ss),
      static_cast<const int*>(c), static_cast<const int*>(c_next), h, shift);
}

// Kernel ids of repro_step_blocks_per_sm (kernel.py _KERNEL_ID).
const void* step_kernel(int id) {
  switch (id) {
    case 0: return reinterpret_cast<const void*>(rs_step_vec_kernel<float>);
    case 1:
      return reinterpret_cast<const void*>(rs_step_vec_kernel<__nv_bfloat16>);
    case 2: return reinterpret_cast<const void*>(rs_step_kernel<float>);
    case 3:
      return reinterpret_cast<const void*>(rs_step_kernel<__nv_bfloat16>);
    case 4: return reinterpret_cast<const void*>(rs_step_q_kernel<true, false>);
    case 5: return reinterpret_cast<const void*>(rs_step_q_kernel<true, true>);
    case 6:
      return reinterpret_cast<const void*>(rs_step_q_kernel<false, false>);
    case 7: return reinterpret_cast<const void*>(rs_step_q_kernel<false, true>);
    case 8: return reinterpret_cast<const void*>(rs_step_q_scalar_kernel);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// vec selects the 16-byte vector kernel (the wrapper's rs_step_uses_vectors
// checks h and the alignment); grid: blocks a rank (blockIdx.x).
int repro_rs_step_f32(const void* buf, const void* recv, void* out,
                      void* send, const void* c, const void* c_next,
                      long long p, long long h, int vec, int grid,
                      void* stream) {
  return launch_rs_step<float>(buf, recv, out, send, c, c_next, p, h, vec,
                               grid, stream);
}

int repro_rs_step_bf16(const void* buf, const void* recv, void* out,
                       void* send, const void* c, const void* c_next,
                       long long p, long long h, int vec, int grid,
                       void* stream) {
  return launch_rs_step<__nv_bfloat16>(buf, recv, out, send, c, c_next, p, h,
                                       vec, grid, stream);
}

// n units of `unit` bytes (16, 4, 2 or 1) a row half: kernel.py
// ag_step_launch picks the unit from the row and the pointers; grid: the
// blocks walking the 2p ceil(n / kTile) tiles.
int repro_ag_step(const void* buf, const void* recv, void* out,
                  const void* c, long long p, long long n, int unit,
                  int grid, void* stream) {
  if (p > 0 && n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (unit) {
      case 16: launch_ag_unit<uint4>(buf, recv, out, c, p, n, grid, st);
        break;
      case 4: launch_ag_unit<uint32_t>(buf, recv, out, c, p, n, grid, st);
        break;
      case 2: launch_ag_unit<uint16_t>(buf, recv, out, c, p, n, grid, st);
        break;
      case 1: launch_ag_unit<uint8_t>(buf, recv, out, c, p, n, grid, st);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// shift = log2(the codec chunk of recv); path: 0 the warp kernel with
// vectors, 1 the warp kernel element by element, 2 the element-wise kernel
// (no send); send_q non-null selects the send variant (h % 512 == 0, a
// warp path); grid: blocks a rank.
int repro_rs_step_q(const void* buf, const void* recv_q, const void* recv_s,
                    void* out, void* send_q, void* send_s, const void* c,
                    const void* c_next, long long p, long long h, int shift,
                    int path, int grid, void* stream) {
  if (p > 0 && h > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 g(static_cast<unsigned>(grid), static_cast<unsigned>(p));
    const float* b = static_cast<const float*>(buf);
    const int8_t* q = static_cast<const int8_t*>(recv_q);
    const float* s = static_cast<const float*>(recv_s);
    float* o = static_cast<float*>(out);
    const bool send = send_q != nullptr;
    if (path == 2 && !send) {
      rs_step_q_scalar_kernel<<<g, kThreads, 0, st>>>(
          b, q, s, o, static_cast<const int*>(c), h, shift);
    } else if (path == 0 && send) {
      launch_q<true, true>(g, st, b, q, s, o, send_q, send_s, c, c_next, h,
                           shift);
    } else if (path == 0) {
      launch_q<true, false>(g, st, b, q, s, o, send_q, send_s, c, c_next, h,
                            shift);
    } else if (path == 1 && send) {
      launch_q<false, true>(g, st, b, q, s, o, send_q, send_s, c, c_next, h,
                            shift);
    } else if (path == 1) {
      launch_q<false, false>(g, st, b, q, s, o, send_q, send_s, c, c_next, h,
                             shift);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// *blocks = resident blocks of kernel `id` (step_kernel) per SM at
// kThreads a block; the wrapper's grids span RS_WAVES such waves.
int repro_step_blocks_per_sm(int id, int* blocks) {
  const void* fn = step_kernel(id);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0));
}

}  // extern "C"
