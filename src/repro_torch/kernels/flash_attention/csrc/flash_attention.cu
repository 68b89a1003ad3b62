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
// Design (a first, simple version; wgmma and TMA are later work): one
// block of 256 threads per (batch, query head, 64-row query tile); GQA
// maps the query head to its kv head.  The Q tile is staged once in
// shared memory as float32; the block walks only the live 64-key tiles
// (the causal and window bounds of the tile, the TPU kernel's block-level
// skipping at kernel.py:49-54), staging K and V through shared memory.
// QK^T and PV run on the CUDA cores in float32: thread (ty, tx) of the
// 16 x 16 grid holds the scores of rows 4ty..4ty+3 and keys tx + 16j
// (j < 4) and the accumulator of those rows for columns tx + 16c
// (c < hd/16); the row max and sum are reduced across the 16 threads of a
// row by shuffles.  Shared rows are padded so the reads are free of bank
// conflicts.  The TPU kernel's tile (g = 3 heads folded into 128 rows,
// a 384 x 128 float32 accumulator) does not fit a block's registers and is
// not copied.
//
// Bound: operations.  4 hd flops per live (query head, query, key) pair
// (QK^T and PV) over the card's rate for the input type (989 TFLOP/s bf16
// on the tensor cores, 67 TFLOP/s float32), or the bytes of q, k, v and o
// over 3.35 TB/s where larger.  This version runs on the CUDA cores only
// and is far from the bf16 bound.
//
// Numerics: expf (no fast math), IEEE division; sums in another order
// than the plain version's, so results agree within float32 rounding
// (2e-5) and, for bf16 inputs, within bf16 rounding (3e-2).  Kernels
// launch on the caller's stream and allocate nothing; each C entry point
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    case 128:
      return launch<T, 128>(q, k, v, o, B, nkv, g, Tq, Tk, st, window,
                            causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers; strides in elements (the head dim has
// stride 1): q and o [B, nkv, g, T, hd] as (b, n, g, t), k and v
// [B, nkv, Tk, hd] as (b, n, t); hd in {16, 32, 64, 128}; window <= 0
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

}  // extern "C"
