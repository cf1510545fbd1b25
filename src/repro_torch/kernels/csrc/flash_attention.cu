// Hopper (sm_90a) flash attention: causal GQA with an optional sliding window
// and logit softcap, f32 or bf16 in, f32 math, output in q's dtype.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel, pallas_call at :144).  Same function: for query i
// and key j (top-left positions: query i is sequence position i, key j is
// position j, whatever Sq and Skv are),
//   logit = (q_i * scale) . k_j            (q scaled in f32 before the dot)
//   logit = softcap * tanh(logit / softcap)     when softcap > 0
//   logit = -1e30 unless j < Skv, (causal) j <= i, (window) j > i - window
//   out_i = sum_j exp(logit - m) v_j / max(sum_j exp(logit - m), 1e-20)
// with an online softmax over key blocks, and key blocks skipped exactly when
// the Pallas kernel skips them (causal: k0 <= q0 + BQ - 1; window:
// k0 + BK - 1 > q0 - window).  Masked logits are -1e30, not -inf, so a row
// whose first visited block holds no visible key behaves as in the Pallas
// kernel (its weight is wiped by the first visible one).
//
// Design: one CTA of 256 threads per (q block of 64 rows, query head, batch).
// The kv head is h / (H / KV) (GQA).  Q (scaled), K and V tiles of 64 rows
// sit in shared memory as f32 with rows padded to D + 1 floats (conflict-free
// column reads); a 16 x 16 thread grid computes the 64 x 64 logit tile (each
// thread rows ty + 16i, columns tx + 16j, i, j < 4), the row max and sum are
// reduced over the 16 lanes of a half-warp with shuffles, probabilities go
// through shared memory, and each thread keeps its 4 rows x ceil(D/16)
// columns of the output accumulator in registers.  Plain f32 FMAs (SIMT):
// no tensor cores, TMA or warp specialisation yet.
//
// Bound on this card: at the serve path's prefill (B=8, S=1024, H=16, D=128,
// bf16) the causal work is ~2*B*H*S^2*D = 34 GFLOP, 35 us at the bf16
// tensor-core peak, while the bytes (q, k, v, out: ~46 MB) take 14 us: the
// function is operation-bound.  This kernel runs on the f32 SIMT units and
// re-reads its tiles from shared memory, so it sits far above that bound
// (PERF.md has its time).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define NTHREADS 256
#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(int Sq, int Skv, int H, int KV, int D, float scale, int causal,
                       int window, float softcap, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;                 // [BQ][DP]
  float* Ks = Qs + BQ * DP;         // [BK][DP]
  float* Vs = Ks + BK * DP;         // [BK][DP]
  float* Ps = Vs + BK * DP;         // [BQ][BK + 1]
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qb * BQ;

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, d = e - r * D, qi = q0 + r;
    float val = 0.0f;
    if (qi < Sq) val = to_f32(q[(((size_t)b * Sq + qi) * H + h) * D + d]) * scale;
    Qs[r * DP + d] = val;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (Skv + BK - 1) / BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    bool relevant = true;                                  // uniform over the CTA
    if (causal) relevant = k0 <= q0 + BQ - 1;
    if (window > 0) relevant = relevant && (k0 + BK - 1 > q0 - window);
    if (!relevant) continue;

    __syncthreads();                     // Q staged; last block's K/V/P readers done
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int c = e / D, d = e - c * D, kj = k0 + c;
      float kv_k = 0.0f, kv_v = 0.0f;
      if (kj < Skv) {
        const size_t off = (((size_t)b * Skv + kj) * KV + kvh) * D + d;
        kv_k = to_f32(k[off]);
        kv_v = to_f32(v[off]);
      }
      Ks[c * DP + d] = kv_k;
      Vs[c * DP + d] = kv_v;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = kp < Skv;
        if (causal) ok = ok && (kp <= qp);
        if (window > 0) ok = ok && (kp > qp - window);
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = (d < D) ? Vs[c * DP + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[d] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
static int launch(int B, int Sq, int Skv, int H, int KV, int D, float scale, int causal,
                  int window, float softcap, const void* q, const void* k, const void* v,
                  void* out, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NJ><<<grid, NTHREADS, smem, stream>>>(
      Sq, Skv, H, KV, D, scale, causal, window, softcap, (const T*)q, (const T*)k,
      (const T*)v, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_d(int B, int Sq, int Skv, int H, int KV, int D, float scale, int causal,
                      int window, float softcap, const void* q, const void* k, const void* v,
                      void* out, cudaStream_t stream) {
  const int nj = (D + 15) / 16;
#define FA_CASE(N)                                                                         \
  if (nj <= N)                                                                             \
    return launch<T, N>(B, Sq, Skv, H, KV, D, scale, causal, window, softcap, q, k, v, out, \
                        stream);
  FA_CASE(1) FA_CASE(2) FA_CASE(4) FA_CASE(8) FA_CASE(16)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: none; softcap <= 0: none.
// q [B, Sq, H, D], k/v [B, Skv, KV, D], out [B, Sq, H, D], all contiguous,
// D <= 256 and H a multiple of KV (the wrapper checks).
extern "C" int flash_attention_launch(int B, int Sq, int Skv, int H, int KV, int D, int dtype,
                                      float scale, int causal, int window, float softcap,
                                      const void* q, const void* k, const void* v, void* out,
                                      void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(B, Sq, Skv, H, KV, D, scale, causal, window, softcap, q, k, v,
                             out, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(B, Sq, Skv, H, KV, D, scale, causal, window, softcap, q,
                                     k, v, out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
