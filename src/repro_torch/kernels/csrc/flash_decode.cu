// Hopper (sm_90a) flash decode: one query token per sequence over an
// append-only KV cache, f32 or bf16 in, f32 math, output in q's dtype.
//
// Replaces src/repro/kernels/flash_decode.py::flash_decode (the Pallas TPU
// kernel _decode_kernel, pallas_call at :108).  Same function: query head h
// of sequence b attends kv head h / G (G = H / KV) over cache positions
// j < kv_len, where kv_len is read on the card from an int32 (the Pallas
// kernel's SMEM scalar), so the host never waits for it:
//   logit = (q * scale) . k_j,  softcap * tanh(logit / softcap) when softcap > 0
//   out = sum_{j < kv_len} exp(logit - m) v_j / max(sum exp(logit - m), 1e-20)
// Positions >= kv_len are never read.  (The Pallas kernel masks them to
// -1e30 inside a visited block, where they weigh exp(-1e30 - m) = 0: the same
// sums.)
//
// Design: split-KV.  The reference grid, (B * KV, kv blocks) with the blocks
// walked in order, gives only B * KV programs (16 at the serve path's decode)
// for 132 SMs, so here the cache is cut into `nsplit` ranges of whole 64-row
// tiles and one CTA of 256 threads takes one (b, kv head, range): it stages
// the G queries of the group (scaled, f32), walks its tiles with an online
// softmax (K and V tiles in shared memory as f32, rows padded to D + 1; one
// warp per query row for the max and sum), and writes its partial (m, l,
// acc[G, D]) to an f32 scratch.  Ranges that start at or past kv_len write
// (m = -inf, l = 0, acc = 0) and read nothing.  A second kernel, one CTA per
// query head, merges the ranges: M = max m_s, out = sum acc_s e^(m_s - M) /
// max(sum l_s e^(m_s - M), 1e-20).
//
// Bound on this card: the function must read the written cache once,
// B * kv_len * KV * D * 2 tensors * (2 bytes in bf16): at the serve path's
// decode (B=8, KV=2, D=128, kv_len ~1000) 8 MB, 2.4 us at 3.35 TB/s; its
// ~2 * B * H * kv_len * D * 2 FLOP are far below the operation bound.  It is
// bytes-bound; the launch and the merge's second launch dominate at this size.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define DBK 64
#define DTHREADS 256
#define MAX_ACC 8            // G * D <= MAX_ACC * DTHREADS = 2048
#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(DTHREADS)
flash_decode_split_kernel(int Smax, int KV, int G, int D, int split_len, float scale,
                          float softcap, const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc) {
  extern __shared__ float smem[];
  const int DP = D + 1, GD = G * D;
  float* Qs = smem;                  // [G][D]
  float* Ks = Qs + GD;               // [DBK][DP]
  float* Vs = Ks + DBK * DP;         // [DBK][DP]
  float* Ss = Vs + DBK * DP;         // [G][DBK]
  float* m_s = Ss + G * DBK;         // [G]
  float* l_s = m_s + G;              // [G]
  float* alpha_s = l_s + G;          // [G]
  const int bkv = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = bkv / KV, kvh = bkv - b * KV, H = KV * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int kv_len = *kv_len_ptr;
  kv_len = kv_len < 0 ? 0 : (kv_len > Smax ? Smax : kv_len);
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, kv_len);

  for (int e = tid; e < GD; e += DTHREADS)
    Qs[e] = to_f32(q[((size_t)b * H + kvh * G) * D + e]) * scale;
  for (int g = tid; g < G; g += DTHREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.0f;

  for (int t0 = s0; t0 < s1; t0 += DBK) {
    const int n = min(DBK, s1 - t0);
    __syncthreads();                    // Q staged; last tile's readers done
    for (int e = tid; e < n * D; e += DTHREADS) {
      const int c = e / D, d = e - c * D;
      const size_t off = (((size_t)b * Smax + t0 + c) * KV + kvh) * D + d;
      Ks[c * DP + d] = to_f32(k[off]);
      Vs[c * DP + d] = to_f32(v[off]);
    }
    __syncthreads();
    for (int e = tid; e < G * DBK; e += DTHREADS) {
      const int g = e / DBK, c = e - g * DBK;
      float s = -INFINITY;
      if (c < n) {
        float x = 0.0f;
        for (int d = 0; d < D; ++d) x = fmaf(Qs[g * D + d], Ks[c * DP + d], x);
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        s = x;
      }
      Ss[e] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += DTHREADS / 32) {
      float mx = -INFINITY;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, Ss[g * DBK + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);      // finite: row c = 0 is a valid position
      float ps = 0.0f;
      for (int c = lane; c < DBK; c += 32) {
        const float p = (c < n) ? expf(Ss[g * DBK + c] - m_new) : 0.0f;
        Ss[g * DBK + c] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_ACC; ++i) {
      const int e = tid + i * DTHREADS;
      if (e < GD) {
        const int g = e / D, d = e - g * D;
        float a = acc[i] * alpha_s[g];
        for (int c = 0; c < n; ++c) a = fmaf(Ss[g * DBK + c], Vs[c * DP + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  const size_t base = (size_t)bkv * nsplit + split;
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int e = tid + i * DTHREADS;
    if (e < GD) part_acc[base * GD + e] = acc[i];
  }
  for (int g = tid; g < G; g += DTHREADS) {
    part_m[base * G + g] = m_s[g];
    part_l[base * G + g] = l_s[g];
  }
}

template <typename T>
__global__ void flash_decode_merge_kernel(int G, int D, int nsplit,
                                          const float* __restrict__ part_m,
                                          const float* __restrict__ part_l,
                                          const float* __restrict__ part_acc,
                                          T* __restrict__ out) {
  const int bh = blockIdx.x;                 // b * H + h, h = kvh * G + g
  const int bkv = bh / G, g = bh - bkv * G;
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[((size_t)bkv * nsplit + s) * G + g]);
  float L = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t i = ((size_t)bkv * nsplit + s) * G + g;
    const float w = (part_m[i] == -INFINITY) ? 0.0f : expf(part_m[i] - M);
    L += part_l[i] * w;
  }
  const float denom = fmaxf(L, 1e-20f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = ((size_t)bkv * nsplit + s) * G + g;
      const float w = (part_m[i] == -INFINITY) ? 0.0f : expf(part_m[i] - M);
      o += part_acc[i * D + d] * w;
    }
    out[(size_t)bh * D + d] = from_f32<T>(o / denom);
  }
}

template <typename T>
static int launch(int B, int Smax, int H, int KV, int D, int nsplit, int split_len,
                  float scale, float softcap, const void* q, const void* k, const void* v,
                  const void* kv_len, void* part_m, void* part_l, void* part_acc, void* out,
                  cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      (size_t)(G * D + 2 * DBK * (D + 1) + G * DBK + 3 * G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * KV, nsplit);
  flash_decode_split_kernel<T><<<grid, DTHREADS, smem, stream>>>(
      Smax, KV, G, D, split_len, scale, softcap, (const T*)q, (const T*)k, (const T*)v,
      (const int*)kv_len, (float*)part_m, (float*)part_l, (float*)part_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge_kernel<T><<<B * H, 128, 0, stream>>>(
      G, D, nsplit, (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (T*)out);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; softcap <= 0: none.  q/out [B, 1, H, D],
// k/v [B, Smax, KV, D], all contiguous; kv_len one int32 on the card;
// scratch part_m/part_l f32[B * KV * nsplit * G], part_acc f32[.. * G * D];
// nsplit * split_len >= Smax, split_len a multiple of 64; G * D <= 2048.
extern "C" int flash_decode_launch(int B, int Smax, int H, int KV, int D, int dtype,
                                   int nsplit, int split_len, float scale, float softcap,
                                   const void* q, const void* k, const void* v,
                                   const void* kv_len, void* part_m, void* part_l,
                                   void* part_acc, void* out, void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(B, Smax, H, KV, D, nsplit, split_len, scale, softcap, q, k, v,
                         kv_len, part_m, part_l, part_acc, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(B, Smax, H, KV, D, nsplit, split_len, scale, softcap, q, k,
                                 v, kv_len, part_m, part_l, part_acc, out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
