// Hopper (sm_90a) kernels for gradient compression with error feedback.
//
// Replace no TPU kernel: the reference computes GradCompressor.compress and
// decompress (src/repro/distributed/compress.py:50-66, 79-93) as XLA ops on
// the TPU.  In eager PyTorch the int8 path is about ten launches a leaf (add,
// pad, abs, max, divide, clamp, round, clamp, cast, multiply, subtract), each
// a full pass over the leaf through device memory; here it is one.
//
//   compress_int8:   gf = f32(g) + e over the flattened leaf, cut in blocks of
//                    128 (padding counted as zero); per block the max-abs,
//                    scale = max(amax / 127, floor), q = clamp(rint(gf / scale),
//                    -127, 127) as int8 (NaN -> 0), and the residual
//                    gf - f32(q) * scale.
//   compress_bf16:   gf, its bf16 value (round to nearest even) and the
//                    residual gf - f32(bf16(gf)).
//   decompress_int8: f32(q) * scale, cut to the leaf's n elements.
//
// Bound on this card: bytes.  A compress reads g (f32, bf16 or f16) and e and
// writes the payload and the residual once (int8: 2 or 4 + 4 bytes in,
// 1 + 4 + 4/128 out per element); a handful of flops an element is far below
// the f32 rate.  Design: one warp a block of 128 for int8 (a lane holds 4
// neighbouring elements, loaded as one 16-byte e load and one 8- or 16-byte
// g load; the block's max-abs is a 5-step shuffle), 4 elements a thread for
// bf16 and the decompress; every store is 4 to 16 bytes wide.  Unaligned
// leaves and the ragged last block take a per-element path.
//
// Bit-exact with the plain torch chain (kernels/ref.py, and the reference's
// eager run): the divisions are IEEE divisions (__fdiv_rn), never a
// reciprocal multiply; rintf rounds half to even as torch.round does; the
// product and the difference of the residual are rounded on their own
// (__fmul_rn, __fsub_rn; built with -fmad=false); the max-abs propagates NaN
// as torch.amax does, where fmaxf would drop it, and so does the floor
// max; a NaN quotient gives q = 0, as the reference's cast does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;             // elements a scale covers
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum GradType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Four neighbouring gradient values from a 4-element-aligned address.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&x);
  for (int j = 0; j < 4; ++j) v[j] = to_f32(h[j]);
}
__device__ __forceinline__ void load4(const __half* p, float v[4]) {
  uint2 x = *reinterpret_cast<const uint2*>(p);
  const __half* h = reinterpret_cast<const __half*>(&x);
  for (int j = 0; j < 4; ++j) v[j] = to_f32(h[j]);
}

// NaN-propagating max of two non-negative-or-NaN values.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  if (r != r) return 0;
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

template <typename G>
__global__ void __launch_bounds__(kThreads) compress_int8_kernel(
    const G* __restrict__ g, const float* __restrict__ e, long long n, long long nb,
    float floor_, int vec, int8_t* __restrict__ q, float* __restrict__ scale,
    float* __restrict__ err) {
  const long long b = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (b >= nb) return;                      // whole warps leave together
  const long long i0 = b * kBlock + lane * 4;
  const bool fast = vec && b * kBlock + kBlock <= n;
  float v[4];
  if (fast) {
    float gv[4], ev[4];
    load4(g + i0, gv);
    load4(e + i0, ev);
    for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(gv[j], ev[j]);
  } else {
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j;
      v[j] = i < n ? __fadd_rn(to_f32(g[i]), e[i]) : 0.0f;
    }
  }
  float m = nan_max(nan_max(fabsf(v[0]), fabsf(v[1])), nan_max(fabsf(v[2]), fabsf(v[3])));
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  float s = __fdiv_rn(m, 127.0f);
  s = nan_max(s, floor_);
  char4 qq;
  qq.x = quantize(v[0], s); qq.y = quantize(v[1], s);
  qq.z = quantize(v[2], s); qq.w = quantize(v[3], s);
  *reinterpret_cast<char4*>(q + i0) = qq;   // the padded payload: always in bounds
  const int8_t qs[4] = {qq.x, qq.y, qq.z, qq.w};
  float r[4];
  for (int j = 0; j < 4; ++j) r[j] = __fsub_rn(v[j], __fmul_rn(static_cast<float>(qs[j]), s));
  if (fast) {
    *reinterpret_cast<float4*>(err + i0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    for (int j = 0; j < 4; ++j)
      if (i0 + j < n) err[i0 + j] = r[j];
  }
  if (lane == 0) scale[b] = s;
}

template <typename G>
__global__ void __launch_bounds__(kThreads) compress_bf16_kernel(
    const G* __restrict__ g, const float* __restrict__ e, long long n, int vec,
    __nv_bfloat16* __restrict__ c, float* __restrict__ err) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i0 >= n) return;
  if (vec && i0 + 4 <= n) {
    float gv[4], ev[4], r[4];
    load4(g + i0, gv);
    load4(e + i0, ev);
    __align__(8) __nv_bfloat16 cc[4];
    for (int j = 0; j < 4; ++j) {
      const float gf = __fadd_rn(gv[j], ev[j]);
      cc[j] = __float2bfloat16_rn(gf);
      r[j] = __fsub_rn(gf, __bfloat162float(cc[j]));
    }
    *reinterpret_cast<uint2*>(c + i0) = *reinterpret_cast<const uint2*>(cc);
    *reinterpret_cast<float4*>(err + i0) = make_float4(r[0], r[1], r[2], r[3]);
    return;
  }
  for (long long i = i0; i < i0 + 4 && i < n; ++i) {
    const float gf = __fadd_rn(to_f32(g[i]), e[i]);
    const __nv_bfloat16 ci = __float2bfloat16_rn(gf);
    c[i] = ci;
    err[i] = __fsub_rn(gf, __bfloat162float(ci));
  }
}

__global__ void __launch_bounds__(kThreads) decompress_int8_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ scale, long long n, int vec,
    float* __restrict__ out) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i0 >= n) return;
  const float s = scale[i0 / kBlock];       // 4 | 128: one block's scale
  if (vec && i0 + 4 <= n) {
    const char4 qq = *reinterpret_cast<const char4*>(q + i0);
    *reinterpret_cast<float4*>(out + i0) = make_float4(
        __fmul_rn(static_cast<float>(qq.x), s), __fmul_rn(static_cast<float>(qq.y), s),
        __fmul_rn(static_cast<float>(qq.z), s), __fmul_rn(static_cast<float>(qq.w), s));
    return;
  }
  for (long long i = i0; i < i0 + 4 && i < n; ++i)
    out[i] = __fmul_rn(static_cast<float>(q[i]), s);
}

unsigned blocks_for(long long items, long long per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

// g_dtype: 0 f32, 1 bf16, 2 f16.  vec: g and e are 16-byte aligned, so full groups of 4 use
// wide loads and stores.
extern "C" int compress_int8_launch(int g_dtype, long long n, const void* g, const void* e,
                                    float floor_, int vec, void* q, void* scale, void* err,
                                    void* stream) {
  if (n <= 0) return 0;
  const long long nb = (n + kBlock - 1) / kBlock;
  const unsigned grid = blocks_for(nb, kThreads / 32);
  cudaStream_t st = (cudaStream_t)stream;
  const float* ef = (const float*)e;
  int8_t* qo = (int8_t*)q;
  float* so = (float*)scale;
  float* eo = (float*)err;
  switch (g_dtype) {
    case kF32:
      compress_int8_kernel<float><<<grid, kThreads, 0, st>>>(
          (const float*)g, ef, n, nb, floor_, vec, qo, so, eo);
      break;
    case kBF16:
      compress_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          (const __nv_bfloat16*)g, ef, n, nb, floor_, vec, qo, so, eo);
      break;
    case kF16:
      compress_int8_kernel<__half><<<grid, kThreads, 0, st>>>(
          (const __half*)g, ef, n, nb, floor_, vec, qo, so, eo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int compress_bf16_launch(int g_dtype, long long n, const void* g, const void* e,
                                    int vec, void* c, void* err, void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = blocks_for(n, kThreads * 4);
  cudaStream_t st = (cudaStream_t)stream;
  const float* ef = (const float*)e;
  __nv_bfloat16* co = (__nv_bfloat16*)c;
  float* eo = (float*)err;
  switch (g_dtype) {
    case kF32:
      compress_bf16_kernel<float><<<grid, kThreads, 0, st>>>((const float*)g, ef, n, vec, co, eo);
      break;
    case kBF16:
      compress_bf16_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          (const __nv_bfloat16*)g, ef, n, vec, co, eo);
      break;
    case kF16:
      compress_bf16_kernel<__half><<<grid, kThreads, 0, st>>>(
          (const __half*)g, ef, n, vec, co, eo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int decompress_int8_launch(long long n, const void* q, const void* scale, int vec,
                                      void* out, void* stream) {
  if (n <= 0) return 0;
  decompress_int8_kernel<<<blocks_for(n, kThreads * 4), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scale, n, vec, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
