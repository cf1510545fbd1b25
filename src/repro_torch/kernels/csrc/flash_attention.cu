// Hopper (sm_90a) flash attention: causal GQA with an optional sliding window
// and logit softcap, output in q's dtype.  Two bodies:
//   * bf16 with D % 16 == 0 (D <= 256): warpgroup tensor-core products
//     (wgmma), the body every served shape takes;
//   * f32, and bf16 with another D: the f32 SIMT body of the first port.
// The wrapper (kernels/flash_attention.py::choose_body) picks the body from
// the dtype and D and passes it here; nothing falls back on a failure.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel, pallas_call at :144).  Same function: for query i
// and key j (top-left positions: query i is sequence position i, key j is
// position j, whatever Sq and Skv are),
//   logit = scale * (q_i . k_j)
//   logit = softcap * tanh(logit / softcap)     when softcap > 0
//   logit = -1e30 unless j < Skv, (causal) j <= i, (window) j > i - window
//   out_i = sum_j exp(logit - m) v_j / max(sum_j exp(logit - m), 1e-20)
// with q_i, k_j of D dims and v_j, out_i of DV <= D dims.
// with an online softmax over key blocks, and a key block skipped exactly
// when no key of it is visible to any row of the 64-row query block (a
// warpgroup's rows in the tensor-core body; causal: k0 <= q0 + 63; window:
// k0 + BK - 1 > q0 - window).  Masked logits are -1e30, not -inf, so a row
// whose first visited block holds no visible key behaves as in the Pallas
// kernel (its weight is wiped by the first visible one).  The SIMT body
// scales q in f32 before the dot, the tensor-core body scales the f32
// product after it: they part by an f32 ulp of the logit.
//
// Bound on this card: at the qwen prefill (B=8, S=1019, H=16, D=128, bf16)
// the causal work is 4*D per visible (query, key) pair, 34 GFLOP, 35 us at
// the bf16 tensor-core peak, while q, k, v and out (~46 MB) take 14 us: the
// function is operation-bound.  At Zamba2's shared block (H=KV=32, D=80) the
// bytes (~167 MB, 50 us) bound it, and at deepseek's MLA prefill (H=KV=16,
// D=192, DV=128; 2 (D + DV) operations a pair, 42.6 GFLOP, 43 us) the bytes
// too (~167 MB, 50 us).
//
// Tensor-core body (what the design does about the operation bound).  One
// CTA = two warpgroups of 128 threads, each with its own 64 query rows, per
// (128 query rows, query head, batch); the kv head is h / (H / KV).  Query
// blocks run heaviest (last) first.
//   * Q.K^T: wgmma m64nBKk16, bf16 in, f32 accumulator, Q and K both from
//     shared memory, K-major (the natural [rows, D] layout: no transpose).
//   * Softmax on the accumulator fragments in registers: scale, softcap,
//     mask at -1e30 (only in a block that holds a masked pair: the ragged
//     end, the diagonal, the window's edge), online max / sum / rescale in
//     f32 (in the log2 domain, exp2).  A fragment row lives in the 4
//     threads of a quad: row max and sum take two shuffles.  P never goes
//     through shared memory.
//   * P.V: wgmma with A from registers (the S accumulator fragment is the A
//     fragment of the next product) and V from shared memory as an MN-major
//     B operand (transpose flag).  P is split into two bf16 terms,
//     P_hi = bf16(p), P_lo = bf16(p - P_hi), and O += P_hi V + P_lo V: p
//     keeps ~16 bits, so the bf16 output stays within one ulp of the f32
//     plain version (a single bf16 rounding of P, as SDPA does, misses
//     that).  The denominator sums the unrounded f32 p.  This costs 1.5x
//     the mma work of one P.V (6 D operations a visible pair against 4 D).
//   * K and V tiles stream through a ring of 4 slots in shared memory (K_0,
//     V_0, K_1, ...), filled by 16-byte cp.async copies written straight
//     into wgmma's no-swizzle core-matrix layout (8 rows x 16 bytes, row
//     groups of 16 D bytes), which fits every D that is a multiple of 16
//     (80 included); ragged rows are zero-filled by the copy and masked,
//     nothing is padded by the wrapper.  Three tiles are in flight while
//     one is consumed.  Both warpgroups share each tile, which halves the
//     tiles read from L2 against one warpgroup a CTA; each warpgroup skips
//     the blocks that none of its own 64 rows sees.
//   * BK = 64 keys for DV <= 128, 32 above (the O accumulator of DV = 256 is
//     128 registers a thread).
//   * V's head dim DV may be smaller than D (MLA: K 192 = 128 + 64 rope
//     dims, V 128).  O and the output are DV wide; a V tile is copied in
//     its own [BK, DV] core-matrix layout into a slot sized for a K tile,
//     and P.V runs over DV columns, so V is read once at its own width
//     (zero-padding it to D would read 1.5x its bytes at MLA's shape).  The
//     body is a template on (D, DV): every D = DV, and (192, 128).
// Left for a later redesign: the two warpgroups run in lock step (one
// barrier a tile), so a warpgroup's softmax does not overlap the products;
// warp specialisation (a producer warp, consumer warpgroups in ping-pong),
// TMA loads with a 128-byte swizzle, overlapping the next Q.K^T with this
// block's softmax inside a warpgroup, and a persistent grid.
//
// SIMT body: one CTA of 256 threads per (64 query rows, head, batch); Q
// (scaled), K and V tiles of 64 rows in shared memory as f32 with rows
// padded to D + 1 (V: DV + 1) floats; a 16 x 16 thread grid computes the
// 64 x 64 logit tile, probabilities go through shared memory, f32 FMAs.  It
// serves the f32 contract (3e-5), which rules out bf16 and TF32 tensor
// cores.  DV < D is an instantiation of its own (NARROW), so equal dims
// keep their code.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define SIMT_BQ 64
#define SIMT_BK 64
#define SIMT_NT 256
#define NEG_INF (-1e30f)

// ---------------------------------------------------------------------------
// SIMT body (f32; bf16 with D % 16 != 0)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// NARROW: V's head dim dv < D (MLA).  The other instantiation takes DV = D,
// so the body for equal dims is the one it was before V had a width of its
// own (same code, same bits, same time).
template <typename T, int NJ, bool NARROW>
__global__ void __launch_bounds__(SIMT_NT)
flash_attention_simt_kernel(int Sq, int Skv, int H, int KV, int D, int dv, float scale,
                       int causal, int window, float softcap, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out) {
  extern __shared__ float smem[];
  const int DV = NARROW ? dv : D;
  const int DP = D + 1, DVP = DV + 1;
  float* Qs = smem;                   // [SIMT_BQ][DP]
  float* Ks = Qs + SIMT_BQ * DP;      // [SIMT_BK][DP]
  float* Vs = Ks + SIMT_BK * DP;      // [SIMT_BK][DVP]
  float* Ps = Vs + SIMT_BK * DVP;     // [SIMT_BQ][SIMT_BK + 1]
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qb * SIMT_BQ;

  for (int e = tid; e < SIMT_BQ * D; e += SIMT_NT) {
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

  const int nk = (Skv + SIMT_BK - 1) / SIMT_BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * SIMT_BK;
    bool relevant = true;                                  // uniform over the CTA
    if (causal) relevant = k0 <= q0 + SIMT_BQ - 1;
    if (window > 0) relevant = relevant && (k0 + SIMT_BK - 1 > q0 - window);
    if (!relevant) continue;

    __syncthreads();                     // Q staged; last block's K/V/P readers done
    if constexpr (NARROW) {
      for (int e = tid; e < SIMT_BK * D; e += SIMT_NT) {
        const int c = e / D, d = e - c * D, kj = k0 + c;
        Ks[c * DP + d] = kj < Skv ? to_f32(k[(((size_t)b * Skv + kj) * KV + kvh) * D + d]) : 0.0f;
      }
      for (int e = tid; e < SIMT_BK * DV; e += SIMT_NT) {
        const int c = e / DV, d = e - c * DV, kj = k0 + c;
        Vs[c * DVP + d] =
            kj < Skv ? to_f32(v[(((size_t)b * Skv + kj) * KV + kvh) * DV + d]) : 0.0f;
      }
    } else {
      for (int e = tid; e < SIMT_BK * D; e += SIMT_NT) {
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
        Ps[(ty + 16 * i) * (SIMT_BK + 1) + tx + 16 * j] = p;
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

    for (int c = 0; c < SIMT_BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (SIMT_BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = (d < DV) ? Vs[c * DVP + d] : 0.0f;
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
    T* o = out + (((size_t)b * Sq + qi) * H + h) * DV;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < DV) o[d] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ, bool NARROW>
static int launch_simt(int B, int Sq, int Skv, int H, int KV, int D, int DV, float scale,
                       int causal, int window, float softcap, const void* q, const void* k,
                       const void* v, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)(SIMT_BQ * (D + 1) + SIMT_BK * (D + 1) + SIMT_BK * (DV + 1) +
                               SIMT_BQ * (SIMT_BK + 1)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_simt_kernel<T, NJ, NARROW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + SIMT_BQ - 1) / SIMT_BQ, H, B);
  flash_attention_simt_kernel<T, NJ, NARROW><<<grid, SIMT_NT, smem, stream>>>(
      Sq, Skv, H, KV, D, DV, scale, causal, window, softcap, (const T*)q, (const T*)k,
      (const T*)v, (T*)out);
  return (int)cudaGetLastError();
}

// NJ: the output columns a thread holds, 16 apart (V's DV columns).
template <typename T>
static int dispatch_d(int B, int Sq, int Skv, int H, int KV, int D, int DV, float scale,
                      int causal, int window, float softcap, const void* q, const void* k,
                      const void* v, void* out, cudaStream_t stream) {
  const int nj = (DV + 15) / 16;
#define FA_CASE(N)                                                                          \
  if (nj <= N)                                                                              \
    return DV == D ? launch_simt<T, N, false>(B, Sq, Skv, H, KV, D, DV, scale, causal, window, \
                                              softcap, q, k, v, out, stream)                   \
                   : launch_simt<T, N, true>(B, Sq, Skv, H, KV, D, DV, scale, causal, window,  \
                                             softcap, q, k, v, out, stream);
  FA_CASE(1) FA_CASE(2) FA_CASE(4) FA_CASE(8) FA_CASE(16)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16, D % 16 == 0)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int WG_ROWS = 64;       // query rows a warpgroup (one wgmma M)
constexpr int NWG = 2;            // warpgroups a CTA; they share the K and V tiles
constexpr int BQ = NWG * WG_ROWS; // query rows a CTA
constexpr int NT = NWG * 128;     // threads a CTA
constexpr int NSLOT = 4;          // K / V tile slots in shared memory
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy writes to shared memory (the cp.async
// data) visible to wgmma's async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator register
// across the asynchronous products.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between core matrices along K) and stride byte offset (between
// core matrices along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

#define FA_D8(i)                                                                          \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8)
      : "l"(da), "l"(db), "r"(acc));
}
// D[64 x N] += A[64 x 16] B[16 x N], A from registers (4 x bf16x2 a thread),
// B from shared memory MN-major (transposed: V's rows are keys).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : FA_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef FA_D8

// O[:, 0:D] += A V[16 keys, 0:D]: D cut into products of 64, 32 and 16
// columns.  o holds the accumulator fragments of D columns (D / 2 floats: n8
// block j at o[4j .. 4j+3]), so the product over columns [c, c + n) takes
// o + c / 2; column c of the core-matrix layout starts 16 c bytes (c units)
// further.
template <int D>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* a, uint64_t dv) {
#pragma unroll
  for (int c = 0; c + 64 <= D; c += 64) wgmma_rs_n64(o + c / 2, a, dv + c);
  constexpr int c32 = D - D % 64;
  if constexpr (D % 64 >= 32) wgmma_rs_n32(o + c32 / 2, a, dv + c32);
  constexpr int c16 = c32 + (D % 64 >= 32 ? 32 : 0);
  if constexpr (D % 32 == 16) wgmma_rs_n16(o + c16 / 2, a, dv + c16);
}

// Row r, 16-byte chunk c of a [rows, D] bf16 tile in the no-swizzle
// core-matrix layout: element (r, c) at byte (r / 8) * 16 D + (c / 8) * 128 +
// (r % 8) * 16 + (c % 8) * 2.  Chunk e of the tile (16 bytes) lands at byte
// 16 e, so the copies' stores are linear; 8 neighbouring threads take one
// 16-byte column of 8 rows, and the threads 8 apart the two halves of a
// 32-byte sector.
template <int D>
__device__ __forceinline__ int chunk_row(int e) { return (e & 7) + 8 * (e / D); }
template <int D>
__device__ __forceinline__ int chunk_col(int e) { return (e >> 3) % (D / 8); }

// Copy rows [r0, r0 + R) of a [rows, D] bf16 matrix (row stride `stride`
// elements) into shared memory at `dst`; rows >= rmax are zero-filled and
// not read.
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* g, size_t stride,
                                          int r0, int rmax, int tid) {
  constexpr int CHUNKS = R * D / 8;
#pragma unroll
  for (int it = 0; it < (CHUNKS + NT - 1) / NT; ++it) {
    const int e = tid + it * NT;
    if (CHUNKS % NT != 0 && e >= CHUNKS) break;
    const int gr = r0 + chunk_row<D>(e);
    const bool ok = gr < rmax;
    cp_async16(dst + 16 * e, g + (size_t)(ok ? gr : 0) * stride + 8 * chunk_col<D>(e), ok);
  }
}

// D: q's and K's head dim; DV (<= D): V's and the output's.  A K tile and
// a V tile share the slot size of a K tile.
template <int D, int DV, int BK>
__global__ void __launch_bounds__(NT)
flash_attention_wgmma_kernel(int Sq, int Skv, int H, int KV, float scale, int causal, int window,
                             float softcap, const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out) {
  static_assert(D % 16 == 0 && D <= 256 && DV % 16 == 0 && DV <= D && BK % 16 == 0, "shape");
  constexpr int QBYTES = BQ * D * 2, TBYTES = BK * D * 2;   // Q; one K tile (a slot)
  constexpr int TCHUNKS = BK * D / 8;                        // 16-byte chunks a K tile
  constexpr int TPT = (TCHUNKS + NT - 1) / NT;               // of them a thread copies
  constexpr int VCHUNKS = BK * DV / 8;                       // the same for a V tile
  constexpr int VPT = (VCHUNKS + NT - 1) / NT;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sq = smem_addr(smem);           // Q | NSLOT tile slots
  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;     // the longest rows first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                      // this thread's warpgroup
  const int q0 = qb * BQ;                        // the CTA's first row
  const int w0 = q0 + WG_ROWS * wg;              // its warpgroup's first row

  // Key blocks: the CTA walks [kb_lo, kb_hi), the blocks visible to some
  // row of it; each warpgroup computes on the blocks visible to some row of
  // its 64 (causal: k0 <= w0 + 63; window: k0 + BK - 1 > w0 - window).
  const int nk = (Skv + BK - 1) / BK;
  auto last_block = [&](int r0, int rows) {
    return causal ? min(nk, (r0 + rows - 1) / BK + 1) : nk;
  };
  auto first_block = [&](int r0) {
    if (window <= 0) return 0;
    const int t = r0 - window - BK + 2;          // smallest k0 with k0 + BK - 1 > r0 - window
    return t <= 0 ? 0 : (t + BK - 1) / BK;
  };
  const int kb_lo = first_block(q0), kb_hi = last_block(q0, BQ);
  const int my_lo = first_block(w0), my_hi = last_block(w0, WG_ROWS);

  const __nv_bfloat16* qg = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kg = k + ((size_t)b * Skv * KV + kvh) * D;
  const __nv_bfloat16* vg = v + ((size_t)b * Skv * KV + kvh) * DV;
  const size_t qstride = (size_t)H * D, kvstride = (size_t)KV * D, vstride = (size_t)KV * DV;

  // This thread's chunks of every K tile (and V tile, when DV = D): row in
  // the tile and element offset from the tile's first row, computed once;
  // with DV < D, those of a V tile apart.
  int c_row[TPT], c_off[TPT];
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const int e = tid + i * NT;
    c_row[i] = chunk_row<D>(e);
    c_off[i] = c_row[i] * (int)kvstride + 8 * chunk_col<D>(e);
  }
  int v_row[DV == D ? 1 : VPT], v_off[DV == D ? 1 : VPT];
  if constexpr (DV != D) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int e = tid + i * NT;
      v_row[i] = chunk_row<DV>(e);
      v_off[i] = v_row[i] * (int)vstride + 8 * chunk_col<DV>(e);
    }
  }

  // Tiles stream through a ring of NSLOT slots in the order K_0, V_0, K_1,
  // V_1, ...: tile j (K of block kb_lo + j / 2 when j is even, else its V)
  // lands in slot j % NSLOT.  While tile j is consumed, tiles j + 1 ..
  // j + NSLOT - 1 are in flight; tile j + NSLOT - 1 reuses the slot of tile
  // j - 1, which every thread has finished with at the barrier before tile j.
  const int ntiles = 2 * (kb_hi > kb_lo ? kb_hi - kb_lo : 0);
  auto issue_tile = [&](int j) {
    if (j < ntiles) {
      const int r0 = (kb_lo + j / 2) * BK;
      const uint32_t dst = sq + QBYTES + (j % NSLOT) * TBYTES;
      if (DV == D || !(j & 1)) {
        const __nv_bfloat16* g = ((j & 1) ? vg : kg) + (size_t)r0 * kvstride;
#pragma unroll
        for (int i = 0; i < TPT; ++i) {
          const int e = tid + i * NT;
          if (TCHUNKS % NT != 0 && e >= TCHUNKS) break;
          const bool ok = r0 + c_row[i] < Skv;
          cp_async16(dst + 16 * e, g + (ok ? c_off[i] : 0), ok);
        }
      } else if constexpr (DV != D) {
        const __nv_bfloat16* g = vg + (size_t)r0 * vstride;
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const int e = tid + i * NT;
          if (VCHUNKS % NT != 0 && e >= VCHUNKS) break;
          const bool ok = r0 + v_row[i] < Skv;
          cp_async16(dst + 16 * e, g + (ok ? v_off[i] : 0), ok);
        }
      }
    }
    cp_async_commit();                           // an empty group past the end
  };
  load_rows<D, BQ>(sq, qg, qstride, q0, Sq, tid);
#pragma unroll
  for (int j = 0; j < NSLOT - 1; ++j) issue_tile(j);   // Q joins tile 0's group

  // This thread's rows of the accumulator fragments: r and r + 8.
  const int row0 = w0 + 16 * (warp & 3) + (lane >> 2);
  const int row1 = row0 + 8;
  const int col_in = 2 * (lane & 3);

  float o[DV / 2];
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) o[j] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;   // log2 domain; partial sums
  const float scale_log2 = scale * LOG2E;

  // Q descriptor: this warpgroup's 64 rows (64 D 2-byte values further per
  // warpgroup), K-major (LBO 128 B, SBO 16 D B).
  const uint64_t dq = make_desc(sq + wg * WG_ROWS * D * 2, 128, 16 * D);

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int jk = 2 * (kb - kb_lo);             // this block's K tile; jk + 1 its V
    const bool mine = kb >= my_lo && kb < my_hi; // uniform over the warpgroup
    cp_async_wait<NSLOT - 2>();                  // tile jk (and Q) landed
    fence_async_shared();
    __syncthreads();
    issue_tile(jk + NSLOT - 1);

    float mn0 = m0, mn1 = m1;
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
    if (mine) {
      // S = Q K^T over D / 16 steps of 16.
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
      const uint64_t dk = make_desc(sq + QBYTES + (jk % NSLOT) * TBYTES, 128, 16 * D);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if constexpr (BK == 64) wgmma_ss_n64(s, dq + 16 * kk, dk + 16 * kk, kk > 0);
        else wgmma_ss_n32(s, dq + 16 * kk, dk + 16 * kk, kk > 0);
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_reg(s[i]);

      // Scale (to the log2 domain), softcap, mask; element i is row
      // (i & 2 ? row1 : row0), key k0 + 8 (i / 4) + col_in + (i & 1).  Only
      // a block that holds a masked pair for some row of the warpgroup pays
      // for the mask: the ragged end, the causal diagonal, the window's edge.
      const int k0 = kb * BK;
      const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > w0) ||
                        (window > 0 && k0 <= w0 + WG_ROWS - 1 - window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = softcap > 0.0f ? softcap * tanhf(s[i] * scale / softcap) * LOG2E
                                 : s[i] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * (i >> 2) + col_in + (i & 1);
          const int qp = (i & 2) ? row1 : row0;
          bool ok = kp < Skv;
          if (causal) ok = ok && (kp <= qp);
          if (window > 0) ok = ok && (kp > qp - window);
          x = ok ? x : NEG_INF;
        }
        s[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      mn0 = fmaxf(m0, mx0);
      mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) o[j] *= (j & 2) ? a1 : a0;

      // p in f32, and its two bf16 terms as the A fragments of P.V: keys
      // 16 kk .. 16 kk + 15 are s[8 kk .. 8 kk + 7], in A's register order.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float mr = (r & 1) ? mn1 : mn0;
          const float p0 = exp2f(s[i] - mr), p1 = exp2f(s[i + 1] - mr);
          if (r & 1) l1 += p0 + p1;
          else l0 += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - __low2float(hi),
                                                          p1 - __high2float(hi));
          ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      }
    }

    cp_async_wait<NSLOT - 2>();                  // tile jk + 1 (V) landed
    fence_async_shared();
    __syncthreads();
    issue_tile(jk + NSLOT);

    if (mine) {
      // O += P_hi V + P_lo V.  V's descriptor is MN-major: LBO (next 8 keys)
      // 16 DV bytes, SBO (next 8 columns) 128 bytes; 16 keys further = 32 DV
      // bytes.
      const uint64_t dv = make_desc(sq + QBYTES + ((jk + 1) % NSLOT) * TBYTES, 16 * DV, 128);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pv_product<DV>(o, ph[kk], dv + 2 * DV * kk);
        pv_product<DV>(o, pl[kk], dv + 2 * DV * kk);
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) fence_reg(o[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-20f), inv1 = 1.0f / fmaxf(l1, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= Sq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * DV + col_in;
#pragma unroll
    for (int nb = 0; nb < DV / 8; ++nb) {
      const float x0 = o[4 * nb + 2 * half] * inv, x1 = o[4 * nb + 2 * half + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// BK: 64 keys a tile while the O accumulator (DV / 2 floats a thread)
// leaves the registers for it, 32 above DV = 128.
template <int D, int DV>
static int launch_wgmma(int B, int Sq, int Skv, int H, int KV, float scale, int causal,
                        int window, float softcap, const void* q, const void* k, const void* v,
                        void* out, cudaStream_t stream) {
  constexpr int BKD = DV <= 128 ? 64 : 32;
  const size_t smem = (size_t)(BQ + NSLOT * BKD) * D * 2;
  auto kernel = flash_attention_wgmma_kernel<D, DV, BKD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(Sq, Skv, H, KV, scale, causal, window, softcap,
                                      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                      (const __nv_bfloat16*)v, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

// Every D = DV that is a multiple of 16 up to 256, and (D, DV) = (192, 128),
// MLA's (deepseek-v2-lite); any other pair is refused.
static int dispatch_wgmma(int B, int Sq, int Skv, int H, int KV, int D, int DV, float scale,
                          int causal, int window, float softcap, const void* q, const void* k,
                          const void* v, void* out, cudaStream_t stream) {
  if (D == 192 && DV == 128)
    return launch_wgmma<192, 128>(B, Sq, Skv, H, KV, scale, causal, window, softcap, q, k, v,
                                  out, stream);
  if (DV != D) return (int)cudaErrorInvalidValue;
  switch (D) {
#define FA_TC_CASE(N)                                                                         \
  case N:                                                                                     \
    return launch_wgmma<N, N>(B, Sq, Skv, H, KV, scale, causal, window, softcap, q, k, v, out, \
                              stream);
    FA_TC_CASE(16) FA_TC_CASE(32) FA_TC_CASE(48) FA_TC_CASE(64) FA_TC_CASE(80)
    FA_TC_CASE(96) FA_TC_CASE(112) FA_TC_CASE(128) FA_TC_CASE(144) FA_TC_CASE(160)
    FA_TC_CASE(176) FA_TC_CASE(192) FA_TC_CASE(208) FA_TC_CASE(224) FA_TC_CASE(240)
    FA_TC_CASE(256)
#undef FA_TC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16; body: 0 = SIMT, 1 = tensor cores (bf16,
// D % 16 == 0 only).  window <= 0: none; softcap <= 0: none.
// q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, DV], out [B, Sq, H, DV],
// all contiguous (16-byte aligned for the tensor-core body), DV <= D <= 256
// and H a multiple of KV (the wrapper checks).
extern "C" int flash_attention_launch(int B, int Sq, int Skv, int H, int KV, int D, int DV,
                                      int dtype, int body, float scale, int causal, int window,
                                      float softcap, const void* q, const void* k,
                                      const void* v, void* out, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (DV <= 0 || DV > D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    if (dtype != 1 || D % 16 != 0) return (int)cudaErrorInvalidValue;
    return tc::dispatch_wgmma(B, Sq, Skv, H, KV, D, DV, scale, causal, window, softcap, q, k,
                              v, out, s);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_d<float>(B, Sq, Skv, H, KV, D, DV, scale, causal, window, softcap, q, k, v,
                             out, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(B, Sq, Skv, H, KV, D, DV, scale, causal, window, softcap,
                                     q, k, v, out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
