// Hopper (sm_90a) Mamba2 SSD per-chunk kernel: f32 in, f32 out.
//
// Replaces src/repro/kernels/mamba_scan.py::ssd_chunk_pallas (the Pallas TPU
// kernel _ssd_chunk_kernel, pallas_call at :71).  Same function, per (batch b,
// chunk c, head h) over the chunk's Q positions:
//   cum_i   = sum_{j<=i} dt_j a                      (a = A[h] < 0)
//   y_i     = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state   = sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_j^T        [P, N]
// with the decay of the upper triangle (j > i) zero without an exp: there
// cum_i - cum_j is positive and its exp would overflow.  The inter-chunk
// recurrence stays outside, in torch (models/mamba2.py::ssd_chunked), as in
// the reference's wrapper.
//
// Design.  One CTA of 8 warps per (group of G heads, chunk, batch); the
// wrapper picks G (kernels/ssd_chunk.py::head_group), the last group of a
// head count that G does not divide is short.
// - The chunk's B and C tiles [Q, N] come in by cp.async.  C.B^T does not
//   depend on the head, so the CTA computes it once, for the 16 x 16 blocks
//   on and below the diagonal only, and keeps it in shared memory for its G
//   heads (36 KiB at Q = 128).
// - cum is a sequential f32 sum per head (lane 0 of warp g, head g): the
//   order of torch.cumsum on the card, so cum matches the plain version bit
//   for bit.  A double sum rounded once is closer to the exact answer, but
//   with x drawn 30 times larger the plain version's own f32 cum moves its
//   y past 5e-5 of the exact one, and the kernel has to agree with it.
// - Per head: its x tile [Q, P] comes in by cp.async; warps 0-3 form the
//   weights W = (C.B^T) o exp(cum_i - cum_j) o dt_j fragment by fragment
//   (the mask before the exp) and compute y = W x, two 16-row strips each
//   (strips w and 7 - w, so that the triangle's work is even); warps 4-7
//   compute state = (x o dw)^T B at the same time.
// - All three products run on the tensor cores as 3xTF32: each f32 operand
//   is split a = a_hi + a_lo with cvt.rna.tf32.f32 (a_hi of a, a_lo of
//   a - a_hi), and mma.sync.m16n8k8 accumulates a_lo b_hi + a_hi b_lo +
//   a_hi b_hi in f32, small terms first.  That keeps about 22 bits of each
//   product, where plain TF32 would keep 11 and miss the reference's 5e-5.
// - Tiles are rows of max(W, 32) floats with the column XORed by swz(row),
//   the C.B^T blocks rows of 16 with swz16(row): every fragment load and
//   every 16-byte cp.async is free of bank conflicts without padding.
// - Shared memory is 107.5 KiB at Q = 128, P = N = 64, G = 5 (one x buffer),
//   so two CTAs share an SM and one's x load overlaps the other's products.
//   A second x buffer, for loading the next head during this head's
//   products, would take a CTA to 139.5 KiB and one CTA per SM.
//
// Bound on this card: at the serve path's prefill (x [8, 8, 128, 80, 64],
// N = 64) the function moves 429 MB (x and y 168 MB each, state 84 MB),
// 0.128 ms at 3.35 TB/s.  Its 10.85 GFLOP of products (C.B^T once per chunk,
// the lower triangle only) take 0.066 ms at the 3xTF32 rate, a third of the
// 495 TFLOP/s TF32 peak, so the bytes bound it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QMAX = 128;
constexpr int NTHREADS = 256;

// Column swizzle of the x, B and C tiles (rows of max(W, 32) floats): bits
// 2-4 of the column, so that 16-byte chunks stay whole and the fragments'
// (row = lane / 4, col = lane % 4) and (row = lane % 4, col = lane / 4)
// patterns each touch 32 distinct banks.
__device__ __forceinline__ int swz(int row) { return ((row & 3) << 3) | (row & 4); }
// The same for the 16 x 16 blocks of C.B^T (rows of 16 floats).
__device__ __forceinline__ int swz16(int row) { return ((row >> 1) & 3) << 2; }
// Index of block (bm, bn), bn <= bm, among the lower-triangle blocks.
__device__ __forceinline__ int tri(int bm, int bn) { return bm * (bm + 1) / 2 + bn; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v = hi + lo, each a TF32 value (round to nearest, ties away).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b over one k-step of 8 in 3xTF32, small terms first.  The three
// products go into a fresh fragment and join d by an f32 add: the tensor
// core's own accumulation rounds toward zero, which over the 16 k-steps of
// a 128-row chunk shrank every output by about 1e-6 of its size when d
// itself was the accumulator (measured on the card); the fresh fragment
// keeps that bias to one k-step's partial sum, whose sign varies.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float (&b)[2]) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b[0], bh0, bl0);
  split(b[1], bh1, bl1);
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
}

template <int W>
__host__ __device__ constexpr int row_len() { return W < 32 ? 32 : W; }

// Shared memory of one CTA, in floats: the x buffer (which also holds C
// until C.B^T is formed), B, the C.B^T blocks, and cum, dt, dw per head.
__host__ __device__ constexpr int smem_floats(int Qp, int XS, int NS, int G) {
  return Qp * (XS > NS ? XS : NS) + Qp * NS + (Qp / 16) * (Qp / 16 + 1) / 2 * 256 + 3 * G * Qp;
}

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS, 2)
ssd_chunk_kernel(int C, int Q, int H, int G, const float* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ state,
                 float* __restrict__ cum_out) {
  constexpr int XS = row_len<P>(), NS = row_len<N>();
  const int Qp = (Q + 15) & ~15, nst = Qp >> 4;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                      // [Qp][XS], C first
  float* Cs = smem;                                      // [Qp][NS]
  float* Bs = smem + Qp * (XS > NS ? XS : NS);           // [Qp][NS]
  float* CBs = Bs + Qp * NS;                             // lower blocks [16][16]
  float* cumv = CBs + nst * (nst + 1) / 2 * 256;         // [G][Qp]
  float* dtv = cumv + G * Qp;                            // [G][Qp]
  float* dwv = dtv + G * Qp;                             // [G][Qp]: exp(total - cum_j) dt_j

  const int h0 = blockIdx.x * G, gn = min(G, H - h0);
  const size_t bc = (size_t)blockIdx.z * C + blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // -- B and C tiles (rows past Q zero), dt of the group's heads -------------
  for (int e = tid; e < (Qp - Q) * NS; e += NTHREADS) {
    Bs[Q * NS + e] = 0.0f;
    Cs[Q * NS + e] = 0.0f;
  }
  {
    const float* bg = Bm + bc * Q * N;
    const float* cg = Cm + bc * Q * N;
    for (int e = tid; e < Q * (N / 4); e += NTHREADS) {
      const int q = e / (N / 4), col = ((e % (N / 4)) * 4) ^ swz(q);
      cp_async16(&Bs[q * NS + col], bg + 4 * e);
      cp_async16(&Cs[q * NS + col], cg + 4 * e);
    }
    cp_async_commit();
  }
  for (int e = tid; e < Qp * gn; e += NTHREADS) {
    const int q = e / gn, g = e - q * gn;
    dtv[g * Qp + q] = (q < Q) ? dt[(bc * Q + q) * H + h0 + g] : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  // -- cum and dw of head g (warp g).  cum is the sequential f32 prefix sum
  // of the f32 products dt_q a, the order torch.cumsum takes on the card, so
  // the plain version's cum comes out bit for bit the same -----------------
  if (warp < gn) {
    float* cum = cumv + warp * Qp;
    const float* dts = dtv + warp * Qp;
    if (lane == 0) {
      const float a = A[h0 + warp];
      float run = 0.0f;
      for (int q = 0; q < Qp; ++q) {
        run = __fadd_rn(run, __fmul_rn(dts[q], a));
        cum[q] = run;
      }
    }
    __syncwarp();
    const float total = cum[Q - 1];
    for (int q = lane; q < Qp; q += 32) {
      dwv[warp * Qp + q] = expf(total - cum[q]) * dts[q];
      if (q < Q) cum_out[(bc * Q + q) * H + h0 + warp] = cum[q];
    }
  }

  // -- C.B^T on the lower blocks: warp w takes strips w % 4 and 7 - w % 4 and
  // the n8 half w / 4 of each of their blocks (nine n8 tiles a warp) ---------
  {
    const int pi = warp & 3, half = warp >> 2;
#pragma unroll 1
    for (int si = 0; si < 2; ++si) {
      const int m = si ? 7 - pi : pi;
      if (m >= nst) continue;
      float acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
      const int r0 = 16 * m + gid, r1 = r0 + 8;
#pragma unroll 2
      for (int ks = 0; ks < N / 8; ++ks) {
        const int n0 = 8 * ks + tig, n1 = n0 + 4;
        const float av[4] = {Cs[r0 * NS + (n0 ^ swz(r0))], Cs[r1 * NS + (n0 ^ swz(r1))],
                             Cs[r0 * NS + (n1 ^ swz(r0))], Cs[r1 * NS + (n1 ^ swz(r1))]};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
#pragma unroll
        for (int bn = 0; bn < 8; ++bn) {
          if (bn <= m) {
            const int j = 16 * bn + 8 * half + gid;
            const float bv[2] = {Bs[j * NS + (n0 ^ swz(j))], Bs[j * NS + (n1 ^ swz(j))]};
            mma3(acc[bn], ah, al, bv);
          }
        }
      }
      const int cj = 8 * half + 2 * tig;
#pragma unroll
      for (int bn = 0; bn < 8; ++bn) {
        if (bn <= m) {
          float* blk = CBs + tri(m, bn) * 256;
          *reinterpret_cast<float2*>(&blk[gid * 16 + (cj ^ swz16(gid))]) =
              make_float2(acc[bn][0], acc[bn][1]);
          *reinterpret_cast<float2*>(&blk[(gid + 8) * 16 + (cj ^ swz16(gid))]) =
              make_float2(acc[bn][2], acc[bn][3]);
        }
      }
    }
  }
  __syncthreads();                       // C.B^T complete; C is dead
  for (int e = tid; e < (Qp - Q) * XS; e += NTHREADS) xs[Q * XS + e] = 0.0f;

  // -- per head ---------------------------------------------------------------
#pragma unroll 1
  for (int g = 0; g < gn; ++g) {
    const int h = h0 + g;
    {
      const float* xg = x + bc * Q * H * P + (size_t)h * P;
      for (int e = tid; e < Q * (P / 4); e += NTHREADS) {
        const int q = e / (P / 4), ch = e - q * (P / 4);
        cp_async16(&xs[q * XS + ((4 * ch) ^ swz(q))], xg + (size_t)q * H * P + 4 * ch);
      }
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    const float* cum = cumv + g * Qp;
    const float* dts = dtv + g * Qp;

    if (warp < 4) {
      // y = W x: strips warp and 7 - warp, all P columns.
#pragma unroll 1
      for (int si = 0; si < 2; ++si) {
        const int m = si ? 7 - warp : warp;
        if (m >= nst) continue;
        const int i0 = 16 * m + gid, i1 = i0 + 8;
        const float ci0 = cum[i0], ci1 = cum[i1];
        float acc[P / 8][4];
#pragma unroll
        for (int t = 0; t < P / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
#pragma unroll 1
        for (int kb = 0; kb < 2 * (m + 1); ++kb) {
          const int j0 = 8 * kb + tig, j1 = j0 + 4;
          const float cj0 = cum[j0], cj1 = cum[j1], d0 = dts[j0], d1 = dts[j1];
          const float* blk = CBs + tri(m, kb >> 1) * 256;
          const int c0 = 8 * (kb & 1) + tig, c1 = c0 + 4;
          const int sw = swz16(gid);
          float wv[4];
          wv[0] = (j0 <= i0) ? blk[gid * 16 + (c0 ^ sw)] * expf(ci0 - cj0) * d0 : 0.0f;
          wv[1] = (j0 <= i1) ? blk[(gid + 8) * 16 + (c0 ^ sw)] * expf(ci1 - cj0) * d0 : 0.0f;
          wv[2] = (j1 <= i0) ? blk[gid * 16 + (c1 ^ sw)] * expf(ci0 - cj1) * d1 : 0.0f;
          wv[3] = (j1 <= i1) ? blk[(gid + 8) * 16 + (c1 ^ sw)] * expf(ci1 - cj1) * d1 : 0.0f;
          uint32_t ah[4], al[4];
          split4(wv, ah, al);
#pragma unroll
          for (int t = 0; t < P / 8; ++t) {
            const int p = 8 * t + gid;
            const float bv[2] = {xs[j0 * XS + (p ^ swz(j0))], xs[j1 * XS + (p ^ swz(j1))]};
            mma3(acc[t], ah, al, bv);
          }
        }
        const int pc = 2 * tig;
#pragma unroll
        for (int t = 0; t < P / 8; ++t) {
          if (i0 < Q)
            *reinterpret_cast<float2*>(&y[((bc * Q + i0) * H + h) * P + 8 * t + pc]) =
                make_float2(acc[t][0], acc[t][1]);
          if (i1 < Q)
            *reinterpret_cast<float2*>(&y[((bc * Q + i1) * H + h) * P + 8 * t + pc]) =
                make_float2(acc[t][2], acc[t][3]);
        }
      }
    } else {
      // state = (x o dw)^T B: [P, N] as (P / 16) x (N / 8) tiles, NTW a warp.
      constexpr int NT = N / 8, TILES = (P / 16) * NT;
      constexpr int NTW = TILES / 4 > 0 ? TILES / 4 : 1;
      const int t0 = (warp - 4) * NTW;
      if (t0 < TILES) {
        const int p0 = 16 * (t0 / NT) + gid, p1 = p0 + 8, nt0 = t0 % NT;
        const float* dw = dwv + g * Qp;
        float acc[NTW][4];
#pragma unroll
        for (int t = 0; t < NTW; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
#pragma unroll 2
        for (int kb = 0; kb < Qp / 8; ++kb) {
          const int j0 = 8 * kb + tig, j1 = j0 + 4;
          const float w0 = dw[j0], w1 = dw[j1];
          const float av[4] = {xs[j0 * XS + (p0 ^ swz(j0))] * w0, xs[j0 * XS + (p1 ^ swz(j0))] * w0,
                               xs[j1 * XS + (p0 ^ swz(j1))] * w1, xs[j1 * XS + (p1 ^ swz(j1))] * w1};
          uint32_t ah[4], al[4];
          split4(av, ah, al);
#pragma unroll
          for (int t = 0; t < NTW; ++t) {
            const int n = 8 * (nt0 + t) + gid;
            const float bv[2] = {Bs[j0 * NS + (n ^ swz(j0))], Bs[j1 * NS + (n ^ swz(j1))]};
            mma3(acc[t], ah, al, bv);
          }
        }
        float* so = state + (bc * H + h) * P * N;
#pragma unroll
        for (int t = 0; t < NTW; ++t) {
          const int n = 8 * (nt0 + t) + 2 * tig;
          *reinterpret_cast<float2*>(&so[p0 * N + n]) = make_float2(acc[t][0], acc[t][1]);
          *reinterpret_cast<float2*>(&so[p1 * N + n]) = make_float2(acc[t][2], acc[t][3]);
        }
      }
    }
    __syncthreads();                     // the x buffer is free for the next head
  }
}

template <int P, int N>
int launch(int B, int C, int Q, int H, int G, const void* x, const void* dt, const void* A,
           const void* Bm, const void* Cm, void* y, void* state, void* cum,
           cudaStream_t stream) {
  const int Qp = (Q + 15) & ~15;
  const size_t smem =
      (size_t)smem_floats(Qp, row_len<P>(), row_len<N>(), G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + G - 1) / G, C, B);
  ssd_chunk_kernel<P, N><<<grid, NTHREADS, smem, stream>>>(
      C, Q, H, G, (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (float*)y, (float*)state, (float*)cum);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_n(int B, int C, int Q, int H, int N, int G, const void* x, const void* dt,
               const void* A, const void* Bm, const void* Cm, void* y, void* state,
               void* cum, cudaStream_t s) {
  if (N == 16) return launch<P, 16>(B, C, Q, H, G, x, dt, A, Bm, Cm, y, state, cum, s);
  if (N == 32) return launch<P, 32>(B, C, Q, H, G, x, dt, A, Bm, Cm, y, state, cum, s);
  if (N == 64) return launch<P, 64>(B, C, Q, H, G, x, dt, A, Bm, Cm, y, state, cum, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [B, C, Q, H, P], dt [B, C, Q, H], A [H], Bm/Cm [B, C, Q, N] -> y [B, C, Q,
// H, P], state [B, C, H, P, N], cum [B, C, Q, H]; all f32, contiguous, x, Bm
// and Cm 16-byte aligned; 1 <= Q <= 128, P and N in {16, 32, 64}, G heads a
// CTA in [1, 8], C and B <= 65535 (the wrapper checks the shapes and picks G).
extern "C" int ssd_chunk_launch(int B, int C, int Q, int H, int P, int N, int G, const void* x,
                                const void* dt, const void* A, const void* Bm, const void* Cm,
                                void* y, void* state, void* cum, void* stream) {
  if (B == 0 || C == 0 || H == 0) return 0;
  // one warp scans each head's cum, so a CTA takes at most NTHREADS / 32 heads
  if (Q < 1 || Q > QMAX || G < 1 || G > NTHREADS / 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 16) return dispatch_n<16>(B, C, Q, H, N, G, x, dt, A, Bm, Cm, y, state, cum, s);
  if (P == 32) return dispatch_n<32>(B, C, Q, H, N, G, x, dt, A, Bm, Cm, y, state, cum, s);
  if (P == 64) return dispatch_n<64>(B, C, Q, H, N, G, x, dt, A, Bm, Cm, y, state, cum, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
