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
// Design: one CTA of 256 threads per (h, c, b) (h fastest, so the CTAs that
// share a chunk's B and C tiles run together and find them in L2).  The
// head's x tile [Q, P], the chunk's B and C tiles [Q, N] and dt sit in shared
// memory as f32.  cum is a scan by warp 0 (four positions a lane, then a
// shuffle scan).  Three SIMT products on a 16 x 16 thread grid, all from
// shared memory: the masked weights W = (C B^T) o decay o dt [Q, Q] (8 x 8
// per thread, written to shared memory), y = W x (8 rows x P/16 columns per
// thread, summed up to the diagonal of its last row) and state = (x o dw)^T B
// (P/16 x N/16 per thread).  Row strides keep the column reads conflict-free:
// B and C rows are N + 1 floats, W rows 144 (16 banks apart).  Shared memory
// is 175 KB at Q = 128, P = N = 64, so one CTA per SM.  No tensor cores: the
// function is f32 and is held to the reference's 5e-5, which TF32 would miss.
//
// Bound on this card: at the serve path's prefill (x [8, 8, 128, 80, 64],
// N = 64) the CTAs move 429 MB (x and y 168 MB each, state 84 MB), 0.128 ms
// at 3.35 TB/s, and do 26.8 GFLOP of f32 as written (C B^T recomputed per
// head, full squares), 0.40 ms at 67 TFLOP/s; the least work (C B^T once per
// chunk, the lower triangle only) is 11.0 GFLOP, 0.164 ms.  Operation-bound
// either way (PERF.md has the kernel's time).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define QMAX 128
#define NTHREADS 256
#define WS (QMAX + 16)   // W row stride: rows ty and ty + 1 land 16 banks apart

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS, 1)
ssd_chunk_kernel(int C, int Q, int H, const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ state, float* __restrict__ cum_out) {
  constexpr int NS = N + 1;        // B/C row stride (odd: conflict-free column reads)
  constexpr int PJ = P / 16;       // y columns per thread
  constexpr int NJ = N / 16;       // state columns per thread
  extern __shared__ float smem[];
  float* Xs = smem;                // [QMAX][P]
  float* Bs = Xs + QMAX * P;       // [QMAX][NS]
  float* Cs = Bs + QMAX * NS;      // [QMAX][NS]
  float* Ws = Cs + QMAX * NS;      // [QMAX][WS]
  float* cum = Ws + QMAX * WS;     // [QMAX]
  float* dts = cum + QMAX;         // [QMAX]
  float* dw = dts + QMAX;          // [QMAX]: exp(total - cum_j) dt_j

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bc = (size_t)b * C + c;
  const float a = A[h];

  // -- stage x (this head), B and C (the chunk's), dt ---------------------------
  const float* xg = x + bc * Q * H * P + (size_t)h * P;
  for (int e = tid; e < Q * P; e += NTHREADS) {
    const int q = e / P, p = e - q * P;
    Xs[q * P + p] = xg[(size_t)q * H * P + p];
  }
  const float* bg = Bm + bc * Q * N;
  const float* cg = Cm + bc * Q * N;
  for (int e = tid; e < Q * N; e += NTHREADS) {
    const int q = e / N, n = e - q * N;
    Bs[q * NS + n] = bg[e];
    Cs[q * NS + n] = cg[e];
  }
  for (int q = tid; q < Q; q += NTHREADS) dts[q] = dt[(bc * Q + q) * H + h];
  __syncthreads();

  // -- cum: warp 0, positions 4 lane .. 4 lane + 3, then an inclusive shuffle scan
  if (tid < 32) {
    float v[4], run = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = 4 * tid + k;
      run += (q < Q) ? dts[q] * a : 0.0f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += up;
    }
    const float base = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = 4 * tid + k;
      if (q < Q) cum[q] = base + v[k];
    }
  }
  __syncthreads();
  const float total = cum[Q - 1];
  for (int q = tid; q < Q; q += NTHREADS) {
    dw[q] = expf(total - cum[q]) * dts[q];
    cum_out[(bc * Q + q) * H + h] = cum[q];
  }

  // -- W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, 0 above -----
  // Rows and columns past Q read unstaged shared memory and are never stored.
  {
    float s[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) s[r][k] = 0.0f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float ci[8], bj[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) ci[r] = Cs[(ty + 16 * r) * NS + n];
#pragma unroll
      for (int k = 0; k < 8; ++k) bj[k] = Bs[(tx + 16 * k) * NS + n];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) s[r][k] = fmaf(ci[r], bj[k], s[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= Q) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = tx + 16 * k;
        if (j >= Q) continue;
        Ws[i * WS + j] = (j <= i) ? s[r][k] * expf(cum[i] - cum[j]) * dts[j] : 0.0f;
      }
    }
  }
  __syncthreads();

  // -- y = W x: rows ty + 16 r, columns tx + 16 k; W is zero past the diagonal
  {
    float acc[8][PJ];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < PJ; ++k) acc[r][k] = 0.0f;
    const int jend = min(Q, ty + 16 * 7 + 1);
    for (int j = 0; j < jend; ++j) {
      float w[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) w[r] = Ws[(ty + 16 * r) * WS + j];
#pragma unroll
      for (int k = 0; k < PJ; ++k) {
        const float xv = Xs[j * P + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][k] = fmaf(w[r], xv, acc[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= Q) continue;
      float* yo = y + ((bc * Q + i) * H + h) * P;
#pragma unroll
      for (int k = 0; k < PJ; ++k) yo[tx + 16 * k] = acc[r][k];
    }
  }

  // -- state[p][n] = sum_j x_j[p] dw_j B_j[n]: p = ty + 16 r, n = tx + 16 k ---
  {
    float st[PJ][NJ];
#pragma unroll
    for (int r = 0; r < PJ; ++r)
#pragma unroll
      for (int k = 0; k < NJ; ++k) st[r][k] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float d = dw[j];
      float xv[PJ];
#pragma unroll
      for (int r = 0; r < PJ; ++r) xv[r] = Xs[j * P + ty + 16 * r] * d;
#pragma unroll
      for (int k = 0; k < NJ; ++k) {
        const float bv = Bs[j * NS + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < PJ; ++r) st[r][k] = fmaf(xv[r], bv, st[r][k]);
      }
    }
    float* so = state + (bc * H + h) * P * N;
#pragma unroll
    for (int r = 0; r < PJ; ++r)
#pragma unroll
      for (int k = 0; k < NJ; ++k) so[(ty + 16 * r) * N + tx + 16 * k] = st[r][k];
  }
}

template <int P, int N>
static int launch(int B, int C, int Q, int H, const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, void* y, void* state, void* cum,
                  cudaStream_t stream) {
  const size_t smem =
      (size_t)(QMAX * P + 2 * QMAX * (N + 1) + QMAX * WS + 3 * QMAX) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, C, B);
  ssd_chunk_kernel<P, N><<<grid, NTHREADS, smem, stream>>>(
      C, Q, H, (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (float*)y, (float*)state, (float*)cum);
  return (int)cudaGetLastError();
}

template <int P>
static int dispatch_n(int B, int C, int Q, int H, int N, const void* x, const void* dt,
                      const void* A, const void* Bm, const void* Cm, void* y, void* state,
                      void* cum, cudaStream_t s) {
  if (N == 16) return launch<P, 16>(B, C, Q, H, x, dt, A, Bm, Cm, y, state, cum, s);
  if (N == 32) return launch<P, 32>(B, C, Q, H, x, dt, A, Bm, Cm, y, state, cum, s);
  if (N == 64) return launch<P, 64>(B, C, Q, H, x, dt, A, Bm, Cm, y, state, cum, s);
  return (int)cudaErrorInvalidValue;
}

// x [B, C, Q, H, P], dt [B, C, Q, H], A [H], Bm/Cm [B, C, Q, N] -> y [B, C, Q,
// H, P], state [B, C, H, P, N], cum [B, C, Q, H]; all f32 and contiguous,
// 1 <= Q <= 128, P and N in {16, 32, 64}, C and B <= 65535 (the wrapper checks).
extern "C" int ssd_chunk_launch(int B, int C, int Q, int H, int P, int N, const void* x,
                                const void* dt, const void* A, const void* Bm, const void* Cm,
                                void* y, void* state, void* cum, void* stream) {
  if (B == 0 || C == 0 || H == 0) return 0;
  if (Q < 1 || Q > QMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 16) return dispatch_n<16>(B, C, Q, H, N, x, dt, A, Bm, Cm, y, state, cum, s);
  if (P == 32) return dispatch_n<32>(B, C, Q, H, N, x, dt, A, Bm, Cm, y, state, cum, s);
  if (P == 64) return dispatch_n<64>(B, C, Q, H, N, x, dt, A, Bm, Cm, y, state, cum, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
