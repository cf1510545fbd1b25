// The xLSTM recurrences: the mLSTM and sLSTM scans over time.
//
// Replaces no Pallas kernel: the reference runs both as ``lax.scan`` over
// the sequence (src/repro/models/xlstm.py:104 for the mLSTM cell at :45-61,
// :183 for the sLSTM cell at :143-166).  A per-step loop of PyTorch ops on
// the card would launch ~15 kernels a step and a layer, so each scan is one
// launch that keeps its state on chip across all S steps.
//
// Both read the initial state in the cache's dtype (bf16 or f32), carry it
// in f32 and write the final state back in place in that dtype, rounding
// to nearest even: the reference's casts around its scan.  The order of
// operations is the reference's; divisions are true divisions (no
// --use_fast_math, expf/log1pf/tanhf rather than the intrinsics).  The
// mLSTM's state updates are elementwise and round each operation on its own,
// so its C, n and m are the plain version's bit for bit.
//
// mlstm_scan: one CTA per (batch, head, block of 32 rows of C), 4 warps of
// 8 rows each.  Rows of C are independent within a step: row i needs v_i,
// all of k and q and the head's scalars.  Each warp keeps its 8 rows of C in
// registers (lane l holds columns l, l + 32, ...) and its own copy of the
// head's n (the same columns) and m, and recomputes the gates, n and the
// denominator max(|n . q|, exp(-m)) + 1e-6 itself: the same operations on
// the same data give every warp and CTA of a head the same bits, so the
// warps never synchronise inside the scan.  The gates' transcendentals run
// 32 steps at a time, a step a lane, leaving only the stabiliser's max to
// the sequential walk; k / sqrt(Dh) is a product and one exact-remainder
// correction (correctly rounded, as the division); the 8 rows' sums share
// 9 shuffles.  q_t, k_t and v_t are read from global memory each step,
// prefetched into L1 two steps ahead.  At xlstm-125m (B = 8, H = 4,
// Dh = 384) the grid is 12 x 32 = 384 CTAs of 128 threads; C is 18.9 MB of
// registers across the card, so three CTAs an SM (__launch_bounds__) keep
// the whole grid resident in one wave.  Bound: f32 operations (6 per
// element of C a step), not bytes.
//
// slstm_scan: one CTA per (batch, head) chain, a thread per row of the four
// stacked recurrent matrices (z, i, f, o; two rows a thread above 256 rows).
// Each step every row's pre-activation w + R_g h_{t-1} (a dot over Dh in f32
// from the bf16- or f32-valued R), a barrier, then thread i < Dh runs the
// cell for element i, writes h_t to shared memory and global memory, and a
// barrier.  As many of the head's four matrices as fit in shared memory
// (three at Dh = 192 in bf16, 72 KiB each) are staged there once, with a
// 16-byte-chunk XOR swizzle so that threads reading neighbouring rows hit
// distinct banks; the CTA copies the rest once into a scratch of its own,
// chunk-major, and reads them from there (L2) every step, a warp's rows 512
// contiguous bytes a chunk.  A decode step (S = 1) reads all four in place.  Bound: the chain
// of S dependent steps (B * H = 32 chains use 32 SMs), then operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int MLSTM_ROWS_PER_WARP = 8;                           // reduce8 sums 8 rows
constexpr int MLSTM_WARPS = 4;
constexpr int MLSTM_ROWS = MLSTM_ROWS_PER_WARP * MLSTM_WARPS;   // rows of C a CTA
constexpr int MLSTM_MAX_CPL = 12;                                // Dh <= 384
constexpr int MLSTM_PREFETCH = 2;                                // steps ahead
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// log(sigmoid(x)) = -softplus(-x) = min(x, 0) - log1p(exp(-|x|)).
__device__ __forceinline__ float log_sigmoid(float x) {
    return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The sum over the warp's lanes, the same bits on every lane (each butterfly
// stage adds the same two values on both lanes of a pair).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

// x / d correctly rounded, from inv = RN(1 / d): the product, then one
// Markstein correction with the exact remainder (Markstein's theorem; no
// subnormal quotients here).
__device__ __forceinline__ float div_rn(float x, float d, float inv) {
    const float q0 = x * inv;
    return fmaf(fmaf(-q0, d, x), inv, q0);
}

// The sums of s[0..7] over the warp's 32 lanes, 9 shuffles for the 8: each
// stage sends half of a lane's partial sums to its partner and keeps the
// other half; afterwards lane l holds the sum of row l / 4 (bits 4, 3, 2 of
// l pick the halves).
__device__ __forceinline__ float reduce8(const float (&s)[8], int lane) {
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    float t[4], u[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        t[i] = (b4 ? s[i + 4] : s[i]) + __shfl_xor_sync(FULL, b4 ? s[i] : s[i + 4], 16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
        u[i] = (b3 ? t[i + 2] : t[i]) + __shfl_xor_sync(FULL, b3 ? t[i] : t[i + 2], 8);
    float w = (b2 ? u[1] : u[0]) + __shfl_xor_sync(FULL, b2 ? u[0] : u[1], 4);
    w += __shfl_xor_sync(FULL, w, 2);
    w += __shfl_xor_sync(FULL, w, 1);
    return w;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

template <int CPL, typename TS>
__global__ void __launch_bounds__(MLSTM_WARPS * 32, 3)
mlstm_scan_kernel(int S, int H, int Dh, const float* __restrict__ q,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ gi, long long gi_sb, long long gi_st,
                  long long gi_sh, const float* __restrict__ gf, long long gf_sb,
                  long long gf_st, long long gf_sh, TS* __restrict__ C, TS* __restrict__ n,
                  TS* __restrict__ m, float* __restrict__ h, int* __restrict__ done) {
    const int bh = blockIdx.y;
    const int b = bh / H, hd = bh % H;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row0 = blockIdx.x * MLSTM_ROWS + warp * MLSTM_ROWS_PER_WARP;
    const bool active = row0 < Dh;        // Dh is a multiple of 16: whole warps
    TS* Cbh = C + (size_t)bh * Dh * Dh;

    float c[MLSTM_ROWS_PER_WARP][CPL];
    float nr[CPL];
    float mm = 0.0f;
    if (active) {
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
            const int j = lane + 32 * cc;
            nr[cc] = j < Dh ? to_f32(n[(size_t)bh * Dh + j]) : 0.0f;
#pragma unroll
            for (int r = 0; r < MLSTM_ROWS_PER_WARP; ++r)
                c[r][cc] = j < Dh ? to_f32(Cbh[(size_t)(row0 + r) * Dh + j]) : 0.0f;
        }
        mm = to_f32(m[bh]);

        const float sqrt_dh = sqrtf((float)Dh);
        const float inv_sqrt_dh = 1.0f / sqrt_dh;
        const size_t step = (size_t)H * Dh;
        const size_t base = ((size_t)b * S * H + hd) * Dh;     // [b, 0, hd, 0]
        const int lines = (Dh * 4 + 127) / 128;                 // of q_t and of k_t
        for (int t0 = 0; t0 < S; t0 += 32) {
            // The block's gate scalars, a step a lane: log_sigmoid(f) and i,
            // then the stabiliser's sequential max over the block, then f_act,
            // i_act and exp(-m') a lane, in the plain version's operations.
            const int steps = min(32, S - t0);
            float ir_l = 0.0f, fl_l = 0.0f, mprev_l = 0.0f, mnew_l = 0.0f;
            if (lane < steps) {
                ir_l = gi[b * gi_sb + (t0 + lane) * gi_st + hd * gi_sh];
                fl_l = log_sigmoid(gf[b * gf_sb + (t0 + lane) * gf_st + hd * gf_sh]);
            }
            for (int j = 0; j < steps; ++j) {
                const float m_new = fmaxf(__shfl_sync(FULL, fl_l, j) + mm,
                                          __shfl_sync(FULL, ir_l, j));
                if (lane == j) {
                    mprev_l = mm;
                    mnew_l = m_new;
                }
                mm = m_new;
            }
            const float fa_l = expf(fl_l + mprev_l - mnew_l);
            const float ia_l = expf(ir_l - mnew_l);
            const float em_l = expf(-mnew_l);

            for (int j = 0; j < steps; ++j) {
                const int t = t0 + j;
                if (t + MLSTM_PREFETCH < S) {
                    const size_t ahead = base + (size_t)(t + MLSTM_PREFETCH) * step;
                    if (lane < lines)
                        prefetch_l1(q + ahead + lane * 32);
                    else if (lane < 2 * lines)
                        prefetch_l1(k + ahead + (lane - lines) * 32);
                    else if (lane == 2 * lines)
                        prefetch_l1(v + ahead + row0);
                }
                const float f_act = __shfl_sync(FULL, fa_l, j);
                const float i_act = __shfl_sync(FULL, ia_l, j);
                const float em = __shfl_sync(FULL, em_l, j);
                const float* qt = q + base + (size_t)t * step;
                const float* kt = k + base + (size_t)t * step;
                const float vl = lane < MLSTM_ROWS_PER_WARP ? v[base + (size_t)t * step + row0 + lane]
                                                            : 0.0f;
                float qv[CPL], ks[CPL];
#pragma unroll
                for (int cc = 0; cc < CPL; ++cc) {
                    const int col = lane + 32 * cc;
                    qv[cc] = col < Dh ? qt[col] : 0.0f;
                    ks[cc] = col < Dh ? div_rn(kt[col], sqrt_dh, inv_sqrt_dh) : 0.0f;
                }

                // The state's updates round every product and sum on its own
                // (no fused multiply-add), in the plain version's order, so
                // that C, n and m stay bit for bit the plain version's over any
                // number of steps: only h's two dot products sum in another
                // order.
                float nq = 0.0f;
#pragma unroll
                for (int cc = 0; cc < CPL; ++cc) {
                    nr[cc] = __fadd_rn(__fmul_rn(f_act, nr[cc]), __fmul_rn(i_act, ks[cc]));
                    nq += nr[cc] * qv[cc];
                }
                nq = warp_sum(nq);
                const float denom = fmaxf(fabsf(nq), em) + 1e-6f;

                float sums[MLSTM_ROWS_PER_WARP];
#pragma unroll
                for (int r = 0; r < MLSTM_ROWS_PER_WARP; ++r) {
                    const float vr = __shfl_sync(FULL, vl, r);
                    float acc = 0.0f;
#pragma unroll
                    for (int cc = 0; cc < CPL; ++cc) {
                        const float upd = __fmul_rn(i_act, __fmul_rn(vr, ks[cc]));
                        c[r][cc] = __fadd_rn(__fmul_rn(f_act, c[r][cc]), upd);
                        acc += c[r][cc] * qv[cc];
                    }
                    sums[r] = acc;
                }
                const float row_sum = reduce8(sums, lane);            // row lane / 4
                if ((lane & 3) == 0)
                    h[base + (size_t)t * step + row0 + (lane >> 2)] = row_sum / denom;
            }
        }

#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
            const int j = lane + 32 * cc;
            if (j < Dh) {
#pragma unroll
                for (int r = 0; r < MLSTM_ROWS_PER_WARP; ++r)
                    Cbh[(size_t)(row0 + r) * Dh + j] = from_f32<TS>(c[r][cc]);
            }
        }
    }

    // n and m are shared by the head's CTAs, each of which read them at its
    // start: the last CTA of the head to finish writes them (warp 0 is
    // active in every CTA).
    __shared__ int last;
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(done + bh, 1) == (int)gridDim.x - 1;
    }
    __syncthreads();
    if (last && warp == 0) {
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
            const int j = lane + 32 * cc;
            if (j < Dh) n[(size_t)bh * Dh + j] = from_f32<TS>(nr[cc]);
        }
        if (lane == 0) m[bh] = from_f32<TS>(mm);
    }
}

// Eight (bf16) or four (f32) products of a 16-byte chunk of R with h.
__device__ __forceinline__ float chunk_dot(uint4 raw, const float* hv, float acc, float) {
    const float4 r = *reinterpret_cast<const float4*>(&raw);
    const float4 x = *reinterpret_cast<const float4*>(hv);
    acc = fmaf(x.x, r.x, acc);
    acc = fmaf(x.y, r.y, acc);
    acc = fmaf(x.z, r.z, acc);
    acc = fmaf(x.w, r.w, acc);
    return acc;
}

__device__ __forceinline__ float chunk_dot(uint4 raw, const float* hv, float acc,
                                           __nv_bfloat16) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 x0 = *reinterpret_cast<const float4*>(hv);
    const float4 x1 = *reinterpret_cast<const float4*>(hv + 4);
    const float2 r0 = __bfloat1622float2(p[0]), r1 = __bfloat1622float2(p[1]);
    const float2 r2 = __bfloat1622float2(p[2]), r3 = __bfloat1622float2(p[3]);
    acc = fmaf(x0.x, r0.x, acc);
    acc = fmaf(x0.y, r0.y, acc);
    acc = fmaf(x0.z, r1.x, acc);
    acc = fmaf(x0.w, r1.y, acc);
    acc = fmaf(x1.x, r2.x, acc);
    acc = fmaf(x1.y, r2.y, acc);
    acc = fmaf(x1.z, r3.x, acc);
    acc = fmaf(x1.w, r3.y, acc);
    return acc;
}

constexpr int SLSTM_MAX_ROWS_PER_THREAD = 2;

template <typename TR, typename TS>
__global__ void __launch_bounds__(1024) slstm_scan_kernel(int S, int H, int Dh, int n_smem,
                                  const float* __restrict__ w_in, const TR* __restrict__ rz,
                                  const TR* __restrict__ ri, const TR* __restrict__ rf,
                                  const TR* __restrict__ ro, TS* __restrict__ cst,
                                  TS* __restrict__ nst, TS* __restrict__ hst,
                                  TS* __restrict__ mst, float* __restrict__ hout,
                                  TR* __restrict__ scratch) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int VPC = 16 / sizeof(TR);                 // values a 16-byte chunk
    const int bh = blockIdx.x;
    const int b = bh / H, hd = bh % H;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int d = H * Dh, rows = 4 * Dh, chunks = Dh / VPC;
    const int swz = min(8, chunks & -chunks) - 1;        // XOR mask of the chunk index
    TR* Rs = reinterpret_cast<TR*>(smem);
    float* hs = reinterpret_cast<float*>(smem + (size_t)n_smem * Dh * Dh * sizeof(TR));
    float* pre = hs + Dh;
    const size_t head = (size_t)hd * Dh * Dh;
    const TR* Rg[4] = {rz + head, ri + head, rf + head, ro + head};

    for (int idx = tid; idx < n_smem * Dh * chunks; idx += nt) {
        const int g = idx / (Dh * chunks), rem = idx % (Dh * chunks);
        const int i = rem / chunks, cc = rem % chunks;
        const uint4 val = *reinterpret_cast<const uint4*>(Rg[g] + (size_t)i * Dh + cc * VPC);
        *reinterpret_cast<uint4*>(Rs + ((size_t)g * Dh + i) * Dh + (cc ^ (i & swz)) * VPC) = val;
    }
    // The gates that do not fit: this CTA's copy, chunk-major ([chunk][row]),
    // so that a warp's rows read 512 contiguous bytes a chunk.  Written and
    // read by this CTA alone, after the barrier below, with plain loads.
    TR* Rt = scratch == nullptr ? nullptr : scratch + (size_t)bh * (4 - n_smem) * Dh * Dh;
    if (Rt != nullptr) {
        for (int idx = tid; idx < (4 - n_smem) * Dh * chunks; idx += nt) {
            const int g = idx / (Dh * chunks), rem = idx % (Dh * chunks);
            const int i = rem / chunks, cc = rem % chunks;
            const uint4 val =
                *reinterpret_cast<const uint4*>(Rg[n_smem + g] + (size_t)i * Dh + cc * VPC);
            *reinterpret_cast<uint4*>(Rt + (((size_t)g * chunks + cc) * Dh + i) * VPC) = val;
        }
    }
    float cs = 0.0f, ns = 0.0f, ms = 0.0f;
    if (tid < Dh) {
        const size_t e = (size_t)bh * Dh + tid;
        cs = to_f32(cst[e]);
        ns = to_f32(nst[e]);
        ms = to_f32(mst[e]);
        hs[tid] = to_f32(hst[e]);
    }
    __syncthreads();

    // w_in[b, t, g d + hd Dh + i] for this thread's rows, one step ahead
    const float* wb = w_in + (size_t)b * S * 4 * d + (size_t)hd * Dh;
    float wcur[SLSTM_MAX_ROWS_PER_THREAD], wnext[SLSTM_MAX_ROWS_PER_THREAD];
#pragma unroll
    for (int u = 0; u < SLSTM_MAX_ROWS_PER_THREAD; ++u) {
        const int r = tid + u * nt;
        wcur[u] = r < rows ? wb[(r / Dh) * d + r % Dh] : 0.0f;
    }
    for (int t = 0; t < S; ++t) {
#pragma unroll
        for (int u = 0; u < SLSTM_MAX_ROWS_PER_THREAD; ++u) {
            const int r = tid + u * nt;
            wnext[u] = (r < rows && t + 1 < S)
                           ? wb[(size_t)(t + 1) * 4 * d + (r / Dh) * d + r % Dh] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < SLSTM_MAX_ROWS_PER_THREAD; ++u) {
            const int r = tid + u * nt;
            if (r >= rows) break;
            const int g = r / Dh, i = r % Dh;
            float acc = 0.0f;
            if (g < n_smem) {
                const TR* row = Rs + ((size_t)g * Dh + i) * Dh;
#pragma unroll 8
                for (int cc = 0; cc < chunks; ++cc) {
                    const uint4 raw =
                        *reinterpret_cast<const uint4*>(row + (cc ^ (i & swz)) * VPC);
                    acc = chunk_dot(raw, hs + cc * VPC, acc, TR());
                }
            } else if (Rt != nullptr) {
                const uint4* col = reinterpret_cast<const uint4*>(
                    Rt + ((size_t)(g - n_smem) * chunks * Dh + i) * VPC);
#pragma unroll 8
                for (int cc = 0; cc < chunks; ++cc)
                    acc = chunk_dot(col[(size_t)cc * Dh], hs + cc * VPC, acc, TR());
            } else {
                const uint4* row = reinterpret_cast<const uint4*>(Rg[g] + (size_t)i * Dh);
#pragma unroll 8
                for (int cc = 0; cc < chunks; ++cc)
                    acc = chunk_dot(__ldg(row + cc), hs + cc * VPC, acc, TR());
            }
            pre[r] = wcur[u] + acc;
        }
        __syncthreads();
        if (tid < Dh) {
            const float z = tanhf(pre[tid]);
            const float i_raw = pre[Dh + tid];
            const float f_raw = pre[2 * Dh + tid];
            const float o = sigmoid(pre[3 * Dh + tid]);
            const float f_log = log_sigmoid(f_raw);
            const float m_new = fmaxf(f_log + ms, i_raw);
            const float i_act = expf(i_raw - m_new);
            const float f_act = expf(f_log + ms - m_new);
            cs = f_act * cs + i_act * z;
            ns = f_act * ns + i_act;
            const float hn = o * cs / fmaxf(ns, 1e-6f);
            ms = m_new;
            hs[tid] = hn;
            hout[(((size_t)b * S + t) * H + hd) * Dh + tid] = hn;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < SLSTM_MAX_ROWS_PER_THREAD; ++u) wcur[u] = wnext[u];
    }
    if (tid < Dh) {
        const size_t e = (size_t)bh * Dh + tid;
        cst[e] = from_f32<TS>(cs);
        nst[e] = from_f32<TS>(ns);
        hst[e] = from_f32<TS>(hs[tid]);
        mst[e] = from_f32<TS>(ms);
    }
}

template <int CPL, typename TS>
cudaError_t launch_mlstm(int B, int S, int H, int Dh, const float* q, const float* k,
                         const float* v, const float* gi, long long gi_sb, long long gi_st,
                         long long gi_sh, const float* gf, long long gf_sb, long long gf_st,
                         long long gf_sh, void* C, void* n, void* m, float* h, int* done,
                         cudaStream_t stream) {
    const dim3 grid((Dh + MLSTM_ROWS - 1) / MLSTM_ROWS, B * H);
    mlstm_scan_kernel<CPL, TS><<<grid, MLSTM_WARPS * 32, 0, stream>>>(
        S, H, Dh, q, k, v, gi, gi_sb, gi_st, gi_sh, gf, gf_sb, gf_st, gf_sh,
        static_cast<TS*>(C), static_cast<TS*>(n), static_cast<TS*>(m), h, done);
    return cudaGetLastError();
}

template <typename TS>
cudaError_t dispatch_mlstm(int cpl, int B, int S, int H, int Dh, const float* q,
                           const float* k, const float* v, const float* gi, long long gi_sb,
                           long long gi_st, long long gi_sh, const float* gf, long long gf_sb,
                           long long gf_st, long long gf_sh, void* C, void* n, void* m,
                           float* h, int* done, cudaStream_t stream) {
#define XLSTM_MLSTM_CASE(W)                                                              \
    case W:                                                                              \
        return launch_mlstm<W, TS>(B, S, H, Dh, q, k, v, gi, gi_sb, gi_st, gi_sh, gf,    \
                                   gf_sb, gf_st, gf_sh, C, n, m, h, done, stream);
    switch (cpl) {
        XLSTM_MLSTM_CASE(1)
        XLSTM_MLSTM_CASE(2)
        XLSTM_MLSTM_CASE(3)
        XLSTM_MLSTM_CASE(4)
        XLSTM_MLSTM_CASE(5)
        XLSTM_MLSTM_CASE(6)
        XLSTM_MLSTM_CASE(7)
        XLSTM_MLSTM_CASE(8)
        XLSTM_MLSTM_CASE(9)
        XLSTM_MLSTM_CASE(10)
        XLSTM_MLSTM_CASE(11)
        XLSTM_MLSTM_CASE(12)
        default:
            return cudaErrorInvalidValue;
    }
#undef XLSTM_MLSTM_CASE
}

int slstm_gates_in_smem(int S, int Dh, int r_size) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const size_t fixed = (size_t)5 * Dh * sizeof(float);          // h and the 4 Dh pre-acts
    if (S <= 1 || (size_t)optin <= fixed) return 0;
    return (int)std::min((size_t)4, (optin - fixed) / ((size_t)Dh * Dh * r_size));
}

template <typename TR, typename TS>
cudaError_t launch_slstm(int B, int S, int H, int Dh, int n_smem, const float* w_in,
                         const void* rz, const void* ri, const void* rf, const void* ro, void* c,
                         void* n, void* hst, void* m, float* hout, void* scratch,
                         cudaStream_t stream) {
    const size_t bytes = (size_t)5 * Dh * sizeof(float) + (size_t)n_smem * Dh * Dh * sizeof(TR);
    auto kernel = slstm_scan_kernel<TR, TS>;
    if (bytes > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
    }
    const int threads = 4 * Dh <= 1024 ? 4 * Dh : 2 * Dh;
    kernel<<<B * H, threads, bytes, stream>>>(
        S, H, Dh, n_smem, w_in, static_cast<const TR*>(rz), static_cast<const TR*>(ri),
        static_cast<const TR*>(rf), static_cast<const TR*>(ro), static_cast<TS*>(c),
        static_cast<TS*>(n), static_cast<TS*>(hst), static_cast<TS*>(m), hout,
        static_cast<TR*>(scratch));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, h f32 [B, S, H, Dh] contiguous; the gates f32 [B, S, H] at the
// given element strides; C [B, H, Dh, Dh], n [B, H, Dh], m [B, H]
// contiguous, bf16 (state_bf16) or f32, updated in place; done: B * H
// zeroed ints of this launch's own.  Dh a multiple of 16 up to 384 (the wrapper
// checks).
int mlstm_scan_launch(int B, int S, int H, int Dh, int state_bf16, const void* q, const void* k,
                      const void* v, const void* gi, long long gi_sb, long long gi_st,
                      long long gi_sh, const void* gf, long long gf_sb, long long gf_st,
                      long long gf_sh, void* C, void* n, void* m, void* h, void* done,
                      void* stream) {
    const int cpl = (Dh + 31) / 32;
    if (Dh % 16 != 0 || cpl < 1 || cpl > MLSTM_MAX_CPL) return (int)cudaErrorInvalidValue;
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    const auto* gif = static_cast<const float*>(gi);
    const auto* gff = static_cast<const float*>(gf);
    auto* hf = static_cast<float*>(h);
    auto* dn = static_cast<int*>(done);
    auto st = static_cast<cudaStream_t>(stream);
    if (state_bf16)
        return (int)dispatch_mlstm<__nv_bfloat16>(cpl, B, S, H, Dh, qf, kf, vf, gif, gi_sb, gi_st,
                                                  gi_sh, gff, gf_sb, gf_st, gf_sh, C, n, m, hf,
                                                  dn, st);
    return (int)dispatch_mlstm<float>(cpl, B, S, H, Dh, qf, kf, vf, gif, gi_sb, gi_st, gi_sh,
                                      gff, gf_sb, gf_st, gf_sh, C, n, m, hf, dn, st);
}

// The number of the four recurrent matrices that slstm_scan_launch stages in
// shared memory for S steps at head dim Dh, r_size bytes a value (none for a
// single step); the rest need a scratch of B * H * (4 - that) * Dh * Dh
// values (not for a single step, which reads them in place).
int slstm_smem_gates(int S, int Dh, int r_size) { return slstm_gates_in_smem(S, Dh, r_size); }

// w_in f32 [B, S, 4 H Dh] contiguous; r_* [H, Dh, Dh] bf16 (r_bf16) or f32;
// the state c, n, h, m [B, H, Dh] bf16 (state_bf16) or f32, updated in
// place; h_out f32 [B, S, H, Dh]; scratch as slstm_smem_gates says (null
// when none is needed).  Dh a multiple of 16 up to 384.
int slstm_scan_launch(int B, int S, int H, int Dh, int r_bf16, int state_bf16, const void* w_in,
                      const void* rz, const void* ri, const void* rf, const void* ro, void* c,
                      void* n, void* h_state, void* m, void* h_out, void* scratch, void* stream) {
    if (Dh % 16 != 0 || Dh < 16 || Dh > 384) return (int)cudaErrorInvalidValue;
    const int n_smem = slstm_gates_in_smem(S, Dh, r_bf16 ? 2 : 4);
    if (n_smem < 4 && S > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const auto* w = static_cast<const float*>(w_in);
    auto* ho = static_cast<float*>(h_out);
    auto st = static_cast<cudaStream_t>(stream);
    void* sc = S > 1 ? scratch : nullptr;
    if (r_bf16 && state_bf16)
        return (int)launch_slstm<__nv_bfloat16, __nv_bfloat16>(B, S, H, Dh, n_smem, w, rz, ri, rf,
                                                              ro, c, n, h_state, m, ho, sc, st);
    if (r_bf16)
        return (int)launch_slstm<__nv_bfloat16, float>(B, S, H, Dh, n_smem, w, rz, ri, rf, ro, c,
                                                      n, h_state, m, ho, sc, st);
    if (state_bf16)
        return (int)launch_slstm<float, __nv_bfloat16>(B, S, H, Dh, n_smem, w, rz, ri, rf, ro, c,
                                                      n, h_state, m, ho, sc, st);
    return (int)launch_slstm<float, float>(B, S, H, Dh, n_smem, w, rz, ri, rf, ro, c, n, h_state,
                                           m, ho, sc, st);
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
