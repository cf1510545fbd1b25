// Hopper (sm_90a) flash decode: one query token per sequence over an
// append-only KV cache, f32 or bf16 in, f32 math, output in q's dtype.
//
// Replaces src/repro/kernels/flash_decode.py::flash_decode (the Pallas TPU
// kernel _decode_kernel, pallas_call at :108).  Same function: query head h
// of sequence b attends kv head h / G (G = H / KV) over cache positions
// lo <= j < kv_len, where kv_len is read on the card from an int32 (the
// Pallas kernel's SMEM scalar), so the host never waits for it, and lo is 0,
// or max(0, kv_len - window) for a sliding window (gemma2's local layers):
//   logit = (q * scale) . k_j,  softcap * tanh(logit / softcap) when softcap > 0
//   out = sum_{lo <= j < kv_len} exp(logit - m) v_j / max(sum exp(logit - m), 1e-20)
// with q and k_j of D dims and v_j and out of DV <= D (MLA: 192 and 128).
// Positions outside [lo, kv_len) are never read.  (The Pallas kernel masks
// those >= kv_len to -1e30 inside a visited block, where they weigh
// exp(-1e30 - m) = 0: the same sums.  It has no window: the reference runs
// windowed decode in XLA, src/repro/models/layers.py:111-153, with the mask
// kv_pos > q_pos - window, which is j >= lo for the query at kv_len - 1.)
//
// Bound on this card: the function must read the rows [lo, kv_len) of the
// cache once, B * (kv_len - lo) * KV * D * 2 tensors * (2 bytes in bf16): at
// the qwen decode (B=8, KV=2, D=128, kv_len ~1050) 8.6 MB, 2.6 us at 3.35
// TB/s; at Zamba2's shared block (KV=32, D=80) 86 MB, 26 us; at gemma2's
// (B=8, KV=8, D=256) 268 MB for the 4,096 rows a local layer's window
// admits, 80 us, and 524 MB for a global layer at kv_len 8,000, 156 us.  Its
// 4 D operations per position
// and query head are far below the operation bound: it is bytes-bound, and
// at these sizes a launch and the chain of dependent memory round trips
// inside it weigh as much as the bytes.
//
// Design: one launch, split-KV.  The reference grid, (B * KV, kv blocks)
// walked in order, gives only B * KV programs (16 at the qwen decode) for
// 132 SMs, so the cache is cut into `nsplit` ranges of whole TILE-row tiles
// (kernels/flash_decode.py::split_plan) and one CTA of 4 warps takes one
// (b, kv head, range).  The ranges start at lo, which each CTA computes on
// the card from kv_len: with a window the wrapper plans them over the
// window's rows, not over Smax, so a local layer's CTAs all fall inside
// [lo, kv_len) and none idles over rows before it.  K and V stay bf16 (or
// f32) in memory and are read with 16-byte loads straight into registers;
// nothing is staged in shared memory.  Each warp walks its own steps of
// rows; no barrier couples the warps until the end, where they merge with
// weights e^(m_w - M).  Two bodies, chosen by the wrapper
// (flash_decode.py::choose_body):
//   * Tensor cores (bf16, a query group of up to 16 heads, D = 64, 80, 96
//     or 128: qwen2.5, smollm, Zamba2's shared block and phi-3-vision;
//     gemma2's D = 256 takes the SIMT body): the group's heads are the 16 rows of mma.sync
//     m16n8k16, so q's fragments serve every head once and each loaded K
//     row serves all G heads in one product; 16 rows a warp step (the next
//     step's rows loaded before this step's products), S and P.V on the
//     tensor cores, P split in two bf16 terms (namespace tcd).
//   * SIMT (f32, other D such as gemma2's 256, larger groups): a row is
//     read by LPR lanes, neighbouring lanes on neighbouring 16 bytes, CPL
//     chunks a lane (few lanes a row where the registers allow, so more
//     rows are in flight),
//     converted to f32 in registers; a lane's partial dots are summed over
//     its row's lanes by shuffles and the softmax bookkeeping is done once
//     a step and head, spread over the warp's lanes; a query group is cut
//     into sets of at most 4 heads, one CTA a set, so a lane holds few
//     heads.  With DV < D (MLA's decode, D = 192, DV = 128; an
//     instantiation of its own, so equal dims keep their code) the lanes
//     that read a K row's D dims read its V row's DV, at V's own row
//     stride, and take zeros past DV: V is read once at its width.
// The CTA's partial (m, l, acc[G, D]) goes to an f32 scratch; then a
// __threadfence() and a ticket (atomicAdd on an int32 per (b, kv head,
// head set)): the CTA that draws the last ticket merges the nsplit
// partials, M = max m_s, out = sum acc_s e^(m_s - M) / max(sum l_s
// e^(m_s - M), 1e-20), writes out and puts the counter back to 0
// (finish_cta).  With one range the CTA writes out directly.  Ranges that
// start at or past kv_len contribute (m = -inf, l = 0, acc = 0) and read
// nothing; no range starts before lo, so no row before it is read or masked.
// Left for a later redesign: the tensor-core body at D = 256 and at MLA's
// (192, 128), a shorter chain of dependent memory round trips around the
// rows (q, partials, fence, ticket, merge), fewer instructions a row in the
// SIMT body, a persistent grid sized to the card, fusing the cache write of
// the new token, fp8 caches.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define DNT 128               // threads a CTA
#define DWARPS 4              // warps a CTA
#define MERGE_VALUES 8        // output values a thread of the merging CTA sums at once
#define MERGE_RANGES 8        // ranges whose partials it loads at once
#define ACC_BUDGET 40         // GC * CPL * VEC: accumulator floats a lane may hold

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of a row as floats: 8 bf16 or 4 f32.
__device__ __forceinline__ void unpack16(const uint4& r, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& r, float* f, const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// Chunk c (VEC elements from dim c * VEC) of a row: one 16-byte load when
// the rows are 16-byte aligned and the chunk lies inside D, else element by
// element with zeros past D.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int D, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int d0 = c * VEC;
  if (vec_ok && d0 + VEC <= D) return __ldg(reinterpret_cast<const uint4*>(row + d0));
  uint4 r;
  T* t = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int e = 0; e < VEC; ++e) t[e] = (d0 + e < D) ? row[d0 + e] : from_f32<T>(0.0f);
  return r;
}

// The CTA's result for heads g0 .. g0 + gn - 1 of its group: the DWARPS
// warps' running max and sum (wm, wl [DWARPS][hstride]) and accumulators
// (red [DWARPS][hstride][D], D here the output's width, V's) in shared
// memory merge with weights
// e^(m_w - M).  With one range (nsplit == 1) the CTA writes out (at
// out_base, the group's first head) directly; else it writes its partial
// (m, l, acc) at range pidx, and the CTA that draws the last ticket merges
// the ranges first .. first + nsplit - 1: M = max m_s, out = sum acc_s
// e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-20), then puts the ticket back
// to 0.  Barrier, then one thread's fence and atomic: the release covers
// the CTA's partial writes.  Called by every thread of the CTA.
template <typename T>
__device__ __forceinline__ void finish_cta(float* smem, float* red, float* wm, float* wl,
                                           int hstride, int g0, int gn, int G, int D,
                                           size_t out_base, size_t pidx, size_t first,
                                           int nparts, float* part, int* ticket, T* out) {
  __shared__ float hl[32];             // the CTA's sum per head (gn <= 16)
  __shared__ int is_last;
  const int tid = threadIdx.x, nsplit = gridDim.y;
  float* part_m = part;
  float* part_l = part + (size_t)nparts * G;
  float* part_acc = part + (size_t)2 * nparts * G;
  __syncthreads();
  if (tid < gn) {                  // per head: M, L and the warps' weights
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) M = fmaxf(M, wm[w * hstride + tid]);
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) {
      const float mw = wm[w * hstride + tid];
      const float wt = (mw == -INFINITY) ? 0.0f : expf(mw - M);
      wm[w * hstride + tid] = wt;
      L += wl[w * hstride + tid] * wt;
    }
    hl[tid] = L;
    if (nsplit > 1) {
      part_m[pidx * G + g0 + tid] = M;
      part_l[pidx * G + g0 + tid] = L;
    }
  }
  __syncthreads();
  for (int e = tid; e < gn * D; e += DNT) {
    const int g = e / D, d = e - g * D;
    float A = 0.0f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) A += red[(w * hstride + g) * D + d] * wm[w * hstride + g];
    if (nsplit == 1)
      out[out_base + (size_t)g0 * D + e] = from_f32<T>(A / fmaxf(hl[g], 1e-20f));
    else
      part_acc[(pidx * G + g0) * D + e] = A;
  }
  if (nsplit == 1) return;

  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(ticket, 1) == nsplit - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // Each output value's ranges are loaded (MERGE_RANGES at a time) after
  // the weights e^(m_s - M) and 1 / max(L, 1e-20) per head are computed.
  const int SG = nsplit * gn, GDs = gn * D;
  float* w_s = smem;                    // [nsplit][gn]: m, then the weights
  float* l_s = w_s + SG;                // [nsplit][gn]
  float* inv_s = l_s + SG;              // [gn]
  for (int e = tid; e < SG; e += DNT) {
    const int s = e / gn, g = e - s * gn;
    w_s[e] = __ldcg(part_m + (first + s) * G + g0 + g);
    l_s[e] = __ldcg(part_l + (first + s) * G + g0 + g);
  }
  __syncthreads();
  for (int g = tid; g < gn; g += DNT) {
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, w_s[s * gn + g]);
    float L = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const float ms = w_s[s * gn + g];
      const float wt = (ms == -INFINITY) ? 0.0f : expf(ms - M);
      w_s[s * gn + g] = wt;
      L += l_s[s * gn + g] * wt;
    }
    inv_s[g] = 1.0f / fmaxf(L, 1e-20f);
  }
  __syncthreads();
  T* out0 = out + out_base + (size_t)g0 * D;
  for (int e0 = 0; e0 < GDs; e0 += DNT * MERGE_VALUES) {
    float A[MERGE_VALUES];
    int hg[MERGE_VALUES];              // each value's head in the set
#pragma unroll
    for (int j = 0; j < MERGE_VALUES; ++j) {
      A[j] = 0.0f;
      hg[j] = (e0 + tid + j * DNT) / D;
    }
    for (int r0 = 0; r0 < nsplit; r0 += MERGE_RANGES) {
      float t[MERGE_RANGES][MERGE_VALUES];
#pragma unroll
      for (int r = 0; r < MERGE_RANGES; ++r)
#pragma unroll
        for (int j = 0; j < MERGE_VALUES; ++j) {
          const int e = e0 + tid + j * DNT;
          t[r][j] = (r0 + r < nsplit && e < GDs)
                        ? __ldcg(part_acc + ((first + r0 + r) * G + g0) * D + e)
                        : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < MERGE_RANGES; ++r) {
        if (r0 + r >= nsplit) break;
#pragma unroll
        for (int j = 0; j < MERGE_VALUES; ++j)
          if (hg[j] < gn) A[j] += t[r][j] * w_s[(r0 + r) * gn + hg[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < MERGE_VALUES; ++j) {
      const int e = e0 + tid + j * DNT;
      if (e < GDs) out0[e] = from_f32<T>(A[j] * inv_s[hg[j]]);
    }
  }
  if (tid == 0) *ticket = 0;
}

// Rows a lane group loads at once: as many as ~200 registers hold beside
// the lane's q and accumulators (GC x E each), its logits (U x GC) and one
// row of floats (E), with K and V of two steps in flight (16 CPL a row);
// 1 to 4.
template <int CPL, int GC, int VEC>
struct RowsAtOnce {
  static constexpr int E = CPL * VEC;
  static constexpr int raw = (200 - 2 * GC * E - E) / (16 * CPL + GC);
  static constexpr int value = raw < 1 ? 1 : (raw > 4 ? 4 : raw);
};

// CPL chunks of VEC elements a lane, up to GC query heads a CTA.  NARROW:
// V's head dim dv < D (MLA); the other instantiation takes DV = D, so the
// body for equal dims is the one it was before V had a width of its own.
template <typename T, int CPL, int GC, bool NARROW>
__global__ void __launch_bounds__(DNT)
flash_decode_kernel(int Smax, int KV, int G, int D, int dv, int lpr, int hsplit, int split_len,
                    int window, float scale, float softcap, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ kv_len_ptr,
                    float* __restrict__ part, int* __restrict__ tickets, T* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int E = CPL * VEC;                           // dims a lane holds
  constexpr int U = RowsAtOnce<CPL, GC, VEC>::value;
  const int DV = NARROW ? dv : D;
  extern __shared__ float smem[];
  const int rpw = 32 / lpr;                              // rows a warp reads at once
  const int wrows = rpw * U;                             // rows a warp step
  const int wstep = DWARPS * wrows;                      // rows from a warp's step to its next
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* lgw = smem + warp * wrows * GC;                 // [wrows][GC] the warp's logits, then p
  float* alw = smem + DWARPS * wrows * GC + warp * GC;   // [GC] the warp's rescale
  float* red = smem + DWARPS * (wrows + 1) * GC;         // [DWARPS][GC][DV] accumulators
  float* wm = red + DWARPS * GC * DV;                    // [DWARPS][GC] running max, then weight
  float* wl = wm + DWARPS * GC;                          // [DWARPS][GC] running sum

  // blockIdx.x = (b KV + kv head) hsplit + head set: the group's G heads
  // are cut into hsplit sets of at most GC, one CTA a set, so that a lane
  // holds few heads and more rows are in flight.
  const int bkv = blockIdx.x / hsplit, hs = blockIdx.x - bkv * hsplit;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int nparts = (gridDim.x / hsplit) * nsplit;
  const int b = bkv / KV, kvh = bkv - b * KV, H = KV * G;
  const int hper = (G + hsplit - 1) / hsplit;            // heads a set (<= GC)
  const int g0 = hs * hper, gn = max(0, min(hper, G - g0));
  const int grp = lane / lpr, sub = lane - grp * lpr;   // row group, lane in it
  int kv_len = *kv_len_ptr;
  kv_len = kv_len < 0 ? 0 : (kv_len > Smax ? Smax : kv_len);
  const int lo = window > 0 ? max(0, kv_len - window) : 0;   // the window's first row
  const int s0 = lo + split * split_len;
  const int s1 = min(s0 + split_len, kv_len);
  const bool vec_ok = D % VEC == 0, vvec_ok = NARROW ? DV % VEC == 0 : vec_ok;
  const size_t row_stride = (size_t)KV * D, vrow_stride = NARROW ? (size_t)KV * DV : row_stride;
  const T* kbase = k + ((size_t)b * Smax * KV + kvh) * D;
  const T* vbase = v + ((size_t)b * Smax * KV + kvh) * DV;
  const size_t pidx = (size_t)bkv * nsplit + split;

  float qf[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      float* f = &qf[g][i * VEC];
      if (g < gn) {
        unpack16(load_chunk(q + ((size_t)b * H + kvh * G + g0 + g) * D, sub + lpr * i, D,
                            vec_ok),
                 f, (const T*)nullptr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] *= scale;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.0f;
      }
    }
  float acc[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  // The warp's running max and sum of head lane % GC (every lane holds
  // those of one head: the bookkeeping below puts head g on lanes = g mod GC).
  float m_run = -INFINITY, l_run = 0.0f;

  // Warp w walks rows c0 + grp + u rpw, c0 = s0 + w wrows + n wstep; the
  // next step's K and V are loaded before this step's math.
  uint4 kn[U][CPL], vn[U][CPL];
  auto load_rows = [&](int c0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = c0 + grp + u * rpw;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        if (row < s1) {
          kn[u][i] = load_chunk(kbase + row * row_stride, sub + lpr * i, D, vec_ok);
          vn[u][i] = load_chunk(vbase + row * vrow_stride, sub + lpr * i, DV, vvec_ok);
        } else {
          kn[u][i] = make_uint4(0, 0, 0, 0);
          vn[u][i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  };
  const int first_row = s0 + warp * wrows;
  if (first_row < s1) load_rows(first_row);
  for (int c0 = first_row; c0 < s1; c0 += wstep) {       // uniform over the warp
    uint4 kr[U][CPL], vr[U][CPL];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        kr[u][i] = kn[u][i];
        vr[u][i] = vn[u][i];
      }
    if (c0 + wstep < s1) load_rows(c0 + wstep);

    // Logits: the lane's partial dots, summed over the row's lpr lanes
    // (aligned groups); past s1 -inf.
    float x[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int i = 0; i < CPL; ++i) unpack16(kr[u][i], kf + i * VEC, (const T*)nullptr);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // 4 chains, not one of E
#pragma unroll
        for (int e = 0; e < E; ++e) dot[e & 3] = fmaf(qf[g][e], kf[e], dot[e & 3]);
        x[u][g] = (dot[0] + dot[1]) + (dot[2] + dot[3]);
      }
    }
    for (int off = lpr >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GC; ++g) x[u][g] += __shfl_xor_sync(0xffffffffu, x[u][g], off);
    if (sub == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = grp + u * rpw;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float t = x[u][g];
          if (softcap > 0.0f) t = softcap * tanhf(t / softcap);
          lgw[r * GC + g] = c0 + r < s1 ? t : -INFINITY;
        }
      }
    }
    __syncwarp();

    // Softmax bookkeeping once a step and head: lane l takes the (row,
    // head) entries l, l + 32, ... of [wrows][GC], all of head l % GC.
    float mx = -INFINITY;
    for (int e = lane; e < wrows * GC; e += 32) mx = fmaxf(mx, lgw[e]);
    for (int off = GC; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);          // finite: the step's row c0 is valid
    float ps = 0.0f;
    for (int e = lane; e < wrows * GC; e += 32) {
      const float p = expf(lgw[e] - m_new);         // 0 past s1
      lgw[e] = p;
      ps += p;
    }
    for (int off = GC; off < 32; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
    const float alpha = expf(m_run - m_new);       // 0 on the warp's first step
    l_run = l_run * alpha + ps;
    m_run = m_new;
    if (lane < GC) alw[lane] = alpha;
    __syncwarp();

    // acc = acc alpha + sum over the lane's rows of p v.
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float a = alw[g];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = grp + u * rpw;
      float vf[E];
#pragma unroll
      for (int i = 0; i < CPL; ++i) unpack16(vr[u][i], vf + i * VEC, (const T*)nullptr);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = lgw[r * GC + g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncwarp();                  // lgw and alw are the next step's
  }

  // Sum the accumulators over the warp's row groups (one running max in a
  // warp), then merge the warps with weights e^(m_w - M).
  for (int off = lpr; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int d = (sub + lpr * i) * VEC + e;
          if (g < gn && d < DV) red[(warp * GC + g) * DV + d] = acc[g][i * VEC + e];
        }
  }
  if (lane < GC) {
    wm[warp * GC + lane] = m_run;
    wl[warp * GC + lane] = l_run;
  }
  finish_cta(smem, red, wm, wl, GC, g0, gn, G, DV, ((size_t)b * H + kvh * G) * DV, pidx,
             (size_t)bkv * nsplit, nparts, part, tickets + blockIdx.x, out);
}

template <typename T, int CPL, int GC, bool NARROW>
static int launch(int B, int Smax, int H, int KV, int D, int DV, int lpr, int hsplit, int nsplit,
                  int split_len, int window, float scale, float softcap, const void* q,
                  const void* k, const void* v, const void* kv_len, void* part, void* tickets,
                  void* out, cudaStream_t stream) {
  const int G = H / KV;
  const int wrows = (32 / lpr) * RowsAtOnce<CPL, GC, 16 / sizeof(T)>::value;
  const int pass_floats = DWARPS * (wrows + 1) * GC + DWARPS * GC * DV + 2 * DWARPS * GC;
  const int merge_floats = 2 * nsplit * GC + GC;
  const size_t smem =
      (size_t)(pass_floats > merge_floats ? pass_floats : merge_floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<T, CPL, GC, NARROW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * KV * hsplit, nsplit);
  flash_decode_kernel<T, CPL, GC, NARROW><<<grid, DNT, smem, stream>>>(
      Smax, KV, G, D, DV, lpr, hsplit, split_len, window, scale, softcap, (const T*)q,
      (const T*)k, (const T*)v, (const int*)kv_len, (float*)part, (int*)tickets, (T*)out);
  return (int)cudaGetLastError();
}

// Lanes a row and chunks a lane: the fewest lanes a row (more rows in
// flight) whose chunks, rounded up to a compiled CPL (1, 2, 4, 5), keep the
// lane's accumulators within ACC_BUDGET floats; else one chunk a lane, or
// at most 32 lanes a row (f32 rows of more than 128 values take 2 chunks).
// A lane's chunks are those of K's rows (D); a V row (DV <= D) is read by
// the same lanes, its chunks past DV as zeros that nothing reads.
template <typename T>
static int dispatch(int B, int Smax, int H, int KV, int D, int DV, int hsplit, int nsplit,
                    int split_len, int window, float scale, float softcap, const void* q,
                    const void* k, const void* v, const void* kv_len, void* part, void* tickets,
                    void* out, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = (D + VEC - 1) / VEC;
  const int hper = (H / KV + hsplit - 1) / hsplit;
  const int gc = hper <= 1 ? 1 : (hper <= 2 ? 2 : 4);
  int lpr = 1, cpl = 1;
  for (;; lpr <<= 1) {
    const int need = (chunks + lpr - 1) / lpr;
    cpl = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 5 ? 5 : 0;
    if (lpr == 32 || cpl == 1 || (cpl > 0 && gc * cpl * VEC <= ACC_BUDGET)) break;
  }
#define FD_CASE(C, N)                                                                       \
  if (cpl == C && gc == N)                                                                  \
    return DV == D ? launch<T, C, N, false>(B, Smax, H, KV, D, DV, lpr, hsplit, nsplit,       \
                                            split_len, window, scale, softcap, q, k, v, kv_len, \
                                            part, tickets, out, stream)                         \
                   : launch<T, C, N, true>(B, Smax, H, KV, D, DV, lpr, hsplit, nsplit,        \
                                           split_len, window, scale, softcap, q, k, v, kv_len,  \
                                           part, tickets, out, stream);
  FD_CASE(1, 1) FD_CASE(1, 2) FD_CASE(1, 4) FD_CASE(2, 1) FD_CASE(2, 2) FD_CASE(4, 1)
  FD_CASE(5, 1)
  if constexpr (VEC == 4) {             // f32: 4 values a chunk, so larger CPL fit
    FD_CASE(2, 4) FD_CASE(4, 2) FD_CASE(5, 2)
  }
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core body: bf16, 1 <= G <= 16, D = 64, 80, 96 or 128
// ---------------------------------------------------------------------------
// The query group's G heads are the 16 rows of mma.sync.m16n8k16 (rows past
// G are zeros), so q's fragments, held once by every lane, serve all heads
// and the registers go to rows of K and V in flight.  A warp takes 16
// cache rows a step: S = Q K^T as two 16 x 8 tiles, the online softmax on
// the accumulator fragments (a head's 16 logits live in the 4 lanes of a
// quad), then O += P_hi V + P_lo V with P from the S fragments (P split in
// two bf16 terms, as in flash_attention.cu).  K and V are read with 16-byte
// loads straight into the mma operands: a dot product does not depend on
// the order of its dims, so each 16-dim k-step uses, in every lane, the
// dims its own 16-byte chunk holds, for q and K alike; P.V's output columns
// are permuted the same way (column c of n8-block nb of 64-column group J
// is dim 64 J + 8 c + nb) and put back when the warps merge.
namespace tcd {

constexpr int MH = 16;                 // mma rows: query heads, padded
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes of a bf16 row at element `off`, zeros when !ok.
__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : (i == 1 ? r.y : (i == 2 ? r.z : r.w));
}

template <int D>
__global__ void __launch_bounds__(DNT)
flash_decode_mma_kernel(int Smax, int KV, int G, int split_len, int window, float scale,
                        float softcap,
                        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len_ptr,
                        float* __restrict__ part, int* __restrict__ tickets,
                        __nv_bfloat16* __restrict__ out) {
  constexpr int NCH = D / 8;           // 16-byte chunks of a row
  constexpr int KJ = (D + 31) / 32;    // K chunks a lane holds of a row (tig + 4 j < NCH)
  constexpr int VJ = (D + 63) / 64;    // 64-column groups of P.V (8 J + gid < NCH)
  extern __shared__ float smem[];
  float* red = smem;                   // [DWARPS][MH][D]
  float* wm = red + DWARPS * MH * D;   // [DWARPS][MH]
  float* wl = wm + DWARPS * MH;        // [DWARPS][MH]
  const int bkv = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = bkv / KV, kvh = bkv - b * KV, H = KV * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  int kv_len = *kv_len_ptr;
  kv_len = kv_len < 0 ? 0 : (kv_len > Smax ? Smax : kv_len);
  const int lo = window > 0 ? max(0, kv_len - window) : 0;   // the window's first row
  const int s0 = lo + split * split_len;
  const int s1 = min(s0 + split_len, kv_len);
  const size_t row_stride = (size_t)KV * D;
  const __nv_bfloat16* kbase = k + ((size_t)b * Smax * KV + kvh) * D;
  const __nv_bfloat16* vbase = v + ((size_t)b * Smax * KV + kvh) * D;
  const __nv_bfloat16* qbase = q + ((size_t)b * H + kvh * G) * D;

  // q's A fragments: head gid (and gid + 8), chunk tig + 4 j of its row.
  uint4 qa[KJ], qb[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const bool in_row = tig + 4 * j < NCH;
    qa[j] = ld16(qbase + (size_t)gid * D + 8 * (tig + 4 * j), in_row && gid < G);
    qb[j] = ld16(qbase + (size_t)(gid + 8) * D + 8 * (tig + 4 * j), in_row && gid + 8 < G);
  }

  float o[8 * VJ][4];                  // n8-block nb of group J is o[8 J + nb]
#pragma unroll
  for (int n = 0; n < 8 * VJ; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;   // heads gid, gid + 8
  const float scale_log2 = scale * LOG2E;

  // K rows r0 + 8 t + gid (the n of S tile t), chunks tig + 4 j; V rows
  // r0 + 2 tig + {0, 1, 8, 9} (P.V's k), chunk 8 J + gid.  The next step's
  // rows are loaded before this step's products.
  uint4 kn[2][KJ], vn[4][VJ];
  auto load_step = [&](int r0) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int row = r0 + 8 * t + gid;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kn[t][j] = ld16(kbase + (size_t)row * row_stride + 8 * (tig + 4 * j),
                        row < s1 && tig + 4 * j < NCH);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 2 * tig + (i & 1) + 8 * (i >> 1);
#pragma unroll
      for (int J = 0; J < VJ; ++J)
        vn[i][J] = ld16(vbase + (size_t)row * row_stride + 8 * (8 * J + gid),
                        row < s1 && 8 * J + gid < NCH);
    }
  };
  if (s0 + 16 * warp < s1) load_step(s0 + 16 * warp);
  for (int r0 = s0 + 16 * warp; r0 < s1; r0 += 16 * DWARPS) {   // uniform over the warp
    uint4 kr[2][KJ], vr[4][VJ];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < KJ; ++j) kr[t][j] = kn[t][j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int J = 0; J < VJ; ++J) vr[i][J] = vn[i][J];
    if (r0 + 16 * DWARPS < s1) load_step(r0 + 16 * DWARPS);

    // S = Q K^T: k-step (j, h) takes words 2 h, 2 h + 1 of each chunk j.
    float s[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma_bf16(s[t], word(qa[j], 2 * h), word(qb[j], 2 * h), word(qa[j], 2 * h + 1),
                   word(qb[j], 2 * h + 1), word(kr[t][j], 2 * h), word(kr[t][j], 2 * h + 1));
    }

    // Scale (log2 domain), softcap, mask past s1; s[t][i]: head gid (i < 2)
    // or gid + 8, row r0 + 8 t + 2 tig + (i & 1).
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = softcap > 0.0f ? softcap * tanhf(s[t][i] * scale / softcap) * LOG2E
                                 : s[t][i] * scale_log2;
        x = (r0 + 8 * t + 2 * tig + (i & 1) < s1) ? x : -INFINITY;
        s[t][i] = x;
        if (i < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);   // finite: row r0 is valid
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);   // 0 on the first step
    m0 = mn0;
    m1 = mn1;
    float p[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[t][i] = exp2f(s[t][i] - (i < 2 ? mn0 : mn1));
    l0 = l0 * a0 + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
    l1 = l1 * a1 + (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
#pragma unroll
    for (int n = 0; n < 8 * VJ; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // P as A fragments (tile 0 = keys 0..7, tile 1 = keys 8..15), in two
    // bf16 terms.
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = r >> 1, i = 2 * (r & 1);     // a0: t0 rows gid; a1: t0 gid+8; ...
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[t][i], p[t][i + 1]);
      ph[r] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[r] = pack_bf16(p[t][i] - __low2float(hi), p[t][i + 1] - __high2float(hi));
    }
    // O += P V: B of n8-block (J, nb) = V[rows 2 tig, 2 tig + 1][col] and
    // V[rows 2 tig + 8, 2 tig + 9][col], col = element nb of chunk 8 J + gid.
#pragma unroll
    for (int J = 0; J < VJ; ++J)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const uint32_t sel = (nb & 1) ? 0x7632 : 0x5410;
        const uint32_t b0 = __byte_perm(word(vr[0][J], nb >> 1), word(vr[1][J], nb >> 1), sel);
        const uint32_t b1 = __byte_perm(word(vr[2][J], nb >> 1), word(vr[3][J], nb >> 1), sel);
        mma_bf16(o[8 * J + nb], ph[0], ph[1], ph[2], ph[3], b0, b1);
        mma_bf16(o[8 * J + nb], pl[0], pl[1], pl[2], pl[3], b0, b1);
      }
  }

  // The quad's partial sums, then each warp's O (dims put back in order),
  // max and sum per head to shared memory for finish_cta.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int J = 0; J < VJ; ++J)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 64 * J + 8 * (2 * tig + c) + nb;
        if (d >= D) continue;
        if (gid < G) red[(warp * MH + gid) * D + d] = o[8 * J + nb][c];
        if (gid + 8 < G) red[(warp * MH + gid + 8) * D + d] = o[8 * J + nb][2 + c];
      }
  if (tig == 0) {                      // m back from the log2 domain for finish_cta
    wm[warp * MH + gid] = m0 * (1.0f / LOG2E);
    wl[warp * MH + gid] = l0;
    wm[warp * MH + gid + 8] = m1 * (1.0f / LOG2E);
    wl[warp * MH + gid + 8] = l1;
  }
  finish_cta(smem, red, wm, wl, MH, 0, G, G, D, ((size_t)b * H + kvh * G) * D,
             (size_t)bkv * nsplit + split, (size_t)bkv * nsplit, gridDim.x * nsplit, part,
             tickets + blockIdx.x, out);
}

template <int D>
static int launch_mma(int B, int Smax, int H, int KV, int nsplit, int split_len, int window,
                      float scale, float softcap, const void* q, const void* k, const void* v,
                      const void* kv_len, void* part, void* tickets, void* out,
                      cudaStream_t stream) {
  const int G = H / KV;
  const int pass_floats = DWARPS * MH * D + 2 * DWARPS * MH;
  const int merge_floats = 2 * nsplit * G + G;
  const size_t smem =
      (size_t)(pass_floats > merge_floats ? pass_floats : merge_floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * KV, nsplit);
  flash_decode_mma_kernel<D><<<grid, DNT, smem, stream>>>(
      Smax, KV, G, split_len, window, scale, softcap, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const int*)kv_len, (float*)part,
      (int*)tickets, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

static int dispatch_mma(int B, int Smax, int H, int KV, int D, int nsplit, int split_len,
                        int window, float scale, float softcap, const void* q, const void* k,
                        const void* v, const void* kv_len, void* part, void* tickets,
                        void* out, cudaStream_t stream) {
  switch (D) {
#define FD_MMA_CASE(N)                                                                       \
  case N:                                                                                    \
    return launch_mma<N>(B, Smax, H, KV, nsplit, split_len, window, scale, softcap, q, k, v, \
                         kv_len, part, tickets, out, stream);
    FD_MMA_CASE(64) FD_MMA_CASE(80) FD_MMA_CASE(96) FD_MMA_CASE(128)
#undef FD_MMA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tcd

// dtype: 0 = float32, 1 = bfloat16; body: 0 = SIMT, 1 = tensor cores (bf16,
// G <= 16, D = DV = 64, 80, 96 or 128, hsplit = 1); softcap <= 0: none; window
// <= 0: none, else the rows [max(0, kv_len - window), kv_len).  q
// [B, 1, H, D], k [B, Smax, KV, D], v [B, Smax, KV, DV], out [B, 1, H, DV],
// all contiguous; kv_len one int32 on the card; part f32: m and l (B * KV *
// nsplit * G each), then acc (B * KV * nsplit * G * DV); tickets
// int32[B * KV * hsplit], all 0 on entry and left 0; the G query heads of a
// kv head in hsplit sets of at most 4 (SIMT); nsplit * split_len >= Smax, or
// >= window with a window; DV <= D <= 256.
extern "C" int flash_decode_launch(int B, int Smax, int H, int KV, int D, int DV, int dtype,
                                   int body, int hsplit, int nsplit, int split_len, int window,
                                   float scale, float softcap, const void* q, const void* k,
                                   const void* v, const void* kv_len, void* part, void* tickets,
                                   void* out, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (D > 256 || D <= 0 || DV <= 0 || DV > D || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    if (dtype != 1 || hsplit != 1 || H / KV > tcd::MH || DV != D)
      return (int)cudaErrorInvalidValue;
    return tcd::dispatch_mma(B, Smax, H, KV, D, nsplit, split_len, window, scale, softcap, q,
                             k, v, kv_len, part, tickets, out, s);
  }
  if (body != 0 || hsplit <= 0 || hsplit > H / KV || 4 * hsplit < H / KV)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(B, Smax, H, KV, D, DV, hsplit, nsplit, split_len, window, scale,
                           softcap, q, k, v, kv_len, part, tickets, out, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(B, Smax, H, KV, D, DV, hsplit, nsplit, split_len, window,
                                   scale, softcap, q, k, v, kv_len, part, tickets, out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
