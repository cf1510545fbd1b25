// Hopper (sm_90a) kernels for the data movement of the MoE layer: routing
// with its capacity cut (dispatch), and the weighted sum of the experts'
// outputs (combine).
//
// Replace no TPU kernel: the reference runs models/moe.py::_moe_apply_global's
// top-k, renormalisation and sort-based dispatch (src/repro/models/moe.py:70-
// 112) and its combine (:114-121) as XLA ops.  In eager PyTorch they are some
// thirty launches a layer (sort, gathers, a bincount, a cumsum, the scatter
// into a zeroed buffer, k rounds of gather, multiply and add); here two.
//
//   moe_dispatch: for probs f32 [T, E] (the router's softmax) and x [T, d]:
//     idx i32 [T, k], token t's k experts in top_k's order (descending
//     probability, the lower expert first on ties); gates f32 [T, k], each
//     probability over max(their sum, 1e-9), the sum taken one term at a
//     time in that order; the rank of entry (t, j) among expert idx[t, j]'s
//     entries in flat order t k + j (the reference's stable argsort), slot =
//     rank where rank < capacity, else -1 (dropped); counts i32 [E], the
//     entries routed to each expert before the cut; buf [E, capacity, d] in
//     x's dtype, buf[e, r] = x[t] for the kept entry of rank r, zero past
//     min(counts[e], capacity).
//   moe_combine: y[t] = sum over token t's kept entries in ascending expert
//     id, from 0.0, of f32(h[e, slot]) * gate, each product and sum rounded
//     on its own; then + f32(shared[t]) where given; cast once to h's dtype
//     (round to nearest even).
//
// Bound on this card: bytes.  The dispatch reads probs and the kept tokens'
// rows of x and writes the whole buffer, zeros included (granite's prefill:
// 8,192 x 32 probabilities, 16 MB of x, a 168 MB buffer); the combine reads
// the kept rows of h and writes y.  Their arithmetic (E compares an entry,
// k products an element) is far below any rate.
//
// Design.  Dispatch: a CTA per (expert, copy split).  Since a token names an
// expert at most once, an expert's entries in flat order are its tokens in
// order, so the CTA walks the tokens 512 at a time: each thread finds the
// rank of the CTA's expert in its token's row (E compares), a block-wide
// scan of "chose e" gives each choosing token its rank, the carry runs on to
// the next 512.  The kept rows of the step are then copied by the whole
// CTA, 16 bytes a thread where the rows allow it; CTA (e, s) of S copies the
// ranks congruent to s mod S, so that E x S CTAs fill the card.  Split
// (step mod S) writes a step's idx, gates and slot (the renormalising sum
// reads the token's row k times), split 0 the counts.  A row is read 16
// bytes at a time where E is a multiple of 4.  Combine: a CTA a token; thread 0
// sorts the token's kept entries by expert id into shared memory, then each
// thread sums 16 bytes of the row (8 bf16 or 4 f32) over them.
//
// Bit-exact with the plain versions (kernels/ref.py::moe_dispatch_ref,
// moe_combine_ref): the rank test is the stable descending sort's order; the
// renormalising sum is sequential, the division IEEE (__fdiv_rn), the max
// fmaxf against 1e-9f; rows are copied as bits; the combine's products and
// sums are rounded on their own (__fmul_rn, __fadd_rn; built with
// -fmad=false) and the output conversion rounds to nearest even.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;           // dispatch: tokens a scan step
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;               // experts a token at most (combine)
constexpr unsigned kFull = 0xffffffffu;

enum ValueType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// f(j, row[j]) for each value of a token's row in index order, four at a
// time (one 16-byte load) when V4 (E a multiple of 4, rows 16-byte aligned).
template <bool V4, typename F>
__device__ __forceinline__ void for_row(const float* __restrict__ row, int E, F f) {
  if constexpr (V4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int q = 0; q < E / 4; ++q) {
      const float4 v = r4[q];
      f(4 * q, v.x);
      f(4 * q + 1, v.y);
      f(4 * q + 2, v.z);
      f(4 * q + 3, v.w);
    }
  } else {
    for (int j = 0; j < E; ++j) f(j, row[j]);
  }
}

// Rank of expert e in a token's row in top_k's order: descending value, the
// lower index first on ties.
template <bool V4>
__device__ __forceinline__ int rank_of(const float* __restrict__ row, int E, int e) {
  const float pe = row[e];
  int r = 0;
  for_row<V4>(row, E, [&](int j, float pj) { r += (pj > pe) || (pj == pe && j < e); });
  return r;
}

// The sum of a row's k largest values, added one at a time in top_k's order.
template <bool V4>
__device__ float topk_sum(const float* __restrict__ row, int E, int k) {
  float prev = 0.0f, sum = 0.0f;
  int prev_j = -1;
  for (int p = 0; p < k; ++p) {
    float best = 0.0f;
    int best_j = -1;
    for_row<V4>(row, E, [&](int j, float v) {
      const bool after = p == 0 || v < prev || (v == prev && j > prev_j);
      if (after && (best_j < 0 || v > best)) {
        best = v;
        best_j = j;
      }
    });
    sum = p == 0 ? best : __fadd_rn(sum, best);
    prev = best;
    prev_j = best_j;
  }
  return sum;
}

// Exclusive prefix sum of flag over the CTA; *total is the CTA's sum.
__device__ __forceinline__ int block_exclusive_scan(int flag, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = flag;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = (warp == 0 ? 0 : warp_sums[warp - 1]) + x - flag;
  *total = warp_sums[kWarps - 1];
  __syncthreads();                      // warp_sums is rewritten by the next scan
  return excl;
}

// Copy (src != nullptr) or zero n rows of an expert's buffer: row i of the
// n is rank first + i * stride; its source is x's row src[i].  A warp a row,
// a lane a unit of V.
template <typename V>
__device__ __forceinline__ void move_rows(const V* __restrict__ x, V* __restrict__ ebuf, int units,
                                          const int* src, int first, int stride, int n) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < n; i += warps) {
    V* dst = ebuf + (size_t)(first + i * stride) * units;
    if (src != nullptr) {
      const V* from = x + (size_t)src[i] * units;
      for (int u = lane; u < units; u += 32) dst[u] = from[u];
    } else {
      for (int u = lane; u < units; u += 32) dst[u] = V{};
    }
  }
}

template <typename V, bool V4>
__global__ void __launch_bounds__(kThreads) moe_dispatch_kernel(
    int T, int E, int k, int capacity, int units, const float* __restrict__ probs,
    const V* __restrict__ x, int* __restrict__ idx, float* __restrict__ gates,
    int* __restrict__ slot, int* __restrict__ counts, V* __restrict__ buf) {
  __shared__ int warp_sums[kWarps];
  __shared__ int rows[kThreads];        // the step's kept tokens, by rank
  __shared__ int picked[kThreads];      // rows[] this CTA copies
  const int e = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  V* ebuf = buf + (size_t)e * capacity * units;
  int carry = 0;                        // entries of e before this step
  for (int base = 0; base < T; base += kThreads) {
    const int t = base + threadIdx.x;
    const float* row = probs + (size_t)t * E;
    const int pos = t < T ? rank_of<V4>(row, E, e) : k;
    const int chose = pos < k;
    int total;
    const int excl = block_exclusive_scan(chose, warp_sums, &total);
    const int rank = carry + excl;
    if (chose) {
      if (rank < capacity) rows[excl] = t;
      if ((base / kThreads) % S == s) {   // one split an expert writes a step's entries
        const size_t at = (size_t)t * k + pos;
        idx[at] = e;
        gates[at] = __fdiv_rn(row[e], fmaxf(topk_sum<V4>(row, E, k), 1e-9f));
        slot[at] = rank < capacity ? rank : -1;
      }
    }
    __syncthreads();
    // the step's kept ranks are carry .. carry + kept - 1; this CTA's are
    // those congruent to s mod S
    const int kept = max(0, min(total, capacity - carry));
    const int i0 = ((s - carry) % S + S) % S;
    const int n = kept > i0 ? (kept - i0 + S - 1) / S : 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) picked[i] = rows[i0 + i * S];
    __syncthreads();
    move_rows(x, ebuf, units, picked, carry + i0, S, n);
    __syncthreads();                    // rows[] and picked[] are rewritten next step
    carry += total;
  }
  const int start = min(carry, capacity);
  const int i0 = ((s - start) % S + S) % S;
  const int n = capacity - start > i0 ? (capacity - start - i0 + S - 1) / S : 0;
  move_rows<V>(nullptr, ebuf, units, nullptr, start + i0, S, n);
  if (s == 0 && threadIdx.x == 0) counts[e] = carry;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// VEC neighbouring values from p (16 bytes at once when VEC * sizeof(Tv) ==
// 16, else one at a time).
template <typename Tv, int VEC>
__device__ __forceinline__ void load_vec(const Tv* __restrict__ p, float v[VEC]) {
  if constexpr (VEC * sizeof(Tv) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const Tv* h = reinterpret_cast<const Tv*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(h[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(p[j]);
  }
}

template <typename Tv, int VEC>
__global__ void moe_combine_kernel(int k, int capacity, int d, const Tv* __restrict__ h,
                                   const int* __restrict__ idx, const int* __restrict__ slot,
                                   const float* __restrict__ gates, const Tv* __restrict__ shared,
                                   Tv* __restrict__ out) {
  __shared__ int se[kMaxK], ss[kMaxK];
  __shared__ float sg[kMaxK];
  __shared__ int sn;
  const int t = blockIdx.x;
  if (threadIdx.x == 0) {               // kept entries by ascending expert id
    int n = 0;
    for (int j = 0; j < k; ++j) {
      const int sl = slot[(size_t)t * k + j];
      if (sl < 0) continue;
      const int e = idx[(size_t)t * k + j];
      const float g = gates[(size_t)t * k + j];
      int p = n++;
      while (p > 0 && se[p - 1] > e) {
        se[p] = se[p - 1];
        ss[p] = ss[p - 1];
        sg[p] = sg[p - 1];
        --p;
      }
      se[p] = e;
      ss[p] = sl;
      sg[p] = g;
    }
    sn = n;
  }
  __syncthreads();
  const int n = sn;
  for (int c = threadIdx.x * VEC; c < d; c += blockDim.x * VEC) {
    float acc[VEC], v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    for (int m = 0; m < n; ++m) {
      load_vec<Tv, VEC>(h + ((size_t)se[m] * capacity + ss[m]) * d + c, v);
      const float g = sg[m];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], g));
    }
    if (shared != nullptr) {
      load_vec<Tv, VEC>(shared + (size_t)t * d + c, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
    }
    Tv* o = out + (size_t)t * d + c;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = from_f32<Tv>(acc[j]);
  }
}

template <typename Tv>
int launch_combine(int T, int k, int capacity, int d, int vec, const void* h, const int* idx,
                   const int* slot, const float* gates, const void* shared, void* out,
                   cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(Tv);
  const int per = vec ? kVec : 1;
  int threads = (d / per + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const Tv* hv = (const Tv*)h;
  const Tv* sv = (const Tv*)shared;
  if (vec) {
    moe_combine_kernel<Tv, kVec><<<T, threads, 0, st>>>(k, capacity, d, hv, idx, slot, gates, sv,
                                                        (Tv*)out);
  } else {
    moe_combine_kernel<Tv, 1><<<T, threads, 0, st>>>(k, capacity, d, hv, idx, slot, gates, sv,
                                                     (Tv*)out);
  }
  return (int)cudaGetLastError();
}

template <typename V, bool V4>
void launch_dispatch(dim3 grid, cudaStream_t st, int T, int E, int k, int capacity, int units,
                     const float* probs, const void* x, void* idx, void* gates, void* slot,
                     void* counts, void* buf) {
  moe_dispatch_kernel<V, V4><<<grid, kThreads, 0, st>>>(
      T, E, k, capacity, units, probs, (const V*)x, (int*)idx, (float*)gates, (int*)slot,
      (int*)counts, (V*)buf);
}

}  // namespace

// row_bytes: bytes of a row of x; vec: 1 when rows are whole 16-byte units
// and x and buf are 16-byte aligned; probs_vec: 1 when E is a multiple of 4
// and probs is 16-byte aligned; splits: CTAs an expert.
extern "C" int moe_dispatch_launch(int T, int E, int k, int capacity, int row_bytes, int vec,
                                   int probs_vec, int splits, const void* probs, const void* x,
                                   void* idx, void* gates, void* slot, void* counts, void* buf,
                                   void* stream) {
  if (E <= 0 || k <= 0 || k > E || splits <= 0 || capacity < 0 || row_bytes % 2) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(E, splits);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)probs;
  const int u16 = row_bytes / 16, u2 = row_bytes / 2;
  if (vec && probs_vec) {
    launch_dispatch<uint4, true>(grid, st, T, E, k, capacity, u16, p, x, idx, gates, slot,
                                 counts, buf);
  } else if (vec) {
    launch_dispatch<uint4, false>(grid, st, T, E, k, capacity, u16, p, x, idx, gates, slot,
                                  counts, buf);
  } else if (probs_vec) {
    launch_dispatch<uint16_t, true>(grid, st, T, E, k, capacity, u2, p, x, idx, gates, slot,
                                    counts, buf);
  } else {
    launch_dispatch<uint16_t, false>(grid, st, T, E, k, capacity, u2, p, x, idx, gates, slot,
                                     counts, buf);
  }
  return (int)cudaGetLastError();
}

// value_type: the dtype of h, shared and y; vec: 1 when d is a whole
// number of 16-byte units and every row is 16-byte aligned.
extern "C" int moe_combine_launch(int value_type, int T, int k, int capacity, int d, int vec,
                                  const void* h, const void* idx, const void* slot,
                                  const void* gates, const void* shared, void* out,
                                  void* stream) {
  if (T <= 0) return 0;
  if (k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* i = (const int*)idx;
  const int* s = (const int*)slot;
  const float* g = (const float*)gates;
  switch (value_type) {
    case kF32:
      return launch_combine<float>(T, k, capacity, d, vec, h, i, s, g, shared, out, st);
    case kBF16:
      return launch_combine<__nv_bfloat16>(T, k, capacity, d, vec, h, i, s, g, shared, out, st);
    case kF16:
      return launch_combine<__half>(T, k, capacity, d, vec, h, i, s, g, shared, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
