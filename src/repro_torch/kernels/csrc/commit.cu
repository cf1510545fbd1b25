// Hopper (sm_90a) kernel for LocalSearch's batched commit scan.
//
// Replaces the sequential lax.scan of src/repro/core/solver_local.py
// (body_topk's commit, scanned over the sweep's top-k candidates); it is not
// a Pallas kernel there, but on the card a host loop over k <= 16 candidates
// would cost a host round trip per sweep.
//
// What it computes: the candidates cand_n[0..k) arrive in ascending-score
// order (best_s[cand_n], best_t[cand_n] from the move_eval_best sweep).  Each
// is committed in turn if it still fits the destination (absolute units,
// util + d <= cap + FEAS_TOL, as core/constraints.py::destination_fits), the
// movement budget allows it, it is not a self-move, and -- for every
// candidate after the first -- its exact delta against the state the earlier
// commits left is still improving and within batch_quality of the sweep-best
// score (budget-neutral re-targets of already-moved apps skip the window).
// x, util and tier_tasks are updated in place; status = (improving, accepted)
// where improving is 0 when the sweep-best score is not below -tol (the
// solver has converged and nothing is committed).
//
// Bound: the bytes are a few hundred and the operations a few thousand, so
// the card could do it in well under a microsecond; what it takes is the
// latency of its dependent steps.  Design: one warp, in three stages.
// 1. Gather.  Lane i loads candidate i's fields (looping where k > 32):
//    cand_n[i], then best_s, best_t, x, a0, tasks, criticality and demand of
//    that app, all in flight at once; the lanes load the whole tier state
//    (util, tier_tasks, capacity, task_limit, ideal fractions) beside them.
//    Two round trips to memory in all, where a walk over global memory pays
//    a chain of them per candidate.  Then lane i computes, in parallel, the
//    parts of candidate i's exact delta that do not depend on the loads
//    (d / capacity at both ends, their difference over T, the movement and
//    criticality terms: most of the divisions), and the lanes fill the tier
//    fractions util / capacity and tier_tasks / task_limit.
// 2. Scan.  The sequential decisions read and write shared memory only.
//    Every lane walks the same candidates with the same (uniform) decisions.
//    The tier means are sequential sums over the cached fractions (lane r
//    one column, then a shuffle gives every lane the same bits), recomputed
//    only after a commit has changed two tiers.  A commit
//    updates the loads and the two tiers' fractions (lane r resource r, lane
//    0 the task counts) and the gathered assignment of every copy of that
//    app among the candidates, between two __syncwarp barriers.  A candidate
//    whose app an earlier commit moved has its load-free parts recomputed
//    for its new source.
// 3. Write back: the assignment of each candidate, the tier loads, status.
//    The host reads back only `status` per sweep.
//
// Shard-batched entry (commit_topk_batched_launch): the counterpart of the
// reference's vmap of this scan over a shard stack.  One one-warp CTA a
// shard runs the same body (commit_body) on its shard's slices, so each
// shard's result is the unbatched kernel's; an active[S] mask leaves the
// shards whose solve has converged untouched with status (0, 0).  S CTAs
// run side by side, so a launch costs about one unbatched launch.
//
// Numerics.  The exact delta repeats core/delta.py::single_move_delta
// operation for operation as it runs on a card (compiled with -fmad=false,
// like move_eval.cu): caching a quotient or a mean moves an operation
// earlier, never changes it, and the load updates are the same f32
// additions in the same order, so x and the tier loads stay bit-identical
// to the plain version's.  On a card `x / T` by a host scalar multiplies
// by its float reciprocal, and the tier means (core/means.py) multiply
// their sequential sum by the float 1/T, so the kernel multiplies by
// 1.0f / T where a division would part from them at the last bit (a third
// of quotients at T = 3), and a decision on the cancelling f'^2 - f^2 could
// then flip; for the same reason the means sum the tiers in the plain
// version's order (tier_means).
#include <cuda_runtime.h>
#include <stdint.h>

#define FEAS_TOL 1e-6f

__device__ __forceinline__ float h2(float x, float ideal) {
  float h = fmaxf(x - ideal, 0.0f);
  return h * h;
}

// The tier state in shared memory.
struct Tiers {
  float* util;          // [T, R]
  float* capacity;      // [T, R]
  float* ideal_frac;    // [T, R]
  float* frac;          // [T, R]: util / capacity
  float* tier_tasks;    // [T]
  float* task_limit;    // [T]
  float* ideal_task;    // [T]
  float* gfrac;         // [T]: tier_tasks / task_limit
};

// The candidates in shared memory: gathered fields, and the parts of the
// exact delta that depend on the candidate's source and destination only
// (computed for source `csrc`).
struct Cands {
  int64_t* n;           // [k] app id
  float* score;         // [k]
  int* t;               // [k] destination tier
  int* x;               // [k] current tier
  int* home;            // [k]
  float* tasks;         // [k]
  float* crit;          // [k]
  float* demand;        // [k, R]
  int* csrc;            // [k] source tier of the cached parts below
  float* dC_src;        // [k, R] d / capacity[src]
  float* dC_dst;        // [k, R] d / capacity[t]
  float* dmean;         // [k, R] (dC_dst - dC_src) / T
  float* dK;            // [k, 3] k / task_limit[src], k / task_limit[t], their difference / T
  float* dmove;         // [k, 2] movement and criticality terms
};

// core/delta.py::single_move_delta's parts that do not depend on the loads,
// for candidate i moving from src to its destination.
template <int R>
__device__ void cand_parts(int i, int src, int T, const Tiers& s, const Cands& c,
                           const float* totals) {
  const float inv_T = 1.0f / (float)T;     // the plain version's `/ T` on a card
  const int t = c.t[i];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float d = c.demand[i * R + r];
    const float dC_src = d / s.capacity[src * R + r], dC_dst = d / s.capacity[t * R + r];
    c.dC_src[i * R + r] = dC_src;
    c.dC_dst[i * R + r] = dC_dst;
    c.dmean[i * R + r] = (dC_dst - dC_src) * inv_T;
  }
  const float k = c.tasks[i];
  const float dK_src = k / s.task_limit[src], dK_dst = k / s.task_limit[t];
  c.dK[i * 3 + 0] = dK_src;
  c.dK[i * 3 + 1] = dK_dst;
  c.dK[i * 3 + 2] = (dK_dst - dK_src) * inv_T;
  const int home = c.home[i];
  const float was_moved = (src != home) ? 1.0f : 0.0f;
  const float will_move = (t != home) ? 1.0f : 0.0f;
  const float d_moved = will_move - was_moved;
  c.dmove[i * 2 + 0] = d_moved * k / totals[0];
  c.dmove[i * 2 + 1] = d_moved * c.crit[i] / totals[1];
  c.csrc[i] = src;
}

// The tier means of the fractions as core/means.py::tier_mean takes them,
// bit for bit: a sequential sum over t = 0, ..., T - 1 from 0, times the
// float 1/T (the reference's XLA order for T <= 16, kept past it).  Lane r
// sums column r of f[T, R], lane R sums g; a shuffle gives every lane the
// R + 1 means.  Called with the warp converged.
template <int R>
__device__ __forceinline__ void tier_means(int T, const Tiers& s, float (&mean)[R + 1]) {
  const float inv_T = 1.0f / (float)T;     // tier_mean's factor
  const int lane = threadIdx.x & 31;
  const int c = (lane < R) ? lane : R;     // lanes past R repeat the task column
  const float* col = (c < R) ? s.frac + c : s.gfrac;
  const int step = (c < R) ? R : 1;
  float acc = 0.0f;
#pragma unroll 1
  for (int t = 0; t < T; ++t) acc += col[t * step];
  const float m = acc * inv_T;
#pragma unroll
  for (int r = 0; r <= R; ++r) mean[r] = __shfl_sync(0xffffffffu, m, r);
}

// core/delta.py::single_move_delta for candidate i: src -> t against the
// current loads, from the cached parts, fractions and means.
template <int R>
__device__ __forceinline__ float delta_exact(int i, int t, int src, int T, const Tiers& s,
                                             const Cands& c, const float (&mean)[R + 1],
                                             const float* w) {
  const float Tf = (float)T;
  float d_res = 0.0f, d_under = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dC_src = c.dC_src[i * R + r], dC_dst = c.dC_dst[i * R + r];
    float f_src = s.frac[src * R + r], f_dst = s.frac[t * R + r];
    float f_src_new = f_src - dC_src, f_dst_new = f_dst + dC_dst;
    float d_sumsq = f_src_new * f_src_new - f_src * f_src
                    + f_dst_new * f_dst_new - f_dst * f_dst;
    float new_mean = mean[r] + c.dmean[i * R + r];
    d_res += d_sumsq - Tf * (new_mean * new_mean - mean[r] * mean[r]);
    float i_src = s.ideal_frac[src * R + r], i_dst = s.ideal_frac[t * R + r];
    d_under += h2(f_src_new, i_src) - h2(f_src, i_src)
               + h2(f_dst_new, i_dst) - h2(f_dst, i_dst);
  }
  float dK_src = c.dK[i * 3 + 0], dK_dst = c.dK[i * 3 + 1];
  float g_src = s.gfrac[src], g_dst = s.gfrac[t];
  float g_src_new = g_src - dK_src, g_dst_new = g_dst + dK_dst;
  float d_sumsq_t = g_src_new * g_src_new - g_src * g_src
                    + g_dst_new * g_dst_new - g_dst * g_dst;
  float new_mean_t = mean[R] + c.dK[i * 3 + 2];
  float d_task = d_sumsq_t - Tf * (new_mean_t * new_mean_t - mean[R] * mean[R]);
  float gi_src = s.ideal_task[src], gi_dst = s.ideal_task[t];
  d_under = d_under + (h2(g_src_new, gi_src) - h2(g_src, gi_src)
                       + h2(g_dst_new, gi_dst) - h2(g_dst, gi_dst));
  return w[0] * d_under + w[1] * d_res + w[2] * d_task
         + w[3] * c.dmove[i * 2 + 0] + w[4] * c.dmove[i * 2 + 1];
}

// Shared memory in bytes for T tiers, R resources and k candidates.
__host__ __device__ inline size_t commit_smem_bytes(int T, int R, int k) {
  return (size_t)k * sizeof(int64_t) + (size_t)T * (4 * R + 4) * sizeof(float)
         + (size_t)k * (12 + 4 * R) * sizeof(float);
}

// The scan of one problem's candidates: both commit kernels run it, the
// batched one with its shard's pointers, so a shard's commits are the
// unbatched kernel's bit for bit.
template <int R>
__device__ __forceinline__ void commit_body(int T, int k,
                                   const int64_t* __restrict__ cand_n,
                                   const float* __restrict__ best_s,
                                   const int* __restrict__ best_t,
                                   int* x, float* util, float* tier_tasks,
                                   const float* __restrict__ demand,
                                   const float* __restrict__ tasks,
                                   const float* __restrict__ crit,
                                   const int* __restrict__ a0,
                                   const float* __restrict__ capacity,
                                   const float* __restrict__ task_limit,
                                   const float* __restrict__ ideal_frac,
                                   const float* __restrict__ ideal_task_frac,
                                   const float* __restrict__ weights,
                                   const float* __restrict__ totals_in,
                                   const int* __restrict__ moves_left,
                                   float neg_tol, float batch_quality,
                                   int* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  Cands c;
  c.n = reinterpret_cast<int64_t*>(smem_raw);
  Tiers s;
  s.util = reinterpret_cast<float*>(c.n + k);
  s.capacity = s.util + T * R;
  s.ideal_frac = s.capacity + T * R;
  s.frac = s.ideal_frac + T * R;
  s.tier_tasks = s.frac + T * R;
  s.task_limit = s.tier_tasks + T;
  s.ideal_task = s.task_limit + T;
  s.gfrac = s.ideal_task + T;
  c.score = s.gfrac + T;
  c.t = reinterpret_cast<int*>(c.score + k);
  c.x = c.t + k;
  c.home = c.x + k;
  c.csrc = c.home + k;
  c.tasks = reinterpret_cast<float*>(c.csrc + k);
  c.crit = c.tasks + k;
  c.demand = c.crit + k;
  c.dC_src = c.demand + k * R;
  c.dC_dst = c.dC_src + k * R;
  c.dmean = c.dC_dst + k * R;
  c.dK = c.dmean + k * R;
  c.dmove = c.dK + 3 * k;

  // -- 1. gather ----------------------------------------------------------------
  for (int i = lane; i < k; i += 32) {
    const int64_t n = cand_n[i];
    c.n[i] = n;
    c.score[i] = best_s[n];
    c.t[i] = best_t[n];
    c.x[i] = x[n];
    c.home[i] = a0[n];
    c.tasks[i] = tasks[n];
    c.crit[i] = crit[n];
    for (int r = 0; r < R; ++r) c.demand[i * R + r] = demand[n * R + r];
  }
  for (int e = lane; e < T * R; e += 32) {
    s.util[e] = util[e];
    s.capacity[e] = capacity[e];
    s.ideal_frac[e] = ideal_frac[e];
  }
  for (int e = lane; e < T; e += 32) {
    s.tier_tasks[e] = tier_tasks[e];
    s.task_limit[e] = task_limit[e];
    s.ideal_task[e] = ideal_task_frac[e];
  }
  float w[5], totals[2];
#pragma unroll
  for (int e = 0; e < 5; ++e) w[e] = weights[e];
  totals[0] = totals_in[0];
  totals[1] = totals_in[1];
  int left = *moves_left;
  __syncwarp();
  const float s0 = c.score[0];
  if (!(s0 < neg_tol)) {                   // no improving move: converged
    if (lane == 0) { status[0] = 0; status[1] = 0; }
    return;
  }
  for (int i = lane; i < k; i += 32) cand_parts<R>(i, c.x[i], T, s, c, totals);
  for (int e = lane; e < T * R; e += 32) s.frac[e] = s.util[e] / s.capacity[e];
  for (int e = lane; e < T; e += 32) s.gfrac[e] = s.tier_tasks[e] / s.task_limit[e];
  __syncwarp();

  // -- 2. scan on shared memory --------------------------------------------------
  const float window = batch_quality * s0;
  float mean[R + 1];
  bool means_stale = true;
  int accepted = 0;
  for (int i = 0; i < k; ++i) {
    if (!(c.score[i] < neg_tol)) break;    // scores ascend: nothing later improves
    const int t = c.t[i];
    const int src = c.x[i];
    const int home = c.home[i];
    if (t == src) continue;
    const bool already = src != home;
    const float k_n = c.tasks[i];
    const float* d = c.demand + i * R;
    bool fits = s.tier_tasks[t] + k_n <= s.task_limit[t] + FEAS_TOL;
#pragma unroll
    for (int r = 0; r < R; ++r)
      fits = fits && (s.util[t * R + r] + d[r] <= s.capacity[t * R + r] + FEAS_TOL);
    if (!(fits && (already || left > 0))) continue;
    if (i > 0) {
      if (c.csrc[i] != src) {              // an earlier commit moved this app
        if (lane == 0) cand_parts<R>(i, src, T, s, c, totals);
        __syncwarp();
      }
      if (means_stale) {
        tier_means<R>(T, s, mean);
        means_stale = false;
      }
      float dlt = delta_exact<R>(i, t, src, T, s, c, mean, w);
      if (!((dlt < neg_tol) && (dlt <= window || already))) continue;
    }
    __syncwarp();                          // every lane has read the state it commits over
    if (lane < R) {
      const float dr = d[lane];
      const float u_src = s.util[src * R + lane] + (-dr);
      const float u_dst = s.util[t * R + lane] + dr;
      s.util[src * R + lane] = u_src;
      s.util[t * R + lane] = u_dst;
      s.frac[src * R + lane] = u_src / s.capacity[src * R + lane];
      s.frac[t * R + lane] = u_dst / s.capacity[t * R + lane];
    }
    if (lane == 0) {
      const float g_src = s.tier_tasks[src] + (-k_n);
      const float g_dst = s.tier_tasks[t] + k_n;
      s.tier_tasks[src] = g_src;
      s.tier_tasks[t] = g_dst;
      s.gfrac[src] = g_src / s.task_limit[src];
      s.gfrac[t] = g_dst / s.task_limit[t];
    }
    const int64_t n = c.n[i];
    for (int j = lane; j < k; j += 32)
      if (c.n[j] == n) c.x[j] = t;
    __syncwarp();
    means_stale = true;
    left -= already ? ((t == home) ? -1 : 0) : 1;
    ++accepted;
  }

  // -- 3. write back ---------------------------------------------------------------
  __syncwarp();
  for (int i = lane; i < k; i += 32) x[c.n[i]] = c.x[i];
  for (int e = lane; e < T * R; e += 32) util[e] = s.util[e];
  for (int e = lane; e < T; e += 32) tier_tasks[e] = s.tier_tasks[e];
  if (lane == 0) { status[0] = 1; status[1] = accepted; }
}

template <int R>
__global__ void commit_topk_kernel(int T, int k,
                                   const int64_t* __restrict__ cand_n,
                                   const float* __restrict__ best_s,
                                   const int* __restrict__ best_t,
                                   int* x, float* util, float* tier_tasks,
                                   const float* __restrict__ demand,
                                   const float* __restrict__ tasks,
                                   const float* __restrict__ crit,
                                   const int* __restrict__ a0,
                                   const float* __restrict__ capacity,
                                   const float* __restrict__ task_limit,
                                   const float* __restrict__ ideal_frac,
                                   const float* __restrict__ ideal_task_frac,
                                   const float* __restrict__ weights,
                                   const float* __restrict__ totals_in,
                                   const int* __restrict__ moves_left,
                                   float neg_tol, float batch_quality,
                                   int* __restrict__ status) {
  commit_body<R>(T, k, cand_n, best_s, best_t, x, util, tier_tasks, demand, tasks, crit, a0,
                 capacity, task_limit, ideal_frac, ideal_task_frac, weights, totals_in,
                 moves_left, neg_tol, batch_quality, status);
}

// The shard-batched scan (the counterpart of the reference's vmap of this
// scan over a shard stack, src/repro/shard/solve.py): one one-warp CTA a
// shard, each on its shard's N apps and T tiers, `s` strides from every
// base pointer; candidate ids are the shard's own app indices.  A shard
// whose solve has converged (active[s] == 0) writes nothing and reports
// status (0, 0).
template <int R>
__global__ void commit_topk_batched_kernel(int N, int T, int k,
                                           const int64_t* __restrict__ cand_n,
                                           const float* __restrict__ best_s,
                                           const int* __restrict__ best_t,
                                           int* x, float* util, float* tier_tasks,
                                           const float* __restrict__ demand,
                                           const float* __restrict__ tasks,
                                           const float* __restrict__ crit,
                                           const int* __restrict__ a0,
                                           const float* __restrict__ capacity,
                                           const float* __restrict__ task_limit,
                                           const float* __restrict__ ideal_frac,
                                           const float* __restrict__ ideal_task_frac,
                                           const float* __restrict__ weights,
                                           const float* __restrict__ totals_in,
                                           const int* __restrict__ moves_left,
                                           const int* __restrict__ active,
                                           float neg_tol, float batch_quality,
                                           int* __restrict__ status) {
  const size_t s = blockIdx.x;
  if (!active[s]) {
    if (threadIdx.x == 0) { status[2 * s] = 0; status[2 * s + 1] = 0; }
    return;
  }
  const size_t n = (size_t)N, t = (size_t)T;
  commit_body<R>(T, k, cand_n + s * k, best_s + s * n, best_t + s * n, x + s * n,
                 util + s * t * R, tier_tasks + s * t, demand + s * n * R, tasks + s * n,
                 crit + s * n, a0 + s * n, capacity + s * t * R, task_limit + s * t,
                 ideal_frac + s * t * R, ideal_task_frac + s * t, weights + 5 * s,
                 totals_in + 2 * s, moves_left + s, neg_tol, batch_quality, status + 2 * s);
}

template <int R>
int launch(int T, int k, const void* cand_n, const void* best_s, const void* best_t, void* x,
           void* util, void* tier_tasks, const void* demand, const void* tasks,
           const void* crit, const void* a0, const void* capacity, const void* task_limit,
           const void* ideal_frac, const void* ideal_task_frac, const void* w,
           const void* totals, const void* moves_left, float neg_tol, float batch_quality,
           void* status, cudaStream_t stream) {
  const size_t smem = commit_smem_bytes(T, R, k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(commit_topk_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  commit_topk_kernel<R><<<1, 32, smem, stream>>>(
      T, k, (const int64_t*)cand_n, (const float*)best_s, (const int*)best_t, (int*)x,
      (float*)util, (float*)tier_tasks, (const float*)demand, (const float*)tasks,
      (const float*)crit, (const int*)a0, (const float*)capacity, (const float*)task_limit,
      (const float*)ideal_frac, (const float*)ideal_task_frac, (const float*)w,
      (const float*)totals, (const int*)moves_left, neg_tol, batch_quality, (int*)status);
  return (int)cudaGetLastError();
}

template <int R>
int launch_batched(int S, int N, int T, int k, const void* cand_n, const void* best_s,
                   const void* best_t, void* x, void* util, void* tier_tasks,
                   const void* demand, const void* tasks, const void* crit, const void* a0,
                   const void* capacity, const void* task_limit, const void* ideal_frac,
                   const void* ideal_task_frac, const void* w, const void* totals,
                   const void* moves_left, const void* active, float neg_tol,
                   float batch_quality, void* status, cudaStream_t stream) {
  const size_t smem = commit_smem_bytes(T, R, k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(commit_topk_batched_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  commit_topk_batched_kernel<R><<<S, 32, smem, stream>>>(
      N, T, k, (const int64_t*)cand_n, (const float*)best_s, (const int*)best_t, (int*)x,
      (float*)util, (float*)tier_tasks, (const float*)demand, (const float*)tasks,
      (const float*)crit, (const int*)a0, (const float*)capacity, (const float*)task_limit,
      (const float*)ideal_frac, (const float*)ideal_task_frac, (const float*)w,
      (const float*)totals, (const int*)moves_left, (const int*)active, neg_tol,
      batch_quality, (int*)status);
  return (int)cudaGetLastError();
}

extern "C" int commit_topk_launch(int T, int R, int k, const void* cand_n, const void* best_s,
                                  const void* best_t, void* x, void* util, void* tier_tasks,
                                  const void* demand, const void* tasks, const void* crit,
                                  const void* a0, const void* capacity, const void* task_limit,
                                  const void* ideal_frac, const void* ideal_task_frac,
                                  const void* w, const void* totals, const void* moves_left,
                                  float neg_tol, float batch_quality, void* status,
                                  void* stream) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define COMMIT_LAUNCH(RR)                                                                   \
  launch<RR>(T, k, cand_n, best_s, best_t, x, util, tier_tasks, demand, tasks, crit, a0,  \
             capacity, task_limit, ideal_frac, ideal_task_frac, w, totals, moves_left,      \
             neg_tol, batch_quality, status, s)
  switch (R) {
    case 1: return COMMIT_LAUNCH(1);
    case 2: return COMMIT_LAUNCH(2);
    case 3: return COMMIT_LAUNCH(3);
    case 4: return COMMIT_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef COMMIT_LAUNCH
}

// The shard-batched scan: S problems of N apps and T tiers each, every
// array with a leading [S] axis, cand_n [S, k]; status [S, 2].
extern "C" int commit_topk_batched_launch(int S, int N, int T, int R, int k,
                                          const void* cand_n, const void* best_s,
                                          const void* best_t, void* x, void* util,
                                          void* tier_tasks, const void* demand,
                                          const void* tasks, const void* crit, const void* a0,
                                          const void* capacity, const void* task_limit,
                                          const void* ideal_frac, const void* ideal_task_frac,
                                          const void* w, const void* totals,
                                          const void* moves_left, const void* active,
                                          float neg_tol, float batch_quality, void* status,
                                          void* stream) {
  if (k <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define COMMIT_BATCHED(RR)                                                                \
  launch_batched<RR>(S, N, T, k, cand_n, best_s, best_t, x, util, tier_tasks, demand,     \
                     tasks, crit, a0, capacity, task_limit, ideal_frac, ideal_task_frac,   \
                     w, totals, moves_left, active, neg_tol, batch_quality, status, s)
  switch (R) {
    case 1: return COMMIT_BATCHED(1);
    case 2: return COMMIT_BATCHED(2);
    case 3: return COMMIT_BATCHED(3);
    case 4: return COMMIT_BATCHED(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef COMMIT_BATCHED
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
