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
// Design.  One warp.  The scan is sequential by nature, so every lane walks
// the same candidates with the same (uniform) decisions; the lanes share only
// the O(T) tier means of the delta re-check (lane j sums tiers j, j+32, ...,
// then an xor-shuffle sum, which gives every lane the same bits).  Lane 0
// writes the commits between two __syncwarp barriers: every lane has read
// the old state before the write, and sees the new one after it.  The only
// thing the host reads back per sweep is `status`.
//
// Numerics.  delta_exact repeats core/delta.py::single_move_delta operation
// for operation (compiled with -fmad=false, like move_eval.cu), and the load
// updates are the same f32 additions in the same order, so the tier loads
// stay bit-identical to the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

#define FEAS_TOL 1e-6f
#define MAX_R 4

__device__ __forceinline__ float h2(float x, float ideal) {
  float h = fmaxf(x - ideal, 0.0f);
  return h * h;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// core/delta.py::single_move_delta for app n: src -> t against the current
// loads; the tier means are reduced over the warp.
__device__ float delta_exact(int64_t n, int t, int src, int home, int T, int R,
                             const float* demand, const float* tasks, const float* crit,
                             const float* capacity, const float* task_limit,
                             const float* ideal_frac, const float* ideal_task_frac,
                             const float* util, const float* tier_tasks, const float* w,
                             const float* totals) {
  const float Tf = (float)T;
  float mean_f[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < R) {
      float part = 0.0f;
      for (int tt = threadIdx.x; tt < T; tt += 32) part += util[tt * R + r] / capacity[tt * R + r];
      mean_f[r] = warp_sum(part) / Tf;
    }
  }
  float part_g = 0.0f;
  for (int tt = threadIdx.x; tt < T; tt += 32) part_g += tier_tasks[tt] / task_limit[tt];
  const float mean_g = warp_sum(part_g) / Tf;

  float d_res = 0.0f, d_under = 0.0f;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < R) {
      float d = demand[n * R + r];
      float c_src = capacity[src * R + r], c_dst = capacity[t * R + r];
      float dC_src = d / c_src, dC_dst = d / c_dst;
      float f_src = util[src * R + r] / c_src, f_dst = util[t * R + r] / c_dst;
      float f_src_new = f_src - dC_src, f_dst_new = f_dst + dC_dst;
      float d_sumsq = f_src_new * f_src_new - f_src * f_src
                      + f_dst_new * f_dst_new - f_dst * f_dst;
      float new_mean = mean_f[r] + (dC_dst - dC_src) / Tf;
      d_res += d_sumsq - Tf * (new_mean * new_mean - mean_f[r] * mean_f[r]);
      float i_src = ideal_frac[src * R + r], i_dst = ideal_frac[t * R + r];
      d_under += h2(f_src_new, i_src) - h2(f_src, i_src)
                 + h2(f_dst_new, i_dst) - h2(f_dst, i_dst);
    }
  }
  float k = tasks[n];
  float dK_src = k / task_limit[src], dK_dst = k / task_limit[t];
  float g_src = tier_tasks[src] / task_limit[src], g_dst = tier_tasks[t] / task_limit[t];
  float g_src_new = g_src - dK_src, g_dst_new = g_dst + dK_dst;
  float d_sumsq_t = g_src_new * g_src_new - g_src * g_src
                    + g_dst_new * g_dst_new - g_dst * g_dst;
  float new_mean_t = mean_g + (dK_dst - dK_src) / Tf;
  float d_task = d_sumsq_t - Tf * (new_mean_t * new_mean_t - mean_g * mean_g);
  float gi_src = ideal_task_frac[src], gi_dst = ideal_task_frac[t];
  d_under = d_under + (h2(g_src_new, gi_src) - h2(g_src, gi_src)
                       + h2(g_dst_new, gi_dst) - h2(g_dst, gi_dst));

  float was_moved = (src != home) ? 1.0f : 0.0f;
  float will_move = (t != home) ? 1.0f : 0.0f;
  float d_moved = will_move - was_moved;
  float d_movement = d_moved * k / totals[0];
  float d_criticality = d_moved * crit[n] / totals[1];
  return w[0] * d_under + w[1] * d_res + w[2] * d_task
         + w[3] * d_movement + w[4] * d_criticality;
}

__global__ void commit_topk_kernel(int T, int R, int k,
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
                                   const float* __restrict__ w,
                                   const float* __restrict__ totals,
                                   const int* __restrict__ moves_left,
                                   float neg_tol, float batch_quality,
                                   int* __restrict__ status) {
  const bool lead = threadIdx.x == 0;
  const float s0 = best_s[cand_n[0]];
  if (!(s0 < neg_tol)) {                   // no improving move: converged
    if (lead) { status[0] = 0; status[1] = 0; }
    return;
  }
  const float window = batch_quality * s0;
  int left = *moves_left;
  int accepted = 0;
  for (int i = 0; i < k; ++i) {
    const int64_t n = cand_n[i];
    if (!(best_s[n] < neg_tol)) break;     // scores ascend: nothing later improves
    const int t = best_t[n];
    const int src = x[n];
    const int home = a0[n];
    if (t == src) continue;
    const bool already = src != home;
    const float k_n = tasks[n];
    bool fits = tier_tasks[t] + k_n <= task_limit[t] + FEAS_TOL;
    for (int r = 0; r < R; ++r)
      fits = fits && (util[t * R + r] + demand[n * R + r] <= capacity[t * R + r] + FEAS_TOL);
    if (!(fits && (already || left > 0))) continue;
    if (i > 0) {
      float d = delta_exact(n, t, src, home, T, R, demand, tasks, crit, capacity, task_limit,
                            ideal_frac, ideal_task_frac, util, tier_tasks, w, totals);
      if (!((d < neg_tol) && (d <= window || already))) continue;
    }
    __syncwarp();                          // every lane has read the state it commits over
    if (lead) {
      x[n] = t;
      for (int r = 0; r < R; ++r) {
        float d = demand[n * R + r];
        util[src * R + r] = util[src * R + r] + (-d);
        util[t * R + r] = util[t * R + r] + d;
      }
      tier_tasks[src] = tier_tasks[src] + (-k_n);
      tier_tasks[t] = tier_tasks[t] + k_n;
    }
    __syncwarp();
    left -= already ? ((t == home) ? -1 : 0) : 1;
    ++accepted;
  }
  if (lead) { status[0] = 1; status[1] = accepted; }
}

extern "C" int commit_topk_launch(int T, int R, int k, const void* cand_n, const void* best_s,
                                  const void* best_t, void* x, void* util, void* tier_tasks,
                                  const void* demand, const void* tasks, const void* crit,
                                  const void* a0, const void* capacity, const void* task_limit,
                                  const void* ideal_frac, const void* ideal_task_frac,
                                  const void* w, const void* totals, const void* moves_left,
                                  float neg_tol, float batch_quality, void* status,
                                  void* stream) {
  if (k <= 0 || R > MAX_R) return (int)cudaErrorInvalidValue;
  commit_topk_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      T, R, k, (const int64_t*)cand_n, (const float*)best_s, (const int*)best_t, (int*)x,
      (float*)util, (float*)tier_tasks, (const float*)demand, (const float*)tasks,
      (const float*)crit, (const int*)a0, (const float*)capacity, (const float*)task_limit,
      (const float*)ideal_frac, (const float*)ideal_task_frac, (const float*)w,
      (const float*)totals, (const int*)moves_left, neg_tol, batch_quality, (int*)status);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
