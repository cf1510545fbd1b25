// Hopper (sm_90a) kernels for the SPTLB candidate-move sweep.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/move_eval.py:
//   move_eval_best_kernel <- move_eval_best_pallas (_move_eval_best_kernel)
//   move_eval_kernel      <- move_eval_pallas      (_move_eval_kernel)
//   move_eval_best_batched_kernel <- the same best kernel under the
//     reference's vmap over a shard stack (src/repro/shard/solve.py)
// All share pair_delta(), the counterpart of the Pallas _block_delta; the
// two best kernels share best_body().  tier_stats_kernel computes the tier
// table they read (core/means.py's means; not a TPU kernel: the reference
// computes it in the Pallas wrapper's XLA prologue,
// src/repro/kernels/move_eval.py:169-172, and in core/delta.py:61-64), and
// tier_mean_kernel the objective's means (src/repro/core/goals.py:55, 59).
//
// What it computes: for app n and tier t, the exact change of the scalarized
// objective if n moved to t (core/delta.py closed form), plus the destination
// capacity / task-limit fit in load-fraction space
// (f_dst + dC <= 1 + FEAS_TOL * inv_cap, the Pallas kernel's own form).  The
// best kernel masks by fit, the static feasible[N, T] mask, the movement
// budget, no self-move, and reduces each app to (best score, best tier), ties
// to the lowest tier and +inf / tier 0 where nothing is feasible.
//
// Design.  Both kernels read the function's own per-app inputs (demand,
// tasks, criticality, the two assignments; the best kernel also feasible)
// and stage the T-sized tier table (fractions, capacities, their inverses,
// ideals, the means and the weights) in shared memory; each app's
// source-side quantities are gathered from the staged table by its source
// tier (gather_app); the two N-sized totals come from the caller.  At T <= 8
// one thread serves one app and walks the tiers in order, so a warp's loads
// are 32 consecutive apps and no lane idles: the best kernel keeps a strict
// '<' (lowest tier among equals); the full sweep pins the self-move to 0,
// computes the other T - 1 deltas (every lane the same count) into a
// shared [apps, T] tile, and the block stores the tile as one contiguous
// span with 16-byte stores.  At larger T a group of G lanes (G = the power
// of two >= T, capped at 32) serves one app: lane j evaluates tiers j, j+G,
// ...; the best kernel reduces the group with xor shuffles, again
// preferring the lower tier on equal scores, and the full sweep's lanes
// store tier j of an app beside tier j+1, so its stores are already
// contiguous.  feasible is read as bytes, not padded floats, and tiers are
// not padded to the TPU's 128 lanes.
//
// The batched sweep is the best kernel on a grid of (app blocks, S): each
// block offsets every pointer by its shard and runs best_body(), so shard s
// gives the unbatched kernel's bits on shard s alone; one launch serves all
// shards a sweep, and a converged shard (active[s] == 0) only writes
// (+inf, 0).
//
// Bound on this card: per app the best function reads R+2 four-byte values,
// two tier ids and T feasibility bytes and writes 8 bytes; the full sweep
// reads the same values but feasible and writes T floats (44 bytes an app at
// R = 2, T = 5); about 94 f32 operations per (app, tier) at R = 2.  At T = 5
// the bytes bound both, at T = 128 the f32 operations (see PERF.md).
//
// Numerics.  At fleet scale an app's delta is tiny beside the tier fractions,
// so f'^2 - f^2 cancels: one ulp of difference in f' shows as ~1e-4 of the
// delta.  The kernels therefore repeat the plain torch version's operations
// one for one — d / C by division, not d * (1/C) as the Pallas kernel does —
// and are compiled with -fmad=false, so each operation rounds on its own as
// the separate elementwise ops do.  Only the fit test keeps the kernel's own
// load-fraction form (f_dst + dC <= 1 + FEAS_TOL * inv_cap).  One operation
// differs: on a card the plain version's `/ T` (a host scalar) is a multiply
// by the reciprocal, where the kernels divide; the two quotients part at the
// last bit, but mean + d_mean absorbs that at every shape checked (PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FEAS_TOL 1e-6f
#define MAX_R 4
// tier layout [4R + 4, T]: f[R], cap[R], inv_cap[R], ideal[R], g, klim,
// inv_klim, gideal
// consts [R + 1 + 5]: mean_f[R], mean_g, w[5]

__device__ __forceinline__ float h2(float x, float ideal) {
  float h = fmaxf(x - ideal, 0.0f);
  return h * h;
}

struct AppRow {
  float f_src[MAX_R], f_src_new[MAX_R], dC_src[MAX_R], ideal_src[MAX_R], demand[MAX_R];
  float g_src, g_src_new, dK_src, gideal_src, k, mc, cc;
  int a_src, a0;
};

// The delta of moving app `a` to tier t, and whether t has the headroom.
// Operation order follows core/delta.py::move_delta_cost term by term.
__device__ __forceinline__ float pair_delta(const AppRow& a, int t, int T, int R,
                                            const float* tier, const float* c,
                                            bool* fits_out) {
  const float Tf = (float)T;
  float d_under = 0.0f, d_res = 0.0f;
  bool fits = true;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < R) {
      float f_dst = tier[r * T + t];
      float cap = tier[(R + r) * T + t];
      float inv_cap = tier[(2 * R + r) * T + t];
      float ideal = tier[(3 * R + r) * T + t];
      float dC = a.demand[r] / cap;
      float f_dst_new = f_dst + dC;
      fits = fits && (f_dst_new <= 1.0f + FEAS_TOL * inv_cap);
      float d_sumsq = a.f_src_new[r] * a.f_src_new[r] - a.f_src[r] * a.f_src[r]
                      + f_dst_new * f_dst_new - f_dst * f_dst;
      float d_mean = (dC - a.dC_src[r]) / Tf;
      float mean_f = c[r];
      float new_mean = mean_f + d_mean;
      d_res += d_sumsq - Tf * (new_mean * new_mean - mean_f * mean_f);
      d_under += h2(a.f_src_new[r], a.ideal_src[r]) - h2(a.f_src[r], a.ideal_src[r])
                 + h2(f_dst_new, ideal) - h2(f_dst, ideal);
    }
  }
  float g_dst = tier[(4 * R) * T + t];
  float klim = tier[(4 * R + 1) * T + t];
  float inv_klim = tier[(4 * R + 2) * T + t];
  float gideal = tier[(4 * R + 3) * T + t];
  float dK = a.k / klim;
  float g_dst_new = g_dst + dK;
  fits = fits && (g_dst_new <= 1.0f + FEAS_TOL * inv_klim);
  float d_sumsq_t = a.g_src_new * a.g_src_new - a.g_src * a.g_src
                    + g_dst_new * g_dst_new - g_dst * g_dst;
  float d_mean_t = (dK - a.dK_src) / Tf;
  float mean_g = c[R];
  float new_mean_t = mean_g + d_mean_t;
  float d_task = d_sumsq_t - Tf * (new_mean_t * new_mean_t - mean_g * mean_g);
  d_under += h2(a.g_src_new, a.gideal_src) - h2(a.g_src, a.gideal_src)
             + h2(g_dst_new, gideal) - h2(g_dst, gideal);

  float was_moved = (a.a_src != a.a0) ? 1.0f : 0.0f;
  float will_move = (t != a.a0) ? 1.0f : 0.0f;
  float d_moved = will_move - was_moved;
  const float* w = c + R + 1;
  *fits_out = fits;
  return w[0] * d_under + w[1] * d_res + w[2] * d_task
         + w[3] * (d_moved * a.mc) + w[4] * (d_moved * a.cc);
}

// Both kernels' inputs: the function's own per-app arrays and scalars (the
// full sweep leaves feasible and moves_left null), and the per-tier arrays
// (the caller's inputs and the wrapper's tier statistics f, g, their means
// and the two inverses).
struct BestApps {
  const float *demand, *tasks, *crit;
  const int *a_src, *a0;
  const uint8_t* feasible;
  const int* moves_left;
  const float* totals;                     // clamp(sum(tasks), 1), clamp(sum(crit), 1)
};

struct BestTiers {
  const float *capacity, *task_limit, *ideal_frac, *ideal_task_frac, *weights;
  const float *f, *g, *mean_f, *mean_g, *inv_cap, *inv_klim;
};

// Stage the tier layout and the consts from the separate per-tier arrays.
__device__ __forceinline__ void stage_best_tables(float* sm, const BestTiers& in, int T, int R) {
  float* c = sm + (4 * R + 4) * T;
  for (int i = threadIdx.x; i < R * T; i += blockDim.x) {
    int t = i / R, r = i % R;
    sm[r * T + t] = in.f[i];
    sm[(R + r) * T + t] = in.capacity[i];
    sm[(2 * R + r) * T + t] = in.inv_cap[i];
    sm[(3 * R + r) * T + t] = in.ideal_frac[i];
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    sm[(4 * R) * T + t] = in.g[t];
    sm[(4 * R + 1) * T + t] = in.task_limit[t];
    sm[(4 * R + 2) * T + t] = in.inv_klim[t];
    sm[(4 * R + 3) * T + t] = in.ideal_task_frac[t];
  }
  for (int i = threadIdx.x; i < R + 6; i += blockDim.x) {
    c[i] = (i < R) ? in.mean_f[i] : (i == R) ? in.mean_g[0] : in.weights[i - R - 1];
  }
  __syncthreads();
}

// App n's row, computed from its inputs and the staged table at its source
// tier: the operations of kernels/move_eval.py::prepare, one for one.
__device__ __forceinline__ void gather_app(AppRow& a, int n, int T, int R, const BestApps& in,
                                           const float* tier, float total_tasks,
                                           float total_crit) {
  const int src = a.a_src;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < R) {
      float d = in.demand[(size_t)n * R + r];
      float f = tier[r * T + src];
      float dC = d / tier[(R + r) * T + src];
      a.demand[r] = d;
      a.f_src[r] = f;
      a.dC_src[r] = dC;
      a.f_src_new[r] = f - dC;
      a.ideal_src[r] = tier[(3 * R + r) * T + src];
    }
  }
  float k = in.tasks[n];
  float g = tier[(4 * R) * T + src];
  float dK = k / tier[(4 * R + 1) * T + src];
  a.k = k;
  a.g_src = g;
  a.dK_src = dK;
  a.g_src_new = g - dK;
  a.gideal_src = tier[(4 * R + 3) * T + src];
  a.mc = k / total_tasks;
  a.cc = in.crit[n] / total_crit;
}

static const int kThreads = 256;           // threads a block, both kernels

// The fused sweep of the apps of block `block` against one problem's tier
// table: both best kernels run it, the batched one with its shard's
// pointers, so a shard's (score, tier) is the unbatched kernel's bit for bit.
__device__ __forceinline__ void best_body(int block, int N, int T, int R, int G,
                                          const BestApps& apps, const BestTiers& tiers,
                                          float* __restrict__ best_score,
                                          int* __restrict__ best_tier) {
  extern __shared__ float sm_tier[];
  stage_best_tables(sm_tier, tiers, T, R);
  const float* consts = sm_tier + (4 * R + 4) * T;
  int gid = block * blockDim.x + threadIdx.x;
  int n = gid / G;
  int j = gid % G;
  if (n >= N) return;                      // whole groups leave together
  unsigned lane = threadIdx.x & 31u;
  unsigned gmask = (G == 32) ? 0xffffffffu : (((1u << G) - 1u) << (lane - lane % G));

  AppRow a;
  a.a_src = apps.a_src[n];
  a.a0 = apps.a0[n];
  gather_app(a, n, T, R, apps, sm_tier, apps.totals[0], apps.totals[1]);
  bool budget_ok = (a.a_src != a.a0) || (*apps.moves_left > 0);
  const uint8_t* feas_row = apps.feasible + (size_t)n * T;

  float s = INFINITY;
  int bt = T;                              // sentinel: no feasible tier yet
  for (int t = j; t < T; t += G) {
    if (!(budget_ok && feas_row[t] && t != a.a_src)) continue;   // masked: no delta needed
    bool fits;
    float d = pair_delta(a, t, T, R, sm_tier, consts, &fits);
    if (fits && d < s) { s = d; bt = t; }
  }
  for (int off = G >> 1; off > 0; off >>= 1) {
    float os = __shfl_xor_sync(gmask, s, off);
    int ot = __shfl_xor_sync(gmask, bt, off);
    if (os < s || (os == s && ot < bt)) { s = os; bt = ot; }
  }
  if (j == 0) {
    best_score[n] = s;
    best_tier[n] = (bt == T) ? 0 : bt;     // argmin of an all-inf row is 0
  }
}

// At most 64 registers a thread, so that 4 blocks of kThreads share an SM:
// the main path's 131,072 apps (512 blocks at T <= 8) then run in one wave.
__global__ void __launch_bounds__(kThreads, 4)
move_eval_best_kernel(int N, int T, int R, int G, BestApps apps, BestTiers tiers,
                      float* __restrict__ best_score, int* __restrict__ best_tier) {
  best_body(blockIdx.x, N, T, R, G, apps, tiers, best_score, best_tier);
}

// The shard-batched sweep (the counterpart of the reference's vmap over the
// shard stack, src/repro/shard/solve.py): blockIdx.y is the shard, whose
// slices of every per-app and per-tier array lie `s` strides from the
// base.  A shard whose solve has converged (active[s] == 0) computes
// nothing and reports every app as having no move: (+inf, tier 0).
__global__ void __launch_bounds__(kThreads, 4)
move_eval_best_batched_kernel(int N, int T, int R, int G, BestApps apps, BestTiers tiers,
                              const int* __restrict__ active,
                              float* __restrict__ best_score, int* __restrict__ best_tier) {
  const size_t s = blockIdx.y;
  best_score += s * N;
  best_tier += s * N;
  if (!active[s]) {
    int gid = blockIdx.x * blockDim.x + threadIdx.x;
    int n = gid / G;
    if (n < N && gid % G == 0) {
      best_score[n] = INFINITY;
      best_tier[n] = 0;
    }
    return;
  }
  const size_t NR = (size_t)N * R, TR = (size_t)T * R;
  BestApps a{apps.demand + s * NR, apps.tasks + s * N, apps.crit + s * N,
             apps.a_src + s * N, apps.a0 + s * N, apps.feasible + s * N * T,
             apps.moves_left + s, apps.totals + 2 * s};
  BestTiers t{tiers.capacity + s * TR, tiers.task_limit + s * T, tiers.ideal_frac + s * TR,
              tiers.ideal_task_frac + s * T, tiers.weights + 5 * s, tiers.f + s * TR,
              tiers.g + s * T, tiers.mean_f + s * R, tiers.mean_g + s,
              tiers.inv_cap + s * TR, tiers.inv_klim + s * T};
  best_body(blockIdx.x, N, T, R, G, a, t, best_score, best_tier);
}

// Floats of the staged tier table, rounded up to a whole 16 bytes so that
// the full sweep's tile after it can be read as float4.
__host__ __device__ __forceinline__ int tier_table_floats(int T, int R) {
  return ((4 * R + 4) * T + R + 6 + 3) & ~3;
}

// The full delta[N, T], self-moves 0; registers capped as the best kernel's.
__global__ void __launch_bounds__(kThreads, 4)
move_eval_kernel(int N, int T, int R, int G, BestApps apps, BestTiers tiers,
                 float* __restrict__ delta) {
  extern __shared__ float sm_tier[];
  stage_best_tables(sm_tier, tiers, T, R);
  const float* consts = sm_tier + (4 * R + 4) * T;
  const float total_tasks = apps.totals[0], total_crit = apps.totals[1];
  AppRow a;
  bool fits;                               // the fit test: not part of delta
  if (G == 1) {
    // One thread an app; the block's [apps, T] tile is one contiguous span.
    float* tile = sm_tier + tier_table_floats(T, R);
    const int n0 = blockIdx.x * kThreads;
    const int n = n0 + threadIdx.x;
    if (n < N) {
      a.a_src = apps.a_src[n];
      a.a0 = apps.a0[n];
      gather_app(a, n, T, R, apps, sm_tier, total_tasks, total_crit);
      // Self-moves are pinned to 0; every lane walks the other T - 1 tiers
      // in order, so no lane idles beside one that computes.
      tile[threadIdx.x * T + a.a_src] = 0.0f;
      for (int k = 0; k + 1 < T; ++k) {
        int t = k + (k >= a.a_src ? 1 : 0);
        tile[threadIdx.x * T + t] = pair_delta(a, t, T, R, sm_tier, consts, &fits);
      }
    }
    __syncthreads();
    // n0 * T floats is a multiple of 1024 bytes, so the span starts 16-byte
    // aligned; a ragged last block stores its tail float by float.
    const int count = min(kThreads, N - n0) * T;
    float* out = delta + (size_t)n0 * T;
    const int vec = count >> 2;
    for (int i = threadIdx.x; i < vec; i += kThreads) {
      reinterpret_cast<float4*>(out)[i] = reinterpret_cast<const float4*>(tile)[i];
    }
    for (int i = (vec << 2) + threadIdx.x; i < count; i += kThreads) out[i] = tile[i];
    return;
  }
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  int n = gid / G;
  int j = gid % G;
  if (n >= N) return;
  a.a_src = apps.a_src[n];
  a.a0 = apps.a0[n];
  gather_app(a, n, T, R, apps, sm_tier, total_tasks, total_crit);
  float* out = delta + (size_t)n * T;
  for (int t = j; t < T; t += G) {
    float d = pair_delta(a, t, T, R, sm_tier, consts, &fits);
    out[t] = (t == a.a_src) ? 0.0f : d;
  }
}

static int group_width(int T) {
  int g = 1;
  while (g < T && g < 32) g <<= 1;
  return g;
}

// Up to this many tiers one thread serves one app (no idle lanes, no
// shuffles); above it a group of lanes does.
static const int kThreadPerAppMaxT = 8;

extern "C" int move_eval_best_launch(int N, int T, int R, const void* demand, const void* tasks,
                                     const void* crit, const void* a_src, const void* a0,
                                     const void* feasible, const void* moves_left,
                                     const void* totals, const void* capacity,
                                     const void* task_limit, const void* ideal_frac,
                                     const void* ideal_task_frac, const void* weights,
                                     const void* f, const void* g, const void* mean_f,
                                     const void* mean_g, const void* inv_cap,
                                     const void* inv_klim, void* best_score, void* best_tier,
                                     void* stream) {
  if (N == 0) return 0;
  BestApps apps{(const float*)demand, (const float*)tasks, (const float*)crit,
                (const int*)a_src, (const int*)a0, (const uint8_t*)feasible,
                (const int*)moves_left, (const float*)totals};
  BestTiers tiers{(const float*)capacity, (const float*)task_limit, (const float*)ideal_frac,
                  (const float*)ideal_task_frac, (const float*)weights, (const float*)f,
                  (const float*)g, (const float*)mean_f, (const float*)mean_g,
                  (const float*)inv_cap, (const float*)inv_klim};
  int G = (T <= kThreadPerAppMaxT) ? 1 : group_width(T);
  long long threads = (long long)N * G;
  int blocks = (int)((threads + kThreads - 1) / kThreads);
  size_t smem = sizeof(float) * ((size_t)(4 * R + 4) * T + R + 6);
  move_eval_best_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      N, T, R, G, apps, tiers, (float*)best_score, (int*)best_tier);
  return (int)cudaGetLastError();
}

// The shard-batched fused sweep: S problems of N apps and T tiers each,
// every array with a leading [S] axis; one launch for all shards.
extern "C" int move_eval_best_batched_launch(
    int S, int N, int T, int R, const void* demand, const void* tasks, const void* crit,
    const void* a_src, const void* a0, const void* feasible, const void* moves_left,
    const void* totals, const void* active, const void* capacity, const void* task_limit,
    const void* ideal_frac, const void* ideal_task_frac, const void* weights, const void* f,
    const void* g, const void* mean_f, const void* mean_g, const void* inv_cap,
    const void* inv_klim, void* best_score, void* best_tier, void* stream) {
  if (N == 0 || S == 0) return 0;
  if (S > 65535) return (int)cudaErrorInvalidValue;
  BestApps apps{(const float*)demand, (const float*)tasks, (const float*)crit,
                (const int*)a_src, (const int*)a0, (const uint8_t*)feasible,
                (const int*)moves_left, (const float*)totals};
  BestTiers tiers{(const float*)capacity, (const float*)task_limit, (const float*)ideal_frac,
                  (const float*)ideal_task_frac, (const float*)weights, (const float*)f,
                  (const float*)g, (const float*)mean_f, (const float*)mean_g,
                  (const float*)inv_cap, (const float*)inv_klim};
  int G = (T <= kThreadPerAppMaxT) ? 1 : group_width(T);
  long long threads = (long long)N * G;
  dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), (unsigned)S);
  size_t smem = sizeof(float) * ((size_t)(4 * R + 4) * T + R + 6);
  move_eval_best_batched_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      N, T, R, G, apps, tiers, (const int*)active, (float*)best_score, (int*)best_tier);
  return (int)cudaGetLastError();
}

extern "C" int move_eval_launch(int N, int T, int R, const void* demand, const void* tasks,
                                const void* crit, const void* a_src, const void* a0,
                                const void* totals, const void* capacity,
                                const void* task_limit, const void* ideal_frac,
                                const void* ideal_task_frac, const void* weights, const void* f,
                                const void* g, const void* mean_f, const void* mean_g,
                                const void* inv_cap, const void* inv_klim, void* delta,
                                void* stream) {
  if (N == 0) return 0;
  BestApps apps{(const float*)demand, (const float*)tasks, (const float*)crit,
                (const int*)a_src, (const int*)a0, nullptr, nullptr, (const float*)totals};
  BestTiers tiers{(const float*)capacity, (const float*)task_limit, (const float*)ideal_frac,
                  (const float*)ideal_task_frac, (const float*)weights, (const float*)f,
                  (const float*)g, (const float*)mean_f, (const float*)mean_g,
                  (const float*)inv_cap, (const float*)inv_klim};
  int G = (T <= kThreadPerAppMaxT) ? 1 : group_width(T);
  long long threads = (long long)N * G;
  int blocks = (int)((threads + kThreads - 1) / kThreads);
  size_t smem = sizeof(float) * ((size_t)tier_table_floats(T, R) + (G == 1 ? kThreads * T : 0));
  move_eval_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(N, T, R, G, apps, tiers,
                                                                     (float*)delta);
  return (int)cudaGetLastError();
}

// The sweeps' tier table for S stacked problems, one CTA a problem
// (kernels/ref.py::tier_stats_ref bit for bit): f = util / cap, g = tasks /
// klim, 1 / cap and 1 / klim, each an IEEE division as torch's elementwise
// ops on a card; then the means of f's R columns and of g, one thread each,
// as core/means.py::tier_mean takes them: a sequential sum over t = 0, ...,
// T - 1 from 0, times the float 1/T (the reference's order for T <= 16).
// A problem's quotients are staged in shared memory (T * (R + 1) floats).
__global__ void tier_stats_kernel(int T, int R, const float* __restrict__ cap,
                                  const float* __restrict__ klim,
                                  const float* __restrict__ util,
                                  const float* __restrict__ tier_tasks, float* __restrict__ f,
                                  float* __restrict__ g, float* __restrict__ mean_f,
                                  float* __restrict__ mean_g, float* __restrict__ inv_cap,
                                  float* __restrict__ inv_klim) {
  extern __shared__ float sm_q[];          // [T, R] f, then [T] g
  const size_t s = blockIdx.x;
  const size_t TR = (size_t)T * R;
  cap += s * TR; util += s * TR; f += s * TR; inv_cap += s * TR;
  klim += s * T; tier_tasks += s * T; g += s * T; inv_klim += s * T;
  for (int i = threadIdx.x; i < T * R; i += blockDim.x) {
    const float q = util[i] / cap[i];
    sm_q[i] = q;
    f[i] = q;
    inv_cap[i] = 1.0f / cap[i];
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float q = tier_tasks[t] / klim[t];
    sm_q[TR + t] = q;
    g[t] = q;
    inv_klim[t] = 1.0f / klim[t];
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c > R) return;
  const float inv_T = 1.0f / (float)T;
  const float* col = (c < R) ? sm_q + c : sm_q + TR;
  const int step = (c < R) ? R : 1;
  float acc = 0.0f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) acc += col[(size_t)t * step];
  if (c < R) mean_f[s * R + c] = acc * inv_T;
  else mean_g[s] = acc * inv_T;
}

// core/means.py::tier_mean over the tier axis of x [rows, T, C] (contiguous),
// one thread an output column: out[l, c] = (sum over t of x[l, t, c], in
// order from 0) * (1.0f / T).  The objective's means on a card.
__global__ void tier_mean_kernel(int rows, int T, int C, const float* __restrict__ x,
                                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * C) return;
  const long long l = i / C;
  const float* col = x + l * T * C + (i - l * C);
  float acc = 0.0f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) acc += col[(size_t)t * C];
  out[i] = acc * (1.0f / (float)T);
}

extern "C" int tier_mean_launch(int rows, int T, int C, const void* x, void* out,
                                void* stream) {
  const long long n = (long long)rows * C;
  if (n == 0) return 0;
  const int threads = 128;
  tier_mean_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     (cudaStream_t)stream>>>(rows, T, C, (const float*)x, (float*)out);
  return (int)cudaGetLastError();
}

// The tier table of S problems of T tiers and R resources, every array with
// a leading [S] axis (S = 1 for one problem).
extern "C" int tier_stats_launch(int S, int T, int R, const void* capacity,
                                 const void* task_limit, const void* util,
                                 const void* tier_tasks, void* f, void* g, void* mean_f,
                                 void* mean_g, void* inv_cap, void* inv_klim, void* stream) {
  if (S == 0 || T == 0) return 0;
  size_t smem = sizeof(float) * (size_t)T * (R + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  tier_stats_kernel<<<S, 128, smem, (cudaStream_t)stream>>>(
      T, R, (const float*)capacity, (const float*)task_limit, (const float*)util,
      (const float*)tier_tasks, (float*)f, (float*)g, (float*)mean_f, (float*)mean_g,
      (float*)inv_cap, (float*)inv_klim);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
