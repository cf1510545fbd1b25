// Hopper (sm_90a) kernel for OptimalSearch's confidence-ordered rounding.
//
// Replaces the sequential lax.scan of src/repro/core/solver_optimal.py::_round
// (the scan at :138); it is not a Pallas kernel there, but on the card a host
// loop over the movers would cost a host round trip per app.
//
// What it computes: the apps arrive in `order` (most confident first, a
// stable sort of -(p_target - p_stay) done by torch before the launch, with
// the argmax `target` of each row).  Walking that order, each app whose target
// is not its home (a "mover") is moved if the destination is feasible
// (feas[n, t]), the destination's loads plus the app's demand and tasks stay
// within capacity and task limit plus the literal 1e-6 (f32), and the
// movement budget is positive; the loads then change by util[src] + (-d) and
// util[t] + d in that order.  An app that stays home changes nothing, so only
// the movers are walked, and once the budget is spent no later app can be
// accepted, so the walk stops there.  x, util and tier_tasks are updated in
// place; status = (accepted, movers walked).
//
// Bound: the bytes are the order, the targets and the homes of the apps
// scanned (20 B an app) and a mover's demand, tasks and feasibility byte, a
// few MB at fleet scale, so under a microsecond at 3.35 TB/s; what it takes
// is the chain of dependent decisions, one per mover (the loads of two
// tiers' state, an add, a compare and a vote).  Design: one CTA of 1024
// threads, tile by tile over the order (4096 positions a tile).
// 1. Prologue, all threads: each thread reads 4 consecutive positions of the
//    order and gathers their targets and homes, marks the movers, and a
//    block-wide prefix sum (warp shuffles, then the 32 warp totals) gives
//    each mover its slot, in order; the thread then gathers its movers'
//    demand, tasks and feasibility byte into the slots in shared memory.
//    Every gather of the scan is made here, by 1024 threads at once.
// 2. Walk, one warp, shared memory only: lane r tests resource r against
//    the T x R loads and lane R the task count, and a warp vote decides;
//    lane r then updates resource r of both tiers (each lane only ever
//    touches its own column, so no barrier is needed between links).  The
//    next mover's slot is read ahead of each decision.  The budget lives in
//    a register.  (A first version kept the movers' fields in registers,
//    gathered 32 movers at a time; the compiler re-read them from device
//    memory at each use: 693.5 cycles a link at the main path on an H100
//    80GB HBM3 at 700 W, against 532.7 for this design, chip_smoke.py 3f.)
// 3. The other warps wait at the barrier; the walk's budget is shared, and
//    the tiles stop once it reaches 0.  Then the loads are written back.
//
// Numerics: the fit test and the load updates are the plain version's f32
// additions and comparisons, in the same order (compiled with -fmad=false,
// like the other scheduling kernels), so x and the loads are bit-identical to
// kernels/ref.py::optimal_round_ref.
#include <cuda_runtime.h>
#include <stdint.h>

#define FIT_TOL 1e-6f
#define FULL_MASK 0xffffffffu

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;                 // positions of the order a thread reads a tile
constexpr int TILE = THREADS * ITEMS;

// Shared memory in bytes for T tiers and R resources: the tier tables, and
// per mover slot its app id, packed tiers, tasks and R demands.
__host__ __device__ inline size_t round_smem_bytes(int T, int R) {
  return (size_t)T * R * 2 * sizeof(float) + (size_t)T * 2 * sizeof(float)
         + (size_t)TILE * (3 + R) * sizeof(int) + (size_t)(WARPS + 2) * sizeof(int);
}

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
optimal_round_kernel(int N, int T, const int64_t* __restrict__ order,
                     const int64_t* __restrict__ target, int* __restrict__ x,
                     float* __restrict__ util, float* __restrict__ tier_tasks,
                     const int* __restrict__ a0, const float* __restrict__ demand,
                     const float* __restrict__ tasks, const float* __restrict__ capacity,
                     const float* __restrict__ task_limit, const bool* __restrict__ feas,
                     const int* __restrict__ budget, int* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_util = reinterpret_cast<float*>(smem_raw);    // [T, R] loads
  float* s_cap = s_util + T * R;                         // [T, R] capacity + 1e-6
  float* s_tt = s_cap + T * R;                           // [T] task counts
  float* s_lim = s_tt + T;                               // [T] task limit + 1e-6
  int* buf_n = reinterpret_cast<int*>(s_lim + T);        // [TILE] the tile's movers, in order
  int* buf_ts = buf_n + TILE;                            // [TILE] t << 16 | feasible << 15 | home
  float* buf_k = reinterpret_cast<float*>(buf_ts + TILE);  // [TILE] tasks
  float* buf_d = buf_k + TILE;                           // [TILE, R] demand
  int* warp_off = reinterpret_cast<int*>(buf_d + TILE * R);  // [WARPS]
  int* tile_movers = warp_off + WARPS;                   // [1]
  int* shared_left = tile_movers + 1;                    // [1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < T * R; e += THREADS) {
    s_util[e] = util[e];
    s_cap[e] = capacity[e] + FIT_TOL;
  }
  for (int e = tid; e < T; e += THREADS) {
    s_tt[e] = tier_tasks[e];
    s_lim[e] = task_limit[e] + FIT_TOL;
  }
  int left = *budget;                    // the same value in every thread
  int accepted = 0, walked = 0;          // kept by the walking warp
  __syncthreads();

  for (int base = 0; base < N && left > 0; base += TILE) {
    // -- 1. prologue: mark the tile's movers, compact them in order and gather
    //       what the walk reads of each into shared memory ---------------------
    int n_k[ITEMS], ts_k[ITEMS];
    unsigned flags = 0;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int j = base + tid * ITEMS + k;
      n_k[k] = j < N ? (int)order[j] : 0;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int j = base + tid * ITEMS + k;
      if (j < N) {
        const int t = (int)target[n_k[k]];
        const int src = a0[n_k[k]];
        ts_k[k] = (t << 16) | src;
        if (t != src) {
          flags |= 1u << k;
          ++cnt;
        }
      }
    }
    int incl = cnt;                      // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {                     // exclusive scan of the warp totals
      const int w = warp_off[lane];
      int wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, wi, off);
        if (lane >= off) wi += y;
      }
      warp_off[lane] = wi - w;
      if (lane == 31) *tile_movers = wi;
    }
    __syncthreads();
    int pos = warp_off[warp] + incl - cnt;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (flags & (1u << k)) {
        const int n = n_k[k];
        const int t = ts_k[k] >> 16;
        buf_n[pos] = n;
        buf_ts[pos] = ts_k[k] | (feas[(size_t)n * T + t] ? 1 << 15 : 0);
        buf_k[pos] = tasks[n];
#pragma unroll
        for (int r = 0; r < R; ++r) buf_d[pos * R + r] = demand[(size_t)n * R + r];
        ++pos;
      }
    }
    __syncthreads();
    const int m = *tile_movers;

    // -- 2. walk: one warp, one link a mover, shared memory only ---------------
    if (warp == 0) {
      // The next mover's fields are read ahead of each link's decision, so
      // the chain is the loads of the two tiers' state, the add, the
      // compare and the vote.
      int ts = m > 0 ? buf_ts[0] : 0;
      float k = m > 0 ? buf_k[0] : 0.0f;
      float dr = (m > 0 && lane < R) ? buf_d[lane] : 0.0f;
      for (int i = 0; i < m; ++i) {
        const int j = i + 1 < m ? i + 1 : i;
        const int ts_next = buf_ts[j];
        const float k_next = buf_k[j];
        const float d_next = lane < R ? buf_d[j * R + lane] : 0.0f;
        const int t = ts >> 16, src = ts & 0x7fff;
        const bool ok = (ts >> 15) & 1;
        // Movers have t != src, so the loads of both tiers are read before
        // either is written.
        float u_t = 0.0f, u_s = 0.0f;
        bool fit = true;
        if (lane < R) {
          u_t = s_util[t * R + lane];
          u_s = s_util[src * R + lane];
          fit = u_t + dr <= s_cap[t * R + lane];
        } else if (lane == R) {
          u_t = s_tt[t];
          u_s = s_tt[src];
          fit = u_t + k <= s_lim[t];
        }
        ++walked;
        if (__all_sync(FULL_MASK, fit) && ok) {
          if (lane < R) {
            s_util[src * R + lane] = u_s + (-dr);
            s_util[t * R + lane] = u_t + dr;
          } else if (lane == R) {
            s_tt[src] = u_s + (-k);
            s_tt[t] = u_t + k;
          }
          if (lane == 0) x[buf_n[i]] = t;
          ++accepted;
          if (--left <= 0) break;
        }
        ts = ts_next;
        k = k_next;
        dr = d_next;
      }
      if (lane == 0) *shared_left = left;
    }
    __syncthreads();
    left = *shared_left;
  }

  // -- 3. write back -------------------------------------------------------------
  __syncthreads();
  for (int e = tid; e < T * R; e += THREADS) util[e] = s_util[e];
  for (int e = tid; e < T; e += THREADS) tier_tasks[e] = s_tt[e];
  if (tid == 0) {
    status[0] = accepted;
    status[1] = walked;
  }
}

template <int R>
int launch(int N, int T, const void* order, const void* target, void* x, void* util,
           void* tier_tasks, const void* a0, const void* demand, const void* tasks,
           const void* capacity, const void* task_limit, const void* feas,
           const void* budget, void* status, cudaStream_t stream) {
  const size_t smem = round_smem_bytes(T, R);
  // Too many tiers for the block's shared memory: refused here, before any
  // call could fail and leave its error for the next launch to read.
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(optimal_round_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  optimal_round_kernel<R><<<1, THREADS, smem, stream>>>(
      N, T, (const int64_t*)order, (const int64_t*)target, (int*)x, (float*)util,
      (float*)tier_tasks, (const int*)a0, (const float*)demand, (const float*)tasks,
      (const float*)capacity, (const float*)task_limit, (const bool*)feas,
      (const int*)budget, (int*)status);
  return (int)cudaGetLastError();
}

extern "C" int optimal_round_launch(int N, int T, int R, const void* order, const void* target,
                                    void* x, void* util, void* tier_tasks, const void* a0,
                                    const void* demand, const void* tasks, const void* capacity,
                                    const void* task_limit, const void* feas, const void* budget,
                                    void* status, void* stream) {
  if (N <= 0 || T <= 0 || T > 0x7fff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ROUND_LAUNCH(RR)                                                                    \
  launch<RR>(N, T, order, target, x, util, tier_tasks, a0, demand, tasks, capacity,        \
             task_limit, feas, budget, status, s)
  switch (R) {
    case 1: return ROUND_LAUNCH(1);
    case 2: return ROUND_LAUNCH(2);
    case 3: return ROUND_LAUNCH(3);
    case 4: return ROUND_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROUND_LAUNCH
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
