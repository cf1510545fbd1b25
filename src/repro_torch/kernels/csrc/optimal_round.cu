// Hopper (sm_90a) kernels for OptimalSearch's confidence-ordered rounding.
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
// is the chain of dependent decisions, one per mover.
//
// Two bodies, chosen by the wrapper from the table's shape alone
// (kernels/optimal_round.py::choose_body).
//
// "registers" (T * (R + 1) <= 32 * MAX_COLS = 128 columns, T <= MAX_TIERS
// = 64: a column is one resource or the task count of one tier; the wrapper
// reads both limits from this file), two launches:
// 1. Staging (optimal_round_stage), a CTA per CHUNK positions of the
//    order: mark the movers, compact them in order (a block-wide prefix
//    sum) and write each mover's packed tiers and feasibility, app id, R
//    demands and tasks, and the column masks of its target and source tiers
//    (none if infeasible) into rows at the chunk's offset of a scratch
//    buffer, with the chunk's mover count.  Every gather of the scan is made
//    here, on the whole card.
// 2. The walk (optimal_round_walk), one CTA of two warps.  Warp 1 streams
//    the staged rows into a ring in shared memory with cp.async, DEPTH
//    chunks ahead, and publishes how many have landed.  Warp 0 walks them:
//    lane c holds column c (and c + 32, ... up to 4 columns) of the tier
//    table in registers, its load and its capacity (or task limit) + 1e-6,
//    and the movers go in rounds.
//    - Speculative round, of up to 64 movers (two a lane; 32 where a lane
//      holds three or four columns): every lane applies each mover of the
//      block as though it were accepted (one f32 add a mover and column: +v
//      at the target's columns, -v at the source's, -0.0 elsewhere), notes
//      the movers whose fit fails in its columns and keeps each step's load;
//      a vote every 8 movers stops the round at a failure, and one OR over
//      the warp gives the first.  Exactness: until the first failing feasible
//      mover every feasible mover really was accepted, so the speculated
//      loads are the true loads and that failure is the true first
//      rejection.  A rejected mover changes nothing, so each lane takes its
//      loads as they stood just before it, and the next round starts after
//      it.  The budget ends the round at the left-th accepted mover (a
//      popcount of the block's feasible flags), where the plain version
//      stops.
//    - Ballot round, of up to 32 movers, while rejections are dense (a
//      speculative round accepted fewer than DENSE_BELOW movers before its
//      rejection): one lane a mover, each tested against the loads at the
//      round's start.  A
//      verdict holds until an accepted mover of the round touches the
//      mover's target tier, and no rejection changes a load, so the first
//      mover that fits is accepted, every one before it rejected, and so on
//      until a mover whose target was touched, where the round ends.
//    The accepted movers of a round write x in parallel, one lane a mover;
//    the loads are written back at the end.
//
// "shared" (wider tables, the kernel's first, one-CTA body;
// optimal_round_shared): one CTA of 1024 threads, tile by tile over the
// order (4096 positions a tile): all threads compact the
// tile's movers and gather their fields into shared memory, then one warp
// walks them, lane r testing resource r of the T x R loads in shared memory
// and lane R the task count, and a warp vote deciding each mover.
//
// Numerics: the fit test and the load updates are the plain version's f32
// additions and comparisons, in the same order (compiled with -fmad=false,
// like the other scheduling kernels; the speculative steps' other columns
// add -0.0, which changes no float), so x and the loads are bit-identical
// to kernels/ref.py::optimal_round_ref.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define FIT_TOL 1e-6f
#define FULL_MASK 0xffffffffu

// ---------------------------------------------------------------------------
// "registers" body
// ---------------------------------------------------------------------------

constexpr int CHUNK = 1024;              // positions of the order a staging CTA compacts
constexpr int STAGE_THREADS = 256;
constexpr int STAGE_ITEMS = CHUNK / STAGE_THREADS;
constexpr int STAGE_WARPS = STAGE_THREADS / 32;
constexpr int RING = 2048;               // staged rows the walk keeps in shared memory
constexpr int MAX_SPEC = 64;             // movers a speculative round takes, at most
constexpr int RING_PAD = MAX_SPEC;       // rows past the ring a partial block may read
constexpr int DEPTH = 4;                 // chunks in flight ahead of the walk
constexpr int MAX_COLS = 4;              // columns a lane holds: T * (R + 1) <= 128
constexpr int MAX_TIERS = 64;            // tiers a round's touched set holds (R >= 1)
constexpr int GROUP = 8;                 // movers between two votes of a speculative round
constexpr int DENSE_BELOW = 4;           // a speculative round that accepts fewer movers
                                         // before its rejection hands over to ballot rounds
constexpr int PUBLISH_EVERY = 128;       // walked rows between two releases of ring rows

// With nothing in flight the ring always has room for the next chunk, even
// against a release PUBLISH_EVERY rows old, so neither warp waits on itself.
static_assert(RING >= CHUNK + MAX_SPEC + PUBLISH_EVERY, "a chunk must fit beside a block");

__host__ __device__ inline int stage_chunks(int N) { return (N + CHUNK - 1) / CHUNK; }
__host__ __device__ inline int walk_cols(int T, int R) { return (T * (R + 1) + 31) / 32; }
// Four-byte fields of a staged row: packed tiers, app id, R + 1 values, and
// per word of the column mask the target's and the source's bits.
__host__ __device__ inline int row_ints(int T, int R) { return 2 + R + 1 + 2 * walk_cols(T, R); }

// Word q of a tier's column mask (column c is bit c % 32 of word c / 32):
// the V columns from `first` on.
__host__ __device__ inline unsigned col_word(int first, int V, int q) {
  const int lo = first - 32 * q;
  const unsigned long long m = (1ull << V) - 1ull;
  if (lo >= 32 || lo + V <= 0) return 0u;
  return lo >= 0 ? (unsigned)(m << lo) : (unsigned)(m >> -lo);
}

// The staging buffer: for each chunk of the order, its movers' rows from the
// chunk's first position on (struct of arrays over every position), then
// the chunks' mover counts.
struct Staged {
  int* ts;                               // [rows] t << 16 | feasible << 15 | src
  int* n;                                // [rows] app id
  float* v;                              // [rows, R + 1] demands, then tasks
  uint2* mask;                           // [rows, cols] target, source columns (0: infeasible)
  int* counts;                           // [chunks]
};

__host__ __device__ inline Staged staged_layout(void* scratch, int N, int T, int R) {
  const size_t rows = (size_t)stage_chunks(N) * CHUNK;
  Staged g;
  g.ts = (int*)scratch;
  g.n = g.ts + rows;
  g.v = (float*)(g.n + rows);
  g.mask = (uint2*)(g.v + rows * (R + 1));     // 8-byte aligned: rows is a multiple of CHUNK
  g.counts = (int*)(g.mask + rows * walk_cols(T, R));
  return g;
}

template <int R>
__global__ void __launch_bounds__(STAGE_THREADS)
round_stage_kernel(int N, int T, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ target, const int* __restrict__ a0,
                   const float* __restrict__ demand, const float* __restrict__ tasks,
                   const bool* __restrict__ feas, Staged g) {
  constexpr int V = R + 1;
  const int cols = walk_cols(T, R);
  __shared__ int warp_off[STAGE_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * CHUNK;
  int n_k[STAGE_ITEMS], ts_k[STAGE_ITEMS];
  unsigned flags = 0;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < STAGE_ITEMS; ++k) {
    const int j = base + tid * STAGE_ITEMS + k;
    n_k[k] = j < N ? (int)order[j] : 0;
  }
#pragma unroll
  for (int k = 0; k < STAGE_ITEMS; ++k) {
    const int j = base + tid * STAGE_ITEMS + k;
    ts_k[k] = 0;
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
  int incl = cnt;                        // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {                       // exclusive scan of the warp totals
    const int w = lane < STAGE_WARPS ? warp_off[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < STAGE_WARPS; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < STAGE_WARPS) warp_off[lane] = wi - w;
    if (lane == STAGE_WARPS - 1) g.counts[blockIdx.x] = wi;
  }
  __syncthreads();
  int row = base + warp_off[warp] + incl - cnt;
#pragma unroll
  for (int k = 0; k < STAGE_ITEMS; ++k) {
    if (flags & (1u << k)) {
      const int n = n_k[k];
      const int t = ts_k[k] >> 16, src = ts_k[k] & 0x7fff;
      const bool ok = feas[(size_t)n * T + t];
      g.n[row] = n;
      g.ts[row] = ts_k[k] | (ok ? 1 << 15 : 0);
#pragma unroll
      for (int r = 0; r < R; ++r) g.v[(size_t)row * V + r] = demand[(size_t)n * R + r];
      g.v[(size_t)row * V + R] = tasks[n];
      for (int q = 0; q < cols; ++q)
        g.mask[(size_t)row * cols + q] = ok ? make_uint2(col_word(t * V, V, q),
                                                         col_word(src * V, V, q))
                                            : make_uint2(0u, 0u);
      ++row;
    }
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Dynamic shared memory of the walk: the ring of staged rows.  The rest is
// static, so the compiler knows that the history's stores leave the ring's
// rows alone.
__host__ __device__ inline size_t walk_smem_bytes(int T, int R) {
  return (size_t)(RING + RING_PAD) * row_ints(T, R) * 4;
}

// One speculative step of one column.  At the mover's target (its bit in
// mt) the load becomes load + v, and the step fails unless that sum is at
// most cap; at its source (ms) the load becomes load + (-v); elsewhere it
// adds -0.0, which leaves every float as it is (-0.0 and NaN included).  So
// the chain from step to step is the one add, and the selects, the test and
// the failure bit stay off it.
__device__ __forceinline__ void spec_step(float& load, unsigned& fail, float v, unsigned mt,
                                          unsigned ms, unsigned lane_bit, float cap,
                                          unsigned step_bit) {
  asm("{\n\t.reg .pred pt, ps, pf;\n\t.reg .b32 a;\n\t.reg .f32 d;\n\t"
      "and.b32 a, %3, %5;\n\tsetp.ne.b32 pt, a, 0;\n\t"
      "and.b32 a, %4, %5;\n\tsetp.ne.b32 ps, a, 0;\n\t"
      "neg.f32 d, %2;\n\t"
      "selp.f32 d, d, 0f80000000, ps;\n\t"
      "selp.f32 d, %2, d, pt;\n\t"
      "add.rn.f32 %0, %0, d;\n\t"
      "setp.gtu.and.f32 pf, %0, %6, pt;\n\t"
      "@pf or.b32 %1, %1, %7;\n\t}"
      : "+f"(load), "+r"(fail)
      : "f"(v), "r"(mt), "r"(ms), "r"(lane_bit), "f"(cap), "r"(step_bit));
}

// Two warps: warp 1 streams the staged rows into the ring (cp.async, DEPTH
// chunks in flight, publishing how many rows have landed), warp 0 walks them.
template <int R, int COLS>
__global__ void __launch_bounds__(64, 1)
round_walk_kernel(int N, int T, Staged g, int* __restrict__ x, float* __restrict__ util,
                  float* __restrict__ tier_tasks, const float* __restrict__ capacity,
                  const float* __restrict__ task_limit, const int* __restrict__ budget,
                  int* __restrict__ status) {
  constexpr int V = R + 1;               // values of a row: R demands, then the tasks
  constexpr int RR = RING + RING_PAD;
  // Movers a speculative round takes: two a lane while a lane holds one or
  // two columns, one a lane above (where the longer history costs more
  // than the rounds it saves).
  constexpr int SPEC = COLS <= 2 ? MAX_SPEC : 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_ts = reinterpret_cast<int*>(smem_raw);           // [RR] t << 16 | ok << 15 | src
  int* s_n = s_ts + RR;                                   // [RR] app ids
  float* s_v = reinterpret_cast<float*>(s_n + RR);        // [RR, V]
  uint2* s_mask = reinterpret_cast<uint2*>(s_v + RR * V); // [RR, COLS] target, source columns
  __shared__ float s_hist[COLS * SPEC * 32];              // [COLS, SPEC steps, 32 lanes]
  __shared__ float s_load[COLS * 32];                     // loads by column (ballot rounds)
  __shared__ float s_cap[COLS * 32];                      // capacity + 1e-6 by column
  __shared__ int s_end[2 * DEPTH];                        // row ends of the chunks in flight
  __shared__ volatile int s_arrived, s_finished, s_pos, s_stop;

  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_arrived = 0;
    s_finished = 0;
    s_pos = 0;
    s_stop = 0;
  }
  __syncthreads();
  const int nchunks = stage_chunks(N);

  if (threadIdx.x >= 32) {
    // -- warp 1: keep DEPTH chunks in flight where the ring has room ----------
    int issued = 0, inflight = 0, rows_issued = 0;
    // The chunks' mover counts, a window of 32 a lane each, the next window
    // read 32 chunks ahead of its use.
    int cwin = lane < nchunks ? g.counts[lane] : 0;
    int cwin_next = 32 + lane < nchunks ? g.counts[32 + lane] : 0;
    int cnt_next = __shfl_sync(FULL_MASK, cwin, 0);   // the count of chunk `issued`
    while (!s_stop) {
      const int released = s_pos;
      while (issued < nchunks && inflight < DEPTH && rows_issued + cnt_next <= released + RING) {
        const size_t src0 = (size_t)issued * CHUNK;
        for (int e = lane; e < cnt_next; e += 32) {
          const int r = (rows_issued + e) & (RING - 1);
          cp_async<4>(s_ts + r, g.ts + src0 + e);
          cp_async<4>(s_n + r, g.n + src0 + e);
#pragma unroll
          for (int v = 0; v < V; ++v) cp_async<4>(s_v + r * V + v, g.v + (src0 + e) * V + v);
#pragma unroll
          for (int q = 0; q < COLS; ++q)
            cp_async<8>(s_mask + r * COLS + q, g.mask + (src0 + e) * COLS + q);
        }
        cp_async_commit();
        rows_issued += cnt_next;
        s_end[issued & (2 * DEPTH - 1)] = rows_issued;   // each lane reads back its own
        ++issued;
        ++inflight;
        if ((issued & 31) == 0) {
          cwin = cwin_next;
          cwin_next = issued + 32 + lane < nchunks ? g.counts[issued + 32 + lane] : 0;
        }
        cnt_next = __shfl_sync(FULL_MASK, cwin, issued & 31);
      }
      if (inflight == 0) {
        if (issued == nchunks) {         // every row has landed
          if (lane == 0) s_finished = 1;
          break;
        }
        continue;                        // the ring is full: wait for the walk
      }
      switch (inflight) {                // the oldest chunk in flight has landed
        case 1: cp_async_wait<0>(); break;
        case 2: cp_async_wait<1>(); break;
        case 3: cp_async_wait<2>(); break;
        default: cp_async_wait<3>(); break;
      }
      __syncwarp();
      const int landed = s_end[(issued - inflight) & (2 * DEPTH - 1)];
      --inflight;
      __threadfence_block();             // the rows before the count that names them
      if (lane == 0) s_arrived = landed;
    }
    cp_async_wait<0>();
    return;
  }

  // -- warp 0: the walk ----------------------------------------------------------
  const int C = T * V;
  const unsigned lane_bit = 1u << lane;
  int tier[COLS], res[COLS];
  float load[COLS], cap[COLS];
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    const int c = lane + 32 * q;
    if (c < C) {
      tier[q] = c / V;
      res[q] = c % V;
      load[q] = res[q] < R ? util[tier[q] * R + res[q]] : tier_tasks[tier[q]];
      cap[q] = (res[q] < R ? capacity[tier[q] * R + res[q]] : task_limit[tier[q]]) + FIT_TOL;
    } else {                             // no column: matches no tier
      tier[q] = -1;
      res[q] = 0;
      load[q] = 0.0f;
      cap[q] = 0.0f;
    }
    s_load[c] = load[q];
    s_cap[c] = cap[q];
  }

  int left = *budget;
  int accepted = 0, walked = 0;
  int pos = 0;                           // the first mover not yet walked
  int released = 0;                      // rows handed back to warp 1
  int arrived = 0;                       // rows landed, as last read
  bool finished = false;                 // every row has landed
  bool dense = false;                    // rejections dense: ballot rounds

  while (left > 0) {
    __syncwarp();                        // the last round's shared reads are done
    if (arrived < pos + SPEC && !finished) {
      do {
        finished = s_finished;           // read before the count, so a final count
        __threadfence_block();
        arrived = s_arrived;
      } while (arrived < pos + SPEC && !finished);
      __threadfence_block();             // the landed rows after their count
    }
    // A block never wraps around the ring, so its rows are base .. base +
    // SPEC - 1 (rows past the block's B are read and ignored).  Lane l holds
    // movers l and 32 + l of it.
    const int base = pos & (RING - 1);
    const int B = min(min(SPEC, arrived - pos), RING - base);
    if (B <= 0) break;                   // every mover walked

    const int ts_own = s_ts[base + lane], ts_hi = s_ts[base + 32 + lane];
    const int n_own = s_n[base + lane], n_hi = s_n[base + 32 + lane];
    const bool ok_own = lane < B && ((ts_own >> 15) & 1);
    const bool ok_hi = 32 + lane < B && ((ts_hi >> 15) & 1);
    const unsigned long long feas_bits =
        __ballot_sync(FULL_MASK, ok_own) | (unsigned long long)__ballot_sync(FULL_MASK, ok_hi) << 32;
    unsigned long long take = 0;         // the block's accepted movers
    int consumed;                        // the block's movers walked
    if (dense) {
      // -- ballot round: each lane tests its mover against the loads at the
      //    round's start.  A verdict stays true until an accepted mover of
      //    the round touches the mover's target tier; the first mover that
      //    fits with a true verdict is accepted (every mover before it is
      //    rejected) and the next is sought, until one whose target was
      //    touched (the round ends before it) or none is left.
      const int t_own = ok_own ? ts_own >> 16 : 0;
      bool fits = ok_own;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = t_own * V + v;
        fits &= s_load[c] + s_v[(base + lane) * V + v] <= s_cap[c];
      }
      unsigned long long touched = 0;    // tiers the round's accepted movers changed
      int done = 0;                      // movers [0, done) decided
      consumed = min(B, 32);             // a ballot round takes a mover a lane
      for (;;) {
        const bool stale = ok_own && ((touched >> t_own) & 1ull);
        const unsigned cand = __ballot_sync(FULL_MASK, lane >= done && (stale || fits));
        if (cand == 0) break;
        const int gm = __ffs(cand) - 1;
        if ((__ballot_sync(FULL_MASK, stale) >> gm) & 1u) {
          consumed = gm;
          break;
        }
        const int tsg = __shfl_sync(FULL_MASK, ts_own, gm);
        const int t = tsg >> 16, src = tsg & 0x7fff;
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          const float v = s_v[(base + gm) * V + res[q]];
          const bool at_t = tier[q] == t;
          if (at_t || tier[q] == src) load[q] = load[q] + (at_t ? v : -v);
        }
        take |= 1ull << gm;
        ++accepted;
        done = gm + 1;
        touched |= (1ull << t) | (1ull << src);
        if (--left == 0) {
          consumed = done;
          break;
        }
      }
      // every mover decided was accepted: speculate again
      dense = take != (1ull << consumed) - 1ull;
    } else {
      // -- speculative round: GROUP movers at a time, their column masks and
      //    values read a group ahead of their steps, the group's history
      //    stored after its steps
      if (B < SPEC) {
        // The rows past a short block are ring padding or past the last
        // staged row: their masks are cleared, so that their steps change
        // nothing.
        for (int j = lane; j < SPEC; j += 32) {
          if (j >= B) {
#pragma unroll
            for (int q = 0; q < COLS; ++q) s_mask[(base + j) * COLS + q] = make_uint2(0u, 0u);
          }
        }
        __syncwarp();
      }
      float ck[COLS];
#pragma unroll
      for (int q = 0; q < COLS; ++q) ck[q] = load[q];
      unsigned fail = 0, fail_hi = 0;    // failing movers 0-31 and 32-63
      uint2 m_c[GROUP][COLS];
      float v_c[GROUP][COLS];
#pragma unroll
      for (int jj = 0; jj < GROUP; ++jj) {
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          m_c[jj][q] = s_mask[(base + jj) * COLS + q];
          v_c[jj][q] = s_v[(base + jj) * V + res[q]];
        }
      }
#pragma unroll
      for (int g8 = 0; g8 < SPEC / GROUP; ++g8) {
        uint2 m_n[GROUP][COLS];
        float v_n[GROUP][COLS];
        if (g8 + 1 < SPEC / GROUP) {
#pragma unroll
          for (int jj = 0; jj < GROUP; ++jj) {
            const int j = (g8 + 1) * GROUP + jj;
#pragma unroll
            for (int q = 0; q < COLS; ++q) {
              m_n[jj][q] = s_mask[(base + j) * COLS + q];
              v_n[jj][q] = s_v[(base + j) * V + res[q]];
            }
          }
        }
        float h[GROUP][COLS];
#pragma unroll
        for (int jj = 0; jj < GROUP; ++jj) {
#pragma unroll
          for (int q = 0; q < COLS; ++q) {
            const int j = g8 * GROUP + jj;
            spec_step(load[q], j < 32 ? fail : fail_hi, v_c[jj][q], m_c[jj][q].x, m_c[jj][q].y,
                      lane_bit, cap[q], 1u << (j & 31));
            h[jj][q] = load[q];
          }
        }
#pragma unroll
        for (int jj = 0; jj < GROUP; ++jj) {
#pragma unroll
          for (int q = 0; q < COLS; ++q)
            s_hist[(q * SPEC + g8 * GROUP + jj) * 32 + lane] = h[jj][q];
        }
        if (__any_sync(FULL_MASK, (fail | fail_hi) != 0) || (g8 + 1) * GROUP >= B) break;
        if (g8 + 1 < SPEC / GROUP) {
#pragma unroll
          for (int jj = 0; jj < GROUP; ++jj) {
#pragma unroll
            for (int q = 0; q < COLS; ++q) {
              m_c[jj][q] = m_n[jj][q];
              v_c[jj][q] = v_n[jj][q];
            }
          }
        }
      }
      const unsigned long long fails =
          __reduce_or_sync(FULL_MASK, fail) |
          (unsigned long long)__reduce_or_sync(FULL_MASK, fail_hi) << 32;
      const int f = fails ? __ffsll(fails) - 1 : SPEC;  // the first rejected mover
      const unsigned long long cand = f >= SPEC ? feas_bits : feas_bits & ((1ull << f) - 1ull);
      const int n_ok = __popcll(cand);
      int e;                                            // movers whose effect stands
      if (n_ok >= left) {                               // the budget ends the walk
        unsigned long long m = cand;
        for (int i = 1; i < left; ++i) m &= m - 1ull;
        e = __ffsll(m);                                 // the left-th accepted mover, + 1
        take = e >= SPEC ? cand : cand & ((1ull << e) - 1ull);
        consumed = e;
        accepted += left;
        left = 0;
      } else {
        take = cand;
        accepted += n_ok;
        left -= n_ok;
        e = f < B ? f : B;
        consumed = f < B ? f + 1 : B;
      }
      if (e < B) {                       // undo the speculated movers from e on
#pragma unroll
        for (int q = 0; q < COLS; ++q)
          load[q] = e == 0 ? ck[q] : s_hist[(q * SPEC + e - 1) * 32 + lane];
      }
      // a rejection came early in the block: ballot rounds
      dense = f < B && n_ok < DENSE_BELOW;
    }
    if (dense) {                         // the loads by column, for the ballot round
#pragma unroll
      for (int q = 0; q < COLS; ++q) s_load[lane + 32 * q] = load[q];
    }
    if ((take >> lane) & 1ull) x[n_own] = ts_own >> 16;
    if ((take >> (32 + lane)) & 1ull) x[n_hi] = ts_hi >> 16;
    pos += consumed;
    walked += consumed;
    if (pos - released >= PUBLISH_EVERY) {
      __threadfence_block();             // the reads of the released rows before their release
      released = pos;
      if (lane == 0) s_pos = released;
    }
  }
  if (lane == 0) s_stop = 1;

  // -- write back ---------------------------------------------------------------
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    const int c = lane + 32 * q;
    if (c < C) {
      if (res[q] < R) util[tier[q] * R + res[q]] = load[q];
      else tier_tasks[tier[q]] = load[q];
    }
  }
  if (lane == 0) {
    status[0] = accepted;
    status[1] = walked;
  }
}

// ---------------------------------------------------------------------------
// "shared" body: for tables wider than the walk's registers hold
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Refused before any call could fail and leave its error for the next launch
// to read: more shared memory than a block may opt in to.
static int set_smem(const void* kernel, size_t smem) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// fn(std::integral_constant<int, R>) for R in 1..4; anything else is refused.
template <typename F>
static int with_resources(int R, F fn) {
  switch (R) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The "registers" body takes a table whose T * (R + 1) columns fit the
// walking warp (MAX_COLS a lane) and whose tiers fit a round's touched set.
static bool registers_fit(int N, int T, int R, const void* scratch) {
  return N > 0 && T > 0 && R >= 1 && R <= 4 && T * (R + 1) <= MAX_COLS * 32 &&
         T <= MAX_TIERS && scratch != nullptr;
}

template <int R, int COLS>
int launch_walk(int N, int T, const Staged& g, int* x, float* util, float* tier_tasks,
                const float* capacity, const float* task_limit, const int* budget, int* status,
                cudaStream_t stream) {
  const size_t smem = walk_smem_bytes(T, R);
  int err = set_smem((const void*)round_walk_kernel<R, COLS>, smem);
  if (err != 0) return err;
  round_walk_kernel<R, COLS><<<1, 64, smem, stream>>>(N, T, g, x, util, tier_tasks, capacity,
                                                      task_limit, budget, status);
  return (int)cudaGetLastError();
}

// The "registers" body's staging buffer in four-byte words for N apps, T
// tiers and R resources (the wrapper allocates it): ceil(N / CHUNK) * CHUNK
// rows of row_ints(T, R) words, then a count a chunk.
extern "C" long long optimal_round_scratch_words(int N, int T, int R) {
  const long long chunks = stage_chunks(N);
  return chunks * CHUNK * row_ints(T, R) + chunks;
}

// "registers" body, launch 1: stage the movers of the order into `scratch`.
extern "C" int optimal_round_stage(int N, int T, int R, const void* order, const void* target,
                                   const void* a0, const void* demand, const void* tasks,
                                   const void* feas, void* scratch, void* stream) {
  if (!registers_fit(N, T, R, scratch)) return (int)cudaErrorInvalidValue;
  return with_resources(R, [&](auto r) {
    constexpr int RC = decltype(r)::value;
    round_stage_kernel<RC><<<stage_chunks(N), STAGE_THREADS, 0, (cudaStream_t)stream>>>(
        N, T, (const int64_t*)order, (const int64_t*)target, (const int*)a0,
        (const float*)demand, (const float*)tasks, (const bool*)feas,
        staged_layout(scratch, N, T, RC));
    return (int)cudaGetLastError();
  });
}

// "registers" body, launch 2: walk what optimal_round_stage wrote to `scratch`.
extern "C" int optimal_round_walk(int N, int T, int R, void* x, void* util, void* tier_tasks,
                                  const void* capacity, const void* task_limit,
                                  const void* budget, void* status, void* scratch,
                                  void* stream) {
  if (!registers_fit(N, T, R, scratch)) return (int)cudaErrorInvalidValue;
  return with_resources(R, [&](auto r) {
    constexpr int RC = decltype(r)::value;
    const Staged g = staged_layout(scratch, N, T, RC);
    auto walk = [&](auto cols) {
      return launch_walk<RC, decltype(cols)::value>(
          N, T, g, (int*)x, (float*)util, (float*)tier_tasks, (const float*)capacity,
          (const float*)task_limit, (const int*)budget, (int*)status, (cudaStream_t)stream);
    };
    switch (walk_cols(T, RC)) {
      case 1: return walk(std::integral_constant<int, 1>{});
      case 2: return walk(std::integral_constant<int, 2>{});
      case 3: return walk(std::integral_constant<int, 3>{});
      default: return walk(std::integral_constant<int, 4>{});   // registers_fit: <= 4
    }
  });
}

// The "shared" body, one launch.
extern "C" int optimal_round_shared(int N, int T, int R, const void* order, const void* target,
                                    void* x, void* util, void* tier_tasks, const void* a0,
                                    const void* demand, const void* tasks,
                                    const void* capacity, const void* task_limit,
                                    const void* feas, const void* budget, void* status,
                                    void* stream) {
  if (N <= 0 || T <= 0 || T > 0x7fff) return (int)cudaErrorInvalidValue;
  return with_resources(R, [&](auto r) {
    constexpr int RC = decltype(r)::value;
    const size_t smem = round_smem_bytes(T, RC);
    int err = set_smem((const void*)optimal_round_kernel<RC>, smem);
    if (err != 0) return err;
    optimal_round_kernel<RC><<<1, THREADS, smem, (cudaStream_t)stream>>>(
        N, T, (const int64_t*)order, (const int64_t*)target, (int*)x, (float*)util,
        (float*)tier_tasks, (const int*)a0, (const float*)demand, (const float*)tasks,
        (const float*)capacity, (const float*)task_limit, (const bool*)feas,
        (const int*)budget, (int*)status);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
