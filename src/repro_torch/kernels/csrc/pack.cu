// Hopper (sm_90a) kernel for first-fit-decreasing host packing.
//
// Replaces src/repro/kernels/pack.py::pack_ffd_tiers (and pack_ffd, its T = 1
// case): an XLA lax.scan over items, vmapped over tiers, not a Pallas kernel.
// In eager PyTorch a strictly sequential scan over M items would cost a chain
// of launches per item, so the scan lives in one kernel here.
//
// What it computes: tier t's items demand[t, i, :] (pre-sorted decreasing,
// zero-padded) are placed in order into the lowest-index live host whose
// remaining capacity covers the item in every resource; rejected[t, i] = 1
// when no live host fits.  Hosts h < min(hosts_per_tier[t], num_hosts_pad)
// are live and start at `capacity`; dead bins start at -inf, as in the
// reference, so they never accept.
//
// Bound on this card: FFD is a strict chain over a tier's items (each
// placement changes the bins the next item sees), so a tier's time is its
// item count times the length of one link.  The bytes moved (T*M*R*4 in,
// T*M out) and the f32 work are tiny beside that chain (see PERF.md).
//
// Design: one warp per tier and no block barrier.  Lane l holds the S bins
// h = l*S + s (s < S) in registers, so the global first fit is the lowest
// fitting lane's lowest fitting slot.  Per item the chain is: each lane
// tests its S slots -> one ballot of "a slot fits" -> the winning lane (it
// fits and no lower lane does) subtracts the item from its lowest fitting
// slot.  The fit tests stay predicates (no bit mask is built), which keeps
// the chain about ten dependent instructions long.  The demand never
// depends on the bins, so it is kept off the chain: a ring of kStages tiles
// of kTile items is filled by cp.async ahead of the scan, and each item is
// a broadcast read from shared memory.  A tile whose items are
// all zero (the sorted padding) changes no bin, so its answer is one ballot:
// rejected iff no bin covers a zero item.  Zeros elsewhere take the per-item
// path.  Each lane stores the 4 reject bytes of its 4 items of a tile.
// The f32 subtractions host + (-d) happen in item order, so reject masks are
// bit-identical to kernels/ref.py::pack_ffd_tiers_ref and to the reference.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPerLane = 4;                 // items a lane loads and stores per tile
constexpr int kTile = 32 * kPerLane;        // items per tile
constexpr int kStages = 8;                  // tiles in flight in the cp.async ring
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy this lane's kPerLane items of tile `tile` (R floats each, 16*R bytes)
// into `buf`; items past M are zero-filled (a copy of 0 bytes still names the
// aligned `demand` base).  Every row starts 16-byte aligned: M*R % 4 == 0.
template <int R>
__device__ __forceinline__ void load_tile(float* buf, const float* demand, const float* d_t,
                                          int M, int tile, int lane) {
  const int first = tile * kTile + lane * kPerLane;
  const int valid = max(0, min(kPerLane, M - first));
  const float* src = d_t + (size_t)first * R;
  float* dst = buf + lane * kPerLane * R;
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int bytes = max(0, min(16, valid * R * 4 - 16 * c));
    cp_async16(dst + 4 * c, bytes > 0 ? src + 4 * c : demand, bytes);
  }
}

template <int S, int R>
__global__ void __launch_bounds__(32) pack_ffd_kernel(int M, int num_hosts_pad,
                                                      const float* __restrict__ demand,
                                                      const float* __restrict__ capacity,
                                                      const int* __restrict__ hosts_per_tier,
                                                      uint8_t* __restrict__ rejected) {
  __shared__ __align__(16) float ring[kStages][kTile * R];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int nh = min(hosts_per_tier[t], num_hosts_pad);

  float host[S][R];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool live = lane * S + s < nh;
#pragma unroll
    for (int r = 0; r < R; ++r) host[s][r] = live ? capacity[r] : -INFINITY;
  }
  const unsigned lower = (1u << lane) - 1u;            // the lanes below this one
  const float* d_t = demand + (size_t)t * M * R;
  uint8_t* rej_t = rejected + (size_t)t * M;
  const int tiles = (M + kTile - 1) / kTile;

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < tiles) load_tile<R>(ring[p], demand, d_t, M, p, lane);
    cp_async_commit();
  }
  for (int tile = 0; tile < tiles; ++tile) {
    const int ahead = tile + kStages - 1;
    if (ahead < tiles) load_tile<R>(ring[ahead % kStages], demand, d_t, M, ahead, lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                     // this tile's copies landed
    __syncwarp();
    const float* buf = ring[tile % kStages];
    const int base = tile * kTile;
    const int n = min(kTile, M - base);

    bool zero = true;
#pragma unroll
    for (int i = 0; i < kPerLane * R; ++i) zero = zero && (buf[lane * kPerLane * R + i] == 0.0f);
    uint32_t rej4;                                    // this lane's 4 reject bytes
    if (__all_sync(kFull, zero)) {
      // An all-zero item changes no bin: one answer for the whole tile.
      bool covers = false;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        bool f = true;
#pragma unroll
        for (int r = 0; r < R; ++r) f = f && (host[s][r] >= 0.0f);
        covers = covers || f;
      }
      rej4 = __ballot_sync(kFull, covers) ? 0u : 0x01010101u;
    } else {
      uint32_t mine = 0;                              // the reject bits of my group of 32
#pragma unroll
      for (int w = 0; w < kTile / 32; ++w) {
        uint32_t word = 0;
        const int kn = min(32, n - 32 * w);
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          const float* dk = buf + (32 * w + k) * R;
          float d[R];
#pragma unroll
          for (int r = 0; r < R; ++r) d[r] = dk[r];
          bool fit[S];                                // slot s covers the item
          bool any = false;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            fit[s] = true;
#pragma unroll
            for (int r = 0; r < R; ++r) fit[s] = fit[s] && (host[s][r] >= d[r]);
            any = any || fit[s];
          }
          const unsigned ballot = __ballot_sync(kFull, any);
          const bool win = (ballot & lower) == 0u;    // no lower lane fits
          bool lower_slot = false;                    // a lower slot of mine fits
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (win && fit[s] && !lower_slot) {
#pragma unroll
              for (int r = 0; r < R; ++r) host[s][r] = host[s][r] + (-d[r]);
            }
            lower_slot = lower_slot || fit[s];
          }
          word |= (unsigned)(ballot == 0u) << k;
        }
        if ((lane >> 3) == w) mine = word;
      }
      const unsigned bits = (mine >> ((lane & 7) * kPerLane)) & 0xFu;
      rej4 = (bits * 0x00204081u) & 0x01010101u;      // bit u -> byte u
    }
    const int first = base + lane * kPerLane;
    uint8_t* out = rej_t + first;
    if (first + kPerLane <= M && ((uintptr_t)out & 3u) == 0) {
      *reinterpret_cast<uint32_t*>(out) = rej4;
    } else {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        if (first + u < M) out[u] = (uint8_t)((rej4 >> (8 * u)) & 1u);
      }
    }
    __syncwarp();                                     // reads done before the refill
  }
  cp_async_wait<0>();
}

template <int S>
int launch_s(int T, int M, int R, int num_hosts_pad, const float* demand,
             const float* capacity, const int* hosts_per_tier, uint8_t* rejected,
             cudaStream_t stream) {
  switch (R) {
    case 1: pack_ffd_kernel<S, 1><<<T, 32, 0, stream>>>(M, num_hosts_pad, demand, capacity,
                                                        hosts_per_tier, rejected); break;
    case 2: pack_ffd_kernel<S, 2><<<T, 32, 0, stream>>>(M, num_hosts_pad, demand, capacity,
                                                        hosts_per_tier, rejected); break;
    case 3: pack_ffd_kernel<S, 3><<<T, 32, 0, stream>>>(M, num_hosts_pad, demand, capacity,
                                                        hosts_per_tier, rejected); break;
    case 4: pack_ffd_kernel<S, 4><<<T, 32, 0, stream>>>(M, num_hosts_pad, demand, capacity,
                                                        hosts_per_tier, rejected); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// demand must be 16-byte aligned with M % 4 == 0 (the wrapper pads M);
// 1 <= R <= 4 and 1 <= num_hosts_pad <= 1024.
extern "C" int pack_ffd_launch(int T, int M, int R, int num_hosts_pad, const void* demand,
                               const void* capacity, const void* hosts_per_tier,
                               void* rejected, void* stream) {
  if (T == 0 || M == 0) return 0;
  const float* d = (const float*)demand;
  const float* c = (const float*)capacity;
  const int* h = (const int*)hosts_per_tier;
  uint8_t* rej = (uint8_t*)rejected;
  cudaStream_t st = (cudaStream_t)stream;
  const int slots = (num_hosts_pad + 31) / 32;        // bins a lane must hold
  if (slots <= 1) return launch_s<1>(T, M, R, num_hosts_pad, d, c, h, rej, st);
  if (slots <= 2) return launch_s<2>(T, M, R, num_hosts_pad, d, c, h, rej, st);
  if (slots <= 4) return launch_s<4>(T, M, R, num_hosts_pad, d, c, h, rej, st);
  if (slots <= 8) return launch_s<8>(T, M, R, num_hosts_pad, d, c, h, rej, st);
  if (slots <= 16) return launch_s<16>(T, M, R, num_hosts_pad, d, c, h, rej, st);
  if (slots <= 32) return launch_s<32>(T, M, R, num_hosts_pad, d, c, h, rej, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
