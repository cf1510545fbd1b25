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
// are live and start at `capacity`; dead bins never accept.
//
// Design: one CTA per tier, one thread per padded host bin (the bin's
// remaining capacity lives in that thread's registers).  Each item is a
// block-wide fit test, a ballot per warp and a minimum over the warps' first
// fitting index (double-buffered in shared memory, so one __syncthreads per
// item), and one subtraction by the winning thread.  The f32 subtractions
// happen in scan order, so reject masks are bit-identical to the reference.
// An all-zero item (padding) fits the first live host and changes nothing
// (capacity never drops below 0: a host only takes an item it covers), so it
// is answered without a barrier.
//
// Bound on this card: the scan is a dependent chain of M steps per tier; the
// bytes moved (T*M*R*4 in, T*M out) and the f32 work are tiny beside the
// chain's latency, which is what the time measures (see PERF.md).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MAX_R 4
#define MAX_WARPS 32

__global__ void pack_ffd_kernel(int M, int R, int num_hosts_pad,
                                const float* __restrict__ demand,      // [T, M, R]
                                const float* __restrict__ capacity,    // [R]
                                const int* __restrict__ hosts_per_tier,  // [T]
                                uint8_t* __restrict__ rejected) {      // [T, M]
  __shared__ int first_buf[2][MAX_WARPS];
  const int t = blockIdx.x;
  const int h = threadIdx.x;
  const int warp = h >> 5;
  const int nwarps = blockDim.x >> 5;
  int nh = hosts_per_tier[t];
  if (nh > num_hosts_pad) nh = num_hosts_pad;
  const bool live = h < nh;

  float host[MAX_R];
  bool cap_nonneg = true;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < R) {
      host[r] = capacity[r];
      cap_nonneg = cap_nonneg && (capacity[r] >= 0.0f);
    }
  }

  const float* d_t = demand + (size_t)t * M * R;
  uint8_t* rej_t = rejected + (size_t)t * M;
  int step = 0;                            // barrier steps taken (buffer parity)
  for (int i = 0; i < M; ++i) {
    float d[MAX_R];
    bool zero = true;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < R) {
        d[r] = d_t[(size_t)i * R + r];
        zero = zero && (d[r] == 0.0f);
      }
    }
    if (zero && cap_nonneg) {              // uniform across the block
      if (h == 0) rej_t[i] = (nh > 0) ? 0 : 1;
      continue;
    }
    bool fit = live;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < R) fit = fit && (host[r] >= d[r]);
    }
    unsigned ballot = __ballot_sync(0xffffffffu, fit);
    int* buf = first_buf[step & 1];
    if ((h & 31) == 0) buf[warp] = ballot ? (warp * 32 + __ffs(ballot) - 1) : INT_MAX;
    __syncthreads();
    int first = INT_MAX;
    for (int w = 0; w < nwarps; ++w) first = min(first, buf[w]);
    if (h == first) {
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        if (r < R) host[r] = host[r] + (-d[r]);
      }
    }
    if (h == 0) rej_t[i] = (first == INT_MAX) ? 1 : 0;
    ++step;
  }
}

extern "C" int pack_ffd_launch(int T, int M, int R, int num_hosts_pad, const void* demand,
                               const void* capacity, const void* hosts_per_tier,
                               void* rejected, void* stream) {
  if (T == 0 || M == 0) return 0;
  int threads = ((num_hosts_pad + 31) / 32) * 32;
  pack_ffd_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
      M, R, num_hosts_pad, (const float*)demand, (const float*)capacity,
      (const int*)hosts_per_tier, (uint8_t*)rejected);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
