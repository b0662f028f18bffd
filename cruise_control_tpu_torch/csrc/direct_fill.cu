// KD4: the direct-assignment transport's fill search (direct_fill).
//
// Replaces the reference's deficit_fill_dests through row_searchsorted
// (cruise_control_tpu/analyzer/fill.py:82, 119-146) as the direct plan
// calls it (direct.py:697): XLA-lowered gathers of an unrolled binary
// search, not a Pallas kernel.
//
// What it computes: mover i of group g = group[i], at f32 fill position
// q = rank[i] + 0.5, lands in the broker owning position q of its group's
// concatenated [deficit | headroom] profile: the first j with
// cum_d[g, j] > q while q < tot_d, else the first j with cum_h[g, j] >
// q - tot_d; ok when q < tot_d + tot_h and such a j exists. The search is
// the reference's, step for step (bit_length(B) steps, hi then lo), so it
// returns the reference's index on any row, monotone or not.
//
// Bound on this card: bytes (each mover's group and rank read, its dst and
// ok written, each group's two rows read once: ~78 MB at 7,000 brokers,
// 700 groups and 3M movers). What holds it back is the chain of ~13
// dependent probes a mover.
//
// Design: the caller hands the movers sorted by group, so a contiguous
// range of movers holds one group or a few. As many CTAs as the card holds
// at once, each over one contiguous range (kThreads threads, kPerThread
// movers of a thread in flight at once, strided so the loads coalesce;
// on the H100 256-thread CTAs with two movers a thread beat 512 and 1,024
// threads and one, three or four movers): while a CTA works
// through a group its two rows stay in the SM's L1 from the first probes
// on, so each row is read from L2 about once an SM, and every later probe
// is an L1 hit. Staging the rows in shared memory buys nothing: on the
// H100 a probe of shared memory costs what an L1 hit costs (one 256 KB
// store an SM), and the copies and barriers cost more than they save
// (PERF.md). Any group order is placed right: each mover reads its own
// group's rows.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;

// The movers of `mask` (bit u: this thread's u-th mover, at first +
// u * kThreads) searched in lockstep in their own group's rows.
template <int EPT>
__device__ __forceinline__ void place(unsigned mask, const int* g,
                                      const float* rk,
                                      const float* __restrict__ cum_d,
                                      const float* __restrict__ cum_h,
                                      int first, int B, int steps,
                                      int* __restrict__ dst,
                                      uint8_t* __restrict__ ok) {
  float t[EPT];
  bool fits[EPT];
  const float* row[EPT];
  int lo[EPT], hi[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    if (!((mask >> u) & 1u)) continue;
    const long long base = static_cast<long long>(g[u]) * B;
    const float* rd = cum_d + base;
    const float* rh = cum_h + base;
    const float q = __fadd_rn(rk[u], 0.5f);
    const float tot_d = rd[B - 1];
    fits[u] = q < __fadd_rn(tot_d, rh[B - 1]);
    const bool in_def = q < tot_d;
    row[u] = in_def ? rd : rh;
    t[u] = in_def ? q : __fsub_rn(q, tot_d);
    lo[u] = 0;
    hi[u] = B;
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      if (!((mask >> u) & 1u)) continue;
      const int mid = (lo[u] + hi[u]) >> 1;
      const bool gt = row[u][min(mid, B - 1)] > t[u];
      if (gt && mid < hi[u]) hi[u] = mid;
      lo[u] = gt ? lo[u] : min(mid + 1, hi[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    if (!((mask >> u) & 1u)) continue;
    const int i = first + u * kThreads;
    ok[i] = fits[u] && hi[u] < B ? 1 : 0;
    dst[i] = min(max(hi[u], 0), B - 1);
  }
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(const int* __restrict__ group, const float* __restrict__ rank,
            const float* __restrict__ cum_d, const float* __restrict__ cum_h,
            int n, int B, int steps, int per_cta, int* __restrict__ dst,
            uint8_t* __restrict__ ok) {
  const int lo = blockIdx.x * per_cta;
  const int hi = min(n, lo + per_cta);
  for (int at = lo + static_cast<int>(threadIdx.x); at < hi;
       at += kThreads * kPerThread) {
    int g[kPerThread];
    float rk[kPerThread];
    unsigned mask = 0;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = at + u * kThreads;
      g[u] = 0;
      rk[u] = 0.0f;
      if (i < hi) {
        g[u] = group[i];
        rk[u] = rank[i];
        mask |= 1u << u;
      }
    }
    place<kPerThread>(mask, g, rk, cum_d, cum_h, at, B, steps, dst, ok);
  }
}

}  // namespace

// group [n] int32 in [0, G); rank [n] f32; cum_d, cum_h [G, B] f32;
// dst [n] int32 and ok [n] bool out. As many CTAs as the card holds at
// once, each over a contiguous range of the movers.
extern "C" int cc_direct_fill(const int* group, const float* rank,
                              const float* cum_d, const float* cum_h, int n,
                              int G, int B, int* dst, uint8_t* ok,
                              void* stream_) {
  if (n <= 0 || G <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int resident = 0;  // CTAs the card holds at once
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fill_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = std::max(1, sms * per_sm);
  }
  const int steps = 32 - __builtin_clz(static_cast<unsigned>(B));
  const long long per_cta = (n + resident - 1) / resident;
  fill_kernel<<<static_cast<int>((n + per_cta - 1) / per_cta), kThreads, 0,
                static_cast<cudaStream_t>(stream_)>>>(
      group, rank, cum_d, cum_h, n, B, steps, static_cast<int>(per_cta), dst,
      ok);
  return static_cast<int>(cudaGetLastError());
}
