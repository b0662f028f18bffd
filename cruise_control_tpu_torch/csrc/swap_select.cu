// K8 swap_top_replicas: the swap round's per-broker top-j replicas.
//
// Replaces (JAX) cruise_control_tpu/analyzer/search.py:390-407,
// _per_broker_top_replicas, for both of swap_grid's calls (search.py:410):
// for each of the k source brokers the j replicas of largest weight, and
// for each of the k destination brokers the j of smallest weight, as
// lax.top_k orders the masked keys: a replica on the broker whose weight
// is finite keys on its weight (its negation for the smallest), every
// other slot keys -inf; value descending in IEEE total order (-0.0 below
// +0.0), the lower flat index first among equals. A broker with fewer
// than j such replicas is padded, as top_k pads, with the lowest flat
// indices whose key is -inf, marked invalid: those rows still feed the
// swap grid's gathers.
//
// Bound on this card: bytes -- one read of the [P, S] assignment, and of
// the weight and partition mask of the few slots on the 2k brokers:
// ~0.004 ms at 7k brokers / 1M partitions.
//
// Design: one cooperative launch (every CTA co-resident), no memset, no
// atomics on 64-bit keys and no sort. Values and indices pack into unique
// uint64 keys (the order of common.cuh's pack_key), so a top j is the j
// largest keys, whatever order they are offered in.
//  1. stream: each CTA owns a contiguous range of slots and reads its
//     assignment with 16-byte loads, two in flight a thread, a tile of
//     4,096 slots at a time. A slot's broker is tested against the 2k
//     brokers by one shared-memory lookup in a bitmap of 16,384 bits
//     (broker index mod 16,384; exact up to 16,384 brokers); the tile's
//     hits are buffered in shared memory with their brokers (a
//     warp-aggregated count), then a warp an entry folds the buffer into
//     its lanes' running top keys, reading a hit's weight and partition
//     mask only where its broker is the entry's. At the end each entry's top j (a warp's largest heads,
//     one a step) goes to the CTA's rows of a global table, every row
//     written, so nothing needs zeroing.
//  2. merge: after one grid barrier, one CTA an entry merges the CTAs'
//     rows (a thread a row, then its warps' tops) and its lanes write the
//     outputs and top_k's padding.
// Per call: one launch, whatever the data.
//
// The file also compiles as host C++ (without __CUDACC__): the same
// phases with one "thread", the CTAs in turn before the barrier, for
// checking off the card (cc_swap_top_replicas_host).
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
#define CC_HD __device__ __forceinline__
#define CC_UNROLL _Pragma("unroll")
#define TID static_cast<int>(threadIdx.x)
#define BARRIER() __syncthreads()
#else
#include <vector>
#define CC_HD static inline
#define CC_UNROLL
struct int2 {
  int x, y;
};
static inline int2 make_int2(int x, int y) { return int2{x, y}; }
#define TID 0
#define BARRIER() ((void)0)
#endif

namespace {

constexpr int kMaxK = 8;
constexpr int kMaxJ = 4;
constexpr int kEntries = 2 * kMaxK;
#ifdef __CUDACC__
constexpr int kT = 512;      // threads a CTA: a warp for each entry
#else
constexpr int kT = 1;
#endif
constexpr int kVecs = 2;     // 16-byte loads in flight a thread
constexpr int kFilterWords = 512;   // 16,384 bits
constexpr int kMaxCtas = 2048;
constexpr int kMinPerCta = 4096;    // slots a CTA at least

struct Args {
  const float* weight;
  const int* assignment;
  const uint8_t* partition_mask;
  const int* brokers;   // [2k]: the k source brokers, then the k
                        // destination brokers
  int n, S, k, j;
  int ctas, per;        // CTAs, slots a CTA (a multiple of 4)
  int* flat_idx;        // [2k, j]
  uint8_t* valid;       // [2k, j]
  unsigned long long* lists;   // [ctas][kEntries][kMaxJ]
};

// A tile's slots a CTA: the most hits one tile can buffer.
constexpr int kTile = kT * kVecs * 4;

struct Smem {
  int2 hits[kTile];          // (slot, broker) of the tile's filter hits
  uint32_t filter[kFilterWords];
  unsigned long long fin[kT / 32 + 1][kMaxJ];  // the merge's warp tops
  int brokers[kEntries];
  uint32_t count;            // hits buffered
};

CC_HD uint32_t float_bits(float v) {
#ifdef __CUDACC__
  return __float_as_uint(v);
#else
  uint32_t b;
  std::memcpy(&b, &v, sizeof b);
  return b;
#endif
}

// Unsigned order = (value descending in IEEE total order, index
// ascending), common.cuh's pack_key.
CC_HD unsigned long long pack_key(float v, uint32_t idx) {
  const uint32_t b = float_bits(v);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - idx);
}

CC_HD uint32_t key_index(unsigned long long k) {
  return 0xFFFFFFFFu - static_cast<uint32_t>(k & 0xFFFFFFFFull);
}

CC_HD bool finite(float v) {
#ifdef __CUDACC__
  return isfinite(v);
#else
  return std::isfinite(v);
#endif
}

// Slot i holds a replica on broker b with a finite weight.
CC_HD bool on_broker(const Args& g, int i, int b) {
  return g.assignment[i] == b && g.partition_mask[i / g.S] &&
         finite(g.weight[i]);
}

// Entry e's key of slot i (broker already matched).
CC_HD unsigned long long entry_key(const Args& g, int e, float w, int i) {
  return pack_key(e < g.k ? w : -w, static_cast<uint32_t>(i));
}

// Keep top[0..kMaxJ) the largest keys offered, in order (0 = empty):
// the top j of any stream of offers are the first j (keys are unique).
CC_HD void keep(unsigned long long (&top)[kMaxJ], unsigned long long key) {
  if (key <= top[kMaxJ - 1]) return;
CC_UNROLL
  for (int r = 0; r < kMaxJ; ++r) {
    if (key > top[r]) {
      const unsigned long long t = top[r];
      top[r] = key;
      key = t;
    }
  }
}

// Output t = e * j + r of entry e's final list.
CC_HD void emit(const Args& g, const unsigned long long* list, int e,
                int r) {
  int held = 0;
  for (int q = 0; q < g.j; ++q) held += list[q] != 0ull ? 1 : 0;
  const int t = e * g.j + r;
  if (r < held) {
    g.flat_idx[t] = static_cast<int>(key_index(list[r]));
    g.valid[t] = 1;
    return;
  }
  // Padding: the (r - held)-th lowest flat index whose key is -inf.
  int need = r - held;
  int i = 0;
  for (; i < g.n; ++i) {
    if (on_broker(g, i, g.brokers[e])) continue;
    if (need == 0) break;
    --need;
  }
  g.flat_idx[t] = i;
  g.valid[t] = 0;
}

bool args_ok(int P, int S, int k, int j) {
  const long long n = static_cast<long long>(P) * S;
  return k >= 1 && k <= kMaxK && j >= 1 && j <= kMaxJ && S >= 1 && n >= j &&
         n < (1LL << 31);
}

// A warp's (on the host: the one thread's) running top keys of one entry.
#ifdef __CUDACC__
using Tops = unsigned long long[kMaxJ];
#else
using Tops = unsigned long long[kEntries][kMaxJ];
#endif

// The CTA's filter of the 2k brokers, and its hit count cleared.
CC_HD void phase_setup(const Args& g, Smem& sm) {
  const int entries = 2 * g.k;
  for (int t = TID; t < kFilterWords; t += kT) sm.filter[t] = 0u;
  if (TID == 0) sm.count = 0u;
  BARRIER();
  for (int e = TID; e < entries; e += kT) {
    const int b = g.brokers[e];
    sm.brokers[e] = b;
    if (b >= 0) {
      const uint32_t bit = 1u << (b & 31);
#ifdef __CUDACC__
      atomicOr(&sm.filter[(b >> 5) & (kFilterWords - 1)], bit);
#else
      sm.filter[(b >> 5) & (kFilterWords - 1)] |= bit;
#endif
    }
  }
  BARRIER();
}

// Slot i, whose broker a passed the filter (or not), into the hit buffer.
// Every lane calls it.
CC_HD void buffer(Smem& sm, int i, int a) {
  const bool hit = a >= 0 &&
      ((sm.filter[(a >> 5) & (kFilterWords - 1)] >> (a & 31)) & 1u);
#ifdef __CUDACC__
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (!mask) return;
  const int lane = TID & 31, leader = __ffs(mask) - 1;
  uint32_t pos = 0;
  if (lane == leader) pos = atomicAdd(&sm.count, __popc(mask));
  pos = __shfl_sync(0xffffffffu, pos, leader) +
        __popc(mask & ((1u << lane) - 1u));
  if (hit) sm.hits[pos] = make_int2(i, a);
#else
  if (hit) sm.hits[sm.count++] = make_int2(i, a);
#endif
}

// The buffered hits into the entries' running tops (on the card a warp
// an entry, its lanes over the hits), then the buffer emptied.
CC_HD void flush(const Args& g, Smem& sm, Tops& top) {
  BARRIER();
  const int n = static_cast<int>(sm.count);
#ifdef __CUDACC__
  const int e = TID >> 5;
  if (e < 2 * g.k) {
    const int b = sm.brokers[e];
    for (int h = TID & 31; h < n; h += 32) {
      const int2 hit = sm.hits[h];
      if (hit.y != b) continue;
      const int i = hit.x;
      const float w = g.weight[i];
      if (g.partition_mask[i / g.S] && finite(w))
        keep(top, entry_key(g, e, w, i));
    }
  }
#else
  for (int e = 0; e < 2 * g.k; ++e)
    for (int h = 0; h < n; ++h) {
      const int2 hit = sm.hits[h];
      if (hit.y != sm.brokers[e]) continue;
      const int i = hit.x;
      const float w = g.weight[i];
      if (g.partition_mask[i / g.S] && finite(w))
        keep(top[e], entry_key(g, e, w, i));
    }
#endif
  BARRIER();
  if (TID == 0) sm.count = 0u;
  BARRIER();
}

// The warp's kMaxJ largest keys, one a step (keys are unique), at
// out[0..kMaxJ) from lane 0.
#ifdef __CUDACC__
CC_HD void warp_top(unsigned long long (&top)[kMaxJ],
                    unsigned long long* out) {
  for (int r = 0; r < kMaxJ; ++r) {
    unsigned long long best = top[0];
CC_UNROLL
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long u = __shfl_xor_sync(0xffffffffu, best, o);
      best = u > best ? u : best;
    }
    if (best != 0ull && top[0] == best) {
CC_UNROLL
      for (int q = 0; q + 1 < kMaxJ; ++q) top[q] = top[q + 1];
      top[kMaxJ - 1] = 0ull;
    }
    if ((TID & 31) == 0) out[r] = best;
  }
}
#endif

// 1. The CTA's slots [i0, i1): a tile of assignment read with 16-byte
// loads (the range starts at a multiple of 4 slots of a 16-byte aligned
// array), the filter's hits buffered, then folded into the tops; last,
// each entry's top j written to the CTA's rows of the table.
CC_HD void phase_stream(const Args& g, Smem& sm, int cta) {
  const int i0 = cta * g.per;
  const int i1 = i0 + g.per < g.n ? i0 + g.per : g.n;
  Tops top = {};
  const int groups = i1 > i0 ? (i1 - i0) / 4 : 0;   // of four slots
  for (int q0 = 0; q0 < groups; q0 += kT * kVecs) {
    int a[kVecs][4];
CC_UNROLL
    for (int v = 0; v < kVecs; ++v) {
      const int q = q0 + v * kT + TID;
      if (q < groups) {
#ifdef __CUDACC__
        const int4 x = __ldg(reinterpret_cast<const int4*>(
            g.assignment + i0 + 4 * q));
        a[v][0] = x.x; a[v][1] = x.y; a[v][2] = x.z; a[v][3] = x.w;
#else
        for (int u = 0; u < 4; ++u) a[v][u] = g.assignment[i0 + 4 * q + u];
#endif
      } else {
        a[v][0] = a[v][1] = a[v][2] = a[v][3] = -1;
      }
    }
CC_UNROLL
    for (int v = 0; v < kVecs; ++v)
CC_UNROLL
      for (int u = 0; u < 4; ++u)
        buffer(sm, i0 + 4 * (q0 + v * kT + TID) + u, a[v][u]);
    flush(g, sm, top);
  }
  // The range's last slots past its groups (the last CTA's tail).
  for (int t0 = i0 + 4 * groups; t0 < i1; t0 += kT) {
    const int i = t0 + TID;
    buffer(sm, i, i < i1 ? g.assignment[i] : -1);
  }
  flush(g, sm, top);
  // [write]
  unsigned long long* out = g.lists + static_cast<size_t>(cta) *
                                          kEntries * kMaxJ;
#ifdef __CUDACC__
  const int e = TID >> 5;
  if (e < 2 * g.k) warp_top(top, out + e * kMaxJ);
#else
  for (int e = 0; e < 2 * g.k; ++e)
    for (int r = 0; r < kMaxJ; ++r) out[e * kMaxJ + r] = top[e][r];
#endif
}

// 2. Entry e's lists of all CTAs merged (on the card: a CTA an entry,
// a thread a CTA's list, then its warps' tops), and emitted with the
// padding.
CC_HD void phase_merge(const Args& g, Smem& sm, int e) {
  unsigned long long top[kMaxJ] = {0ull, 0ull, 0ull, 0ull};
#ifdef __CUDACC__
  for (int c = TID; c < g.ctas; c += kT) {
    const ulonglong2* l = reinterpret_cast<const ulonglong2*>(
        g.lists + (static_cast<size_t>(c) * kEntries + e) * kMaxJ);
    const ulonglong2 x = __ldcg(l), y = __ldcg(l + 1);
    keep(top, x.x);
    keep(top, x.y);
    keep(top, y.x);
    keep(top, y.y);
  }
  const int warp = TID >> 5, lane = TID & 31;
  warp_top(top, sm.fin[warp]);
  __syncthreads();
  if (warp == 0) {
    for (int q = 0; q < kMaxJ; ++q)
      top[q] = lane < kT / 32 ? sm.fin[lane][q] : 0ull;
    warp_top(top, sm.fin[kT / 32]);
    __syncwarp();
    // [tail]
    if (lane < g.j) emit(g, sm.fin[kT / 32], e, lane);
  }
  __syncthreads();
#else
  for (int c = 0; c < g.ctas; ++c)
    for (int q = 0; q < kMaxJ; ++q)
      keep(top, g.lists[(static_cast<size_t>(c) * kEntries + e) * kMaxJ +
                        q]);
  for (int r = 0; r < g.j; ++r) emit(g, top, e, r);
  (void)sm;
#endif
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kT, 2) top_replicas_kernel(const Args g) {
  __shared__ Smem sm;
  phase_setup(g, sm);
  phase_stream(g, sm, static_cast<int>(blockIdx.x));
  cg::this_grid().sync();
  // [merge]
  for (int e = blockIdx.x; e < 2 * g.k; e += gridDim.x) phase_merge(g, sm, e);
}

// CTAs that can be co-resident (at most two an SM), once per process.
int max_ctas() {
  static int ctas = 0;
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, top_replicas_kernel, kT, 0) != cudaSuccess)
      return 0;
    ctas = sms * (per_sm < 2 ? per_sm : 2);
    if (ctas > kMaxCtas) ctas = kMaxCtas;
  }
  return ctas;
}

int grid_for(int n, int most) {
  const int want = (n + kMinPerCta - 1) / kMinPerCta;
  return want < most ? want : most;
}
#endif

int per_cta(int n, int ctas) { return ((n + ctas - 1) / ctas + 3) & ~3; }

}  // namespace

#ifdef __CUDACC__
// Bytes of scratch (the CTAs' lists) for P*S slots.
extern "C" long long cc_swap_top_replicas_scratch_bytes(int P, int S) {
  const int most = max_ctas();
  if (most < 1 || !args_ok(P, S, 1, 1)) return 0;
  return static_cast<long long>(sizeof(unsigned long long)) *
         grid_for(P * S, most) * kEntries * kMaxJ;
}

// brokers [2k] int32; flat_idx [2k, j] int32 and valid [2k, j] out.
extern "C" int cc_swap_top_replicas(
    const float* weight, const int* assignment,
    const uint8_t* partition_mask, const int* brokers, int P, int S, int k,
    int j, int* flat_idx, uint8_t* valid, void* scratch, void* stream_) {
  if (!args_ok(P, S, k, j)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(assignment) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int most = max_ctas();
  if (most < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n = P * S;
  const int ctas = grid_for(n, most);
  const Args g{weight, assignment, partition_mask, brokers, n, S, k, j,
               ctas, per_cta(n, ctas), flat_idx, valid,
               static_cast<unsigned long long*>(scratch)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kT);
  cfg.stream = static_cast<cudaStream_t>(stream_);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, top_replicas_kernel, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
#else
// The same phases on the host, `ctas` CTAs (at most the card's grid) in
// turn before the barrier, then the merge.
extern "C" int cc_swap_top_replicas_host(
    const float* weight, const int* assignment,
    const uint8_t* partition_mask, const int* brokers, int P, int S, int k,
    int j, int* flat_idx, uint8_t* valid, int ctas) {
  if (!args_ok(P, S, k, j) || ctas < 1 || ctas > kMaxCtas) return 1;
  const int n = P * S;
  std::vector<unsigned long long> lists(static_cast<size_t>(ctas) *
                                        kEntries * kMaxJ);
  const Args g{weight, assignment, partition_mask, brokers, n, S, k, j,
               ctas, per_cta(n, ctas), flat_idx, valid, lists.data()};
  Smem sm;
  for (int c = 0; c < ctas; ++c) {
    phase_setup(g, sm);
    phase_stream(g, sm, c);
  }
  for (int e = 0; e < 2 * k; ++e) phase_merge(g, sm, e);
  return 0;
}
#endif
