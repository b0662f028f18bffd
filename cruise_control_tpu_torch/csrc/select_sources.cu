// K2 select_sources: the move grid's broker-diverse source rows.
//
// Replaces (JAX) cruise_control_tpu/analyzer/candidates.py:181
// select_sources: the global top-`half` of the flat [P·S] replica weights
// (rows on positive-score brokers, -inf elsewhere), then each top source
// broker's best and second-best remaining replica (segment max, ties to
// the lowest flat index), for the top-`quarter` brokers by source score.
// Every top-k is value descending in IEEE total order, lower index first
// on ties, as lax.top_k orders it; -inf rows are invalid.
//
// Bound on this card: bytes — one read of the [P, S] weights and
// assignment (plus the partition mask and the [B] scores) and O(k)
// output: 7.5 µs at 7k brokers / 1M partitions.
//
// Design: a radix select whose launches are fixed by the shapes, never by
// n or the data. A row's key is computed on the fly from the weight,
// assignment, score and partition mask wherever it is needed: no key or
// mark array of size n exists. Values and indices pack into uint64 keys
// (common.cuh), so one unsigned compare is the reference's order and
// every key is unique.
//  1. digit_kernel, kPasses launches over all SMs: each pass histograms
//     the next kDigitBits-bit digit of the keys whose higher bits equal
//     the prefix found so far (a shared-memory histogram per CTA, lanes
//     of a warp with equal digits adding once, merged into global
//     memory); the last CTA to finish (an atomic ticket) picks the digit
//     at which the count from the top crosses `half`. Once the boundary
//     bucket holds at most kBucketCap keys, or the last digit is taken,
//     the later passes return at once (a flag on the device). Ties of any
//     size — the chain gives every offline replica the weight 1e30 — only
//     move the boundary into the index bits: when every key a pass counted
//     falls in one bin, the next digit starts below the bits their
//     smallest and largest keys share, so the next pass splits a tied
//     bucket by its row indices. Passes after the first read the other
//     columns only for rows whose weight can still match.
//  2. seed_kernel, over one tile in kSeedStride: each broker's best key
//     (atomicMax) in each of two disjoint samples of the rows below the
//     bucket, into a [2, B] table; the smaller of the two is a floor under
//     which no row can be among the broker's best two, read through the
//     read-only cache by the next step.
//  3. compact_kernel, over all SMs: keys at or above the bucket's low
//     edge (fewer than half + kBucketCap) go to a small buffer; every
//     other finite source row is outside the global block and offers its
//     (-0.0-folded) key to its broker's best two: atomicMax on the best
//     slot, then the key it displaced (or itself, when it lost)
//     atomicMax-ed into the second slot. That leaves the largest and the
//     second-largest key offered, whatever the order (keys are unique),
//     so the outputs are deterministic. Keys below the sampled floor or a
//     stale second-best skip both atomics, and each broker's slots have a
//     128-byte line of their own: atomics on one address or line
//     serialise in L2, which is also why the digit passes spread theirs
//     over kCopies copies.
//  4. rank_kernel, a 2-D grid: each buffered key's rank is the count of
//     greater buffered keys (tiles of keys against chunks in shared
//     memory, atomics into [cap] counts); the last CTA of each tile of
//     keys writes output row r < half from its key of rank r, so the
//     global block is every key at or above the half-th key, in order;
//     the buffered finite keys below it make their offers as in step 3.
//  5. broker_kernel, a 2-D grid: the same rank count over the broker keys
//     (score where the broker has a best row, else -inf); the last CTA of
//     each tile writes the two rows of its brokers of rank < quarter.
// Loads a thread needs are issued together (kItems rows a tile). Per
// call: one memset of the counters and best slots and kPasses + 4
// kernels, whatever the data.
#include <algorithm>

#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = (64 + kDigitBits - 1) / kDigitBits;  // 6
constexpr int kBucketCap = 8192;   // boundary bucket small enough to rank
constexpr int kMaxHalf = 2048;
constexpr int kMaxQuarter = kMaxHalf / 2;
constexpr int kMaxBrokers = 16384;
constexpr int kThreads = 256;
constexpr int kItems = 4;          // rows a thread loads at once
constexpr int kMaxGrid = 132 * 4;
// Copies of each pass's histogram, tickets and extremes: a block uses
// copy blockIdx.x % kCopies, so atomics on one address come from at most
// kMaxGrid / kCopies blocks (they serialise in L2).
constexpr int kCopies = 8;
constexpr int kRankKeys = 256;     // keys a rank CTA owns, one a thread
constexpr int kRankChunk = 512;    // keys it counts them against
// A broker's best two keys, on a 128-byte line of their own.
constexpr int kSlotWords = 16;
constexpr int kSeedStride = 16;    // the seed pass reads one tile in 16
constexpr int kRankTiles = (kMaxHalf + kBucketCap) / kRankKeys;
constexpr int kBrokerTiles = kMaxBrokers / kRankKeys;

struct SelectState {
  unsigned long long prefix;     // bits of the half-th key found so far,
  unsigned long long high;       // those under this mask
  unsigned long long max_key[kPasses][kCopies];  // of the keys counted
  unsigned long long min_not[kPasses][kCopies];  // ~(their smallest key)
  unsigned int shift;            // lowest bit of the next pass's digit
  unsigned int above;            // keys above the current bucket
  unsigned int done;             // the bucket is small enough: stop
  unsigned int count;            // keys compacted
  unsigned int tickets[kPasses];
  unsigned int copy_tickets[kPasses][kCopies];
  unsigned int rank_tickets[kRankTiles];
  unsigned int broker_tickets[kBrokerTiles];
};

struct Rows {
  const float* weight;
  const float* score;
  const int* assignment;
  const uint8_t* partition_mask;
  int n, S, B;
};

// Weights and source brokers (-1 off source) of one tile's kItems rows a
// thread. With kSkip, the other columns are read only for rows whose
// weight's high word equals `want` under `mask` (the others cannot
// match, and count as off source).
template <bool kSkip>
__device__ __forceinline__ void load_rows(const Rows& rows, int base,
                                          uint32_t mask, uint32_t want,
                                          float (&w)[kItems],
                                          int (&broker)[kItems]) {
  int a[kItems];
  bool pm[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = base + r * kThreads + threadIdx.x;
    w[r] = i < rows.n ? rows.weight[i] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = base + r * kThreads + threadIdx.x;
    const bool need = i < rows.n &&
        (!kSkip || (cc::ordered_bits(w[r]) & mask) == want);
    a[r] = need ? rows.assignment[i] : -1;
    pm[r] = need && rows.partition_mask[i / rows.S];
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int b = a[r];
    broker[r] = (b >= 0 && b < rows.B && pm[r] && rows.score[b] > 0.0f)
                    ? b : -1;
  }
}

__device__ __forceinline__ unsigned long long row_key(float w, int broker,
                                                      int i) {
  return cc::pack_key(broker >= 0 ? w : cc::neg_inf(),
                      static_cast<uint32_t>(i));
}

// The per-broker best key: -0.0 folded into +0.0, so equal weights tie
// on index, as the reference's segment_max / equality / segment_min does.
__device__ __forceinline__ unsigned long long best_key(float w, int i) {
  return cc::pack_key(__fadd_rn(w, 0.0f), static_cast<uint32_t>(i));
}

// Keep slot[0] and slot[1] the largest and second-largest key offered,
// whatever the order of the offers (each key offered once).
__device__ __forceinline__ void offer_best(unsigned long long* slot,
                                           unsigned long long key) {
  if (key < __ldcg(&slot[1])) return;
  const unsigned long long old = atomicMax(&slot[0], key);
  const unsigned long long second = old < key ? old : key;
  if (second != 0ull) atomicMax(&slot[1], second);
}

// One output row: flat index idx (n for none) and whether it is valid.
__device__ __forceinline__ void emit(int r, long long idx, bool valid,
                                     int n, int S, int* cand_p,
                                     int* cand_s, uint8_t* src_valid) {
  valid = valid && idx < n;
  if (idx > n - 1) idx = n - 1;
  cand_p[r] = static_cast<int>(idx / S);
  cand_s[r] = static_cast<int>(idx % S);
  src_valid[r] = valid ? 1 : 0;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
digit_kernel(Rows rows, int half, int pass, SelectState* st,
             unsigned int* __restrict__ global_hist) {
  __shared__ unsigned int hist[kBins];
  __shared__ unsigned long long warp_hi[kThreads / 32], warp_lo[kThreads / 32];
  __shared__ bool last;
  using Scan = cub::BlockScan<unsigned int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  if (__ldcg(&st->done)) return;
  // The digit is bits [shift, top): below the bits found so far.
  const unsigned long long prefix = pass ? __ldcg(&st->prefix) : 0ull;
  const unsigned long long high = pass ? __ldcg(&st->high) : 0ull;
  const int shift = pass ? static_cast<int>(__ldcg(&st->shift))
                         : 64 - kDigitBits;
  const int top = high ? __ffsll(static_cast<long long>(high)) - 1 : 64;
  const unsigned long long digit_mask = (1ull << (top - shift)) - 1ull;
  const unsigned int above = __ldcg(&st->above);
  const int copy = blockIdx.x % kCopies;
  for (int j = threadIdx.x; j < kBins; j += blockDim.x) hist[j] = 0;
  __syncthreads();

  const uint32_t high_hi = static_cast<uint32_t>(high >> 32);
  const uint32_t prefix_hi = static_cast<uint32_t>(prefix >> 32);
  // While -inf rows can still match, every row's columns are needed.
  const bool skip = (cc::ordered_bits(cc::neg_inf()) & high_hi) != prefix_hi;
  const int lane = threadIdx.x & 31;
  unsigned long long hi = 0ull, lo_not = 0ull;  // of the keys counted
  const int tile = kThreads * kItems;
  for (int base = blockIdx.x * tile; base < rows.n;
       base += gridDim.x * tile) {
    float w[kItems];
    int broker[kItems];
    if (skip)
      load_rows<true>(rows, base, high_hi, prefix_hi, w, broker);
    else
      load_rows<false>(rows, base, high_hi, prefix_hi, w, broker);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int i = base + r * kThreads + threadIdx.x;
      const unsigned long long key = row_key(w[r], broker[r], i);
      const bool match = i < rows.n && (key & high) == prefix;
      const unsigned int bin =
          static_cast<unsigned int>((key >> shift) & digit_mask);
      const unsigned int active = __ballot_sync(0xffffffffu, match);
      if (match) {
        const unsigned int peers = __match_any_sync(active, bin);
        if (lane == __ffs(peers) - 1)
          atomicAdd(&hist[bin], static_cast<unsigned int>(__popc(peers)));
        hi = key > hi ? key : hi;
        lo_not = ~key > lo_not ? ~key : lo_not;
      }
    }
  }
  hi = warp_max(hi);
  lo_not = warp_max(lo_not);
  if (lane == 0) {
    warp_hi[threadIdx.x / 32] = hi;
    warp_lo[threadIdx.x / 32] = lo_not;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k) {
      hi = warp_hi[k] > hi ? warp_hi[k] : hi;
      lo_not = warp_lo[k] > lo_not ? warp_lo[k] : lo_not;
    }
    if (hi != 0ull) atomicMax(&st->max_key[pass][copy], hi);
    if (lo_not != 0ull) atomicMax(&st->min_not[pass][copy], lo_not);
  }
  unsigned int* g = global_hist + pass * kCopies * kBins;
  for (int j = threadIdx.x; j < kBins; j += blockDim.x)
    if (hist[j]) atomicAdd(&g[copy * kBins + j], hist[j]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    // The last block of its copy, then the last copy to finish.
    const unsigned int copies =
        min(gridDim.x, static_cast<unsigned int>(kCopies));
    const unsigned int blocks = (gridDim.x - copy + kCopies - 1) / kCopies;
    last = atomicAdd(&st->copy_tickets[pass][copy], 1u) == blocks - 1;
    if (last) {
      __threadfence();
      last = atomicAdd(&st->tickets[pass], 1u) == copies - 1;
    }
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last CTA: bins from the top, kPer a thread, summed over the
  // copies; an exclusive scan gives the keys above each thread's bins.
  constexpr int kPer = kBins / kThreads;
  unsigned int count[kPer];
  unsigned int sum = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int bin = kBins - 1 - (threadIdx.x * kPer + r);
    count[r] = 0;
#pragma unroll
    for (int c = 0; c < kCopies; ++c) count[r] += __ldcg(&g[c * kBins + bin]);
    sum += count[r];
  }
  unsigned int before, total;
  Scan(scan_tmp).ExclusiveSum(sum, before, total);
  const unsigned int need = static_cast<unsigned int>(half) - above;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if (before < need && need <= before + count[r]) {
      const unsigned long long bin = kBins - 1 - (threadIdx.x * kPer + r);
      const bool done = count[r] <= kBucketCap || shift == 0;
      unsigned long long next_prefix = prefix | (bin << shift);
      unsigned long long next_high = ~0ull << shift;
      int next_shift = max(shift - kDigitBits, 0);
      if (!done && count[r] == total) {
        // Every counted key fell in this bin (ties in the value bits): the
        // next digit starts below the bits its smallest and largest keys
        // share.
        unsigned long long lo_not_all = 0ull, hi_key = 0ull;
        for (int c = 0; c < kCopies; ++c) {
          const unsigned long long l = __ldcg(&st->min_not[pass][c]);
          const unsigned long long h = __ldcg(&st->max_key[pass][c]);
          lo_not_all = l > lo_not_all ? l : lo_not_all;
          hi_key = h > hi_key ? h : hi_key;
        }
        const unsigned long long lo = ~lo_not_all;
        const int differ = 63 - __clzll(static_cast<long long>(lo ^ hi_key));
        next_high = ~0ull << (differ + 1);
        next_prefix = lo & next_high;
        next_shift = max(differ + 1 - kDigitBits, 0);
      }
      st->prefix = next_prefix;
      st->high = next_high;
      st->shift = static_cast<unsigned int>(next_shift);
      st->above = above + before;
      st->done = done ? 1u : 0u;
    }
    before += count[r];
  }
}

// Each broker's best key in each of two disjoint samples of the rows
// outside the global block (even and odd sampled tiles), sample[s * B + b]:
// two distinct rows are at or above the smaller, so no row below it can
// be among the broker's best two, and the compaction skips it.
__global__ void __launch_bounds__(kThreads)
seed_kernel(Rows rows, int half, const SelectState* st,
            unsigned long long* __restrict__ sample) {
  const unsigned long long low = __ldcg(&st->prefix);
  const int tile = kThreads * kItems;
  const int tiles = (rows.n + tile - 1) / tile;
  for (int t = blockIdx.x * kSeedStride; t < tiles;
       t += gridDim.x * kSeedStride) {
    const int base = t * tile;
    float w[kItems];
    int broker[kItems];
    load_rows<false>(rows, base, 0u, 0u, w, broker);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int i = base + r * kThreads + threadIdx.x;
      if (i < rows.n && broker[r] >= 0 && isfinite(w[r]) &&
          !(half > 0 && row_key(w[r], broker[r], i) >= low))
        atomicMax(&sample[(t / kSeedStride) % 2 * rows.B + broker[r]],
                  best_key(w[r], i));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(Rows rows, int half, int cap, SelectState* st,
               unsigned long long* __restrict__ buf,
               unsigned long long* __restrict__ best,
               const unsigned long long* __restrict__ sample) {
  const unsigned long long low = __ldcg(&st->prefix);
  const int lane = threadIdx.x & 31;
  const int tile = kThreads * kItems;
  for (int base = blockIdx.x * tile; base < rows.n;
       base += gridDim.x * tile) {
    float w[kItems];
    int broker[kItems];
    load_rows<false>(rows, base, 0u, 0u, w, broker);
    bool offer[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int i = base + r * kThreads + threadIdx.x;
      const bool valid = i < rows.n;
      const unsigned long long key = row_key(w[r], broker[r], i);
      const bool take = valid && half > 0 && key >= low;
      const unsigned int mask = __ballot_sync(0xffffffffu, take);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        unsigned int pos = 0;
        if (lane == leader)
          pos = atomicAdd(&st->count,
                          static_cast<unsigned int>(__popc(mask)));
        pos = __shfl_sync(0xffffffffu, pos, leader) +
              __popc(mask & ((1u << lane) - 1u));
        if (take && pos < static_cast<unsigned int>(cap)) buf[pos] = key;
      }
      offer[r] = valid && !take && broker[r] >= 0 && isfinite(w[r]);
    }
    // offer_best for the tile's rows above the sampled floor, each step's
    // loads in flight together.
    unsigned long long key[kItems], seen[kItems], old[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      key[r] = best_key(w[r], base + r * kThreads + threadIdx.x);
      if (offer[r])
        offer[r] = key[r] >= min(__ldg(&sample[broker[r]]),
                                 __ldg(&sample[rows.B + broker[r]]));
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      seen[r] = offer[r] ? __ldcg(&best[broker[r] * kSlotWords + 1]) : ~0ull;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      offer[r] = offer[r] && key[r] >= seen[r];
      old[r] = offer[r] ? atomicMax(&best[broker[r] * kSlotWords], key[r])
                        : 0ull;
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const unsigned long long second = old[r] < key[r] ? old[r] : key[r];
      if (offer[r] && second != 0ull)
        atomicMax(&best[broker[r] * kSlotWords + 1], second);
    }
  }
}

// Adds to rank[j], for the keys j of this CTA's tile, the number of keys
// of its chunk that are greater; returns true in the last CTA of the tile
// to finish, when the tile's ranks are complete.
template <class KeyAt>
__device__ __forceinline__ bool rank_tiles(const KeyAt& key_at, int m,
                                           unsigned int* rank,
                                           unsigned int* tickets) {
  __shared__ unsigned long long chunk[kRankChunk];
  __shared__ bool last;
  const int j0 = blockIdx.x * kRankKeys;
  const int c0 = blockIdx.y * kRankChunk;
  if (j0 < m && c0 < m) {
    const int len = min(kRankChunk, m - c0);
    for (int t = threadIdx.x; t < len; t += blockDim.x)
      chunk[t] = key_at(c0 + t);
    __syncthreads();
    const int j = j0 + threadIdx.x;
    if (j < m) {
      const unsigned long long key = key_at(j);
      unsigned int greater = 0;
      for (int t = 0; t < len; ++t) greater += chunk[t] > key ? 1u : 0u;
      if (greater) atomicAdd(&rank[j], greater);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

struct BufKey {
  const unsigned long long* buf;
  __device__ unsigned long long operator()(int j) const { return buf[j]; }
};

__global__ void __launch_bounds__(kRankKeys)
rank_kernel(Rows rows, int half, int cap, SelectState* st,
            const unsigned long long* __restrict__ buf,
            unsigned int* __restrict__ rank,
            unsigned long long* __restrict__ best, int* __restrict__ cand_p,
            int* __restrict__ cand_s, uint8_t* __restrict__ src_valid) {
  const int m = min(static_cast<int>(__ldcg(&st->count)), cap);
  if (!rank_tiles(BufKey{buf}, m, rank, st->rank_tickets)) return;
  const int j = blockIdx.x * kRankKeys + threadIdx.x;
  if (j >= m) return;
  const unsigned int r = __ldcg(&rank[j]);
  const unsigned long long key = buf[j];
  const float v = cc::key_value(key);
  const int i = static_cast<int>(cc::key_index(key));
  if (r < static_cast<unsigned int>(half)) {
    emit(static_cast<int>(r), i, isfinite(v), rows.n, rows.S, cand_p, cand_s,
         src_valid);
  } else if (isfinite(v)) {
    // Finite keys are source rows, whose broker is in range.
    offer_best(best + rows.assignment[i] * kSlotWords, best_key(v, i));
  }
}

struct BrokerKey {
  const unsigned long long* best;
  const float* score;
  __device__ unsigned long long operator()(int b) const {
    const float v = __ldcg(&best[b * kSlotWords]) != 0ull ? score[b]
                                                         : cc::neg_inf();
    return cc::pack_key(v, static_cast<uint32_t>(b));
  }
};

__global__ void __launch_bounds__(kRankKeys)
broker_kernel(Rows rows, int half, int quarter, SelectState* st,
              const unsigned long long* __restrict__ best,
              unsigned int* __restrict__ broker_rank,
              int* __restrict__ cand_p, int* __restrict__ cand_s,
              uint8_t* __restrict__ src_valid) {
  const int B = rows.B;
  if (!rank_tiles(BrokerKey{best, rows.score}, B, broker_rank,
                  st->broker_tickets))
    return;
  const int b = blockIdx.x * kRankKeys + threadIdx.x;
  if (b >= B) return;
  const unsigned int r = __ldcg(&broker_rank[b]);
  if (r >= static_cast<unsigned int>(quarter)) return;
  const unsigned long long first = __ldcg(&best[b * kSlotWords]);
  const unsigned long long second = __ldcg(&best[b * kSlotWords + 1]);
  const bool ok = first != 0ull && isfinite(rows.score[b]);
  const int q = static_cast<int>(r);
  emit(half + q, ok ? cc::key_index(first) : rows.n, ok, rows.n, rows.S,
       cand_p, cand_s, src_valid);
  emit(half + quarter + q,
       ok && second != 0ull ? cc::key_index(second) : rows.n,
       ok && second != 0ull, rows.n, rows.S, cand_p, cand_s, src_valid);
}

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// Scratch layout; everything before `buf` is zeroed each call.
struct Layout {
  size_t hist, rank, broker_rank, best, sample, buf, total;
  Layout(int B, int half) {
    const size_t cap = static_cast<size_t>(half) + kBucketCap;
    hist = align256(sizeof(SelectState));
    rank = align256(hist + sizeof(unsigned int) * kPasses * kCopies * kBins);
    broker_rank = align256(rank + sizeof(unsigned int) * cap);
    best = align256(broker_rank + sizeof(unsigned int) * B);
    sample = align256(best + sizeof(unsigned long long) * kSlotWords * B);
    buf = align256(sample + sizeof(unsigned long long) * 2 * B);
    total = align256(buf + sizeof(unsigned long long) * cap);
  }
};

}  // namespace

extern "C" long long cc_select_sources_scratch_bytes(int B, int half) {
  return static_cast<long long>(Layout(B, half).total);
}

extern "C" int cc_select_sources(
    const float* weight, const float* score, const int* assignment,
    const uint8_t* partition_mask, int P, int S, int B, int half,
    int quarter, int* cand_p, int* cand_s, uint8_t* src_valid,
    void* scratch, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int n = P * S;
  if (half < 0 || half > kMaxHalf || quarter < 0 || quarter > kMaxQuarter ||
      B < 1 || B > kMaxBrokers || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(B, half);
  char* base = static_cast<char*>(scratch);
  SelectState* st = reinterpret_cast<SelectState*>(base);
  auto* hist = reinterpret_cast<unsigned int*>(base + lay.hist);
  auto* rank = reinterpret_cast<unsigned int*>(base + lay.rank);
  auto* broker_rank = reinterpret_cast<unsigned int*>(base + lay.broker_rank);
  auto* best = reinterpret_cast<unsigned long long*>(base + lay.best);
  auto* sample = reinterpret_cast<unsigned long long*>(base + lay.sample);
  auto* buf = reinterpret_cast<unsigned long long*>(base + lay.buf);
  const int cap = half + kBucketCap;
  cudaError_t err = cudaMemsetAsync(base, 0, lay.buf, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Rows rows{weight, score, assignment, partition_mask, n, S, B};
  const int tiles = (n + kThreads * kItems - 1) / (kThreads * kItems);
  const int grid = std::min(tiles, kMaxGrid);
  if (half > 0) {
    for (int pass = 0; pass < kPasses; ++pass)
      digit_kernel<<<grid, kThreads, 0, stream>>>(rows, half, pass, st, hist);
  }
  const int seed_grid =
      std::min((tiles + kSeedStride - 1) / kSeedStride, kMaxGrid);
  seed_kernel<<<seed_grid, kThreads, 0, stream>>>(rows, half, st, sample);
  compact_kernel<<<grid, kThreads, 0, stream>>>(rows, half, cap, st, buf,
                                                best, sample);
  if (half > 0) {
    const dim3 rank_grid((cap + kRankKeys - 1) / kRankKeys,
                         (cap + kRankChunk - 1) / kRankChunk);
    rank_kernel<<<rank_grid, kRankKeys, 0, stream>>>(
        rows, half, cap, st, buf, rank, best, cand_p, cand_s, src_valid);
  }
  const dim3 broker_grid((B + kRankKeys - 1) / kRankKeys,
                         (B + kRankChunk - 1) / kRankChunk);
  broker_kernel<<<broker_grid, kRankKeys, 0, stream>>>(
      rows, half, quarter, st, best, broker_rank, cand_p, cand_s, src_valid);
  return static_cast<int>(cudaGetLastError());
}
