// K5 intra_broker: the intra-broker disk balancer, each broker's loop run
// to its own fixed point in one warp; and, in load mode, the per-(broker,
// disk) DISK load.
//
// Replaces (JAX) cruise_control_tpu/model/disks.py:92 balance_intra_broker
// (a lax.while_loop of at most max_rounds rounds over every broker at
// once) and, in load mode, the per-(broker, disk) segment sum of
// disk_load (:54).
//
// Bound on this card: bytes. The balancer reads each slot's broker, disk,
// DISK load and its partition's movable flag once and writes each slot's
// disk once (~51 MB at 7,000 brokers / 1M partitions / RF 3); its
// arithmetic is a few adds and compares a slot a round. The load mode
// reads each slot's broker, disk and load and each partition's mask once
// (~38 MB there) and writes [B, D] floats. What holds the balancer back
// in practice is the chain of dependent rounds: at 7k/1M some 1,650
// brokers run more than 8 of their 64 rounds.
//
// Why brokers run apart: a broker's round reads only its own slots, and a
// broker that does not move keeps its state, so it never moves again. Each
// broker can therefore run its own loop, in one launch, to its own fixed
// point or to max_rounds, which is what the reference's global loop gives
// it. Launches per call do not depend on the round count.
//
// Balancer design (eight device ops a call, one host read):
//  group: the load mode's pass 1 (count, scan, scatter below; the entries
//  carry each slot's flat index) places the slots stably in buckets of
//  2**k consecutive brokers, then split_kernel, one CTA a bucket, places
//  each bucket's entries stably by broker: each broker's slots, in flat
//  order, as one run, with its count and start and the largest count (no
//  sort of a broker's list; no atomic whose order shows in the result).
//  The host reads the largest count, which sizes each warp's shared
//  memory and must not pass 8,192.
//  balance: one warp a broker (a CTA of 32 threads, so many brokers share
//  an SM) stages its run: each slot's load, disk and movable flag. Each
//  disk's load is the sequential fold with __fadd_rn of its slots' loads
//  in flat slot order (the reference's segment sum); the warp keeps, for
//  every slot, its disk's fold over the slots before it (lane d folds disk
//  d once at the start). A move changes only two disks, and a sequential
//  fold keeps its bits up to the first position that changes, so a round
//  refolds the source from the moved slot's prefix and the destination
//  from its prefix at the moved slot, each over its own slots after it
//  only: the warp gathers both disks' later loads into two lists (128
//  slots a step by ballots), one lane folds them in place, the two chains
//  of adds interleaved and the next loads in flight, and the warp writes
//  the prefixes back. Each slot's pick key (the order of its load when movable, 0
//  when pinned) is made once, so a round's pick reads four slots a lane a
//  step with two vector loads. Shed pressure,
//  one lane a disk, each disk's load in its lane's register, every
//  operation rounded alone with __fmul_rn / __fadd_rn: the reference's
//  loop contracts no multiply-add here (XLA hoists cap * threshold out of
//  it and shares avg * upper among a broker's disks), and nvcc would
//  contract them by default; the mean's sum runs in disk order; the
//  first-index argmax and argmin over the disks by warp reductions on
//  order-preserving keys. The heaviest movable replica on the source
//  disk, lowest flat index first among equal loads, by a warp reduction;
//  the move. It records the first round in which the broker had no pick
//  and why (no replica on its source disk, or all of them pinned).
//  fixup (one warp): the reference's sentinel collision. A broker without
//  a pick writes its scatter row onto slot (P-1, 2147483647 % S) (no
//  replica on the source disk) or (P-1, 0) (all pinned), putting back the
//  slot's value from the start of the round; writes with equal indices
//  land in broker order. So a broker above the slot's owner that has no
//  pick in round r undoes the owner's move of that slot in round r, and,
//  having no pick, it has none in every later round. For each sentinel
//  slot's owner, highest index first, the warp takes the first such round
//  of the brokers above it and reruns the owner's loop from the input
//  with the move of that slot frozen from that round on (the owner
//  replays the undone move until max_rounds, changing nothing).
//
// Load mode design (cc_intra_broker_load): the slots are moved into broker
// order, stably, in two passes whose writes are coalesced, then each
// broker's loads are folded per disk; no host read, no sort of a broker's
// list, no atomic whose order shows in the result, four launches at any
// shape. Brokers form at most 256 buckets of 2**k consecutive brokers.
//  1. count: per tile of 8,192 slots, its slots a bucket (shared-memory
//     atomics: integer counts, exact in any order), a row of a
//     [tiles, buckets] table;
//  2. scan: per bucket, each tile's first position within it (an
//     exclusive scan down its column of the table) and its total; the
//     next steps place bucket k after the totals of buckets below k;
//  3. scatter: each tile sorts its slots stably by bucket in shared memory
//     (chunks of 1,024 slots, one a thread: a slot links itself into its
//     bucket's list for the chunk by an atomicExch on the list's head,
//     walks the list and counts the bucket's slots of the chunk and those
//     below its own index, its rank; the lowest takes that many places
//     from the bucket's cursor), then writes each bucket's run, coalesced,
//     as 8-byte entries (the slot's DISK load, its broker and its disk, -1
//     for none or a slot >= D): every bucket lists its slots in flat order;
//  4. fold: one CTA per bucket reads its entries in chunks, sorts each
//     chunk stably by broker in shared memory (up to 32 brokers a bucket:
//     1,024 to 4,096 entries ranked by ballots on the broker's bits and
//     per-group counts; above: 1,024 ranked by lists as in step 3), and
//     one warp per broker of the chunk adds, lane d for disk d, the
//     broker's loads of that disk serially with __fadd_rn onto its
//     running sum.
// Step 4 adds each (broker, disk)'s loads in flat slot order from +0.0,
// the reference's sequential segment sum, so the result carries the plain
// twin's bits (its index_add_ on the CPU). Two passes, because one that
// wrote each slot straight to its broker's bucket (every warp's stores to
// 32 scattered places, 3M of them at 7,000 brokers / 1M partitions) was
// slower on an H100 than both of these together (PERF.md). The load mode
// takes what the balancer's limits allow: B <= 2**20, D <= 32, any number
// of replicas on one broker.
#include "common.cuh"

namespace {

constexpr int kMaxDisks = 32;
constexpr int kMaxReplicas = 8192;
constexpr int kNever = 0x7fffffff;
constexpr int kNoPickPinned = 1;
constexpr int kNoPickEmpty = 2;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int slot_broker(const int* __restrict__ assignment,
                                           const uint8_t* __restrict__ pmask,
                                           int i, int S, int B) {
  const int b = assignment[i];
  return (b >= 0 && b < B && pmask[i / S]) ? b : -1;
}

// ---- load mode ----------------------------------------------------------

constexpr int kLoadThreads = 1024;  // one slot (pass 1) or entry (pass 2) each
constexpr int kMaxBuckets = 256;
constexpr int kTile = 8 * kLoadThreads;  // slots of a pass-1 tile
constexpr int kFoldGroups = 4;           // entries a thread a fold chunk

// Brokers of a bucket: buckets of 2**shift consecutive brokers, the
// fewest a bucket that make at most kMaxBuckets of them.
struct LoadPlan {
  int shift, buckets, tiles;
};

inline LoadPlan load_plan(long long n, int B) {
  LoadPlan pl;
  pl.shift = 0;
  while ((static_cast<long long>(kMaxBuckets) << pl.shift) < B) ++pl.shift;
  pl.buckets = ((B - 1) >> pl.shift) + 1;
  pl.tiles = static_cast<int>((n + kTile - 1) / kTile);
  return pl;
}

// Scratch of the load mode, in int32 words: the entries [n] (8 bytes a
// slot: its DISK load's bits, then (broker << 6) | (disk + 1), disk -1 for
// none or a slot >= D), the [tiles, buckets] table, and each bucket's
// total.
struct LoadScratch {
  unsigned long long* entry;
  int* table;
  int* total;
};

inline long long load_scratch_words(long long n, int B) {
  const LoadPlan pl = load_plan(n, B);
  return 2 * n + (static_cast<long long>(pl.tiles) + 1) * pl.buckets;
}

inline LoadScratch load_scratch_of(int* w, long long n, int B) {
  const LoadPlan pl = load_plan(n, B);
  LoadScratch s;
  s.entry = reinterpret_cast<unsigned long long*>(w);
  s.table = w + 2 * n;
  s.total = s.table + static_cast<long long>(pl.tiles) * pl.buckets;
  return s;
}

// An entry: (broker << 6) | (disk + 1, 0 for none or a slot >= D) in the
// high word, the slot's DISK load's bits (load mode) or its flat index
// (balancer) in the low word.
__device__ __forceinline__ unsigned long long slot_entry(int b, uint32_t low,
                                                         int disk, int D) {
  const uint32_t d = disk >= 0 && disk < D ? disk + 1 : 0;
  return (static_cast<unsigned long long>((static_cast<uint32_t>(b) << 6) |
                                          d)
          << 32) |
         low;
}

__device__ __forceinline__ int entry_broker(unsigned long long e) {
  return static_cast<int>(e >> 38);
}

// One chunk of a stable local ranking, every thread of the CTA calling it
// with its item's key (-1 for none): each item links itself into its
// key's list (an atomicExch on the list's head: the list's order is
// arbitrary and nothing depends on it), then walks the list, counting the
// key's items (count) and those below its own thread index (rank), and
// finds the lowest of them (first). On return the heads are -1 again.
struct Rank {
  int rank, count, first;
};

__device__ __forceinline__ Rank rank_in_chunk(int key, int* head,
                                              int* link) {
  const int t = threadIdx.x;
  if (key >= 0) link[t] = atomicExch(&head[key], t);
  __syncthreads();
  Rank r{0, 0, t};
  if (key >= 0)
    for (int j = head[key]; j >= 0; j = link[j]) {
      ++r.count;
      r.rank += j < t;
      r.first = min(r.first, j);
    }
  __syncthreads();  // every list walked before its head is reset
  if (key >= 0 && r.rank == 0) head[key] = -1;
  return r;
}

// Exclusive scan of v over threads 0..kMaxBuckets-1 (the others give and
// get 0); every thread of the CTA calls it. `sums` holds a value a warp.
__device__ __forceinline__ int scan_buckets(int v, int* sums) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int mine = t < kMaxBuckets ? v : 0;
  int x = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (t < kMaxBuckets && lane == 31) sums[w] = x;
  __syncthreads();
  int before = 0;
  if (t < kMaxBuckets)
    for (int j = 0; j < w; ++j) before += sums[j];
  __syncthreads();
  return before + x - mine;
}

// Pass 1, count: each tile's slots a bucket, row `tile` of the
// [tiles, buckets] table. Each pair of warps counts into its own
// histogram (fewer atomics on one address).
__global__ void __launch_bounds__(kLoadThreads) load_count_kernel(
    const int* __restrict__ assignment, const uint8_t* __restrict__ pmask,
    int n, int S, int B, int shift, int buckets, int* __restrict__ table) {
  constexpr int kCopies = 16;  // a histogram for each pair of warps
  __shared__ int hist[kCopies][kMaxBuckets];
  const int warp = (threadIdx.x >> 5) % kCopies;
  for (int k = threadIdx.x; k < kCopies * kMaxBuckets; k += kLoadThreads)
    hist[k / kMaxBuckets][k % kMaxBuckets] = 0;
  __syncthreads();
  const int lo = blockIdx.x * kTile;
  const int hi = min(n, lo + kTile);
  for (int i = lo + threadIdx.x; i < hi; i += kLoadThreads) {
    const int b = slot_broker(assignment, pmask, i, S, B);
    if (b >= 0) atomicAdd(&hist[warp][b >> shift], 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < buckets; k += kLoadThreads) {
    int c = 0;
    for (int w = 0; w < kCopies; ++w) c += hist[w][k];
    table[static_cast<long long>(blockIdx.x) * buckets + k] = c;
  }
}

// Pass 1, scan: per bucket, its column of the table turned into each
// tile's first position within the bucket (exclusive offsets), and its
// total. A CTA takes 32 buckets (one a lane); its 32 warps split the tiles
// into contiguous ranges.
__global__ void __launch_bounds__(kLoadThreads) load_scan_kernel(
    int tiles, int buckets, int* __restrict__ table, int* __restrict__ total) {
  constexpr int kWarps = kLoadThreads / 32;
  __shared__ int part[kWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const int per = (tiles + kWarps - 1) / kWarps;
  const int t0 = min(tiles, warp * per), t1 = min(tiles, t0 + per);
  int* col = table + k;
  int sum = 0;
  if (k < buckets)
    for (int t = t0; t < t1; ++t) sum += col[static_cast<long long>(t) * buckets];
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = part[w][lane];
      part[w][lane] = run;
      run += v;
    }
    if (k < buckets) total[k] = run;
  }
  __syncthreads();
  if (k >= buckets) return;
  int run = part[warp][lane];
  for (int t = t0; t < t1; ++t) {
    int* c = col + static_cast<long long>(t) * buckets;
    const int v = *c;
    *c = run;
    run += v;
  }
}

// Pass 1, scatter: each tile's slots sorted stably by bucket in shared
// memory (chunks of kLoadThreads slots, each ranked by rank_in_chunk and
// appended to its bucket's run; the next chunk's slots load meanwhile),
// then written out coalesced: the bucket's run of this tile starts at its
// base plus the tile's entry of the table. kIndex: the entries carry the
// slot's flat index (the balancer's grouping) instead of its load.
template <bool kIndex>
__global__ void __launch_bounds__(kLoadThreads) load_scatter_kernel(
    const int* __restrict__ assignment, const uint8_t* __restrict__ pmask,
    const float* __restrict__ load, const int* __restrict__ disk, int n,
    int S, int B, int D, int shift, int buckets, int tiles,
    const int* __restrict__ table, const int* __restrict__ total,
    unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long sorted[];  // [kTile]
  __shared__ int head[kMaxBuckets], cursor[kMaxBuckets], first[kMaxBuckets];
  __shared__ int link[kLoadThreads], taken[kLoadThreads];
  __shared__ int sums[kLoadThreads / 32];
  const int t = threadIdx.x;
  const int lo = blockIdx.x * kTile;
  const int hi = min(n, lo + kTile);
  __shared__ int dest[kMaxBuckets];
  // Bucket k's base: the exclusive scan of the totals. The tile's slots
  // of bucket k: the next tile's offset (or the bucket's total) less this
  // tile's; their exclusive scan places the bucket's run in shared memory,
  // `dest` in device memory.
  const int* row = table + static_cast<long long>(blockIdx.x) * buckets;
  const int base_k = scan_buckets(t < buckets ? total[t] : 0, sums);
  int c = 0;
  if (t < buckets) {
    const int here = row[t];
    c = (blockIdx.x + 1 < tiles ? row[buckets + t] : total[t]) - here;
    dest[t] = base_k + here;
  }
  const int at = scan_buckets(c, sums);
  if (t < kMaxBuckets) {
    head[t] = -1;
    cursor[t] = at;
    first[t] = at;
  }
  // This thread's next slot: its broker, load and disk.
  int i = lo + t;
  int b = i < hi ? slot_broker(assignment, pmask, i, S, B) : -1;
  uint32_t low = b < 0 ? 0u : kIndex ? static_cast<uint32_t>(i)
                                     : __float_as_uint(load[i]);
  int dk = b >= 0 ? disk[i] : -1;
  __syncthreads();
  for (int c0 = lo; c0 < hi; c0 += kLoadThreads) {
    const unsigned long long e = b >= 0 ? slot_entry(b, low, dk, D) : 0ull;
    const int key = b >= 0 ? b >> shift : -1;
    i += kLoadThreads;
    b = i < hi ? slot_broker(assignment, pmask, i, S, B) : -1;
    low = b < 0 ? 0u : kIndex ? static_cast<uint32_t>(i)
                              : __float_as_uint(load[i]);
    dk = b >= 0 ? disk[i] : -1;
    const Rank r = rank_in_chunk(key, head, link);
    if (key >= 0 && r.rank == 0) {
      taken[t] = cursor[key];
      cursor[key] += r.count;
    }
    __syncthreads();
    if (key >= 0) sorted[taken[r.first] + r.rank] = e;
  }
  __syncthreads();
  const int m = cursor[buckets - 1];  // the tile's slots
  for (int j = t; j < m; j += kLoadThreads) {
    const unsigned long long e = sorted[j];
    const int k = entry_broker(e) >> shift;
    out[dest[k] + (j - first[k])] = e;
  }
}

// The lanes of this warp whose key equals this lane's, from one ballot a
// bit of the key (keys in [0, 2**bits), -1 for none).
__device__ __forceinline__ unsigned key_peers(int key, int bits) {
  unsigned peers = __ballot_sync(0xffffffffu, key >= 0);
  for (int bit = 0; bit < bits; ++bit) {
    const unsigned on = __ballot_sync(0xffffffffu, (key >> bit) & 1);
    peers &= ((key >> bit) & 1) ? on : ~on;
  }
  return peers;
}

// Adds the loads of disk `lane` among a run's entries onto `a`, in order.
__device__ __forceinline__ float fold_run(const unsigned long long* run,
                                          int len, int lane, float a) {
  const uint32_t me = lane + 1;
  int x = 0;
  for (; x + 4 <= len; x += 4) {
    unsigned long long v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = run[x + u];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (((v[u] >> 32) & 63u) == me)
        a = __fadd_rn(a, __uint_as_float(static_cast<uint32_t>(v[u])));
  }
  for (; x < len; ++x) {
    const unsigned long long v = run[x];
    if (((v >> 32) & 63u) == me)
      a = __fadd_rn(a, __uint_as_float(static_cast<uint32_t>(v)));
  }
  return a;
}

// Pass 2, fold: one CTA a bucket, its entries (in flat slot order) in
// chunks (the next chunk loading meanwhile), each chunk sorted stably by
// broker in shared memory (each broker's run contiguous), then one warp
// per broker of the chunk, lane d adding the loads of disk d of its run
// serially with __fadd_rn onto the broker's running sum.
//  Up to 32 brokers a bucket (B <= 8,192): chunks of kFoldGroups x
//  kLoadThreads entries, thread t holding entries g * kLoadThreads + t;
//  each 32 of them (a group, in flat order g-major) ranked by ballots on
//  the broker's five bits; per broker, an exclusive scan of the groups'
//  counts (warp q for broker q) places each group's entries; the warp of
//  broker q keeps its sums in registers.
//  Above: chunks of kLoadThreads entries ranked by rank_in_chunk, the sums
//  in `out`.
__global__ void __launch_bounds__(kLoadThreads) load_fold_kernel(
    int B, int D, int shift, int buckets, const int* __restrict__ total,
    const unsigned long long* __restrict__ entry, float* __restrict__ out) {
  constexpr int kWarps = kLoadThreads / 32;
  constexpr int kGroups = kFoldGroups * kWarps;
  // The chunk's entries, then [wide] heads, run starts and lengths,
  // wide = max(width, 32).
  extern __shared__ unsigned long long chunk[];
  __shared__ int cnt[kGroups][33];
  __shared__ int link[kLoadThreads], taken[kLoadThreads];
  __shared__ int sums[kWarps], bucket_base, alloc;
  const int width = 1 << shift, wide = width > 32 ? width : 32;
  int* head = reinterpret_cast<int*>(chunk + kFoldGroups * kLoadThreads);
  int* run_start = head + wide;
  int* run_len = run_start + wide;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int k = blockIdx.x;
  const int b0 = k * width, brokers = min(width, B - b0);
  for (int j = t; j < wide; j += kLoadThreads) {
    head[j] = -1;
    run_len[j] = 0;
  }
  const int before = scan_buckets(t < buckets ? total[t] : 0, sums);
  if (t == k) bucket_base = before;
  if (t == 0) alloc = 0;
  __syncthreads();
  const unsigned long long* bucket = entry + bucket_base;
  const int count = total[k];
  if (shift <= 5) {
    float acc = 0.0f;  // broker b0 + warp, disk lane
    // Groups a thread a chunk: fewer for narrower buckets (a broker's run
    // of a chunk is about kChunk / width entries, folded by one warp).
    const int G = shift >= 5 ? 4 : (shift >= 4 ? 2 : 1);
    const int kChunk = G * kLoadThreads;
    unsigned long long e[kFoldGroups];
#pragma unroll
    for (int g = 0; g < kFoldGroups; ++g)
      e[g] = g < G && g * kLoadThreads + t < count
                 ? bucket[g * kLoadThreads + t] : 0;
    for (int c0 = 0; c0 < count; c0 += kChunk) {
      int key[kFoldGroups], rank[kFoldGroups];
#pragma unroll
      for (int g = 0; g < kFoldGroups; ++g) {
        const int j = c0 + g * kLoadThreads + t;
        key[g] = g < G && j < count ? entry_broker(e[g]) - b0 : -1;
        const unsigned peers = key_peers(key[g], 5);
        rank[g] = __popc(peers & below);
        cnt[g * kWarps + warp][lane] = 0;
        __syncwarp();
        if (key[g] >= 0 && rank[g] == 0)
          cnt[g * kWarps + warp][key[g]] = __popc(peers);
      }
      __syncthreads();
      // Warp q for broker q: lane l takes groups Gl..Gl+G-1 in order.
      {
        int v[kFoldGroups], x = 0;
#pragma unroll
        for (int u = 0; u < kFoldGroups; ++u) {
          v[u] = u < G ? cnt[G * lane + u][warp] : 0;
          x += v[u];
        }
        const int mine = x;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, d);
          if (lane >= d) x += y;
        }
        int run = x - mine;
#pragma unroll
        for (int u = 0; u < kFoldGroups; ++u)
          if (u < G) {
            cnt[G * lane + u][warp] = run;
            run += v[u];
          }
        if (lane == 31) run_len[warp] = x;
      }
      __syncthreads();
      if (warp == 0) {  // the runs' starts: an exclusive scan of lengths
        const int len = lane < brokers ? run_len[lane] : 0;
        int x = len;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, d);
          if (lane >= d) x += y;
        }
        run_start[lane] = x - len;
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kFoldGroups; ++g) {
        if (key[g] >= 0)
          chunk[run_start[key[g]] + cnt[g * kWarps + warp][key[g]] + rank[g]] =
              e[g];
        const int j = c0 + kChunk + g * kLoadThreads + t;
        e[g] = g < G && j < count ? bucket[j] : 0;
      }
      __syncthreads();
      if (warp < brokers && lane < D)
        acc = fold_run(chunk + run_start[warp], run_len[warp], lane, acc);
      __syncthreads();
    }
    if (warp < brokers && lane < D)
      out[static_cast<long long>(b0 + warp) * D + lane] = acc;
    return;
  }
  for (int j = t; j < brokers * D; j += kLoadThreads)
    out[static_cast<long long>(b0) * D + j] = 0.0f;
  unsigned long long e = t < count ? bucket[t] : 0ull;
  __syncthreads();
  for (int c0 = 0; c0 < count; c0 += kLoadThreads) {
    const int key = c0 + t < count ? entry_broker(e) - b0 : -1;
    const unsigned long long mine = e;
    e = c0 + kLoadThreads + t < count ? bucket[c0 + kLoadThreads + t] : 0ull;
    const Rank r = rank_in_chunk(key, head, link);
    if (key >= 0 && r.rank == 0) {
      taken[t] = atomicAdd(&alloc, r.count);  // where the run goes only
      run_start[key] = taken[t];
      run_len[key] = r.count;
    }
    __syncthreads();
    if (key >= 0) chunk[taken[r.first] + r.rank] = mine;
    __syncthreads();
    for (int q = warp; q < brokers; q += kWarps) {
      const int len = run_len[q];
      if (len > 0 && lane < D) {
        float* sum = out + static_cast<long long>(b0 + q) * D + lane;
        *sum = fold_run(chunk + run_start[q], len, lane, *sum);
      }
    }
    __syncthreads();
    for (int q = t; q < brokers; q += kLoadThreads) run_len[q] = 0;
    if (t == 0) alloc = 0;
    __syncthreads();
  }
}

// Dynamic shared memory of the fold: a chunk's entries and three [wide]
// int arrays.
inline size_t fold_smem(int shift) {
  const size_t wide = shift > 5 ? size_t{1} << shift : 32;
  return sizeof(unsigned long long) * kFoldGroups * kLoadThreads +
         sizeof(int) * 3 * wide;
}

// ---- balancer -------------------------------------------------------------

struct Inputs {
  const int* assignment;
  const uint8_t* pmask;
  const float* load;
  const uint8_t* movable;
  const int* disk_in;
  const float* cap;
  const uint8_t* alive;
  int P, S, B, D;
  float threshold, upper;
  int band, max_rounds;
};

// The balancer's scratch, in int32 words (cc_intra_broker_scratch_words):
// each broker's count and its run's start [B] each, the largest count (4
// words), pass 1's entries and the split's runs (8 bytes a slot each),
// pass 1's table and totals, and last each broker's first no-pick round
// and its kind and the rounds it ran [B] each.
struct Scratch {
  int* count;
  int* start;
  int* most;
  unsigned long long* entry;
  unsigned long long* run;
  int* table;
  int* total;
  int* nopick_round;
  int* nopick_kind;
  int* rounds;
};

inline long long entries_at(int B) { return (2LL * B + 4 + 1) & ~1LL; }

inline long long scratch_words(long long n, int B) {
  const LoadPlan pl = load_plan(n, B);
  return entries_at(B) + 4 * n +
         (static_cast<long long>(pl.tiles) + 1) * pl.buckets + 3LL * B;
}

inline Scratch scratch_of(int* w, long long n, int B) {
  const LoadPlan pl = load_plan(n, B);
  Scratch s;
  s.count = w;
  s.start = w + B;
  s.most = w + 2LL * B;
  s.entry = reinterpret_cast<unsigned long long*>(w + entries_at(B));
  s.run = s.entry + n;
  s.table = reinterpret_cast<int*>(s.run + n);
  s.total = s.table + static_cast<long long>(pl.tiles) * pl.buckets;
  s.nopick_round = s.total + pl.buckets;
  s.nopick_kind = s.nopick_round + B;
  s.rounds = s.nopick_kind + B;
  return s;
}

constexpr int kSplitWarps = kLoadThreads / 32;

// Exclusive scan of v over the CTA's kLoadThreads threads, the total in
// *all; every thread of the CTA calls it. `sums` holds a value a warp.
__device__ __forceinline__ int block_scan(int v, int* sums, int* all) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, s, d);
      if (lane >= d) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const int before = w > 0 ? sums[w - 1] : 0;
  *all = sums[kSplitWarps - 1];
  __syncthreads();
  return before + x - v;
}

// One CTA a bucket of pass 1 (its slots' entries in flat order): each
// broker's count, its run's start and the largest count, then the entries
// placed stably by broker into `run`, each broker's slots one run in flat
// order. Up to 32 brokers a bucket (B <= 8,192) each chunk's entries are
// ranked by ballots on the broker's five bits and each warp's counts,
// scanned over the warps a broker; above, by rank_in_chunk's lists.
__global__ void __launch_bounds__(kLoadThreads) split_kernel(
    int B, int shift, int buckets, const int* __restrict__ total,
    const unsigned long long* __restrict__ entry,
    unsigned long long* __restrict__ run, int* __restrict__ count,
    int* __restrict__ start, int* __restrict__ most) {
  extern __shared__ int split_smem[];  // cnt, cursor, head: [wide] each
  __shared__ int link[kLoadThreads], taken[kLoadThreads];
  __shared__ int wcnt[kSplitWarps][33];
  __shared__ int sums[kSplitWarps], bucket_base, top;
  const int width = 1 << shift, wide = width > 32 ? width : 32;
  int* cnt = split_smem;
  int* cursor = cnt + wide;
  int* head = cursor + wide;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int k = blockIdx.x;
  const int b0 = k << shift, brokers = min(width, B - b0);
  for (int j = t; j < wide; j += kLoadThreads) {
    cnt[j] = 0;
    head[j] = -1;
  }
  const int before = scan_buckets(t < buckets ? total[t] : 0, sums);
  if (t == k) bucket_base = before;
  if (t == 0) top = 0;
  __syncthreads();
  const unsigned long long* in = entry + bucket_base;
  unsigned long long* out = run + bucket_base;
  const int m = total[k];
  for (int j = t; j < m; j += kLoadThreads)
    atomicAdd(&cnt[entry_broker(in[j]) - b0], 1);
  __syncthreads();
  // Each broker's run: an exclusive scan of the counts in broker order.
  int carry = 0, biggest = 0;
  for (int c0 = 0; c0 < width; c0 += kLoadThreads) {
    const int q = c0 + t;
    const int v = q < brokers ? cnt[q] : 0;
    int all;
    const int at = carry + block_scan(v, sums, &all);
    if (q < brokers) {
      cursor[q] = at;
      count[b0 + q] = v;
      start[b0 + q] = bucket_base + at;
      biggest = max(biggest, v);
    }
    carry += all;
  }
  biggest = __reduce_max_sync(kAll, biggest);
  if (lane == 0) atomicMax(&top, biggest);
  __syncthreads();
  if (t == 0) atomicMax(most, top);
  if (shift <= 5) {
    for (int c0 = 0; c0 < m; c0 += kLoadThreads) {
      const int j = c0 + t;
      const unsigned long long e = j < m ? in[j] : 0ull;
      const int key = j < m ? entry_broker(e) - b0 : -1;
      const unsigned peers = key_peers(key, 5);
      const int rank = __popc(peers & below);
      wcnt[warp][lane] = 0;
      __syncwarp();
      if (key >= 0 && rank == 0) wcnt[warp][key] = __popc(peers);
      __syncthreads();
      // Warp q for broker q: each warp's offset among the chunk's slots of
      // broker q, and their total.
      int x = wcnt[lane][warp];
      const int own = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kAll, x, d);
        if (lane >= d) x += y;
      }
      wcnt[lane][warp] = x - own;
      const int chunk_total = __shfl_sync(kAll, x, 31);
      __syncthreads();
      if (key >= 0) out[cursor[key] + wcnt[warp][key] + rank] = e;
      __syncthreads();
      if (lane == 0 && warp < brokers) cursor[warp] += chunk_total;
    }
  } else {
    for (int c0 = 0; c0 < m; c0 += kLoadThreads) {
      const int j = c0 + t;
      const unsigned long long e = j < m ? in[j] : 0ull;
      const int key = j < m ? entry_broker(e) - b0 : -1;
      const Rank r = rank_in_chunk(key, head, link);
      if (key >= 0 && r.rank == 0) {
        taken[t] = cursor[key];
        cursor[key] += r.count;
      }
      __syncthreads();
      if (key >= 0) out[taken[r.first] + r.rank] = e;
      __syncthreads();
    }
  }
}

// Dynamic shared memory of the split: three [wide] int arrays.
inline size_t split_smem_bytes(int shift) {
  const size_t wide = shift > 5 ? size_t{1} << shift : 32;
  return sizeof(int) * 3 * wide;
}

// One broker staged in one warp's shared memory, in flat slot order.
struct Staged {
  const unsigned long long* run;  // its entries (low word: the flat index)
  float* ld;                      // DISK load
  float* pre;                     // its disk's fold over the slots before it
  float* ls;                      // the source's loads after the moved slot
  float* lt;                      // the destination's
  uint32_t* pkey;                 // pick key: movable ? load's order : 0
  int8_t* dsk;                    // disk slot, -1 none (and past n)
  int n;
};

// A warp's shared memory for `cap` slots (a multiple of 8): load, prefix,
// the two lists, pick key and disk.
inline size_t slice_bytes(int cap) {
  return static_cast<size_t>(cap) * (4 + 4 + 4 + 4 + 4 + 1);
}

__device__ __forceinline__ Staged staged_layout(unsigned char* smem,
                                                int cap) {
  Staged st;
  st.run = nullptr;
  st.ld = reinterpret_cast<float*>(smem);
  st.pre = st.ld + cap;
  st.ls = st.pre + cap;
  st.lt = st.ls + cap;
  st.pkey = reinterpret_cast<uint32_t*>(st.lt + cap);
  st.dsk = reinterpret_cast<int8_t*>(st.pkey + cap);
  st.n = 0;
  return st;
}

__device__ __forceinline__ int flat_of(const Staged& st, int t) {
  return static_cast<int>(static_cast<uint32_t>(st.run[t]));
}

// The warp stages broker b's run: each slot's disk (-1 for none or one
// >= D, and for the padding up to a multiple of 4), load and pick key
// (the order of its load, signed zeros made equal, when it is movable; 0,
// below every load's, when it is pinned).
__device__ void stage_broker(const Inputs& in, const Scratch& sc, int b,
                             Staged& st) {
  const int lane = threadIdx.x & 31;
  st.n = sc.count[b];
  st.run = sc.run + sc.start[b];
  const int padded = (st.n + 3) & ~3;
#pragma unroll 4
  for (int t = lane; t < padded; t += 32) {
    if (t >= st.n) {
      st.dsk[t] = -1;
      st.pkey[t] = 0u;
      continue;
    }
    const unsigned long long e = st.run[t];
    const int i = static_cast<int>(static_cast<uint32_t>(e));
    const float x = in.load[i];
    st.dsk[t] = static_cast<int8_t>(static_cast<int>((e >> 32) & 63u) - 1);
    st.ld[t] = x;
    st.pkey[t] = in.movable[i / in.S] ? cc::ordered_bits(__fadd_rn(x, 0.0f))
                                      : 0u;
  }
  __syncwarp();
}

// Lane d: disk d's fold over the staged slots in flat order, each of its
// slots' prefix written (every lane reads each slot: a broadcast).
__device__ __forceinline__ float fold_all(const Staged& st) {
  const int lane = threadIdx.x & 31;
  const int8_t* __restrict__ dsk = st.dsk;
  const float* __restrict__ ld = st.ld;
  float* __restrict__ pre = st.pre;
  float acc = 0.0f;
#pragma unroll 8
  for (int j = 0; j < st.n; ++j) {
    const int d = dsk[j];
    const float x = ld[j];
    if (d == lane) {
      pre[j] = acc;
      acc = __fadd_rn(acc, x);
    }
  }
  __syncwarp();
  return acc;
}

// Lane d < D: disk d's capacity and state.
struct DiskLane {
  float cap;
  bool present, alive, dead;
};

struct Disks {
  int src, dst;
  bool ok;
};

// Every lane: the round's source disk (first index of the largest shed
// pressure) and destination (first index of the lowest alive
// utilization; every disk dead: disk 0, never a valid destination), from
// lane d's load of disk d. Every operation rounded alone; the mean's sum
// in disk order; the first indices by warp reductions on
// order-preserving keys (signed zeros made equal; lanes >= D below all).
__device__ __forceinline__ Disks pick_disks(const Inputs& in,
                                            const DiskLane& dl, float l) {
  const int lane = threadIdx.x & 31;
  const bool real = lane < in.D;
  const float c = dl.cap;
  const float over = fmaxf(__fsub_rn(l, __fmul_rn(c, in.threshold)), 0.0f);
  float v = __fadd_rn(dl.present ? over : 0.0f, dl.dead ? l : 0.0f);
  const float util = dl.present ? __fdiv_rn(l, fmaxf(c, 1e-9f)) : 0.0f;
  if (in.band) {
    const float w = __fmul_rn(util, dl.alive ? 1.0f : 0.0f);
    float total = 0.0f;
    for (int d = 0; d < in.D; ++d)
      total = __fadd_rn(total, __shfl_sync(kAll, w, d));
    const int n_alive = __popc(__ballot_sync(kAll, dl.alive));
    const float avg = __fdiv_rn(total, static_cast<float>(max(n_alive, 1)));
    const float bar = __fmul_rn(avg, in.upper);
    const float above = fmaxf(__fsub_rn(util, bar), 0.0f);
    v = __fadd_rn(v, dl.alive ? __fmul_rn(above, c) : 0.0f);
  }
  const uint32_t kv = real ? cc::ordered_bits(__fadd_rn(v, 0.0f)) : 0u;
  const uint32_t ku =
      real ? ~cc::ordered_bits(dl.alive ? __fadd_rn(util, 0.0f)
                                        : __uint_as_float(0x7f800000u))
           : 0u;
  const uint32_t top_v = __reduce_max_sync(kAll, kv);
  const uint32_t top_u = __reduce_max_sync(kAll, ku);
  Disks r;
  r.src = __ffs(__ballot_sync(kAll, kv == top_v)) - 1;
  r.dst = __ffs(__ballot_sync(kAll, ku == top_u)) - 1;
  const float best_v = __shfl_sync(kAll, v, r.src);
  const int dst_alive = __shfl_sync(kAll, dl.alive ? 1 : 0, r.dst);
  r.ok = (best_v > 1e-9f) && dst_alive && r.dst != r.src;
  return r;
}

struct Pick {
  int j;     // staged position, -1 for none
  bool any;  // a slot sits on the source disk
};

// Every lane: the heaviest movable slot on disk `src`, lowest flat index
// first among equal loads (-1 for none, or when its load is not >= 0: the
// reference's pick scores a pinned slot -1), and whether any slot sits
// there. Lane l reads slots 4l..4l+3 of each 128 (their keys as one
// 16-byte load, their disks as one word), in flat order.
__device__ __forceinline__ Pick pick_slot(const Staged& st, int src) {
  const int lane = threadIdx.x & 31;
  uint32_t best = 0u;
  uint32_t bj = 0xffffffffu;
  int any = 0;
  for (int base = 4 * lane; base < st.n; base += 128) {
    const uint4 k4 = *reinterpret_cast<const uint4*>(st.pkey + base);
    const uint32_t d4 = *reinterpret_cast<const uint32_t*>(st.dsk + base);
    const uint32_t key[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (static_cast<int>(static_cast<int8_t>(d4 >> (8 * u))) != src)
        continue;
      any = 1;
      if (key[u] > best) {
        best = key[u];
        bj = static_cast<uint32_t>(base + u);
      }
    }
  }
  Pick p;
  p.any = __any_sync(kAll, any) != 0;
  const uint32_t top = __reduce_max_sync(kAll, best);
  const uint32_t j = __reduce_min_sync(kAll, best == top ? bj : 0xffffffffu);
  p.j = top == 0u || !(cc::unordered_float(top) >= 0.0f)
            ? -1 : static_cast<int>(j);
  return p;
}

// Every lane: the loads of the slots after `from` on disk s and on disk d,
// in flat order, gathered into st.ls and st.lt; their counts. Each step
// takes 128 slots: their disks and ballots first, then the places.
struct Lists {
  int cs, cd;
};

__device__ __forceinline__ Lists collect2(const Staged& st, int from, int s,
                                          int d) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  Lists l{0, 0};
  for (int base = from; base < st.n; base += 128) {
    int x[4];
    unsigned ms[4], md[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = base + 32 * u + lane;
      x[u] = k < st.n ? st.dsk[k] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ms[u] = __ballot_sync(kAll, x[u] == s);
      md[u] = __ballot_sync(kAll, x[u] == d);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = base + 32 * u + lane;
      if (x[u] == s) st.ls[l.cs + __popc(ms[u] & below)] = st.ld[k];
      if (x[u] == d) st.lt[l.cd + __popc(md[u] & below)] = st.ld[k];
      l.cs += __popc(ms[u]);
      l.cd += __popc(md[u]);
    }
  }
  __syncwarp();
  return l;
}

// Every lane: disk d's fold before slot `from`: the prefix of its first
// slot from `from` on, or its whole fold when none follows.
__device__ __forceinline__ float prefix_at(const Staged& st, int from, int d,
                                           float whole) {
  const int lane = threadIdx.x & 31;
  for (int base = from; base < st.n; base += 32) {
    const int k = base + lane;
    const unsigned md =
        __ballot_sync(kAll, k < st.n && st.dsk[k] == d);
    if (md) return st.pre[base + __ffs(md) - 1];
  }
  return whole;
}

// Every lane: the prefixes written back to the slots after `from` on disks
// s and d, found by the same ballots: a slot's is the inclusive fold of
// the list entry before its own (prefix_lists), or the list's start.
__device__ __forceinline__ void scatter2(const Staged& st, int from, int s,
                                         int d, float s0, float d0) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int ns = 0, nd = 0;
  for (int base = from; base < st.n; base += 128) {
    int x[4];
    unsigned ms[4], md[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = base + 32 * u + lane;
      x[u] = k < st.n ? st.dsk[k] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ms[u] = __ballot_sync(kAll, x[u] == s);
      md[u] = __ballot_sync(kAll, x[u] == d);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = base + 32 * u + lane;
      if (x[u] == s) {
        const int at = ns + __popc(ms[u] & below);
        st.pre[k] = at > 0 ? st.ls[at - 1] : s0;
      }
      if (x[u] == d) {
        const int at = nd + __popc(md[u] & below);
        st.pre[k] = at > 0 ? st.lt[at - 1] : d0;
      }
      ns += __popc(ms[u]);
      nd += __popc(md[u]);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// One lane, in place: each of the eight loads in x, y replaced by the fold
// after it, from acc (the sequential fold with __fadd_rn): each add's
// result is the element stored, no copy on the chain.
__device__ __forceinline__ void prefix8(float4& x, float4& y, float& acc) {
  acc = x.x = __fadd_rn(acc, x.x);
  acc = x.y = __fadd_rn(acc, x.y);
  acc = x.z = __fadd_rn(acc, x.z);
  acc = x.w = __fadd_rn(acc, x.w);
  acc = y.x = __fadd_rn(acc, y.x);
  acc = y.y = __fadd_rn(acc, y.y);
  acc = y.z = __fadd_rn(acc, y.z);
  acc = y.w = __fadd_rn(acc, y.w);
}

// One lane: the list at v from position t on turned into its inclusive
// folds in place from acc; returns the fold after its last load. The next
// eight loads are read before the current eight are written.
__device__ __forceinline__ float prefix_list(float* __restrict__ v, int t,
                                             int cnt, float acc) {
  const int blocks = t + ((cnt - t) & ~7);
  if (t < blocks) {
    float4 x = load4(v + t), y = load4(v + t + 4);
    for (; t < blocks; t += 8) {
      float4 nx, ny;
      const bool more = t + 8 < blocks;
      if (more) {
        nx = load4(v + t + 8);
        ny = load4(v + t + 12);
      }
      prefix8(x, y, acc);
      store4(v + t, x);
      store4(v + t + 4, y);
      if (more) {
        x = nx;
        y = ny;
      }
    }
  }
  for (; t < cnt; ++t) acc = v[t] = __fadd_rn(acc, v[t]);
  return acc;
}

// One lane: both lists turned into their inclusive folds in place, the
// source's from *a, the destination's from *b, their common blocks
// interleaved (two independent chains of adds); *a and *b become the two
// disks' folds.
__device__ __forceinline__ void prefix_lists(float* __restrict__ s, int cs,
                                             float* __restrict__ d, int cd,
                                             float* a, float* b) {
  float fa = *a, fb = *b;
  const int both = min(cs, cd) & ~7;
  int t = 0;
  if (both > 0) {
    float4 sx = load4(s), sy = load4(s + 4), dx = load4(d), dy = load4(d + 4);
    for (; t < both; t += 8) {
      float4 nsx, nsy, ndx, ndy;
      const bool more = t + 8 < both;
      if (more) {
        nsx = load4(s + t + 8);
        nsy = load4(s + t + 12);
        ndx = load4(d + t + 8);
        ndy = load4(d + t + 12);
      }
      prefix8(sx, sy, fa);
      prefix8(dx, dy, fb);
      store4(s + t, sx);
      store4(s + t + 4, sy);
      store4(d + t, dx);
      store4(d + t + 4, dy);
      if (more) {
        sx = nsx;
        sy = nsy;
        dx = ndx;
        dy = ndy;
      }
    }
  }
  *a = prefix_list(s, t, cs, fa);
  *b = prefix_list(d, t, cd, fb);
}

// Every lane, after slot j moved from disk s to disk d: the two disks
// refolded from slot j on (a sequential fold keeps its bits up to the
// first position that changes): the source from `from_src` (its prefix at
// j) over its later slots, the destination from `at` (its prefix at j)
// over j and its later slots. The warp gathers both disks' later loads
// into two lists, one lane folds them in place, the two chains of adds
// interleaved, and the warp writes every prefix back. Returns the two new
// folds in *to_src and *to_dst. Running it twice gives the same state.
__device__ __forceinline__ void refold(const Staged& st, int j, int s, int d,
                                       float from_src, float at,
                                       float* to_src, float* to_dst) {
  const int lane = threadIdx.x & 31;
  const Lists l = collect2(st, j + 1, s, d);
  const float d0 = __fadd_rn(at, st.ld[j]);
  float a = from_src, b = d0;
  if (lane == 0) {
    st.pre[j] = at;
    prefix_lists(st.ls, l.cs, st.lt, l.cd, &a, &b);
  }
  __syncwarp();
  scatter2(st, j + 1, s, d, from_src, d0);
  *to_src = __shfl_sync(kAll, a, 0);
  *to_dst = __shfl_sync(kAll, b, 0);
}

struct Block {  // a sentinel slot whose move is undone from `round` on
  long long flat;
  int round;
};

struct Outcome {
  int nopick_round, nopick_kind, rounds;
  float load;  // lane d: disk d's final load
};

// The broker's loop, every lane of the warp. Leaves the final disks in
// st.dsk; returns the first round without a pick and its kind, the rounds
// it ran and lane d's final load of disk d.
__device__ Outcome run_broker(const Inputs& in, int b, const Staged& st,
                              Block blk0, Block blk1) {
  const int lane = threadIdx.x & 31;
  DiskLane dl{0.0f, false, false, false};
  if (lane < in.D) {
    const long long at = static_cast<long long>(b) * in.D + lane;
    dl.cap = in.cap[at];
    const bool a = in.alive[at] != 0;
    dl.present = dl.cap > 0.0f;
    dl.alive = dl.present && a;
    dl.dead = dl.present && !a;
  }
  Outcome o{kNever, 0, 0, fold_all(st)};
  const bool blocks = blk0.flat >= 0 || blk1.flat >= 0;
  Disks dk;
  Pick pk;
  float to_src, to_dst;
  int r = 0;
  for (; r < in.max_rounds; ++r) {
    dk = pick_disks(in, dl, o.load);
    pk = pick_slot(st, dk.src);
    if (!pk.any || pk.j < 0) {
      o.nopick_round = r;
      o.nopick_kind = pk.any ? kNoPickPinned : kNoPickEmpty;
      ++r;
      break;
    }
    if (!dk.ok) {
      ++r;
      break;
    }
    const int j = pk.j;
    if (blocks) {
      const long long flat = flat_of(st, j);
      if ((flat == blk0.flat && r >= blk0.round) ||
          (flat == blk1.flat && r >= blk1.round)) {
        ++r;  // undone every round from here on
        break;
      }
    }
    // The move, then the two disks that changed refolded from slot j on.
    const float from_src = st.pre[j];
    const float at = prefix_at(st, j + 1, dk.dst,
                               __shfl_sync(kAll, o.load, dk.dst));
    __syncwarp();
    if (lane == 0) st.dsk[j] = static_cast<int8_t>(dk.dst);
    __syncwarp();
    refold(st, j, dk.src, dk.dst, from_src, at, &to_src, &to_dst);
    if (lane == dk.src) o.load = to_src;
    if (lane == dk.dst) o.load = to_dst;
    __syncwarp();
  }
  o.rounds = r;
  return o;
}

__device__ void write_back(const Inputs& in, int b, const Staged& st,
                           float load, int* out_disk, float* out_load) {
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < st.n; t += 32) {
    const int d = st.dsk[t];
    if (d >= 0) out_disk[flat_of(st, t)] = d;
  }
  if (lane < in.D) out_load[static_cast<long long>(b) * in.D + lane] = load;
}

__global__ void __launch_bounds__(32) balance_kernel(
    Inputs in, Scratch sc, int cap, int* __restrict__ out_disk,
    float* __restrict__ out_load) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  Staged st = staged_layout(smem, cap);
  stage_broker(in, sc, b, st);
  const Block none{-1, kNever};
  const Outcome o = run_broker(in, b, st, none, none);
  write_back(in, b, st, o.load, out_disk, out_load);
  if (threadIdx.x == 0) {
    sc.nopick_round[b] = o.nopick_round;
    sc.nopick_kind[b] = o.nopick_kind;
    sc.rounds[b] = o.rounds;
  }
}

// Every lane: the first no-pick round, over brokers above `owner`, of a
// kind whose sentinel slot is `flat`.
__device__ int first_block_round(const Inputs& in, const Scratch& sc,
                                 int owner, long long flat,
                                 long long flat_pin, long long flat_empty) {
  int m = kNever;
  for (int b = owner + 1 + static_cast<int>(threadIdx.x & 31); b < in.B;
       b += 32) {
    const int k = sc.nopick_kind[b];
    const long long f = k == kNoPickPinned ? flat_pin
                        : k == kNoPickEmpty ? flat_empty : -1;
    if (f == flat) m = min(m, sc.nopick_round[b]);
  }
  return __reduce_min_sync(kAll, m);
}

__global__ void __launch_bounds__(32) fixup_kernel(
    Inputs in, Scratch sc, int cap, int* __restrict__ out_disk,
    float* __restrict__ out_load) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long last = static_cast<long long>(in.P - 1) * in.S;
  const long long flat_pin = last;
  const long long flat_empty = last + 0x7fffffff % in.S;
  int owner[2];
  const long long flats[2] = {flat_pin, flat_empty};
  for (int k = 0; k < 2; ++k) {
    const long long f = flats[k];
    const int a = in.assignment[f];
    owner[k] = (a >= 0 && a < in.B && in.pmask[in.P - 1] && in.disk_in[f] >= 0)
                   ? a : -1;
  }
  // Owners from the highest index down: a lower owner's block round reads
  // the higher owner's corrected no-pick round.
  int order[2] = {0, 1};
  if (owner[1] > owner[0]) {
    order[0] = 1;
    order[1] = 0;
  }
  for (int q = 0; q < 2; ++q) {
    const int o = owner[order[q]];
    if (o < 0) continue;
    if (q == 1 && o == owner[order[0]]) break;  // one owner of both slots
    Block blk[2] = {{-1, kNever}, {-1, kNever}};
    bool any = false;
    for (int k = 0; k < 2; ++k) {
      if (owner[k] != o || (k == 1 && flats[1] == flats[0])) continue;
      const int r = first_block_round(in, sc, o, flats[k], flat_pin,
                                      flat_empty);
      if (r != kNever) {
        blk[k] = Block{flats[k], r};
        any = true;
      }
    }
    if (!any) continue;
    Staged st = staged_layout(smem, cap);
    stage_broker(in, sc, o, st);
    const Outcome oc = run_broker(in, o, st, blk[0], blk[1]);
    write_back(in, o, st, oc.load, out_disk, out_load);
    if (threadIdx.x == 0) {
      sc.nopick_round[o] = oc.nopick_round;
      sc.nopick_kind[o] = oc.nopick_kind;
      sc.rounds[o] = oc.rounds;
    }
    __syncwarp();
  }
}

}  // namespace

// Int32 words of the balancer's scratch for n slots and B brokers (see
// Scratch): each broker's count first, its first no-pick round and kind
// and the rounds it ran last.
extern "C" long long cc_intra_broker_scratch_words(long long n, int B) {
  return scratch_words(n, B);
}

// Word offset of the largest per-broker count in the scratch.
extern "C" long long cc_intra_broker_max_offset(int B) { return 2LL * B; }

// Group the slots by broker, stably: each broker's slots as one run in
// flat order, its count and start, and the largest count, which the
// caller reads before balancing. Five device ops.
extern "C" int cc_intra_broker_group(const int* assignment,
                                     const uint8_t* partition_mask,
                                     const int* disk_in, int P, int S, int B,
                                     int D, int* scratch, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n = static_cast<long long>(P) * S;
  if (n <= 0 || n >= (1LL << 31) || B < 1 || B > (1 << 20) || D < 1 ||
      D > kMaxDisks)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        load_scatter_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(unsigned long long)) * kTile);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(split_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(split_smem_bytes(12)));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const LoadPlan pl = load_plan(n, B);
  const Scratch sc = scratch_of(scratch, n, B);
  const int ni = static_cast<int>(n);
  cudaError_t err = cudaMemsetAsync(sc.most, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  load_count_kernel<<<pl.tiles, kLoadThreads, 0, stream>>>(
      assignment, partition_mask, ni, S, B, pl.shift, pl.buckets, sc.table);
  load_scan_kernel<<<(pl.buckets + 31) / 32, kLoadThreads, 0, stream>>>(
      pl.tiles, pl.buckets, sc.table, sc.total);
  load_scatter_kernel<true><<<pl.tiles, kLoadThreads,
                              sizeof(unsigned long long) * kTile, stream>>>(
      assignment, partition_mask, nullptr, disk_in, ni, S, B, D, pl.shift,
      pl.buckets, pl.tiles, sc.table, sc.total, sc.entry);
  split_kernel<<<pl.buckets, kLoadThreads, split_smem_bytes(pl.shift),
                 stream>>>(B, pl.shift, pl.buckets, sc.total, sc.entry,
                           sc.run, sc.count, sc.start, sc.most);
  return static_cast<int>(cudaGetLastError());
}

// Run every broker's loop (max_rounds 0: the loads alone), then the
// sentinel fix-up. `most` is the largest per-broker count that
// cc_intra_broker_group wrote.
extern "C" int cc_intra_broker_balance(
    const int* assignment, const uint8_t* partition_mask, const float* load,
    const uint8_t* movable, const int* disk_in, const float* cap,
    const uint8_t* alive, int P, int S, int B, int D, int most,
    float threshold, float upper, int band, int max_rounds, int* out_disk,
    float* out_load, int* scratch, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n = static_cast<long long>(P) * S;
  if (n <= 0 || n >= (1LL << 31) || B < 1 || B > (1 << 20) || D < 1 ||
      D > kMaxDisks || most < 0 || most > kMaxReplicas || max_rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = ((most > 0 ? most : 1) + 7) & ~7;
  const size_t smem = slice_bytes(slots);
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        balance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(slice_bytes(kMaxReplicas)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fixup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(slice_bytes(kMaxReplicas)));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  Inputs in{assignment, partition_mask, load, movable, disk_in, cap, alive,
            P, S, B, D, threshold, upper, band, max_rounds};
  const Scratch sc = scratch_of(scratch, n, B);
  cudaError_t err = cudaMemcpyAsync(out_disk, disk_in, sizeof(int) * n,
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  balance_kernel<<<B, 32, smem, stream>>>(in, sc, slots, out_disk, out_load);
  if (max_rounds > 0)
    fixup_kernel<<<1, 32, smem, stream>>>(in, sc, slots, out_disk, out_load);
  return static_cast<int>(cudaGetLastError());
}

// Int32 words of scratch the load mode needs for n slots and B brokers.
extern "C" long long cc_intra_broker_load_scratch_words(long long n, int B) {
  return load_scratch_words(n, B);
}

// Load mode: out_load [B, D] = each (broker, disk)'s DISK load summed in
// flat slot order over the slots whose partition is masked in, whose
// broker is in [0, B) and whose disk is in [0, D). No host read.
extern "C" int cc_intra_broker_load(const int* assignment,
                                    const uint8_t* partition_mask,
                                    const float* load, const int* disk_in,
                                    int P, int S, int B, int D,
                                    float* out_load, int* scratch,
                                    long long scratch_words, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n = static_cast<long long>(P) * S;
  if (n <= 0 || n >= (1LL << 31) || B < 1 || B > (1 << 20) || D < 1 ||
      D > kMaxDisks || scratch_words < load_scratch_words(n, B))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        load_scatter_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(unsigned long long)) * kTile);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(load_fold_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(fold_smem(12)));  // B <= 2**20
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const LoadPlan pl = load_plan(n, B);
  const LoadScratch sc = load_scratch_of(scratch, n, B);
  const int ni = static_cast<int>(n);
  load_count_kernel<<<pl.tiles, kLoadThreads, 0, stream>>>(
      assignment, partition_mask, ni, S, B, pl.shift, pl.buckets, sc.table);
  load_scan_kernel<<<(pl.buckets + 31) / 32, kLoadThreads, 0, stream>>>(
      pl.tiles, pl.buckets, sc.table, sc.total);
  load_scatter_kernel<false><<<pl.tiles, kLoadThreads,
                        sizeof(unsigned long long) * kTile, stream>>>(
      assignment, partition_mask, load, disk_in, ni, S, B, D, pl.shift,
      pl.buckets, pl.tiles, sc.table, sc.total, sc.entry);
  load_fold_kernel<<<pl.buckets, kLoadThreads, fold_smem(pl.shift), stream>>>(B, D, pl.shift, pl.buckets, sc.total, sc.entry,
                               out_load);
  return static_cast<int>(cudaGetLastError());
}
