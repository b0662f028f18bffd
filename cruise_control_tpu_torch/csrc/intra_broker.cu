// K5 intra_broker: the intra-broker disk balancer, each broker's loop run
// to its own fixed point in one CTA; and, in load mode, the per-(broker,
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
// (~38 MB there) and writes [B, D] floats.
//
// Why brokers run apart: a broker's round reads only its own slots, and a
// broker that does not move keeps its state, so it never moves again. Each
// broker can therefore run its own loop, in one launch, to its own fixed
// point or to max_rounds, which is what the reference's global loop gives
// it. Launches per call do not depend on the round count.
//
// Balancer design:
//  group (4 nodes): per-broker replica counts (integer atomics), one CTA
//  scans them into bases and the largest count, and every slot takes a
//  position in its broker's list (integer atomics, any order);
//  balance: one CTA per broker sorts its list back into flat slot order
//  (bitonic, in shared memory), stages each slot's disk, load and movable
//  flag, and runs the rounds: per-disk loads rebuilt each round by one
//  thread per disk, serially in flat slot order with __fadd_rn (the
//  reference's segment sum; never updated incrementally); shed pressure,
//  every operation rounded alone with __fmul_rn / __fadd_rn: the
//  reference's loop contracts no multiply-add here (XLA hoists
//  cap * threshold out of it and shares avg * upper among a broker's
//  disks), and nvcc would contract them by default; the
//  first-index argmax and argmin over the disks; the heaviest movable
//  replica on the source disk, lowest flat index first among equal loads,
//  by a block reduction; the move. It records the first round in which the
//  broker had no pick and why (no replica on its source disk, or all of
//  them pinned).
//  fixup (one CTA): the reference's sentinel collision. A broker without a
//  pick writes its scatter row onto slot (P-1, 2147483647 % S) (no replica
//  on the source disk) or (P-1, 0) (all pinned), putting back the slot's
//  value from the start of the round; writes with equal indices land in
//  broker order. So a broker above the slot's owner that has no pick in
//  round r undoes the owner's move of that slot in round r, and, having
//  no pick, it has none in every later round. For each sentinel slot's
//  owner, highest index first, the CTA takes the first such round of the
//  brokers above it and reruns the owner's loop from the input with the
//  move of that slot frozen from that round on (the owner replays the
//  undone move until max_rounds, changing nothing).
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

// Both kernels that run a broker's loop use kThreads threads: the loop's
// block reduction keeps one partial per warp (BrokerShared::red_*).
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDisks = 32;
constexpr int kMaxReplicas = 8192;
constexpr int kNever = 0x7fffffff;
constexpr int kNoPickPinned = 1;
constexpr int kNoPickEmpty = 2;

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

struct Scratch {  // int32 words, see cc_intra_broker_scratch_words
  int* count;     // [B]
  int* base;      // [B]
  int* cursor;    // [B]
  int* most;      // [1] (+3 pad)
  int* list;      // [P*S]
  int* nopick_round;  // [B]
  int* nopick_kind;   // [B]
  int* rounds;        // [B] rounds each broker ran (its last one included)
};

__host__ __device__ inline Scratch scratch_of(int* w, long long n, int B) {
  Scratch s;
  s.count = w;
  s.base = w + B;
  s.cursor = w + 2LL * B;
  s.most = w + 3LL * B;
  s.list = w + 3LL * B + 4;
  s.nopick_round = s.list + n;
  s.nopick_kind = s.nopick_round + B;
  s.rounds = s.nopick_kind + B;
  return s;
}

__device__ __forceinline__ int slot_broker(const int* __restrict__ assignment,
                                           const uint8_t* __restrict__ pmask,
                                           int i, int S, int B) {
  const int b = assignment[i];
  return (b >= 0 && b < B && pmask[i / S]) ? b : -1;
}

__global__ void count_kernel(const int* __restrict__ assignment,
                             const uint8_t* __restrict__ pmask, int n, int S,
                             int B, int* __restrict__ count) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int b = slot_broker(assignment, pmask, i, S, B);
    if (b >= 0) atomicAdd(&count[b], 1);
  }
}

// One CTA: exclusive scan of the counts into bases (and cursors), and the
// largest count.
__global__ void scan_kernel(int B, const int* __restrict__ count,
                            int* __restrict__ base, int* __restrict__ cursor,
                            int* __restrict__ most) {
  __shared__ int warp_sums[32];
  __shared__ int warp_max[32];
  __shared__ int carry, top;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    carry = 0;
    top = 0;
  }
  __syncthreads();
  for (int chunk = 0; chunk < B; chunk += blockDim.x) {
    const int b = chunk + threadIdx.x;
    const int v = b < B ? count[b] : 0;
    int x = v, m = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
      m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
    }
    if (lane == 31) warp_sums[warp] = x;
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x >> 5;
      int w = lane < nw ? warp_sums[lane] : 0;
      int mm = lane < nw ? warp_max[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
        mm = max(mm, __shfl_xor_sync(0xffffffffu, mm, d));
      }
      warp_sums[lane] = w;
      if (lane == 0) top = max(top, mm);
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (b < B) {
      base[b] = before + x - v;
      cursor[b] = before + x - v;
    }
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) *most = top;
}

__global__ void scatter_kernel(const int* __restrict__ assignment,
                               const uint8_t* __restrict__ pmask, int n, int S,
                               int B, int* __restrict__ cursor,
                               int* __restrict__ list) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int b = slot_broker(assignment, pmask, i, S, B);
    if (b >= 0) list[atomicAdd(&cursor[b], 1)] = i;
  }
}

// One broker's staged slots in shared memory, in flat slot order.
struct Staged {
  unsigned long long* keys;  // [cap2] sort space
  int* idx;                  // flat slot
  float* ld;                 // DISK load
  int8_t* dsk;               // disk slot, -1 none
  uint8_t* mov;              // movable
  int n;
};

__device__ __forceinline__ Staged staged_layout(unsigned char* smem, int cap2) {
  Staged st;
  st.keys = reinterpret_cast<unsigned long long*>(smem);
  st.idx = reinterpret_cast<int*>(st.keys + cap2);
  st.ld = reinterpret_cast<float*>(st.idx + cap2);
  st.dsk = reinterpret_cast<int8_t*>(st.ld + cap2);
  st.mov = reinterpret_cast<uint8_t*>(st.dsk + cap2);
  st.n = 0;
  return st;
}

// Every thread of the block must call it. The sort covers the broker's
// own count rounded up to a power of two, not the largest broker's.
__device__ void stage_broker(const Inputs& in, const Scratch& sc, int b,
                             Staged& st) {
  const int n = sc.count[b];
  const int n2 = cc::next_pow2(n > 0 ? n : 1);
  const int* lst = sc.list + sc.base[b];
  for (int t = threadIdx.x; t < n2; t += blockDim.x)
    st.keys[t] = t < n ? static_cast<unsigned long long>(lst[t]) + 1ull : 0ull;
  __syncthreads();
  cc::bitonic_sort_desc(st.keys, n2);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int i = static_cast<int>(st.keys[n - 1 - t] - 1ull);
    st.idx[t] = i;
    st.ld[t] = in.load[i];
    st.dsk[t] = static_cast<int8_t>(in.disk_in[i]);
    st.mov[t] = in.movable[i / in.S];
  }
  st.n = n;
  __syncthreads();
}

struct Block {  // a sentinel slot whose move is undone from `round` on
  long long flat;
  int round;
};

struct BrokerShared {
  float load[kMaxDisks];
  int src, dst, ok, stop, pick_j, any_on;
  float red_ld[kWarps];
  int red_j[kWarps], red_any[kWarps];
};

// Per-disk loads of the staged broker, one thread per disk, serially in
// flat slot order.
__device__ __forceinline__ void disk_loads(const Staged& st, int D,
                                           BrokerShared& sh) {
  if (threadIdx.x < D) {
    const int8_t d = static_cast<int8_t>(threadIdx.x);
    float acc = 0.0f;
    for (int j = 0; j < st.n; ++j)
      if (st.dsk[j] == d) acc = __fadd_rn(acc, st.ld[j]);
    sh.load[threadIdx.x] = acc;
  }
}

// The broker's loop (every thread of the block calls it). Leaves the
// final disks in st.dsk and the final loads in sh.load; returns through
// (nopick_round, nopick_kind) the first round without a pick, and through
// rounds_run the rounds it ran.
__device__ void run_broker(const Inputs& in, int b, Staged& st,
                           BrokerShared& sh, Block blk0, Block blk1,
                           int* nopick_round, int* nopick_kind,
                           int* rounds_run) {
  const int D = in.D;
  const float* cap = in.cap + static_cast<long long>(b) * D;
  const uint8_t* alive = in.alive + static_cast<long long>(b) * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int np_round = kNever, np_kind = 0;
  int r = 0;
  for (; r < in.max_rounds; ++r) {
    disk_loads(st, D, sh);
    __syncthreads();
    if (threadIdx.x == 0) {
      // Shed pressure; util and the mean over alive disks.
      float v[kMaxDisks], util[kMaxDisks];
      float total = 0.0f;
      int n_alive = 0;
      for (int d = 0; d < D; ++d) {
        const float c = cap[d], l = sh.load[d];
        const bool present = c > 0.0f;
        const bool dead = present && !alive[d];
        const float over = fmaxf(__fsub_rn(l, __fmul_rn(c, in.threshold)),
                                 0.0f);
        v[d] = __fadd_rn(present ? over : 0.0f, dead ? l : 0.0f);
        util[d] = present ? __fdiv_rn(l, fmaxf(c, 1e-9f)) : 0.0f;
        const bool al = present && alive[d];
        total = __fadd_rn(total, __fmul_rn(util[d], al ? 1.0f : 0.0f));
        n_alive += al;
      }
      if (in.band) {
        const float avg = __fdiv_rn(total, static_cast<float>(max(n_alive, 1)));
        const float bar = __fmul_rn(avg, in.upper);
        for (int d = 0; d < D; ++d) {
          const bool al = cap[d] > 0.0f && alive[d];
          const float above = fmaxf(__fsub_rn(util[d], bar), 0.0f);
          v[d] = __fadd_rn(v[d], al ? __fmul_rn(above, cap[d]) : 0.0f);
        }
      }
      // First index of the largest pressure and of the lowest alive
      // utilization (every disk dead: disk 0, never a valid destination).
      int src = 0, dst = 0;
      float best_v = v[0];
      for (int d = 1; d < D; ++d)
        if (v[d] > best_v) {
          best_v = v[d];
          src = d;
        }
      float best_u = 0.0f;
      for (int d = 0; d < D; ++d) {
        const bool al = cap[d] > 0.0f && alive[d];
        const float u = al ? __fdiv_rn(sh.load[d], fmaxf(cap[d], 1e-9f))
                           : __uint_as_float(0x7f800000u);
        if (d == 0 || u < best_u) {
          best_u = u;
          dst = d;
        }
      }
      const bool dst_alive = cap[dst] > 0.0f && alive[dst];
      sh.src = src;
      sh.dst = dst;
      sh.ok = (best_v > 1e-9f) && dst_alive && dst != src;
    }
    __syncthreads();
    // The heaviest movable replica on the source disk, lowest flat index
    // first; and whether any replica sits there.
    const int8_t src = static_cast<int8_t>(sh.src);
    float bl = cc::neg_inf();
    int bj = -1, any = 0;
    for (int j = threadIdx.x; j < st.n; j += blockDim.x) {
      if (st.dsk[j] != src) continue;
      any = 1;
      if (st.mov[j] && (bj < 0 || st.ld[j] > bl)) {
        bl = st.ld[j];
        bj = j;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float ol = __shfl_xor_sync(0xffffffffu, bl, d);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, d);
      any |= __shfl_xor_sync(0xffffffffu, any, d);
      if (oj >= 0 && (bj < 0 || ol > bl || (ol == bl && oj < bj))) {
        bl = ol;
        bj = oj;
      }
    }
    if (lane == 0) {
      sh.red_ld[warp] = bl;
      sh.red_j[warp] = bj;
      sh.red_any[warp] = any;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float l = sh.red_ld[0];
      int j = sh.red_j[0], a = sh.red_any[0];
      for (int w = 1; w < kWarps; ++w) {
        a |= sh.red_any[w];
        const int oj = sh.red_j[w];
        const float ol = sh.red_ld[w];
        if (oj >= 0 && (j < 0 || ol > l || (ol == l && oj < j))) {
          l = ol;
          j = oj;
        }
      }
      // The reference's pick needs a score >= 0 (a pinned slot scores -1).
      if (j >= 0 && !(l >= 0.0f)) j = -1;
      int stop = 0;
      if (!a) {
        np_round = r;
        np_kind = kNoPickEmpty;
        stop = 1;
      } else if (j < 0) {
        np_round = r;
        np_kind = kNoPickPinned;
        stop = 1;
      } else if (!sh.ok) {
        stop = 1;
      } else {
        const long long flat = st.idx[j];
        if ((flat == blk0.flat && r >= blk0.round) ||
            (flat == blk1.flat && r >= blk1.round)) {
          stop = 1;  // undone every round from here on
        } else {
          st.dsk[j] = static_cast<int8_t>(sh.dst);
        }
      }
      sh.stop = stop;
    }
    __syncthreads();
    if (sh.stop) {
      ++r;
      break;
    }
  }
  disk_loads(st, D, sh);
  __syncthreads();
  if (threadIdx.x == 0) {
    *nopick_round = np_round;
    *nopick_kind = np_kind;
    *rounds_run = r;
  }
}

__device__ void write_back(const Inputs& in, int b, const Staged& st,
                           const BrokerShared& sh, int* out_disk,
                           float* out_load) {
  for (int t = threadIdx.x; t < st.n; t += blockDim.x)
    out_disk[st.idx[t]] = st.dsk[t];
  if (threadIdx.x < in.D)
    out_load[static_cast<long long>(b) * in.D + threadIdx.x] =
        sh.load[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads) balance_kernel(
    Inputs in, Scratch sc, int cap2, int* __restrict__ out_disk,
    float* __restrict__ out_load) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BrokerShared sh;
  __shared__ int np_round, np_kind, ran;
  const int b = blockIdx.x;
  Staged st = staged_layout(smem, cap2);
  stage_broker(in, sc, b, st);
  const Block none{-1, kNever};
  run_broker(in, b, st, sh, none, none, &np_round, &np_kind, &ran);
  write_back(in, b, st, sh, out_disk, out_load);
  if (threadIdx.x == 0) {
    sc.nopick_round[b] = np_round;
    sc.nopick_kind[b] = np_kind;
    sc.rounds[b] = ran;
  }
}

// The first no-pick round, over brokers above `owner`, of a kind whose
// sentinel slot is `flat`.
__device__ int first_block_round(const Inputs& in, const Scratch& sc,
                                 int owner, long long flat, long long flat_pin,
                                 long long flat_empty, int* red) {
  int m = kNever;
  for (int b = owner + 1 + threadIdx.x; b < in.B; b += blockDim.x) {
    const int k = sc.nopick_kind[b];
    const long long f = k == kNoPickPinned ? flat_pin
                        : k == kNoPickEmpty ? flat_empty : -1;
    if (f == flat) m = min(m, sc.nopick_round[b]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, d));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      m = min(m, red[w]);
    red[0] = m;
  }
  __syncthreads();
  m = red[0];
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kThreads) fixup_kernel(
    Inputs in, Scratch sc, int cap2, int* __restrict__ out_disk,
    float* __restrict__ out_load) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BrokerShared sh;
  __shared__ int red[32];
  __shared__ int np_round, np_kind, ran;
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
                                      flat_empty, red);
      if (r != kNever) {
        blk[k] = Block{flats[k], r};
        any = true;
      }
    }
    if (!any) continue;
    Staged st = staged_layout(smem, cap2);
    stage_broker(in, sc, o, st);
    run_broker(in, o, st, sh, blk[0], blk[1], &np_round, &np_kind, &ran);
    write_back(in, o, st, sh, out_disk, out_load);
    if (threadIdx.x == 0) {
      sc.nopick_round[o] = np_round;
      sc.nopick_kind[o] = np_kind;
      sc.rounds[o] = ran;
    }
    __syncthreads();
  }
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

__device__ __forceinline__ unsigned long long load_entry(int b, float load,
                                                         int disk, int D) {
  const uint32_t d = disk >= 0 && disk < D ? disk + 1 : 0;
  return (static_cast<unsigned long long>((static_cast<uint32_t>(b) << 6) |
                                          d)
          << 32) |
         __float_as_uint(load);
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
// base plus the tile's entry of the table.
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
  float ld = b >= 0 ? load[i] : 0.0f;
  int dk = b >= 0 ? disk[i] : -1;
  __syncthreads();
  for (int c0 = lo; c0 < hi; c0 += kLoadThreads) {
    const unsigned long long e = b >= 0 ? load_entry(b, ld, dk, D) : 0ull;
    const int key = b >= 0 ? b >> shift : -1;
    i += kLoadThreads;
    b = i < hi ? slot_broker(assignment, pmask, i, S, B) : -1;
    ld = b >= 0 ? load[i] : 0.0f;
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

inline int grid_of(long long n) {
  const long long want = (n + 255) / 256;
  return static_cast<int>(want < 2112 ? (want > 0 ? want : 1) : 2112);
}

inline size_t smem_of(int cap2) {
  return static_cast<size_t>(cap2) * (8 + 4 + 4 + 1 + 1);
}

}  // namespace

// Int32 words of scratch for n slots and B brokers: counts, bases,
// cursors [B] each, the largest count (4 words), the lists [n], and the
// first no-pick round and kind and the rounds run [B] each.
extern "C" long long cc_intra_broker_scratch_words(long long n, int B) {
  return 6LL * B + 4 + n;
}

// Word offset of the largest per-broker count in the scratch.
extern "C" long long cc_intra_broker_max_offset(int B) { return 3LL * B; }

// Group the slots by broker: counts, bases, the largest count and the
// (unordered) lists. The caller reads the largest count before balancing.
extern "C" int cc_intra_broker_group(const int* assignment,
                                     const uint8_t* partition_mask, int P,
                                     int S, int B, int* scratch,
                                     void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n = static_cast<long long>(P) * S;
  if (n <= 0 || n >= (1LL << 31) || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Scratch sc = scratch_of(scratch, n, B);
  cudaError_t err = cudaMemsetAsync(sc.count, 0, sizeof(int) * B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ni = static_cast<int>(n);
  count_kernel<<<grid_of(n), 256, 0, stream>>>(assignment, partition_mask, ni,
                                               S, B, sc.count);
  scan_kernel<<<1, 1024, 0, stream>>>(B, sc.count, sc.base, sc.cursor,
                                      sc.most);
  scatter_kernel<<<grid_of(n), 256, 0, stream>>>(
      assignment, partition_mask, ni, S, B, sc.cursor, sc.list);
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
  if (n <= 0 || n >= (1LL << 31) || B < 1 || D < 1 || D > kMaxDisks ||
      most < 0 || most > kMaxReplicas || max_rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap2 = cc::next_pow2(most > 0 ? most : 1);
  const size_t smem = smem_of(cap2);
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        balance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_of(kMaxReplicas)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fixup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_of(kMaxReplicas)));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  Inputs in{assignment, partition_mask, load, movable, disk_in, cap, alive,
            P, S, B, D, threshold, upper, band, max_rounds};
  Scratch sc = scratch_of(scratch, n, B);
  cudaError_t err = cudaMemcpyAsync(out_disk, disk_in, sizeof(int) * n,
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  balance_kernel<<<B, kThreads, smem, stream>>>(in, sc, cap2, out_disk,
                                                out_load);
  if (max_rounds > 0)
    fixup_kernel<<<1, kThreads, smem, stream>>>(in, sc, cap2, out_disk,
                                                   out_load);
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
        load_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  load_scatter_kernel<<<pl.tiles, kLoadThreads,
                        sizeof(unsigned long long) * kTile, stream>>>(
      assignment, partition_mask, load, disk_in, ni, S, B, D, pl.shift,
      pl.buckets, pl.tiles, sc.table, sc.total, sc.entry);
  load_fold_kernel<<<pl.buckets, kLoadThreads, fold_smem(pl.shift), stream>>>(B, D, pl.shift, pl.buckets, sc.total, sc.entry,
                               out_load);
  return static_cast<int>(cudaGetLastError());
}
