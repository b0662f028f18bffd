// K3 select_batch: one round's move selection up to the joint recheck.
//
// Replaces (JAX) cruise_control_tpu/analyzer/search.py:89
// reduce_per_source, search.py:179 cumulative_select up to its recheck,
// and candidates.py:377 attach_cumulative_segments (with
// _exclusive_group_prefix):
//  1. per source row of the move and leadership blocks, the best column
//     inside the 1% tie window of the row's maximum, preferring column
//     (row mod cols) and then the next, with the targeted destination
//     column ranked last among ties;
//  2. the top-m rows by reduced score (value descending, lower row first);
//  3. partition dedupe: a row is considered iff it scores above 1e-9 and
//     no earlier scoring row has its partition;
//  4. for every row, the sums over EARLIER considered rows sharing its
//     source broker, destination broker, (source, topic) and
//     (destination, topic) — the pre-deltas — and has_earlier (an earlier
//     considered row touches either of its brokers in either role). The
//     sums take the reference's association: rows sorted by (key, row),
//     an inclusive cumsum blocked by 16 (XLA:CPU's lowering, the one the
//     reference runs on the host), and the difference of the exclusive
//     prefix at the row and at its group's first row;
//  5. the selected rows themselves: every CandidateDeltas field at the
//     picked index (the reference's tree-map gather) and the pot / lbi
//     deltas (agg.py pot_lbi_deltas: the partition's leader NW_OUT where
//     the replica moves, its leader NW_IN where the leadership does).
// The goal-dependent recheck and the move cap stay in PyTorch.
//
// Limits: at most 4,096 reduced rows (2,048 move and 2,048 leadership
// rows on the bounded path's deficit-sized grids), 1 <= m <= 2,048, any
// number of columns, fewer than 2**20 brokers (a broker id + 1 takes 21
// bits of a sort key); partition and broker ids are >= -1. Beyond them
// the entry point returns cudaErrorInvalidValue.
//
// Bound on this card: neither bytes (~4 MB of scores at the 7k/1M cap,
// ~1.3 us) nor operations. Once the scores are reduced what is left is
// latency and on-chip bandwidth: sorts and scans over <= 4,096 rows whose
// phases end in barriers. A first version that ran them all in one CTA
// took 0.17 ms a call at the caps (testing/kernel_times.py --k3-only;
// H100 80GB HBM3 at 700 W): its sorts of 64-bit keys through one SM's
// shared memory and its gather of the picked rows' fields from one SM
// took most of it. This one spreads the sorts over a cluster of four
// SMs and sorts in registers, and gathers on every SM in the reduce.
//
// Design, two launches on the caller's stream:
//  a. reduce_rows_kernel: one warp per reduced row, coalesced over its
//     columns (any number); the row's best column, its packed (value,
//     ~row) 64-bit key and, in one 64-byte record, every field the
//     selection and its outputs read at the picked index (16 lanes, one
//     field each, pot / lbi from leader_load): the only pass over the
//     grid, and the gather spread over every SM.
//  b. select_kernel: a thread-block cluster of four CTAs of 1,024 threads
//     (one SM each), everything in shared memory (dynamic, <= 227 KB a
//     CTA):
//     1. each CTA sorts a quarter of the <= 4,096 keys, descending: a
//        bitonic network over keys held in registers (E = 1 or 2 a
//        thread; strides below 32·E by __shfl_xor_sync, the others
//        through shared memory, one barrier a stage); cluster barrier;
//     2. each key's rank: its position in its quarter plus, in each
//        other quarter (read through distributed shared memory), the
//        number of greater keys (three binary searches stepping
//        together; keys are unique); a key ranked below k is written to
//        every CTA's top-k array; cluster barrier. No CTA reads another's
//        memory after it;
//     3. every CTA copies the k picked records from L2 (four 16-byte
//        loads a row); CTA 0 writes every output field of the rows;
//     4. every CTA dedupes partitions by a first-rank table (an
//        open-addressed hash of 2·k_pad slots, atomicMin of the scoring
//        rank: exact in any order, a minimum): part_ok[i] = ok[i] &&
//        first[part[i]] == i; CTA 0 writes it;
//     5. CTA 1: has_earlier[i] = min(first[src_i], first[dst_i]) < i over
//        a per-broker table (4·k_pad slots, both roles, atomicMin of the
//        considered rank): the twin's entry_min < idx;
//     6. each CTA sorts its grouping's k_pad packed keys ascending, as in
//        1 ((broker + 1) << 43 | (topic ^ 2**31) << 11 | row, 64 bits,
//        for CTA 0 (dst, topic) and 1 (src, topic); (broker + 1) << 11 |
//        row, 32 bits, for CTA 2 (src) and 3 (dst)): the twin's lexsort
//        order, ties by row; then per sorted position its row, per row
//        its position and its group's first position (a binary search
//        for the group's head bits);
//     7. each CTA scans its grouping's value columns (dst: 4 loads,
//        count, leaders, pot, lbi; src: 4 loads, count, leaders;
//        (src, topic): count, leaders; (dst, topic): count): level 0 one
//        thread per 16-row block and column, serial __fadd_rn in sorted
//        order (kept transposed so a warp's stores hit consecutive banks),
//        levels 1 and 2 the same over block totals, the block offsets
//        added top down; then each row's difference of exclusive
//        prefixes, written in row order.
//     No phase loops over all earlier or all m rows, no scan level lives
//     in global memory, and nothing needs a memset.
//
// What each phase costs at the 1k/100k cap (testing/k3_phases.py: CUDA
// events around builds that stop after each phase; H100 80GB HBM3 at
// 700 W; a call 0.061 ms with the reduce): the reduce, the launch and the
// quarter sorts ~18 us (the reduce ~6.5 of it by the profiler); the ranks
// ~6; the gather ~9; the dedupe ~4; has_earlier < 1; the grouping's
// order ~18 (the 64-bit sorts); the scans ~5. ptxas -v: select_kernel 56
// registers, reduce_rows_kernel 32, no stack frame and no spills in
// either.
//
// Shared memory a CTA at the cap (4,096 rows, k = 2,048; region: use,
// then reuse): T 24 KB: its 1,024 run keys and the 2,048 top keys, then
// perm (k u16); V 64 KB: 8 values a row; I 32 KB: src, dst, topic,
// partition, then each row's position and group start (u16); F 2 KB:
// flags; X 64 KB: the quarter sort's spare, the partition table (4,096
// slots × key and rank), the broker table (8,192 slots), the group keys
// and their spare, then the level-0 scan of up to 8 columns (8 × 2,048
// floats); U 4.3 KB: levels 1-2 (8 × (128 + 8) floats). 194,816 bytes.
//
// The file also compiles as host C++ (without __CUDACC__): the same phase
// code runs with one "thread" that walks each phase's items in order, the
// four CTAs one after the other between the cluster barriers, atomics
// that are plain loads and stores, and the sorts as the stage-by-stage
// network (sort_stages, the card's sort below 64 keys)
// (cc_select_batch_host), which the CPU tests hold against the twin.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
#define CC_HD __device__ __forceinline__
#define CC_BOTH __host__ __device__ __forceinline__
#define CC_UNROLL _Pragma("unroll")
#define F_ADD(a, b) __fadd_rn((a), (b))
#define F_SUB(a, b) __fsub_rn((a), (b))
#define F_MUL(a, b) __fmul_rn((a), (b))
#define IS_FINITE(v) isfinite(v)
// A phase's items, strided over the CTA's threads, then a barrier.
#define FOR_ITEMS(t, n) for (int t = threadIdx.x; t < (n); t += blockDim.x)
#define BARRIER() __syncthreads()
// A warp's items over the tiles it owns (its lanes split each tile).
#define FOR_WARP_ITEMS(w, t, tiles, n)                                      \
  for (int w = threadIdx.x >> 5; w < (tiles); w += blockDim.x >> 5)         \
    for (int t = threadIdx.x & 31; t < (n); t += 32)
#define WARP_SYNC() __syncwarp()
#else
#include <vector>
#define CC_HD static inline
#define CC_BOTH static inline
#define CC_UNROLL
#define F_ADD(a, b) ((a) + (b))
#define F_SUB(a, b) ((a) - (b))
#define F_MUL(a, b) ((a) * (b))
#define IS_FINITE(v) std::isfinite(v)
#define FOR_ITEMS(t, n) for (int t = 0; t < (n); ++t)
#define BARRIER() ((void)0)
#define FOR_WARP_ITEMS(w, t, tiles, n)   \
  for (int w = 0; w < (tiles); ++w)      \
    for (int t = 0; t < (n); ++t)
#define WARP_SYNC() ((void)0)
#endif

// The parameter block (search.py SelectBatchParams mirrors it).
struct SelectParams {
  const float* score;          // [n] the grid, move block then leadership
  const int* partition;        // [n] ...
  const int* src_broker;
  const int* dst_broker;
  const int* topic;
  const int* replica_delta;
  const int* leader_delta;
  const float* load_delta;     // [n][4]
  const int* src_slot;
  const int* dst_slot;
  const uint8_t* valid;
  const float* leader_load;    // [P][4]
  int r0, c0, r1, c1, extra_last_col, k, num_partitions, num_brokers;
  int* ints;                   // [9][k]: idx, then the record's fields
  float* floats;               // load [k][4], pot, lbi, pre_load, pre
  uint8_t* flags;              // [3][k]: part_ok, has_earlier, valid
  void* scratch;               // keys [nr] u64, then records [nr][16]
  long long scratch_bytes;
};

namespace {

typedef unsigned long long u64;

constexpr int kMaxRows = 4096;
constexpr int kMaxK = 2048;
constexpr int kMaxBrokers = 1 << 20;
constexpr int kR = 4;
constexpr int kNwIn = 1;
constexpr int kNwOut = 2;
constexpr int kVals = 8;        // load[4], rep, lead, pot, lbi
constexpr int kBlock = 16;      // XLA:CPU's cumsum block
constexpr int kCtas = 4;        // the cluster; one grouping each
constexpr int kMaxCols = 8;     // value columns of the widest grouping
constexpr int kThreads = 1024;
constexpr int kSmemLimit = 232448;  // 227 KB a block on sm_90
constexpr int kRowBits = 11;        // k <= 2,048; (broker + 1) << 11 fits
                                    // 32 bits below 2**20 brokers
constexpr u64 kRowMask = (1ull << kRowBits) - 1;
constexpr int kTopicShift = kRowBits;
constexpr int kBrokerShift = kRowBits + 32;
constexpr int kEmpty = INT_MIN;     // a free table slot (ids are >= -1)
constexpr uint8_t kOk = 1;          // scores above 1e-9
constexpr uint8_t kCons = 2;        // considered (ok and first of its partition)

// A reduced row's record in scratch: 16 words, the fields at its pick;
// its first nine are the int output block's rows.
enum Rec { kRecIdx, kRecSrc, kRecDst, kRecRep, kRecLead, kRecPart,
           kRecTopic, kRecSrcSlot, kRecDstSlot, kRecValid, kRecLoad,
           kRecPot = kRecLoad + kR, kRecLbi, kRecWords };
static_assert(kRecWords == 16, "a record is 64 bytes");
constexpr int kIntOuts = kRecValid;
// The flag output block's rows.
enum FlagOut { kPartOk, kHasEarlier, kValid };
// floats: load [k][4] at 0, pot at 4k, lbi at 5k, pre_load [2][k][4] at
// 6k, pre_scalars [9][k] (candidates.PRE_FIELDS order) at 14k; 23k all.
// Groupings, one a CTA by rank: (dst, topic), (src, topic), src, dst.
enum Grouping { kDstTopic, kSrcTopic, kSrc, kDst };

CC_BOTH int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

CC_BOTH int imax(int a, int b) { return a > b ? a : b; }
CC_BOTH int imin(int a, int b) { return a < b ? a : b; }
CC_BOTH int align16(int n) { return (n + 15) & ~15; }

// Byte offsets of a CTA's shared-memory regions (the same in every CTA).
struct Layout {
  int nr, k, kp, run, cap_p, cap_b, nb0, nb1, nlev, stride;
  int t, top, v, i, f, x, u, total;
};

CC_BOTH Layout make_layout(int nr, int k) {
  Layout L;
  L.nr = nr;
  L.k = k;
  L.kp = next_pow2(k);
  L.run = next_pow2(imax(kCtas, nr)) / kCtas;  // keys a CTA sorts first
  L.cap_p = 2 * L.kp;
  L.cap_b = 4 * L.kp;
  L.nb0 = (k + kBlock - 1) / kBlock;
  L.nb1 = (L.nb0 + kBlock - 1) / kBlock;
  L.nlev = k <= kBlock ? 0 : (L.nb0 <= kBlock ? 1 : 2);
  L.stride = kBlock * L.nb0;
  int off = 0;
  L.t = off;
  L.top = off + align16(8 * L.run);
  off = L.top + align16(8 * k);
  L.v = off;
  off += align16(4 * kVals * k);
  L.i = off;
  off += align16(4 * 4 * k);
  L.f = off;
  off += align16(k);
  L.x = off;
  off += align16(imax(imax(8 * L.cap_p, 8 * L.cap_b),
                      imax(8 * L.run, 4 * kMaxCols * L.stride)));
  L.u = off;
  off += align16(4 * kMaxCols * (L.nb0 + L.nb1));
  L.total = off;
  return L;
}

// Scratch bytes for nr rows: keys, then 64-byte records.
CC_BOTH long long scratch_need(int nr) {
  return align16(8 * nr) + 64ll * nr;
}

CC_BOTH bool params_ok(const SelectParams* q) {
  const int nr = q->r0 + q->r1;
  return q->r0 >= 0 && q->r1 >= 0 && (q->r0 == 0 || q->c0 >= 1) &&
         (q->r1 == 0 || q->c1 >= 1) && nr <= kMaxRows && q->k >= 1 &&
         q->k <= kMaxK && q->k <= nr && q->num_brokers >= 0 &&
         q->num_brokers < kMaxBrokers && q->num_partitions >= 1 &&
         q->scratch_bytes >= scratch_need(nr) &&
         make_layout(nr, q->k).total <= kSmemLimit;
}

// --- keys: an f32 value and a row packed so that the unsigned order is
// (value descending in IEEE total order, then row ascending): lax.top_k's.
CC_HD uint32_t f2u(float v) {
#ifdef __CUDACC__
  return __float_as_uint(v);
#else
  uint32_t b;
  std::memcpy(&b, &v, 4);
  return b;
#endif
}

CC_HD float u2f(uint32_t b) {
#ifdef __CUDACC__
  return __uint_as_float(b);
#else
  float v;
  std::memcpy(&v, &b, 4);
  return v;
#endif
}

CC_HD u64 pack_key(float v, uint32_t row) {
  const uint32_t b = f2u(v);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<u64>(o) << 32) | static_cast<u64>(0xFFFFFFFFu - row);
}

CC_HD uint32_t key_row(u64 key) {
  return 0xFFFFFFFFu - static_cast<uint32_t>(key & 0xFFFFFFFFull);
}

CC_HD float key_value(u64 key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return u2f((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// --- warp reductions (identity on the host, where one lane does it all)
CC_HD bool warp_any(bool x) {
#ifdef __CUDACC__
  return __any_sync(0xffffffffu, x);
#else
  return x;
#endif
}

CC_HD float warp_max(float x) {
#ifdef __CUDACC__
CC_UNROLL
  for (int d = 16; d > 0; d >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, d));
#endif
  return x;
}

CC_HD u64 warp_min(u64 x) {
#ifdef __CUDACC__
CC_UNROLL
  for (int d = 16; d > 0; d >>= 1) {
    const u64 o = __shfl_xor_sync(0xffffffffu, x, d);
    x = o < x ? o : x;
  }
#endif
  return x;
}

// --- tables keyed by an int id: open addressing, linear probing; the
// value is the least rank inserted under the key.
CC_HD int atomic_cas(int* p, int cmp, int val) {
#ifdef __CUDACC__
  return atomicCAS(p, cmp, val);
#else
  const int old = *p;
  if (old == cmp) *p = val;
  return old;
#endif
}

CC_HD void atomic_min(int* p, int val) {
#ifdef __CUDACC__
  atomicMin(p, val);
#else
  if (val < *p) *p = val;
#endif
}

CC_HD int slot_of(int key, int cap) {
  uint32_t h = static_cast<uint32_t>(key) * 0x9E3779B1u;
  h ^= h >> 15;
  return static_cast<int>(h & static_cast<uint32_t>(cap - 1));
}

CC_HD void table_min(int* keys, int* vals, int cap, int key, int rank) {
  for (int s = slot_of(key, cap);; s = (s + 1) & (cap - 1)) {
    const int prev = atomic_cas(&keys[s], kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomic_min(&vals[s], rank);
      return;
    }
  }
}

CC_HD int table_get(const int* keys, const int* vals, int cap, int key) {
  for (int s = slot_of(key, cap);; s = (s + 1) & (cap - 1)) {
    const int kk = keys[s];
    if (kk == key) return vals[s];
    if (kk == kEmpty) return INT_MAX;
  }
}

CC_HD void table_clear(int* keys, int* vals, int cap) {
  FOR_ITEMS(s, cap) {
    keys[s] = kEmpty;
    vals[s] = INT_MAX;
  }
}

// --- a. the per-source reduce of one row, over ``lanes`` lanes: its key
// and the record of the fields at its pick (lane w < 16 fetches word w).
CC_HD int record_word(const SelectParams& q, int c, int w) {
  switch (w) {
    case kRecIdx: return c;
    case kRecSrc: return q.src_broker[c];
    case kRecDst: return q.dst_broker[c];
    case kRecRep: return q.replica_delta[c];
    case kRecLead: return q.leader_delta[c];
    case kRecPart: return q.partition[c];
    case kRecTopic: return q.topic[c];
    case kRecSrcSlot: return q.src_slot[c];
    case kRecDstSlot: return q.dst_slot[c];
    case kRecValid: return q.valid[c];
    case kRecPot:
    case kRecLbi: {
      // leader_load[partition] as the twin indexes it (negative ids wrap)
      const int p = q.partition[c];
      const size_t pp = static_cast<size_t>(p < 0 ? p + q.num_partitions : p);
      const bool moves = (w == kRecPot ? q.replica_delta[c]
                                       : q.leader_delta[c]) > 0;
      return static_cast<int>(f2u(
          moves ? q.leader_load[pp * kR + (w == kRecPot ? kNwOut : kNwIn)]
                : 0.0f));
    }
    default:
      return static_cast<int>(f2u(
          q.load_delta[static_cast<size_t>(c) * kR + (w - kRecLoad)]));
  }
}

CC_HD void reduce_row(const SelectParams& q, int r, int lane, int lanes,
                      u64* keys, int* records) {
  const bool first_block = r < q.r0;
  const int local = first_block ? r : r - q.r0;
  const int cols = first_block ? q.c0 : q.c1;
  const int offset = first_block ? local * q.c0 : q.r0 * q.c0 + local * q.c1;
  const float* row = q.score + offset;
  float row_max = u2f(0xff800000u);  // -inf
  bool any_finite = false;
  for (int c = lane; c < cols; c += lanes) {
    const float v = row[c];
    if (IS_FINITE(v)) {
      any_finite = true;
      row_max = fmaxf(row_max, v);
    }
  }
  any_finite = warp_any(any_finite);
  row_max = warp_max(row_max);
  int best = 0;
  if (any_finite) {
    const float window = F_MUL(0.01f, fmaxf(fabsf(row_max), 1e-6f));
    const float thr = F_SUB(row_max, window);
    const int rot_cols = (q.extra_last_col && first_block) ? cols - 1 : cols;
    const int rc = rot_cols > 1 ? rot_cols : 1;
    // (rotation rank, column): unique per column, so the min is the pick
    u64 best_key = ~0ull;
    for (int c = lane; c < cols; c += lanes) {
      const float v = row[c];
      if (!(IS_FINITE(v) && v >= thr)) continue;
      const int rot = c < rot_cols ? (((c - local) % rc) + rc) % rc : cols;
      const u64 key = (static_cast<u64>(rot) << 32) | static_cast<uint32_t>(c);
      best_key = key < best_key ? key : best_key;
    }
    best_key = warp_min(best_key);
    best = static_cast<int>(best_key & 0xffffffffull);
  }
  if (lane == 0) keys[r] = pack_key(row[best], static_cast<uint32_t>(r));
  for (int w = lane; w < kRecWords; w += lanes)
    records[r * kRecWords + w] = record_word(q, offset + best, w);
}

// --- b. the cluster's phases
// One compare of a bitonic stage: element i (bit ``size`` of its index
// picks the direction) against i + stride.
template <typename K>
CC_HD void compare_swap(K* a, int i, int stride, int size, bool descending) {
  const K x = a[i], y = a[i + stride];
  const bool up = ((i & size) == 0) != descending;
  if (up ? x > y : x < y) {
    a[i] = y;
    a[i + stride] = x;
  }
}

// Bitonic sort of n (a power of two) keys in shared memory, the network
// stage by stage; pair t compares element 2t - (t mod stride). A warp owns
// a tile of 32 keys a lane's share (at most n): the stages of a size whose
// stride stays inside a tile run in the warp between __syncwarp()s, the
// others across the CTA between barriers. The host's sort; on the card
// the sort of fewer than 64 keys.
template <typename K>
CC_HD void sort_stages(K* s, int n, bool descending) {
  const int half = n >> 1;
  const int tile = imin(n, 32 * imax(1, n / kThreads));
  for (int size = 2; size <= n; size <<= 1) {
    int stride = size >> 1;
    for (; stride >= tile; stride >>= 1) {
      FOR_ITEMS(t, half)
        compare_swap(s, 2 * t - (t & (stride - 1)), stride, size, descending);
      BARRIER();
    }
    for (; stride > 0; stride >>= 1) {
      FOR_WARP_ITEMS(w, t, n / tile, tile >> 1)
        compare_swap(s, w * tile + 2 * t - (t & (stride - 1)), stride, size,
                     descending);
      WARP_SYNC();
    }
    BARRIER();
  }
}

#ifdef __CUDACC__
// The same network with E consecutive keys a thread held in registers:
// strides below E inside the thread, below 32·E by __shfl_xor_sync, the
// rest through shared memory (``s`` and ``spare`` in turn, one barrier a
// stage). Each key keeps the min or the max of itself and its partner.
template <typename K, int E>
__device__ __forceinline__ void sort_registers(K* s, K* spare, int n,
                                               bool descending) {
  const int t = threadIdx.x;
  const bool active = t * E < n;
  K x[E];
  if (active) {
    CC_UNROLL
    for (int e = 0; e < E; ++e) x[e] = s[t * E + e];
  }
  bool flip = false;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32 * E) {
        K* b = flip ? spare : s;
        flip = !flip;
        if (active) {
          CC_UNROLL
          for (int e = 0; e < E; ++e) b[t * E + e] = x[e];
        }
        __syncthreads();
        if (active) {
          CC_UNROLL
          for (int e = 0; e < E; ++e) {
            const int i = t * E + e;
            const K y = b[i ^ stride];
            const bool keep_min =
                ((i & stride) == 0) == (((i & size) == 0) != descending);
            x[e] = keep_min ? (y < x[e] ? y : x[e]) : (y > x[e] ? y : x[e]);
          }
        }
      } else if (stride >= E) {
        if (active) {
          CC_UNROLL
          for (int e = 0; e < E; ++e) {
            const int i = t * E + e;
            const K y = __shfl_xor_sync(0xffffffffu, x[e], stride / E);
            const bool keep_min =
                ((i & stride) == 0) == (((i & size) == 0) != descending);
            x[e] = keep_min ? (y < x[e] ? y : x[e]) : (y > x[e] ? y : x[e]);
          }
        }
      } else if (active && E == 2) {  // stride 1: the thread's own pair
        const bool up = ((t * E & size) == 0) != descending;
        if (up ? x[0] > x[E - 1] : x[0] < x[E - 1]) {
          const K y = x[0];
          x[0] = x[E - 1];
          x[E - 1] = y;
        }
      }
    }
  }
  __syncthreads();
  if (active) {
    CC_UNROLL
    for (int e = 0; e < E; ++e) s[t * E + e] = x[e];
  }
  __syncthreads();
}
#endif

// Sort n (a power of two) keys in shared memory; ``spare`` holds n more.
template <typename K>
CC_HD void sort_keys(K* s, K* spare, int n, bool descending) {
#ifdef __CUDACC__
  if (n >= 64 && n <= kThreads)
    sort_registers<K, 1>(s, spare, n, descending);
  else if (n > kThreads)
    sort_registers<K, 2>(s, spare, n, descending);
  else
#endif
    sort_stages(s, n, descending);
  (void)spare;
}

// Grouping g's value columns: how many, and column j's column of the row
// values and its pre_scalars field (-1: a pre_load column).
CC_HD int columns_of(int g) {
  return g == kDst ? 8 : g == kSrc ? 6 : g == kSrcTopic ? 2 : 1;
}

CC_HD void column_of(int g, int j, int& col, int& field) {
  if (g == kDst) {  // load[4], count, leaders, pot, lbi
    col = j;
    field = j < kR ? -1 : (j == 4 ? 1 : j == 5 ? 3 : j + 1);
  } else if (g == kSrc) {  // load[4], count, leaders
    col = j;
    field = j < kR ? -1 : (j == kR ? 0 : 2);
  } else if (g == kSrcTopic) {  // count, leaders
    col = kR + j;
    field = j == 0 ? 4 : 6;
  } else {  // count
    col = kR;
    field = 5;
  }
}

template <typename K>
CC_HD int lower_bound(const K* a, int hi, K head) {
  int lo = 0;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < head) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Grouping g's order: its k_pad keys (broker + 1, then the topic for the
// topic groupings, then the row; 32 bits suffice without the topic)
// sorted ascending; per sorted position its row, per row its position
// and its group's first position.
template <typename K>
CC_HD void group_order(const Layout& L, int g, K* keys, const int* rsrc,
                       const int* rdst, const int* rtopic, uint16_t* perm,
                       uint16_t* pos_of, uint16_t* start_of) {
  const int shift = sizeof(K) == 8 ? kBrokerShift : kRowBits;
  FOR_ITEMS(i, L.kp) {
    K key = ~K(0);
    if (i < L.k) {
      const int b = (g == kSrc || g == kSrcTopic) ? rsrc[i] : rdst[i];
      u64 full = (static_cast<u64>(static_cast<uint32_t>(b + 1)) << shift) |
                 static_cast<u64>(i);
      if (sizeof(K) == 8)
        full |= static_cast<u64>(static_cast<uint32_t>(rtopic[i]) ^
                                 0x80000000u) << kTopicShift;
      key = static_cast<K>(full);
    }
    keys[i] = key;
  }
  BARRIER();
  sort_keys(keys, keys + L.kp, L.kp, false);
  const K mask = static_cast<K>(kRowMask);
  FOR_ITEMS(pos, L.k) {
    const K key = keys[pos];
    const int row = static_cast<int>(key & mask);
    perm[pos] = static_cast<uint16_t>(row);
    pos_of[row] = static_cast<uint16_t>(pos);
    start_of[row] = static_cast<uint16_t>(lower_bound(keys, pos,
                                                      K(key & ~mask)));
  }
  BARRIER();
}

// One CTA's view: its rank and every CTA's shared memory (its own among
// them; the others through distributed shared memory on the card).
struct Cta {
  int rank;
  unsigned char* own;           // smem[rank]
  unsigned char* smem[kCtas];
};

// Phase 1: sort this CTA's quarter of the reduced keys (pads sort last).
CC_HD void phase_sort_run(const Layout& L, const Cta& c, const u64* keys) {
  u64* run = reinterpret_cast<u64*>(c.own + L.t);
  FOR_ITEMS(t, L.run) {
    const int r = c.rank * L.run + t;
    run[t] = r < L.nr ? keys[r] : 0ull;
  }
  BARRIER();
  sort_keys(run, reinterpret_cast<u64*>(c.own + L.x), L.run, true);
}

// Phase 2: each key's rank among all; the top k into every CTA's array.
// The three searches of the other quarters step together, so their
// remote loads overlap.
CC_HD void phase_rank(const Layout& L, const Cta& c) {
  const u64* run = reinterpret_cast<const u64*>(c.own + L.t);
  FOR_ITEMS(t, L.run) {
    const u64 key = run[t];
    if (key == 0ull) continue;  // a pad
    const u64* other[kCtas];
    int lo[kCtas], hi[kCtas];
    CC_UNROLL
    for (int o = 0; o < kCtas; ++o) {
      other[o] = reinterpret_cast<const u64*>(c.smem[o] + L.t);
      lo[o] = 0;
      hi[o] = o == c.rank ? 0 : L.run;  // its own quarter: position t
    }
    // in each other quarter, the first key below ``key``: the count of
    // greater keys
    for (int step = L.run; step > 0; step >>= 1) {
      CC_UNROLL
      for (int o = 0; o < kCtas; ++o) {
        if (lo[o] < hi[o]) {
          const int mid = (lo[o] + hi[o]) >> 1;
          if (other[o][mid] > key) lo[o] = mid + 1;
          else hi[o] = mid;
        }
      }
    }
    int rank = t;
    CC_UNROLL
    for (int o = 0; o < kCtas; ++o) rank += lo[o];
    if (rank < L.k) {
      CC_UNROLL
      for (int o = 0; o < kCtas; ++o)
        reinterpret_cast<u64*>(c.smem[o] + L.top)[rank] = key;
    }
  }
}

// Phase 3: everything else, in this CTA's own shared memory.
CC_HD void phase_select(const SelectParams& q, const Layout& L, const Cta& c,
                        const int* records) {
  unsigned char* smem = c.own;
  const int k = L.k;
  const int g = c.rank;  // this CTA's grouping
  const u64* top = reinterpret_cast<const u64*>(smem + L.top);
  uint16_t* perm = reinterpret_cast<uint16_t*>(smem + L.t);
  float* vals = reinterpret_cast<float*>(smem + L.v);
  int* rsrc = reinterpret_cast<int*>(smem + L.i);
  int* rdst = rsrc + k;
  int* rtopic = rsrc + 2 * k;
  int* rpart = rsrc + 3 * k;
  uint16_t* pos_of = reinterpret_cast<uint16_t*>(smem + L.i);
  uint16_t* start_of = pos_of + k;
  uint8_t* rflag = smem + L.f;
  int* tkey = reinterpret_cast<int*>(smem + L.x);
  float* buf = reinterpret_cast<float*>(smem + L.x);
  float* lev1 = reinterpret_cast<float*>(smem + L.u);
  float* lev2 = lev1 + kMaxCols * L.nb0;
  const bool writer = c.rank == 0;

  // 3. the picked records; CTA 0 writes the rows' output fields
  FOR_ITEMS(i, k) {
    const u64 key = top[i];
    int w[kRecWords];
#ifdef __CUDACC__
    const int4* rec = reinterpret_cast<const int4*>(
        records + static_cast<size_t>(key_row(key)) * kRecWords);
CC_UNROLL
    for (int h = 0; h < kRecWords / 4; ++h) {
      const int4 x = rec[h];
      w[4 * h] = x.x;
      w[4 * h + 1] = x.y;
      w[4 * h + 2] = x.z;
      w[4 * h + 3] = x.w;
    }
#else
    std::memcpy(w, records + static_cast<size_t>(key_row(key)) * kRecWords,
                sizeof(w));
#endif
    float* v = vals + i * kVals;
CC_UNROLL
    for (int r = 0; r < kR; ++r)
      v[r] = u2f(static_cast<uint32_t>(w[kRecLoad + r]));
    v[4] = static_cast<float>(w[kRecRep]);
    v[5] = static_cast<float>(w[kRecLead]);
    v[6] = u2f(static_cast<uint32_t>(w[kRecPot]));
    v[7] = u2f(static_cast<uint32_t>(w[kRecLbi]));
    rsrc[i] = w[kRecSrc];
    rdst[i] = w[kRecDst];
    rtopic[i] = w[kRecTopic];
    rpart[i] = w[kRecPart];
    rflag[i] = key_value(key) > 1e-9f ? kOk : 0;
    if (writer) {
CC_UNROLL
      for (int o = 0; o < kIntOuts; ++o) q.ints[o * k + i] = w[o];
CC_UNROLL
      for (int r = 0; r < kR; ++r) q.floats[i * kR + r] = v[r];
      q.floats[4 * k + i] = v[6];
      q.floats[5 * k + i] = v[7];
      q.flags[kValid * k + i] = static_cast<uint8_t>(w[kRecValid]);
    }
  }
  // 4. partition dedupe by first scoring rank (every CTA needs it)
  int* tval = tkey + L.cap_p;
  table_clear(tkey, tval, L.cap_p);
  BARRIER();
  FOR_ITEMS(i, k) {
    if (rflag[i] & kOk) table_min(tkey, tval, L.cap_p, rpart[i], i);
  }
  BARRIER();
  FOR_ITEMS(i, k) {
    const bool cons = (rflag[i] & kOk) &&
                      table_get(tkey, tval, L.cap_p, rpart[i]) == i;
    if (cons) rflag[i] |= kCons;
    if (writer) q.flags[kPartOk * k + i] = cons ? 1 : 0;
  }
  BARRIER();
  // 5. has_earlier: an earlier considered row touches either broker
  if (g == kSrcTopic) {
    tval = tkey + L.cap_b;
    table_clear(tkey, tval, L.cap_b);
    BARRIER();
    FOR_ITEMS(i, k) {
      if (rflag[i] & kCons) {
        table_min(tkey, tval, L.cap_b, rsrc[i], i);
        table_min(tkey, tval, L.cap_b, rdst[i], i);
      }
    }
    BARRIER();
    FOR_ITEMS(i, k) {
      const int first = imin(table_get(tkey, tval, L.cap_b, rsrc[i]),
                             table_get(tkey, tval, L.cap_b, rdst[i]));
      q.flags[kHasEarlier * k + i] = first < i ? 1 : 0;
    }
    BARRIER();
  }
  // 6. this grouping's order (32-bit keys without the topic)
  if (g == kSrc || g == kDst)
    group_order(L, g, reinterpret_cast<uint32_t*>(smem + L.x), rsrc, rdst,
                rtopic, perm, pos_of, start_of);
  else
    group_order(L, g, reinterpret_cast<u64*>(smem + L.x), rsrc, rdst,
                rtopic, perm, pos_of, start_of);
  // 7. the blocked scans of this grouping's columns
  const int J = columns_of(g);
  const int nb0 = L.nb0, nb1 = L.nb1, stride = L.stride;
  // level 0: each 16-row block of each column, in sorted order
  FOR_ITEMS(t, J * nb0) {
    const int j = t / nb0;
    const int b = t - j * nb0;
    int col, field;
    column_of(g, j, col, field);
    float* out = buf + j * stride;
    const int lo = b * kBlock, hi = imin(k, lo + kBlock);
    float acc = 0.0f;
    for (int i = lo; i < hi; ++i) {
      const int row = perm[i];
      const float x = F_MUL(vals[row * kVals + col],
                            (rflag[row] & kCons) ? 1.0f : 0.0f);
      acc = i == lo ? x : F_ADD(acc, x);
      out[(i & (kBlock - 1)) * nb0 + (i >> 4)] = acc;
    }
    if (L.nlev > 0) lev1[j * nb0 + b] = acc;
  }
  BARRIER();
  // level 1: the block totals, blocked again
  if (L.nlev > 0) {
    FOR_ITEMS(t, J * nb1) {
      const int j = t / nb1;
      const int b = t - j * nb1;
      float* a = lev1 + j * nb0;
      const int lo = b * kBlock, hi = imin(nb0, lo + kBlock);
      float acc = a[lo];
      for (int i = lo + 1; i < hi; ++i) {
        acc = F_ADD(acc, a[i]);
        a[i] = acc;
      }
      if (L.nlev > 1) lev2[j * nb1 + b] = acc;
    }
    BARRIER();
  }
  // level 2 (at most 8 totals for k <= 2,048), then its offsets into 1
  if (L.nlev > 1) {
    FOR_ITEMS(j, J) {
      float* a = lev2 + j * nb1;
      float acc = a[0];
      for (int i = 1; i < nb1; ++i) {
        acc = F_ADD(acc, a[i]);
        a[i] = acc;
      }
    }
    BARRIER();
    FOR_ITEMS(t, J * nb0) {
      const int j = t / nb0;
      const int b = (t - j * nb0) >> 4;
      lev1[t] = F_ADD(lev1[t], b > 0 ? lev2[j * nb1 + b - 1] : 0.0f);
    }
    BARRIER();
  }
  // each row's difference of exclusive prefixes, in row order
  FOR_ITEMS(t, J * k) {
    const int j = t / k;
    const int row = t - j * k;
    int col, field;
    column_of(g, j, col, field);
    const float* lv0 = buf + j * stride;
    const float* lv1 = lev1 + j * nb0;
    float ex[2];
    const int at[2] = {pos_of[row] - 1, start_of[row] - 1};
CC_UNROLL
    for (int e = 0; e < 2; ++e) {
      const int p = at[e];
      if (p < 0) {
        ex[e] = 0.0f;
      } else if (L.nlev == 0) {
        ex[e] = lv0[p];
      } else {
        const int b = p >> 4;
        ex[e] = F_ADD(lv0[(p & (kBlock - 1)) * nb0 + b],
                      b > 0 ? lv1[b - 1] : 0.0f);
      }
    }
    const float d = F_SUB(ex[0], ex[1]);
    if (field < 0)
      q.floats[6 * k + (g == kSrc ? 0 : kR * k) + row * kR + col] = d;
    else
      q.floats[14 * k + field * k + row] = d;
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(256) reduce_rows_kernel(
    const SelectParams q, u64* keys, int* records) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= q.r0 + q.r1) return;
  reduce_row(q, r, threadIdx.x & 31, 32, keys, records);
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 1)
    select_kernel(const SelectParams q, const Layout L, const u64* keys,
                  const int* records) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  Cta c;
  c.rank = static_cast<int>(cluster.block_rank());
  c.own = smem;
  CC_UNROLL
  for (int o = 0; o < kCtas; ++o)
    c.smem[o] = static_cast<unsigned char*>(cluster.map_shared_rank(
        static_cast<void*>(smem), o));
  phase_sort_run(L, c, keys);
  cluster.sync();
  phase_rank(L, c);
  cluster.sync();
  phase_select(q, L, c, records);
}
#endif

}  // namespace

extern "C" long long cc_select_batch_params_bytes() {
  return static_cast<long long>(sizeof(SelectParams));
}

// Bytes of global scratch for nr reduced rows.
extern "C" long long cc_select_batch_scratch_bytes(int nr) {
  return scratch_need(nr);
}

// Bytes of shared memory a CTA of the select kernel takes for nr rows
// and m = k.
extern "C" int cc_select_batch_smem_bytes(int nr, int k) {
  return make_layout(nr, k).total;
}

#ifdef __CUDACC__
// One call: the reduce, then the select cluster, on ``stream``.
extern "C" int cc_select_batch(const SelectParams* q, void* stream_) {
  if (!params_ok(q)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int nr = q->r0 + q->r1;
  const Layout L = make_layout(nr, q->k);
  static bool sized = false;  // once per process
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  u64* keys = static_cast<u64*>(q->scratch);
  int* records = reinterpret_cast<int*>(static_cast<char*>(q->scratch) +
                                        align16(8 * nr));
  constexpr int kWarps = 8;
  reduce_rows_kernel<<<(nr + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
      *q, keys, records);
  select_kernel<<<kCtas, kThreads, L.total, stream>>>(*q, L, keys, records);
  return static_cast<int>(cudaGetLastError());
}
#else
// The same phases on the host, the four CTAs in turn between the cluster
// barriers (the CPU tests' build).
extern "C" int cc_select_batch_host(const SelectParams* q) {
  if (!params_ok(q)) return 1;
  const int nr = q->r0 + q->r1;
  const Layout L = make_layout(nr, q->k);
  std::vector<u64> keys(nr);
  std::vector<int> records(static_cast<size_t>(nr) * kRecWords);
  for (int r = 0; r < nr; ++r)
    reduce_row(*q, r, 0, 1, keys.data(), records.data());
  const size_t words = static_cast<size_t>(L.total + 7) / 8;
  std::vector<u64> mem(kCtas * words);
  Cta ctas[kCtas];
  for (int o = 0; o < kCtas; ++o) {
    ctas[o].rank = o;
    ctas[o].own = reinterpret_cast<unsigned char*>(mem.data() + o * words);
    for (int p = 0; p < kCtas; ++p)
      ctas[o].smem[p] = reinterpret_cast<unsigned char*>(mem.data() + p * words);
  }
  for (const Cta& c : ctas) phase_sort_run(L, c, keys.data());
  for (const Cta& c : ctas) phase_rank(L, c);
  for (const Cta& c : ctas) phase_select(*q, L, c, records.data());
  return 0;
}
#endif
