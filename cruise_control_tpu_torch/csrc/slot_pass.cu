// K7 slot_weights: the active goal's per-slot replica weight, the offline
// mask, its override and the offline count per broker, in one pass over
// the [P, S] slots.
//
// Replaces (JAX) cruise_control_tpu/analyzer/chain.py:146-155, the weight
// branch of _switch_scores (every goal's replica_weight), and
// chain.py:234-240: offline_replicas, the per-broker segment sum of the
// offline mask (the self-healing source bonus) and the override
// where(off & ~lead_only, 1e30, weight).
//
// Design. A CTA takes a tile of kTile consecutive partitions, so its slots
// [p0*S, (p0+n)*S) are one contiguous run: it copies the run's assignment
// into shared memory with 16-byte vector loads while each thread reads its
// partition's leader slot, mask and, for the families that read (nearly)
// every partition's rows, its leader and follower load rows as one float4
// each (16 B, aligned); one thread a partition then computes the
// partition's S slots from there (whether each replica exists, leads,
// sits on a DEAD broker, and the goal family's weight, the table below),
// stages weight (f32) and off (u8) in shared memory, and the CTA writes
// both out as 16-byte vector stores. The other families read a row only
// where a slot's weight needs it (the rack duplicates, the replicas off
// their set). partition_weights is a template on S (1, 2, 3 and 4, and a
// generic instance up to kMaxS), so the slot arrays are fully unrolled and
// stay in registers (no stack frame). The [B] gathers (alive, racks, the
// descriptor's arrays) go through the read-only cache. The offline flag is
// raised once a CTA (__syncthreads_or, one store). With override_offline,
// each offline slot adds one to its broker's int32 count with a
// warp-aggregated atomic (__match_any_sync over the offline lanes of a
// slot): integer counts are exact in any order, and the round adds them to
// an f32 score exactly (counts < 2**24), as the reference adds its segment
// sum of f32 ones. The count takes any broker count (no [B] table in
// shared memory). Families whose weight ranks by a peak (the largest
// per-slot load plus one) first run a max pass over every slot in the
// same tiles: an atomicMax of the values' total-order bits a CTA, exact in
// any order; the weight pass reads the peak once a CTA.
//
// One memset a call zeroes the call's scratch words (the flag, the peak
// bits, the count); a call is that memset and the weight pass (2 device
// ops), plus the max pass for the peak families (3).
//
// Rounding is the plain twin's (slot_pass.py, the goals' replica_weight):
// every f32 operation is one __fadd_rn / __fmul_rn, never contracted;
// replica_load_total sums a row's four resources in index order from 0.0,
// as the twin's xla_sum does, and multiplies by the exists flag (1.0 or
// 0.0), so an empty slot of -total is -0.0 where the twin's is.
//
// The goal reaches the kernel as one descriptor (family, resource, ival,
// up to six device arrays) inside the parameter block, passed by value as
// a __grid_constant__, so captured CUDA graphs replay it unchanged.
//
// Bound on this card: bytes, which depend on the family — the
// assignment, leader slot and partition mask read once, weight and off
// written once, plus the load rows, topic, racks and arrays the family
// reads (the load families every existing slot's row; the rack-duplicate
// family only its duplicates' rows; chip_smoke.py's k7_cost counts them
// from the data): ~0.02 ms at 7k brokers / 1M partitions for the load-total
// families, ~0.011 ms for the rack-duplicate family.
//
// The file also compiles as host C++ (without __CUDACC__): the same
// templated partition function, run tile by tile through staged buffers on
// the CPU, for checking the arithmetic off the card.
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CC_HD __device__ __forceinline__
#define CC_BOTH __host__ __device__ __forceinline__
#define CC_MEMBER __device__ __forceinline__
#define CC_UNROLL _Pragma("unroll")
#define LDG(ptr) __ldg(ptr)
#define F_ADD(a, b) __fadd_rn((a), (b))
#define F_SUB(a, b) __fsub_rn((a), (b))
#define F_MUL(a, b) __fmul_rn((a), (b))
#else
#include <vector>
#define CC_HD static inline
#define CC_BOTH static inline
#define CC_MEMBER inline
#define CC_UNROLL
#define LDG(ptr) (*(ptr))
#define F_ADD(a, b) ((a) + (b))
#define F_SUB(a, b) ((a) - (b))
#define F_MUL(a, b) ((a) * (b))
#endif

// The parameter block, passed by value (named outside the anonymous
// namespace: the exported entry points take it).
struct WeightParams {
  int32_t P, S, B, T;
  // override_offline: the self-healing terms of a move round (every
  // offline slot's weight 1e30, and the offline count per broker).
  int32_t family, resource, ival, override_offline;
  const int32_t* assignment;    // [P, S]
  const int32_t* leader_slot;   // [P]
  const float* leader_load;     // [P, 4]
  const float* follower_load;   // [P, 4]
  const int32_t* topic;         // [P]
  const uint8_t* pmask;         // [P]
  const int32_t* rack;          // [B]
  const uint8_t* alive;         // [B]
  const void* p[6];
  float* weight;                // [P, S] out
  uint8_t* off;                 // [P, S] out
  // [kScratchHead + B] int32, zeroed by the call: byte 0 of word 0 is the
  // any-offline flag, word kPeakWord the peak's total-order bits, words
  // kScratchHead.. the offline count per broker (left zero without
  // override_offline).
  int32_t* scratch;
};

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;   // partitions a CTA, one a thread
constexpr int kMaxS = 16;
// The flag, the peak and the count lie on 128-byte lines of their own:
// the weight pass reads the peak once a CTA while other CTAs store the
// flag, and reads and stores of one line queue behind each other in L2
// (sharing a line cost the peak families ~0.03 ms a call at 7k/1M on an
// H100).
constexpr int kPeakWord = 32;
constexpr int kScratchHead = 64;

// Weight families (goals/base.py WeightFamily).
enum Family : int32_t {
  kLoadTotal = 1,          // replica_load_total
  kNegLoadTotal = 2,       // its negation; ival 1: leader slots only
  kLoadColumn = 3,         // replica_load_column(resource)
  kFitPriority = 4,        // p[0] max_gap (0-dim f32), p[1] room [B] f32
  kLeaderLoad = 5,         // leader_load[p, resource]; ival 1: leaders only
  kTopicDonor = 6,         // p[0] over-donor table [T, B] f32
  kRackDuplicate = 7,      // rack duplicates: 1 + load
  kPreferredLeader = 8,    // p[0] allowed_leadership [B] bool
  kBrokerSet = 9,          // p[0] set [B] i32, p[1] home [T] i32; ival sets
  kKafkaAssignerRack = 10  // p[0] at, p[1] under [B] bool, p[2] at_by_rack,
                           // p[3] under_by_rack [B] i32, p[4] rooms [2] i32,
                           // p[5] over [B] bool
};

// Slot arrays of the instance for S = kS (kS = 0: the generic instance,
// S <= kMaxS at run time).
template <int kS>
struct Slots {
  static constexpr int N = kS > 0 ? kS : kMaxS;
};

CC_HD float neg_inf() { return -INFINITY; }

CC_HD uint32_t float_bits(float v) {
#ifdef __CUDACC__
  return __float_as_uint(v);
#else
  uint32_t b;
  std::memcpy(&b, &v, sizeof b);
  return b;
#endif
}

CC_HD float bits_float(uint32_t b) {
#ifdef __CUDACC__
  return __uint_as_float(b);
#else
  float v;
  std::memcpy(&v, &b, sizeof v);
  return v;
#endif
}

// Unsigned order = IEEE total order of the f32 values.
CC_HD uint32_t ordered_bits(float v) {
  const uint32_t b = float_bits(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

CC_HD float unordered_float(uint32_t o) {
  return bits_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

CC_HD bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// One partition's [4] load row, read at most once, as one float4 where
// the array is 16-byte aligned.
struct Row {
  const float* base;
  long long p;
  bool have;
  float v[4];

  CC_MEMBER void fetch() {
    if (have) return;
    have = true;
#ifdef __CUDACC__
    if (aligned16(base)) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(base) + p);
      v[0] = r.x;
      v[1] = r.y;
      v[2] = r.z;
      v[3] = r.w;
      return;
    }
#endif
    CC_UNROLL
    for (int k = 0; k < 4; ++k) v[k] = base[4 * p + k];
  }
  // The row summed in index order from 0.0 (xla_sum).
  CC_MEMBER float total() {
    fetch();
    float acc = F_ADD(0.0f, v[0]);
    acc = F_ADD(acc, v[1]);
    acc = F_ADD(acc, v[2]);
    return F_ADD(acc, v[3]);
  }
  // Column k, by selects (a run-time index would put v in local memory).
  CC_MEMBER float column(int k) {
    fetch();
    return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
  }
};

// A partition's two rows.
struct Rows {
  Row lead, fol;
  CC_MEMBER Rows(const WeightParams& q, int p)
      : lead{q.leader_load, p, false, {0, 0, 0, 0}},
        fol{q.follower_load, p, false, {0, 0, 0, 0}} {}
  // The family's base load of a slot: replica_load_total or one resource
  // column of its row, times the exists flag.
  // (The two rows are named apart, never through a reference picked at
  // run time, which would put them in local memory.)
  CC_MEMBER float base(const WeightParams& q, bool is_lead, bool ex,
                       bool total) {
    float v;
    if (is_lead)
      v = total ? lead.total() : lead.column(q.resource);
    else
      v = total ? fol.total() : fol.column(q.resource);
    return F_MUL(v, ex ? 1.0f : 0.0f);
  }
};

CC_BOTH bool peak_family(int32_t f) {
  return f == kFitPriority || f == kKafkaAssignerRack;
}

// What a partition's slots read beside the assignment: its leader slot,
// mask, topic (the per-topic families), the leader load's column (the
// leader-load family) and the load rows of the families whose weights
// read (nearly) every partition's rows. Read before the tile's barrier,
// so these loads overlap the tile's copy; the rows of the other families
// (the rack and set families read only a few) are read where needed.
struct Part {
  int ls;
  bool pm;
  int topic;
  float lead_col;
  Rows rows;

  CC_MEMBER Part(const WeightParams& q, int p, bool peak_pass)
      : ls(q.leader_slot[p]), pm(q.pmask[p] != 0), topic(0),
        lead_col(0.0f), rows(q, p) {
    const int32_t f = q.family;
    if (f == kTopicDonor || f == kBrokerSet) topic = q.topic[p];
    if (f == kLeaderLoad) lead_col = q.leader_load[4LL * p + q.resource];
    if (peak_pass || f == kLoadTotal || f == kNegLoadTotal ||
        f == kLoadColumn || f == kFitPriority || f == kKafkaAssignerRack) {
      rows.lead.fetch();
      // Leader slots only: the follower row is never read.
      if (peak_pass || f != kNegLoadTotal || !q.ival) rows.fol.fetch();
    }
  }
};

// The largest base load over the partition's slots, as total-order bits
// (0 below every value); a[] holds the partition's slots.
template <int kS>
CC_HD uint32_t partition_peak_bits(const WeightParams& q, Part& part,
                                   const int* a) {
  constexpr int N = Slots<kS>::N;
  const int S = kS > 0 ? kS : q.S;
  const bool total = q.family == kKafkaAssignerRack;
  uint32_t best = 0u;
  CC_UNROLL
  for (int s = 0; s < N; ++s) {
    if (s >= S) break;
    const bool ex = a[s] >= 0 && part.pm;
    const uint32_t o =
        ordered_bits(part.rows.base(q, ex && part.ls == s, ex, total));
    best = o > best ? o : best;
  }
  return best;
}

struct Rooms {
  bool unused;                  // a rack with room the partition has not
  const uint8_t* mask;          // the brokers with room, [B]
  const int32_t* by_rack;       // their count per rack id, [B]
};

// KafkaAssignerEvenRackAwareGoal._rack_dest_feasibility for slot s.
CC_HD bool feasible(const Rooms& r, bool ex, bool sole, int a, int safe) {
  const int self_room = (a >= 0 && LDG(r.mask + a)) ? 1 : 0;
  const bool own_ok = (LDG(r.by_rack + safe) - self_room) > 0 && sole && ex;
  return (r.unused && ex) || own_ok;
}

CC_HD int clamp_broker(int b, int B) {
  return b < 0 ? 0 : (b > B - 1 ? B - 1 : b);
}

// The weights of a partition's slots a[0..S) into w[], with the offline
// override; returns the bit mask of its offline slots. peak and max_gap
// are the call's scalars (the peak families' peak, the fit priority's
// largest gap).
template <int kS>
CC_HD uint32_t partition_weights(const WeightParams& q, Part& part,
                                 const int* a, float* w, float peak,
                                 float max_gap) {
  constexpr int N = Slots<kS>::N;
  const int S = kS > 0 ? kS : q.S;
  const int B = q.B;
  const bool pm = part.pm;
  const int ls = part.ls;
  const int32_t f = q.family;
  int rk[N];     // rack of each existing slot (-1 - s when empty)
  bool dup[N];   // an earlier slot shares the rack (exists)
  CC_UNROLL
  for (int s = 0; s < N; ++s) {
    rk[s] = -1 - s;
    dup[s] = false;
  }
  if (f == kRackDuplicate || f == kKafkaAssignerRack) {
    CC_UNROLL
    for (int s = 0; s < N; ++s) {
      if (s >= S) break;
      if (a[s] >= 0) rk[s] = LDG(q.rack + a[s]);
    }
    CC_UNROLL
    for (int s = 0; s < N; ++s) {
      if (s >= S) break;
      bool d = false;
      CC_UNROLL
      for (int t = 0; t < N; ++t) {
        if (t >= s) break;
        d = d || rk[t] == rk[s];
      }
      dup[s] = d && a[s] >= 0 && pm;
    }
  }
  // Per-partition terms of the families that have them.
  int pref = S;
  int home = 0;
  Rooms at{false, nullptr, nullptr}, under{false, nullptr, nullptr};
  if (f == kPreferredLeader) {
    const uint8_t* allowed = static_cast<const uint8_t*>(q.p[0]);
    CC_UNROLL
    for (int s = N - 1; s >= 0; --s) {
      if (s >= S) continue;
      if (a[s] >= 0 && pm && LDG(allowed + clamp_broker(a[s], B))) pref = s;
    }
  } else if (f == kBrokerSet) {
    home = LDG(static_cast<const int32_t*>(q.p[1]) + part.topic);
  } else if (f == kKafkaAssignerRack) {
    at.mask = static_cast<const uint8_t*>(q.p[0]);
    under.mask = static_cast<const uint8_t*>(q.p[1]);
    at.by_rack = static_cast<const int32_t*>(q.p[2]);
    under.by_rack = static_cast<const int32_t*>(q.p[3]);
    const int32_t* rooms = static_cast<const int32_t*>(q.p[4]);
    int used_at = 0, used_under = 0;
    CC_UNROLL
    for (int s = 0; s < N; ++s) {
      if (s >= S) break;
      const bool first = a[s] >= 0 && pm && !dup[s];
      const int safe = clamp_broker(rk[s], B);
      used_at += (first && LDG(at.by_rack + safe) > 0) ? 1 : 0;
      used_under += (first && LDG(under.by_rack + safe) > 0) ? 1 : 0;
    }
    at.unused = LDG(rooms) > used_at;
    under.unused = LDG(rooms + 1) > used_under;
  }
  const bool misled = pm && pref < S && ls != pref;
  Rows& rows = part.rows;
  uint32_t offm = 0u;
  CC_UNROLL
  for (int s = 0; s < N; ++s) {
    if (s >= S) break;
    const int as = a[s];
    const bool ex = as >= 0 && pm;
    const bool lead = ex && ls == s;
    const bool off = ex && !LDG(q.alive + as);
    float v;
    switch (f) {
      case kNegLoadTotal:
        v = (q.ival && !lead) ? neg_inf() : -rows.base(q, lead, ex, true);
        break;
      case kLoadColumn:
        v = rows.base(q, lead, ex, false);
        break;
      case kFitPriority: {
        const float size = rows.base(q, lead, ex, false);
        const float room =
            as >= 0 ? LDG(static_cast<const float*>(q.p[1]) + as) : 0.0f;
        const bool fits = size <= max_gap && size <= room && size > 0.0f;
        v = fits ? F_ADD(peak, size) : size;
        break;
      }
      case kLeaderLoad:
        v = (q.ival ? lead : ex) ? part.lead_col : neg_inf();
        break;
      case kTopicDonor:
        v = ex ? LDG(static_cast<const float*>(q.p[0]) +
                     static_cast<long long>(part.topic) * B +
                     clamp_broker(as, B))
               : neg_inf();
        break;
      case kRackDuplicate:
        v = dup[s] ? F_ADD(1.0f, rows.base(q, lead, ex, true)) : neg_inf();
        break;
      case kPreferredLeader:
        v = (lead && misled) ? 1.0f : neg_inf();
        break;
      case kBrokerSet: {
        const int set =
            as >= 0 ? LDG(static_cast<const int32_t*>(q.p[0]) + as) : q.ival;
        v = (ex && set != home) ? F_ADD(1.0f, rows.base(q, lead, ex, true))
                                : neg_inf();
        break;
      }
      case kKafkaAssignerRack: {
        if (!ex) {
          v = neg_inf();
          break;
        }
        bool sole = true;
        CC_UNROLL
        for (int t = 0; t < N; ++t) {
          if (t >= S) break;
          sole = sole && !(t != s && rk[t] == rk[s] && a[t] >= 0 && pm);
        }
        const int safe = clamp_broker(rk[s], B);
        const bool dup_ok = feasible(at, ex, sole, as, safe);
        const bool shed_ok = feasible(under, ex, sole, as, safe);
        const bool on_over =
            LDG(static_cast<const uint8_t*>(q.p[5]) + as) != 0;
        const float load = rows.base(q, lead, ex, true);
        const bool d = dup[s];
        v = F_SUB(peak, load);
        if (shed_ok && !on_over && !d) v = F_SUB(F_MUL(0.5f, peak), load);
        if (on_over && shed_ok && !d) v = F_ADD(F_MUL(3.0f, peak), load);
        if (d && dup_ok) v = F_ADD(F_MUL(5.0f, peak), load);
        if (d && !dup_ok) v = F_ADD(peak, load);
        break;
      }
      default:  // kLoadTotal
        v = rows.base(q, lead, ex, true);
    }
    if (q.override_offline && off) v = 1e30f;
    w[s] = v;
    offm |= off ? (1u << s) : 0u;
  }
  return offm;
}

CC_HD float peak_of(uint32_t bits) {
  return F_ADD(unordered_float(bits), 1.0f);
}

bool params_ok(const WeightParams* q) {
  return q->P >= 1 && q->S >= 1 && q->S <= kMaxS && q->B >= 1 &&
         q->T >= 0 && q->family >= kLoadTotal &&
         q->family <= kKafkaAssignerRack && q->scratch != nullptr &&
         static_cast<long long>(q->P) * q->S < (1LL << 31);
}

long long scratch_bytes(const WeightParams* q) {
  return static_cast<long long>(kScratchHead + q->B) * 4;
}

#ifdef __CUDACC__
// Copy n int32 from global to shared memory, 16 bytes a thread where the
// source is aligned (the tile's run starts at p0*S ints, p0 a multiple of
// kTile, so it is wherever the array is).
__device__ __forceinline__ void tile_in(int32_t* dst, const int32_t* src,
                                        int n) {
  int i0 = 0;
  if (aligned16(src)) {
    const int n4 = n >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = __ldg(s4 + i);
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

// The tile's staged weights and offline bytes out, 16 bytes a thread
// where the destination is aligned.
__device__ __forceinline__ void tile_out(float* w, const float* sw,
                                         uint8_t* o, const uint8_t* so,
                                         int n) {
  int i0 = 0;
  if (aligned16(w)) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(w)[i] =
          reinterpret_cast<const float4*>(sw)[i];
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) w[i] = sw[i];
  i0 = 0;
  if (aligned16(o)) {
    const int n16 = n >> 4;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(o)[i] = reinterpret_cast<const uint4*>(so)[i];
    i0 = n16 << 4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) o[i] = so[i];
}

// The max pass: CTAs walk the tiles, each reduces its partitions' peaks
// and raises the global one once. Every partition's rows count (an empty
// slot's base load is its follower row times 0.0), so they are read with
// the tile's copy.
template <int kS>
__global__ void __launch_bounds__(kThreads)
    peak_kernel(const __grid_constant__ WeightParams q) {
  constexpr int N = Slots<kS>::N;
  const int S = kS > 0 ? kS : q.S;
  __shared__ __align__(16) int32_t sa[kTile * N];
  __shared__ uint32_t warp_best[kThreads / 32];
  const int t = threadIdx.x;
  uint32_t best = 0u;
  for (long long p0 = static_cast<long long>(blockIdx.x) * kTile; p0 < q.P;
       p0 += static_cast<long long>(gridDim.x) * kTile) {
    const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                       q.P - p0));
    __syncthreads();
    tile_in(sa, q.assignment + p0 * S, n * S);
    Part part(q, static_cast<int>(p0) + (t < n ? t : 0), true);
    __syncthreads();
    if (t < n) {
      int a[N];
      CC_UNROLL
      for (int s = 0; s < N; ++s) a[s] = s < S ? sa[t * S + s] : -1;
      const uint32_t o = partition_peak_bits<kS>(q, part, a);
      best = o > best ? o : best;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t u = __shfl_xor_sync(0xffffffffu, best, o);
    best = u > best ? u : best;
  }
  if ((t & 31) == 0) warp_best[t / 32] = best;
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      best = warp_best[w] > best ? warp_best[w] : best;
    atomicMax(reinterpret_cast<uint32_t*>(q.scratch + kPeakWord), best);
  }
}

// The weight pass: one tile a CTA, one partition a thread.
template <int kS>
__global__ void __launch_bounds__(kThreads)
    weights_kernel(const __grid_constant__ WeightParams q) {
  constexpr int N = Slots<kS>::N;
  const int S = kS > 0 ? kS : q.S;
  __shared__ __align__(16) int32_t sa[kTile * N];
  __shared__ __align__(16) float sw[kTile * N];
  __shared__ __align__(16) uint8_t so[kTile * N];
  __shared__ float scalars[2];
  const int p0 = blockIdx.x * kTile;
  const int n = min(kTile, q.P - p0);
  const long long s0 = static_cast<long long>(p0) * S;
  const int t = threadIdx.x;
  tile_in(sa, q.assignment + s0, n * S);
  Part part(q, p0 + (t < n ? t : 0), false);
  if (t == 0) {
    // The call's scalars, read once a CTA: the peak through L2 (a
    // replayed graph must not read a value an earlier replay left in
    // L1), the fit priority's largest gap.
    scalars[0] = peak_family(q.family)
        ? peak_of(__ldcg(
              reinterpret_cast<const uint32_t*>(q.scratch + kPeakWord)))
        : 0.0f;
    scalars[1] = q.family == kFitPriority
        ? __ldg(static_cast<const float*>(q.p[0])) : 0.0f;
  }
  __syncthreads();
  int a[N];
  float w[N];
  CC_UNROLL
  for (int s = 0; s < N; ++s) {
    a[s] = (t < n && s < S) ? sa[t * S + s] : -1;
    w[s] = 0.0f;
  }
  const uint32_t offm =
      t < n ? partition_weights<kS>(q, part, a, w, scalars[0], scalars[1])
            : 0u;
  if (t < n) {
    CC_UNROLL
    for (int s = 0; s < N; ++s) {
      if (s >= S) break;
      sw[t * S + s] = w[s];
      so[t * S + s] = static_cast<uint8_t>((offm >> s) & 1u);
    }
  }
  if (q.override_offline) {
    // Each slot's offline lanes, grouped by broker: one atomic a group.
    const int lane = t & 31;
    int32_t* count = q.scratch + kScratchHead;
    CC_UNROLL
    for (int s = 0; s < N; ++s) {
      if (s >= S) break;
      const bool o = (offm >> s) & 1u;
      const unsigned lanes = __ballot_sync(0xffffffffu, o);
      if (lanes == 0u) continue;
      if (o) {
        const unsigned same = __match_any_sync(lanes, a[s]);
        if (lane == __ffs(same) - 1) atomicAdd(count + a[s], __popc(same));
      }
    }
  }
  if (__syncthreads_or(offm != 0u) && t == 0)
    *reinterpret_cast<uint8_t*>(q.scratch) = 1;
  tile_out(q.weight + s0, sw, q.off + s0, so, n * S);
}

template <int kS>
void launch(const WeightParams* q, cudaStream_t stream) {
  const int tiles = (q->P + kTile - 1) / kTile;
  if (peak_family(q->family))
    peak_kernel<kS><<<tiles < 132 * 8 ? tiles : 132 * 8, kThreads, 0,
                      stream>>>(*q);
  weights_kernel<kS><<<tiles, kThreads, 0, stream>>>(*q);
}
#else
// The same passes on the host, tile by tile through staged buffers, in
// partition order.
template <int kS>
void run_host(const WeightParams* q) {
  constexpr int N = Slots<kS>::N;
  const int S = kS > 0 ? kS : q->S;
  std::memset(q->scratch, 0, static_cast<size_t>(scratch_bytes(q)));
  std::vector<int32_t> sa(kTile * N);
  std::vector<float> sw(kTile * N);
  std::vector<uint8_t> so(kTile * N);
  float peak = 0.0f;
  if (peak_family(q->family)) {
    uint32_t best = 0u;
    for (int p0 = 0; p0 < q->P; p0 += kTile) {
      const int n = q->P - p0 < kTile ? q->P - p0 : kTile;
      std::memcpy(sa.data(), q->assignment + static_cast<long long>(p0) * S,
                  sizeof(int32_t) * n * S);
      for (int t = 0; t < n; ++t) {
        Part part(*q, p0 + t, true);
        int a[N];
        for (int s = 0; s < N; ++s) a[s] = s < S ? sa[t * S + s] : -1;
        const uint32_t o = partition_peak_bits<kS>(*q, part, a);
        best = o > best ? o : best;
      }
    }
    q->scratch[kPeakWord] = static_cast<int32_t>(best);
    peak = peak_of(best);
  }
  const float max_gap = q->family == kFitPriority
      ? *static_cast<const float*>(q->p[0]) : 0.0f;
  bool any = false;
  for (int p0 = 0; p0 < q->P; p0 += kTile) {
    const int n = q->P - p0 < kTile ? q->P - p0 : kTile;
    const long long s0 = static_cast<long long>(p0) * S;
    std::memcpy(sa.data(), q->assignment + s0, sizeof(int32_t) * n * S);
    for (int t = 0; t < n; ++t) {
      Part part(*q, p0 + t, false);
      int a[N];
      float w[N];
      for (int s = 0; s < N; ++s) {
        a[s] = s < S ? sa[t * S + s] : -1;
        w[s] = 0.0f;
      }
      const uint32_t offm =
          partition_weights<kS>(*q, part, a, w, peak, max_gap);
      for (int s = 0; s < S; ++s) {
        sw[t * S + s] = w[s];
        so[t * S + s] = static_cast<uint8_t>((offm >> s) & 1u);
        if (q->override_offline && ((offm >> s) & 1u))
          q->scratch[kScratchHead + a[s]] += 1;
      }
      any = any || offm != 0u;
    }
    std::memcpy(q->weight + s0, sw.data(), sizeof(float) * n * S);
    std::memcpy(q->off + s0, so.data(), static_cast<size_t>(n) * S);
  }
  if (any) *reinterpret_cast<uint8_t*>(q->scratch) = 1;
}
#endif

}  // namespace

extern "C" long long cc_slot_weights_params_bytes() {
  return static_cast<long long>(sizeof(WeightParams));
}

extern "C" int cc_slot_weights_scratch_head() { return kScratchHead; }

#ifdef __CUDACC__
// One call: zero the scratch words, the max pass where the family ranks by
// a peak, then the weight pass, on `stream`; the instance for S.
extern "C" int cc_slot_weights(const WeightParams* q, void* stream_) {
  if (!params_ok(q)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const cudaError_t err =
      cudaMemsetAsync(q->scratch, 0, scratch_bytes(q), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (q->S) {
    case 1: launch<1>(q, stream); break;
    case 2: launch<2>(q, stream); break;
    case 3: launch<3>(q, stream); break;
    case 4: launch<4>(q, stream); break;
    default: launch<0>(q, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int cc_slot_weights_host(const WeightParams* q) {
  if (!params_ok(q)) return 1;
  switch (q->S) {
    case 1: run_host<1>(q); break;
    case 2: run_host<2>(q); break;
    case 3: run_host<3>(q); break;
    case 4: run_host<4>(q); break;
    default: run_host<0>(q);
  }
  return 0;
}
#endif
