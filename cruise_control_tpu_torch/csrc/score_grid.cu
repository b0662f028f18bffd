// K6 score_grid: one search round's candidate scoring.
//
// Replaces (JAX) cruise_control_tpu/analyzer/candidates.py:252
// generate_candidates (the [k_src x (k_dst + extra)] move block and the
// [k_l x S] leadership block), candidates.py:104 compute_deltas, and the
// acceptance / improvement stack of analyzer/chain.py:275-295 (every
// prior goal's acceptance ANDed, the active goal's improvement, the
// offline bonus, the masked score); in its second mode the joint recheck
// of chain.py:301 (every prior goal's acceptance of a rank-ordered batch
// with the cumulative pre-deltas of earlier rows, and the active goal's
// where an earlier row touches the same brokers).
//
// Bound on this card: bytes. Each row writes ~55 bytes of deltas and
// score; its inputs are its source's partition, a few per-broker values a
// goal at its source and its destination, and a [T, B] cell for the
// per-topic goals; the operations are tens of f32 adds a goal.
//
// Design of the grid mode (two launches):
//  panel: one thread a (field, column) writes the per-broker value each
//  goal reads (the core fields: alive, new, the two exclusions, rack,
//  replica and leader counts, potential NW-out, the four loads and
//  capacities; then each goal's [B] arrays, at the slots
//  analyzer/score_grid.py assigns) at each column's broker: the move
//  block's k_dst destinations, then each source row's targeted
//  destination, then each source row's broker, into a [n_fields, width]
//  panel. A row then reads its destination's and its source's values as
//  two columns of the panel (its destination columns coalesced across the
//  row's warp), instead of gathering them from scattered brokers goal by
//  goal;
//  rows: a CTA takes a group of source rows (about kGroupRows rows) and
//  stages each source's partition in shared memory (its slots and their
//  brokers' racks, leader slot, loads, topic and flags), then runs the
//  group's rows, consecutive rows on consecutive threads, so every output
//  store is coalesced. The leadership block's rows take the CTAs after
//  them, one thread a row, reading everything where it lies.
// Either way a row's goals read through a context (Direct or Staged)
// that only says where a value comes from, and index a row's four
// resources by selects, not by a run-time index into a local array
// (which nvcc put in local memory: 120-208 bytes of stack a thread and a
// latency chain through L1 per goal). The arithmetic is one code: a
// row computes its deltas exactly as compute_deltas writes them (invalid
// rows zeroed), then walks the goal table, one descriptor a goal, passed
// by value in the kernel's parameters (so a captured CUDA graph replays it
// with no copy), holding the goal's family, resource and pointers to the
// per-broker / per-topic arrays its aux and limits produce in PyTorch
// (allocated inside the captured round, so their addresses are the same
// at every replay). Every f32 operation is written with the
// round-to-nearest intrinsics, so nvcc contracts nothing: each product
// and sum rounds where the plain twin's PyTorch ops round, and __fmaf_rn
// appears only where the twin calls fma_f32 (the variance gain). The
// clamps are fmaxf(v, lo) behind a NaN test, as PyTorch's CUDA clamp is.
// The recheck mode runs one thread a row with the Direct context.
//
// The file also compiles as host C++ (without __CUDACC__): the same
// panel, staging and row functions called in the kernels' order on the
// CPU, for checking the arithmetic off the card.
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CC_HD __device__ __forceinline__
#define CC_HHD __host__ __device__ __forceinline__
#define CC_MF __device__ __forceinline__
#define F_ADD(a, b) __fadd_rn((a), (b))
#define F_SUB(a, b) __fsub_rn((a), (b))
#define F_MUL(a, b) __fmul_rn((a), (b))
#define F_DIV(a, b) __fdiv_rn((a), (b))
#define F_FMA(a, b, c) __fmaf_rn((a), (b), (c))
#define F_MAX(a, b) fmaxf((a), (b))
#define F_ISNAN(v) isnan(v)
#define F_ISFINITE(v) isfinite(v)
#else
#define CC_HD static inline
#define CC_HHD static inline
#define CC_MF inline
#define F_ADD(a, b) ((a) + (b))
#define F_SUB(a, b) ((a) - (b))
#define F_MUL(a, b) ((a) * (b))
#define F_DIV(a, b) ((a) / (b))
#define F_FMA(a, b, c) std::fma((a), (b), (c))
#define F_MAX(a, b) std::fmax((a), (b))
#define F_ISNAN(v) std::isnan(v)
#define F_ISFINITE(v) std::isfinite(v)
#endif

namespace {

constexpr int kMaxGoals = 24;
constexpr int kThreads = 256;
constexpr int kR = 4;
constexpr int kNwIn = 1;
constexpr int kNwOut = 2;
constexpr int kDisk = 3;
constexpr int kMaxS = 64;
// Sources a group stages at most, and the rows a group aims at (two
// sources at the 1k/100k cap; groups of three were slower there, PERF.md).
constexpr int kMaxGroup = 16;
constexpr int kGroupRows = 256;
// Panel fields: the core per-broker fields (kAlive ... kCap0 + 3), then
// at most two [B] arrays a goal.
constexpr int kCore = 16;
constexpr int kMaxFields = kCore + 2 * kMaxGoals;
constexpr int kAlive = 0, kNew = 1, kAllowRm = 2, kAllowLd = 3, kRack = 4,
              kReplicas = 5, kLeaders = 6, kPot = 7, kLoad0 = 8, kCap0 = 12;
// PyTorch converts a Python float operand to f32 by a cast of the double.
constexpr float kEps6 = static_cast<float>(1e-6);
constexpr float kEps9 = static_cast<float>(1e-9);
constexpr float kBonus = static_cast<float>(1e12);

// Goal families (analyzer/goals/base.py Family).
enum Family : int32_t {
  kRackAware = 1,
  kReplicaCapacity = 2,
  kResourceCapacity = 3,
  kCountDistribution = 4,
  kPotentialNwOut = 5,
  kResourceDistribution = 6,
  kTopicReplicaDistribution = 7,
  kLeaderBytesIn = 8,
  kRackAwareDistribution = 9,
  kPreferredLeader = 10,
  kMinTopicLeaders = 11,
  kBrokerSetAware = 12,
  kKafkaAssignerRack = 13,
  kKafkaAssignerDisk = 14,
};

}  // namespace

// One goal of the table (analyzer/score_grid.py GoalDesc).
struct GoalDesc {
  int32_t family;
  int32_t resource;
  int32_t ival;
  float fval;
  const void* p[4];
};

// Everything a launch reads, passed by value (analyzer/score_grid.py
// GridParams): the cluster, the derived state, the grid's inputs, the
// rows (outputs in grid mode, inputs in recheck mode), the pre-deltas,
// the outputs, the goal table and, in grid mode, the panel and its plan.
struct GridParams {
  int32_t mode;  // 0 grid, 1 recheck
  int32_t n;
  int32_t P, S, B, T;
  const int32_t* assignment;
  const int32_t* leader_slot;
  const float* leader_load;
  const float* follower_load;
  const int32_t* topic;
  const uint8_t* pmask;
  const int32_t* rack;
  const float* capacity;
  const float* broker_load;
  const int32_t* broker_replicas;
  const int32_t* broker_leaders;
  const float* pot_nw_out;
  const uint8_t* alive;
  const uint8_t* new_brokers;
  const uint8_t* allowed_rm;
  const uint8_t* allowed_ld;
  const uint8_t* movable;
  const uint8_t* has_new;
  const uint8_t* off;
  const int32_t* cand_p;
  const int32_t* cand_s;
  const uint8_t* src_valid;
  const int32_t* dst_idx;
  const float* dst_val;
  const int32_t* t_dst;
  const uint8_t* t_ok;
  const int32_t* lp;
  const float* top_lw;
  int32_t k_src, k_dst, extra, k_l;
  int32_t move_block_ok, lead_block_ok;
  int8_t* kind;
  int32_t* partition;
  int32_t* src_broker;
  int32_t* dst_broker;
  int32_t* topic_out;
  int32_t* src_slot;
  int32_t* dst_slot;
  int32_t* replica_delta;
  int32_t* leader_delta;
  float* load_delta;
  uint8_t* valid;
  const float* pre_src_load;
  const float* pre_dst_load;
  const float* pre[9];  // candidates.PRE_FIELDS order
  const uint8_t* has_earlier;
  uint8_t* accept;
  float* score;
  int32_t n_goals;
  int32_t active;
  uint32_t prior_mask;
  int32_t pad_;
  GoalDesc goals[kMaxGoals];
  uint32_t* panel;  // [n_fields, k_dst] words (grid mode)
  int32_t n_fields;
  int32_t pad2_;
  int16_t field[kMaxFields];        // slot -> core id, or kCore + 4 g + k
  int8_t goal_slot[kMaxGoals * 4];  // goal g's array k -> slot, -1 none
};

namespace {

struct Row {
  int part, src, dst, topic, src_slot, dst_slot, rd, ld;
  float d[kR];
  bool valid;
};

struct Pre {
  float src_load[kR], dst_load[kR];
  float src_count, dst_count, src_leaders, dst_leaders, src_topic_count,
      dst_topic_count, src_topic_leaders, dst_pot, dst_lbi;
};

// One source row of the move block, staged for its group's rows.
struct Source {
  int part, cand_slot, lead_slot, src_b, topic;
  uint8_t src_valid, movable, pmask, off;
  float lead[kR], foll[kR];
  int slot_b[kMaxS], slot_rack[kMaxS];
};

CC_HD float neg_inf() { return -INFINITY; }

CC_HD uint32_t f2u(float v) {
#ifdef __CUDACC__
  return __float_as_uint(v);
#else
  uint32_t u;
  std::memcpy(&u, &v, sizeof(u));
  return u;
#endif
}

CC_HD float u2f(uint32_t u) {
#ifdef __CUDACC__
  return __uint_as_float(u);
#else
  float v;
  std::memcpy(&v, &u, sizeof(v));
  return v;
#endif
}

// torch.clamp(v, min=lo) on the card: NaN kept, else ::max(v, lo).
CC_HD float clamp_min(float v, float lo) {
  return F_ISNAN(v) ? v : F_MAX(v, lo);
}

CC_HD int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// a[k] of a row's four resources, k known only at run time: selects, so
// the array stays in registers (an indexed load would put it in local
// memory).
CC_HD float at4(const float (&a)[kR], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : a[3]));
}

CC_HD float band(float v, float lo, float up) {
  return F_ADD(clamp_min(F_SUB(v, up), 0.0f), clamp_min(F_SUB(lo, v), 0.0f));
}

// gap^2 - (gap - 2d)^2 with the first product fused (distribution.py
// _var_diff); the variance gain is 1e-6 times it.
CC_HD float var_diff(float gap, float d) {
  const float rest = F_SUB(gap, F_MUL(2.0f, d));
  return F_FMA(gap, gap, -F_MUL(rest, rest));
}

CC_HD float var_gain(float gap, float d) {
  return F_MUL(var_diff(gap, d), kEps6);
}

template <typename T>
CC_HD const T* arr(const GoalDesc& g, int i) {
  return static_cast<const T*>(g.p[i]);
}

// A core per-broker field of broker b as a 32-bit word.
CC_HD uint32_t core_word(const GridParams& q, int id, int b) {
  switch (id) {
    case kAlive: return q.alive[b];
    case kNew: return q.new_brokers[b];
    case kAllowRm: return q.allowed_rm[b];
    case kAllowLd: return q.allowed_ld[b];
    case kRack: return static_cast<uint32_t>(q.rack[b]);
    case kReplicas: return static_cast<uint32_t>(q.broker_replicas[b]);
    case kLeaders: return static_cast<uint32_t>(q.broker_leaders[b]);
    case kPot: return f2u(q.pot_nw_out[b]);
    default:
      return id < kCap0 ? f2u(q.broker_load[b * kR + id - kLoad0])
                        : f2u(q.capacity[b * kR + id - kCap0]);
  }
}

// Goal g's [B] array k (f32 or int32) at broker b.
CC_HD uint32_t goal_word(const GridParams& q, int g, int k, int b) {
  return static_cast<const uint32_t*>(q.goals[g].p[k])[b];
}

// Panel slot f's field at broker b.
CC_HD uint32_t field_word(const GridParams& q, int f, int b) {
  const int code = q.field[f];
  return code < kCore ? core_word(q, code, b)
                      : goal_word(q, (code - kCore) >> 2, (code - kCore) & 3,
                                  b);
}

// Columns of the panel: the k_dst destinations, then (with a targeted
// column) each source row's targeted destination, then each source row's
// broker.
CC_HHD long long panel_width(const GridParams& q) {
  return static_cast<long long>(q.k_dst) + (1 + q.extra) * q.k_src;
}

// Where a row's values come from: every array where it lies, at the
// row's partition and brokers (the leadership block, the recheck mode).
struct Direct {
  const GridParams& q;
  int part, src, dst;
  CC_MF uint32_t src_core(int id) const { return core_word(q, id, src); }
  CC_MF uint32_t dst_core(int id) const { return core_word(q, id, dst); }
  CC_MF uint32_t src_goal(int g, int k) const {
    return goal_word(q, g, k, src);
  }
  CC_MF uint32_t dst_goal(int g, int k) const {
    return goal_word(q, g, k, dst);
  }
  CC_MF int slot_broker(int s) const {
    return q.assignment[static_cast<long long>(part) * q.S + s];
  }
  CC_MF int slot_rack(int s) const {
    return q.rack[clampi(slot_broker(s), 0, q.B - 1)];
  }
  CC_MF bool part_live() const { return q.pmask[part] != 0; }
  CC_MF float lead(int k) const { return q.leader_load[part * kR + k]; }
  CC_MF bool off(const Row& r) const {
    return q.off[static_cast<long long>(r.part) * q.S + r.src_slot];
  }
};

// A move row of a staged group: its source's partition from shared
// memory, the per-broker fields of its source and its destination from
// their columns of the panel.
struct Staged {
  const GridParams& q;
  const Source& s;
  const uint32_t* src_col;  // the source's panel column, the destination's
  const uint32_t* dst_col;
  long long w;  // the panel's width
  CC_MF uint32_t src_core(int id) const { return src_col[id * w]; }
  CC_MF uint32_t dst_core(int id) const { return dst_col[id * w]; }
  CC_MF uint32_t src_goal(int g, int k) const {
    return src_col[q.goal_slot[g * 4 + k] * w];
  }
  CC_MF uint32_t dst_goal(int g, int k) const {
    return dst_col[q.goal_slot[g * 4 + k] * w];
  }
  CC_MF int slot_broker(int t) const { return s.slot_b[t]; }
  CC_MF int slot_rack(int t) const { return s.slot_rack[t]; }
  CC_MF bool part_live() const { return s.pmask != 0; }
  CC_MF float lead(int k) const { return s.lead[k]; }
  CC_MF bool off(const Row&) const { return s.off != 0; }
};

template <class C>
CC_HD float gate(const C& c, const Row& r) {
  const bool g = (*c.q.has_new && r.rd > 0) ? c.dst_core(kNew) != 0u : true;
  return g ? 1.0f : 0.0f;
}

// A slot of the row's partition holding another replica than the moving
// one whose broker's rack is `want` (rack.py _dst_rack_conflict).
template <class C>
CC_HD bool rack_conflict(const C& c, const Row& r, int want) {
  for (int s = 0; s < c.q.S; ++s) {
    if (c.slot_broker(s) >= 0 && s != r.src_slot && c.slot_rack(s) == want)
      return true;
  }
  return false;
}

// Replicas of the partition other than the moving one in rack `want`
// (rack.py _rack_counts_at).
template <class C>
CC_HD int rack_count(const C& c, const Row& r, int want) {
  int n = 0;
  for (int s = 0; s < c.q.S; ++s)
    n += (c.slot_broker(s) >= 0 && s != r.src_slot && c.slot_rack(s) == want);
  return n;
}

// rack.py _duplicate_mask at the row's (partition, s): the replica shares
// its rack with an earlier existing slot of its partition.
template <class C>
CC_HD bool duplicate(const C& c, int s) {
  if (c.slot_broker(s) < 0 || !c.part_live()) return false;
  const int mine = c.slot_rack(s);
  for (int t = 0; t < s; ++t)
    if (c.slot_broker(t) >= 0 && c.slot_rack(t) == mine) return true;
  return false;
}

CC_HD int as_int(uint32_t w) { return static_cast<int32_t>(w); }

// base.py pair_improvement for a valid row: before - after of
// viol(src) + viol(dst), viol_s / viol_d reading the source's and the
// destination's limits.
template <typename VS, typename VD>
CC_HD float pair(float vs, float vd, float delta, VS viol_s, VD viol_d) {
  const float before = F_ADD(viol_s(vs), viol_d(vd));
  const float after = F_ADD(viol_s(F_SUB(vs, delta)),
                            viol_d(F_ADD(vd, delta)));
  return F_SUB(before, after);
}

template <class C>
CC_HD bool accept_goal(const C& c, int gi, const Row& r, const Pre& pre) {
  const GridParams& q = c.q;
  const GoalDesc& g = q.goals[gi];
  const bool is_move = r.rd > 0;
  const int src = r.src, dst = r.dst;
  switch (g.family) {
    case kRackAware:
      return is_move ? !rack_conflict(c, r, as_int(c.dst_core(kRack))) : true;
    case kReplicaCapacity: {
      const float after = F_ADD(
          F_ADD(static_cast<float>(as_int(c.dst_core(kReplicas))),
                pre.dst_count),
          static_cast<float>(r.rd));
      return after <= g.fval;
    }
    case kResourceCapacity: {
      const int k = g.resource;
      const float after = F_ADD(F_ADD(u2f(c.dst_core(kLoad0 + k)),
                                      at4(pre.dst_load, k)), at4(r.d, k));
      return after <= F_ADD(u2f(c.dst_goal(gi, 0)), kEps6);
    }
    case kCountDistribution: {
      const bool leaders = g.ival != 0;
      const float lower = *arr<float>(g, 0), upper = *arr<float>(g, 1);
      const int id = leaders ? kLeaders : kReplicas;
      const float d = static_cast<float>(leaders ? r.ld : r.rd);
      const float pd = leaders ? pre.dst_leaders : pre.dst_count;
      const float ps = leaders ? pre.src_leaders : pre.src_count;
      const bool dst_ok =
          F_ADD(F_ADD(static_cast<float>(as_int(c.dst_core(id))), pd), d) <=
          F_ADD(upper, kEps6);
      const bool src_ok =
          F_SUB(F_SUB(static_cast<float>(as_int(c.src_core(id))), ps), d) >=
          F_SUB(lower, kEps6);
      return d == 0.0f || (dst_ok && src_ok) || c.src_core(kAlive) == 0u;
    }
    case kPotentialNwOut: {
      const float d = is_move ? c.lead(kNwOut) : 0.0f;
      const float after = F_ADD(F_ADD(u2f(c.dst_core(kPot)), pre.dst_pot), d);
      const bool src_viol = u2f(c.src_core(kPot)) > u2f(c.src_goal(gi, 0));
      return after <= F_ADD(u2f(c.dst_goal(gi, 0)), kEps6) || d <= 0.0f ||
             src_viol;
    }
    case kResourceDistribution: {
      const int k = g.resource;
      const float lower_s = u2f(c.src_goal(gi, 0));
      const float upper_d = u2f(c.dst_goal(gi, 1));
      const bool low_util = *arr<uint8_t>(g, 2) != 0;
      const float d = at4(r.d, k);
      const float load_s = u2f(c.src_core(kLoad0 + k));
      const float load_d = u2f(c.dst_core(kLoad0 + k));
      const float ls = F_SUB(load_s, at4(pre.src_load, k));
      const float ld = F_ADD(load_d, at4(pre.dst_load, k));
      const bool src_above_lower = load_s >= F_SUB(lower_s, kEps6);
      const bool dst_under_upper = load_d <= F_ADD(upper_d, kEps6);
      const bool stays = F_ADD(ld, d) <= F_ADD(upper_d, kEps6) &&
                         F_SUB(ls, d) >= F_SUB(lower_s, kEps6);
      const float cap_s = clamp_min(u2f(c.src_core(kCap0 + k)), kEps9);
      const float cap_d = clamp_min(u2f(c.dst_core(kCap0 + k)), kEps9);
      const bool no_worse = F_DIV(F_ADD(ld, d), cap_d) <=
                            F_ADD(F_DIV(ls, cap_s), kEps6);
      const bool acc = (src_above_lower && dst_under_upper) ? stays
                                                            : no_worse;
      return acc || d <= kEps6 || low_util || c.src_core(kAlive) == 0u;
    }
    case kTopicReplicaDistribution: {
      const float* counts = arr<float>(g, 0);
      const float* upper = arr<float>(g, 1);
      const float* lower = arr<float>(g, 2);
      const long long row = static_cast<long long>(r.topic) * q.B;
      const float d = static_cast<float>(r.rd);
      const float dst_cnt = F_ADD(counts[row + dst], pre.dst_topic_count);
      const float src_cnt = F_SUB(counts[row + src], pre.src_topic_count);
      const bool dst_ok = F_ADD(dst_cnt, d) <= F_ADD(upper[r.topic], kEps6);
      const bool src_ok = F_SUB(src_cnt, d) >= F_SUB(lower[r.topic], kEps6);
      return d == 0.0f || (dst_ok && src_ok) || c.src_core(kAlive) == 0u;
    }
    case kLeaderBytesIn: {
      const float upper = *arr<float>(g, 1);
      const float d = r.ld > 0 ? c.lead(kNwIn) : 0.0f;
      const float after = F_ADD(F_ADD(u2f(c.dst_goal(gi, 0)), pre.dst_lbi), d);
      return after <= F_ADD(upper, kEps6) || d <= 0.0f ||
             u2f(c.src_goal(gi, 0)) > upper;
    }
    case kRackAwareDistribution: {
      const int limit = arr<int32_t>(g, 0)[r.part];
      return is_move ? rack_count(c, r, as_int(c.dst_core(kRack))) + 1 <= limit
                     : true;
    }
    case kPreferredLeader:
      return true;
    case kMinTopicLeaders: {
      if (!g.ival) return true;
      const int32_t* lc = arr<int32_t>(g, 0);
      const float cnt = F_SUB(
          static_cast<float>(lc[static_cast<long long>(r.topic) * q.B + src]),
          pre.src_topic_leaders);
      return r.ld == 0 || F_SUB(cnt, static_cast<float>(r.ld)) >= g.fval;
    }
    case kBrokerSetAware: {
      const int32_t* home = arr<int32_t>(g, 1);
      return is_move ? as_int(c.dst_goal(gi, 0)) == home[r.topic] : true;
    }
    case kKafkaAssignerRack: {
      const bool rack_ok =
          is_move ? !rack_conflict(c, r, as_int(c.dst_core(kRack))) : true;
      const int cap = *arr<int32_t>(g, 0);
      const float after = F_ADD(
          F_ADD(static_cast<float>(as_int(c.dst_core(kReplicas))),
                pre.dst_count),
          1.0f);
      const bool under = after <= static_cast<float>(cap);
      const bool tolerant =
          duplicate(c, r.src_slot) && after <= static_cast<float>(cap + 1) &&
          (under ||
           pre.dst_count < static_cast<float>(as_int(c.dst_goal(gi, 1))));
      return rack_ok && (is_move ? (under || tolerant) : true);
    }
    case kKafkaAssignerDisk: {
      const float upper = *arr<float>(g, 1);
      const float cap = clamp_min(u2f(c.dst_core(kCap0 + kDisk)), kEps9);
      const float util = F_DIV(F_ADD(F_ADD(u2f(c.dst_core(kLoad0 + kDisk)),
                                           pre.dst_load[kDisk]),
                                     r.d[kDisk]),
                               cap);
      return is_move ? util <= upper : true;
    }
    default:
      return false;
  }
}

// The active goal's improvement of a VALID row.
template <class C>
CC_HD float improve_goal(const C& c, int gi, const Row& r) {
  const GridParams& q = c.q;
  const GoalDesc& g = q.goals[gi];
  const bool is_move = r.rd > 0;
  const int src = r.src, dst = r.dst;
  switch (g.family) {
    case kRackAware: {
      const float cur = duplicate(c, r.src_slot) ? 1.0f : 0.0f;
      const float conflict =
          rack_conflict(c, r, as_int(c.dst_core(kRack))) ? 1.0f : 0.0f;
      return is_move ? F_SUB(cur, conflict) : 0.0f;
    }
    case kReplicaCapacity: {
      const float cap = g.fval;
      const auto viol = [cap](float x) {
        return clamp_min(F_SUB(x, cap), 0.0f);
      };
      return pair(static_cast<float>(as_int(c.src_core(kReplicas))),
                  static_cast<float>(as_int(c.dst_core(kReplicas))),
                  static_cast<float>(r.rd), viol, viol);
    }
    case kResourceCapacity: {
      const int k = g.resource;
      const float lim_s = u2f(c.src_goal(gi, 0)), lim_d = u2f(c.dst_goal(gi, 0));
      return pair(u2f(c.src_core(kLoad0 + k)), u2f(c.dst_core(kLoad0 + k)),
                  at4(r.d, k),
                  [lim_s](float x) { return clamp_min(F_SUB(x, lim_s), 0.0f); },
                  [lim_d](float x) { return clamp_min(F_SUB(x, lim_d), 0.0f); });
    }
    case kCountDistribution: {
      const bool leaders = g.ival != 0;
      const float lower = *arr<float>(g, 0), upper = *arr<float>(g, 1);
      const int id = leaders ? kLeaders : kReplicas;
      const float d = static_cast<float>(leaders ? r.ld : r.rd);
      const float cs = static_cast<float>(as_int(c.src_core(id)));
      const float cd = static_cast<float>(as_int(c.dst_core(id)));
      const auto viol = [lower, upper](float x) {
        return band(x, lower, upper);
      };
      const float imp = pair(cs, cd, d, viol, viol);
      const float vg = var_gain(F_SUB(cs, cd), d);
      return F_MUL(F_ADD(imp, imp > 0.0f ? vg : 0.0f), gate(c, r));
    }
    case kPotentialNwOut: {
      const float lim_s = u2f(c.src_goal(gi, 0)), lim_d = u2f(c.dst_goal(gi, 0));
      const float d = is_move ? c.lead(kNwOut) : 0.0f;
      return pair(u2f(c.src_core(kPot)), u2f(c.dst_core(kPot)), d,
                  [lim_s](float x) { return clamp_min(F_SUB(x, lim_s), 0.0f); },
                  [lim_d](float x) { return clamp_min(F_SUB(x, lim_d), 0.0f); });
    }
    case kResourceDistribution: {
      const int k = g.resource;
      const float lo_s = u2f(c.src_goal(gi, 0)), up_s = u2f(c.src_goal(gi, 1));
      const float lo_d = u2f(c.dst_goal(gi, 0)), up_d = u2f(c.dst_goal(gi, 1));
      const float ls = u2f(c.src_core(kLoad0 + k));
      const float ld = u2f(c.dst_core(kLoad0 + k));
      const float d = at4(r.d, k);
      const float imp = pair(
          ls, ld, d, [lo_s, up_s](float x) { return band(x, lo_s, up_s); },
          [lo_d, up_d](float x) { return band(x, lo_d, up_d); });
      const float vg = var_gain(F_SUB(ls, ld), d);
      return F_MUL(F_ADD(imp, imp > 0.0f ? vg : 0.0f), gate(c, r));
    }
    case kTopicReplicaDistribution: {
      const float* counts = arr<float>(g, 0);
      const float up = arr<float>(g, 1)[r.topic];
      const float lo = arr<float>(g, 2)[r.topic];
      const long long row = static_cast<long long>(r.topic) * q.B;
      const float d = static_cast<float>(r.rd);
      const float sc = counts[row + src], dc = counts[row + dst];
      const float before = F_ADD(band(sc, lo, up), band(dc, lo, up));
      const float after = F_ADD(band(F_SUB(sc, d), lo, up),
                                band(F_ADD(dc, d), lo, up));
      const float imp = F_SUB(before, after);
      const float vg = var_gain(F_SUB(sc, dc), d);
      return F_MUL(F_ADD(imp, imp > 0.0f ? vg : 0.0f), gate(c, r));
    }
    case kLeaderBytesIn: {
      const float upper = *arr<float>(g, 1);
      const float lbi_s = u2f(c.src_goal(gi, 0)), lbi_d = u2f(c.dst_goal(gi, 0));
      const float d = r.ld > 0 ? c.lead(kNwIn) : 0.0f;
      const auto viol = [upper](float x) {
        return clamp_min(F_SUB(x, upper), 0.0f);
      };
      const float imp = pair(lbi_s, lbi_d, d, viol, viol);
      return F_FMA(var_diff(F_SUB(lbi_s, lbi_d), d), kEps6, imp);
    }
    case kRackAwareDistribution: {
      const int limit = arr<int32_t>(g, 0)[r.part];
      const int sc = rack_count(c, r, as_int(c.src_core(kRack)));
      const int dc = rack_count(c, r, as_int(c.dst_core(kRack)));
      const auto pos = [](int v) { return v > 0 ? v : 0; };
      const int before = pos(sc + 1 - limit) + pos(dc - limit);
      const int after = pos(sc - limit) + pos(dc + 1 - limit);
      return is_move ? static_cast<float>(before - after) : 0.0f;
    }
    case kPreferredLeader: {
      const int pref = arr<int32_t>(g, 0)[r.part];
      return (r.rd == 0 && r.src_slot != pref && r.dst_slot == pref) ? 1.0f
                                                                    : 0.0f;
    }
    case kMinTopicLeaders:
      return 0.0f;
    case kBrokerSetAware: {
      const int home = arr<int32_t>(g, 1)[r.topic];
      const float src_bad = as_int(c.src_goal(gi, 0)) != home ? 1.0f : 0.0f;
      const float dst_bad = as_int(c.dst_goal(gi, 0)) != home ? 1.0f : 0.0f;
      return is_move ? F_SUB(src_bad, dst_bad) : 0.0f;
    }
    case kKafkaAssignerRack: {
      const float cur = duplicate(c, r.src_slot) ? 1.0f : 0.0f;
      const float conflict =
          rack_conflict(c, r, as_int(c.dst_core(kRack))) ? 1.0f : 0.0f;
      const float rack_imp = is_move ? F_SUB(cur, conflict) : 0.0f;
      const float cap = static_cast<float>(*arr<int32_t>(g, 0));
      const auto viol = [cap](float x) {
        return clamp_min(F_SUB(x, cap), 0.0f);
      };
      const float count_imp =
          pair(static_cast<float>(as_int(c.src_core(kReplicas))),
               static_cast<float>(as_int(c.dst_core(kReplicas))),
               static_cast<float>(r.rd), viol, viol);
      return F_ADD(F_MUL(2.0f, rack_imp), count_imp);
    }
    case kKafkaAssignerDisk: {
      const float lower = *arr<float>(g, 0), upper = *arr<float>(g, 1);
      const float cap_s = u2f(c.src_core(kCap0 + kDisk));
      const float cap_d = u2f(c.dst_core(kCap0 + kDisk));
      return pair(u2f(c.src_core(kLoad0 + kDisk)),
                  u2f(c.dst_core(kLoad0 + kDisk)), r.d[kDisk],
                  [cap_s, lower, upper](float x) {
                    const float u = F_DIV(x, clamp_min(cap_s, kEps9));
                    return F_ADD(clamp_min(F_SUB(u, upper), 0.0f),
                                 clamp_min(F_SUB(lower, u), 0.0f));
                  },
                  [cap_d, lower, upper](float x) {
                    const float u = F_DIV(x, clamp_min(cap_d, kEps9));
                    return F_ADD(clamp_min(F_SUB(u, upper), 0.0f),
                                 clamp_min(F_SUB(lower, u), 0.0f));
                  });
    }
    default:
      return neg_inf();
  }
}

// The row's outputs, as compute_deltas writes them.
CC_HD void write_row(const GridParams& q, int i, const Row& r,
                     bool is_move) {
  q.kind[i] = is_move ? 0 : 1;
  q.partition[i] = r.part;
  q.src_broker[i] = r.src;
  q.dst_broker[i] = r.dst;
  q.topic_out[i] = r.topic;
  q.src_slot[i] = r.src_slot;
  q.dst_slot[i] = r.dst_slot;
  q.replica_delta[i] = r.rd;
  q.leader_delta[i] = r.ld;
  for (int k = 0; k < kR; ++k)
    q.load_delta[static_cast<long long>(i) * kR + k] = r.d[k];
  q.valid[i] = r.valid;
}

// Every prior goal's acceptance, the active goal's improvement with the
// offline bonus, the masked score.
template <class C>
CC_HD void score_row(const C& c, const Row& r, int i) {
  const GridParams& q = c.q;
  bool acc = r.valid;
  float score = neg_inf();
  if (acc) {
    Pre pre = {};
    for (int g = 0; g < q.n_goals && acc; ++g)
      if ((q.prior_mask >> g) & 1u) acc = accept_goal(c, g, r, pre);
    if (acc) {
      float imp = improve_goal(c, q.active, r);
      const bool offline = c.off(r) && r.rd > 0;
      if (offline && F_ISFINITE(imp))
        imp = F_ADD(clamp_min(imp, 0.0f), kBonus);
      score = imp;
    }
  }
  q.accept[i] = acc;
  q.score[i] = score;
}

// Leadership row j of the grid (generate_candidates' second block), its
// values read where they lie.
CC_HD void lead_row(const GridParams& q, int j) {
  const int S = q.S, B = q.B;
  const int i = q.k_src * (q.k_dst + q.extra) + j;
  const int row = j / S;
  const int part = q.lp[row];
  const int cand_dst_slot = j % S;
  const bool cvalid = F_ISFINITE(q.top_lw[row]) && q.lead_block_ok;
  const long long base = static_cast<long long>(part) * S;
  const int lead_slot = q.leader_slot[part];
  const int src_slot = lead_slot;
  const int src_b = q.assignment[base + (src_slot > 0 ? src_slot : 0)];
  const int dst_b = q.assignment[base + (cand_dst_slot > 0 ? cand_dst_slot : 0)];
  const bool src_exists = src_slot >= 0 && src_b >= 0;
  const bool dst_in_range = dst_b >= 0 && dst_b < B;
  const int dst_safe = clampi(dst_b, 0, B - 1);
  const bool dst_alive = q.alive[dst_safe] && dst_in_range;
  const bool lead_ok = dst_b >= 0 && cand_dst_slot != lead_slot &&
                       cand_dst_slot >= 0 && q.allowed_ld[dst_safe] &&
                       lead_slot >= 0;
  const bool valid = cvalid && q.movable[part] && src_exists && dst_alive &&
                     lead_ok;
  Row r;
  r.part = part;
  r.topic = q.topic[part];
  r.valid = valid;
  r.src = valid ? src_b : 0;
  r.dst = valid ? dst_safe : 0;
  r.src_slot = valid ? src_slot : 0;
  r.dst_slot = valid ? cand_dst_slot : 0;
  r.rd = 0;
  r.ld = valid ? 1 : 0;
  const float* lead = q.leader_load + static_cast<long long>(part) * kR;
  const float* foll = q.follower_load + static_cast<long long>(part) * kR;
  for (int k = 0; k < kR; ++k)
    r.d[k] = valid ? F_SUB(lead[k], foll[k]) : 0.0f;
  write_row(q, i, r, false);
  score_row(Direct{q, r.part, r.src, r.dst}, r, i);
}

// Stage source row `row` of the move block: its partition's scalars,
// loads and slots (their brokers and racks).
CC_HD void stage_source(const GridParams& q, int row, Source& s) {
  const int S = q.S;
  s.part = q.cand_p[row];
  s.cand_slot = q.cand_s[row];
  const long long base = static_cast<long long>(s.part) * S;
  s.lead_slot = q.leader_slot[s.part];
  s.src_b = q.assignment[base + (s.cand_slot > 0 ? s.cand_slot : 0)];
  s.topic = q.topic[s.part];
  s.src_valid = q.src_valid[row];
  s.movable = q.movable[s.part];
  s.pmask = q.pmask[s.part];
  s.off = q.off[base + clampi(s.cand_slot, 0, S - 1)];
  for (int k = 0; k < kR; ++k) {
    s.lead[k] = q.leader_load[s.part * kR + k];
    s.foll[k] = q.follower_load[s.part * kR + k];
  }
  for (int k = 0; k < S; ++k) {
    const int a = q.assignment[base + k];
    s.slot_b[k] = a;
    s.slot_rack[k] = q.rack[clampi(a, 0, q.B - 1)];
  }
}

// Move row (row, col) of the grid from its staged source.
CC_HD void move_row(const GridParams& q, const Source& s, int row, int col) {
  const int B = q.B;
  const int c0 = q.k_dst + q.extra;
  const int i = row * c0 + col;
  const bool in_panel = col < q.k_dst;
  const int dst_b = in_panel ? q.dst_idx[col] : q.t_dst[row];
  const bool cvalid =
      (in_panel ? (s.src_valid && F_ISFINITE(q.dst_val[col]))
                : (s.src_valid && q.t_ok[row])) &&
      q.move_block_ok;
  const int src_slot = s.cand_slot;
  const int src_b = s.src_b;
  const bool moving_leader = src_slot == s.lead_slot;
  const bool src_exists = src_slot >= 0 && src_b >= 0;
  const bool dst_in_range = dst_b >= 0 && dst_b < B;
  const int dst_safe = clampi(dst_b, 0, B - 1);
  const Staged c{q, s, q.panel + q.k_dst + q.extra * q.k_src + row,
                 q.panel + (in_panel ? col : q.k_dst + row), panel_width(q)};
  const bool dst_alive = c.dst_core(kAlive) != 0u && dst_in_range;
  bool hosts = false;
  for (int t = 0; t < q.S; ++t) hosts = hosts || s.slot_b[t] == dst_b;
  const bool src_offline = c.src_core(kAlive) == 0u;
  const bool lead_dst_ok =
      !moving_leader || src_offline || c.dst_core(kAllowLd) != 0u;
  const bool move_ok = !hosts && c.dst_core(kAllowRm) != 0u &&
                       src_b != dst_b && lead_dst_ok;
  const bool valid = cvalid && s.movable && src_exists && dst_alive && move_ok;
  Row r;
  r.part = s.part;
  r.topic = s.topic;
  r.valid = valid;
  r.src = valid ? src_b : 0;
  r.dst = valid ? dst_safe : 0;
  r.src_slot = valid ? src_slot : 0;
  r.dst_slot = 0;
  r.rd = valid ? 1 : 0;
  r.ld = valid ? (moving_leader ? 1 : 0) : 0;
  for (int k = 0; k < kR; ++k)
    r.d[k] = valid ? (moving_leader ? s.lead[k] : s.foll[k]) : 0.0f;
  write_row(q, i, r, true);
  score_row(c, r, i);
}

// Panel entry e: field f at column c's broker (a destination, a targeted
// destination or a source row's broker), clamped to [0, B).
CC_HD void panel_entry(const GridParams& q, long long e) {
  const long long w = panel_width(q);
  const int f = static_cast<int>(e / w);
  const int c = static_cast<int>(e % w);
  int b;
  if (c < q.k_dst) {
    b = q.dst_idx[c];
  } else if (c < q.k_dst + q.extra * q.k_src) {
    b = q.t_dst[c - q.k_dst];
  } else {
    const int row = c - q.k_dst - q.extra * q.k_src;
    const int cs = q.cand_s[row];
    b = q.assignment[static_cast<long long>(q.cand_p[row]) * q.S +
                     (cs > 0 ? cs : 0)];
  }
  q.panel[e] = field_word(q, f, clampi(b, 0, q.B - 1));
}

CC_HD void recheck_row(const GridParams& q, int i) {
  Row r;
  r.part = q.partition[i];
  r.src = q.src_broker[i];
  r.dst = q.dst_broker[i];
  r.topic = q.topic_out[i];
  r.src_slot = q.src_slot[i];
  r.dst_slot = q.dst_slot[i];
  r.rd = q.replica_delta[i];
  r.ld = q.leader_delta[i];
  r.valid = q.valid[i];
  Pre pre;
  for (int k = 0; k < kR; ++k) {
    r.d[k] = q.load_delta[static_cast<long long>(i) * kR + k];
    pre.src_load[k] = q.pre_src_load[static_cast<long long>(i) * kR + k];
    pre.dst_load[k] = q.pre_dst_load[static_cast<long long>(i) * kR + k];
  }
  pre.src_count = q.pre[0][i];
  pre.dst_count = q.pre[1][i];
  pre.src_leaders = q.pre[2][i];
  pre.dst_leaders = q.pre[3][i];
  pre.src_topic_count = q.pre[4][i];
  pre.dst_topic_count = q.pre[5][i];
  pre.src_topic_leaders = q.pre[6][i];
  pre.dst_pot = q.pre[7][i];
  pre.dst_lbi = q.pre[8][i];
  const Direct c{q, r.part, r.src, r.dst};
  bool a = true;
  for (int g = 0; g < q.n_goals; ++g) {
    const bool prior = (q.prior_mask >> g) & 1u;
    if (!prior && g != q.active) continue;
    const bool acc = accept_goal(c, g, r, pre);
    if (prior) a = a && acc;
    if (g == q.active) a = a && (!q.has_earlier[i] || acc);
  }
  q.accept[i] = a;
}

// Sources a group stages: about kGroupRows rows, at most kMaxGroup.
inline int group_sources(const GridParams& q) {
  const int c0 = q.k_dst + q.extra;
  const int ns = c0 > 0 ? (kGroupRows + c0 - 1) / c0 : 1;
  return ns < 1 ? 1 : (ns > kMaxGroup ? kMaxGroup : ns);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kThreads)
    panel_kernel(const __grid_constant__ GridParams q) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e < q.n_fields * panel_width(q)) panel_entry(q, e);
}

// Block g < groups stages the move block's source group g and runs its
// rows; the blocks after them run the leadership block, one thread a row.
// At most 64 registers a thread: four CTAs on an SM.
__global__ void __launch_bounds__(kThreads, 4)
    score_grid_kernel(const __grid_constant__ GridParams q, int groups,
                      int ns) {
  __shared__ Source src[kMaxGroup];
  if (static_cast<int>(blockIdx.x) >= groups) {
    const int j = (blockIdx.x - groups) * kThreads + threadIdx.x;
    if (j < q.k_l * q.S) lead_row(q, j);
    return;
  }
  const int c0 = q.k_dst + q.extra;
  const int row0 = blockIdx.x * ns;
  const int rows = min(ns, q.k_src - row0);
  if (static_cast<int>(threadIdx.x) < rows)
    stage_source(q, row0 + threadIdx.x, src[threadIdx.x]);
  __syncthreads();
  for (int t = threadIdx.x; t < rows * c0; t += kThreads)
    move_row(q, src[t / c0], row0 + t / c0, t % c0);
}

__global__ void __launch_bounds__(kThreads)
    recheck_kernel(const __grid_constant__ GridParams q) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < q.n) recheck_row(q, i);
}
#endif

// The goal arrays a family reads at a broker, as bits (analyzer/
// score_grid.py FAMILY_ARRAYS, the "B" entries).
int broker_arrays(int family) {
  switch (family) {
    case kResourceCapacity:
    case kPotentialNwOut:
    case kLeaderBytesIn:
    case kBrokerSetAware:
      return 1;
    case kResourceDistribution:
      return 3;
    case kKafkaAssignerRack:
      return 2;
    default:
      return 0;
  }
}

bool params_ok(const GridParams* q) {
  bool ok = q->n >= 0 && q->S >= 1 && q->S <= kMaxS && q->B >= 1 &&
            q->n_goals >= 0 && q->n_goals <= kMaxGoals &&
            (q->mode == 0 || q->mode == 1) && q->active >= 0 &&
            q->active < q->n_goals;
  if (ok && q->mode == 0) {
    ok = q->n_fields >= kCore && q->n_fields <= kMaxFields &&
         q->k_src >= 0 && q->k_dst >= 0 && q->k_l >= 0 &&
         (q->extra == 0 || q->extra == 1) &&
         static_cast<long long>(q->k_src) * (q->k_dst + q->extra) +
                 static_cast<long long>(q->k_l) * q->S ==
             q->n;
    for (int f = 0; ok && f < q->n_fields; ++f) {
      const int code = q->field[f];
      ok = f < kCore ? code == f
                     : (code >= kCore && code < kCore + 4 * q->n_goals &&
                        q->goal_slot[code - kCore] == f);
    }
    // Every [B] array of every goal has its panel slot.
    for (int g = 0; ok && g < q->n_goals; ++g)
      for (int k = 0; ok && k < 4; ++k) {
        const int f = q->goal_slot[g * 4 + k];
        ok = ((broker_arrays(q->goals[g].family) >> k) & 1)
                 ? (f >= kCore && f < q->n_fields)
                 : f == -1;
      }
  }
  return ok;
}

}  // namespace

extern "C" int cc_score_grid_max_goals() { return kMaxGoals; }

extern "C" long long cc_score_grid_params_bytes() {
  return static_cast<long long>(sizeof(GridParams));
}

#ifdef __CUDACC__
// Grid mode (q->mode 0: the panel, then the rows) or recheck mode (1) over
// q->n rows on `stream`.
extern "C" int cc_score_grid(const GridParams* q, void* stream_) {
  if (!params_ok(q)) return static_cast<int>(cudaErrorInvalidValue);
  if (q->n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (q->mode == 1) {
    recheck_kernel<<<(q->n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        *q);
    return static_cast<int>(cudaGetLastError());
  }
  const long long entries = q->n_fields * panel_width(*q);
  panel_kernel<<<entries > 0 ? static_cast<int>((entries + kThreads - 1) /
                                                kThreads)
                             : 1,
                 kThreads, 0, stream>>>(*q);
  const int ns = group_sources(*q);
  const int groups = (q->k_src + ns - 1) / ns;
  const int lead_ctas = (q->k_l * q->S + kThreads - 1) / kThreads;
  if (groups + lead_ctas > 0)
    score_grid_kernel<<<groups + lead_ctas, kThreads, 0, stream>>>(*q, groups,
                                                                    ns);
  return static_cast<int>(cudaGetLastError());
}
#else
// The same functions on the host, in the kernels' order: the panel, then
// each source group (its sources, their items, its rows), then the
// leadership rows; or the recheck rows.
extern "C" int cc_score_grid_host(const GridParams* q) {
  if (!params_ok(q)) return 1;
  if (q->mode == 1) {
    for (int i = 0; i < q->n; ++i) recheck_row(*q, i);
    return 0;
  }
  for (long long e = 0; e < q->n_fields * panel_width(*q); ++e)
    panel_entry(*q, e);
  const int ns = group_sources(*q);
  const int c0 = q->k_dst + q->extra;
  static Source src[kMaxGroup];
  for (int row0 = 0; row0 < q->k_src; row0 += ns) {
    const int rows = q->k_src - row0 < ns ? q->k_src - row0 : ns;
    for (int t = 0; t < rows; ++t) stage_source(*q, row0 + t, src[t]);
    for (int t = 0; t < rows * c0; ++t)
      move_row(*q, src[t / c0], row0 + t / c0, t % c0);
  }
  for (int j = 0; j < q->k_l * q->S; ++j) lead_row(*q, j);
  return 0;
}
#endif
