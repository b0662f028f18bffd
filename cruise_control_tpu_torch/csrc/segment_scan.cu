// KD2: the direct-assignment transport's segmented scan (segment_scan).
//
// Replaces the reference's _segment_starts / _segment_rank /
// _segment_exclusive (cruise_control_tpu/analyzer/direct.py:222-246) and
// the guard checks built on them (direct.py:273, 307, 518, 776-858,
// 874-907) with their un-permuting verdict scatters
// ``sel &= zeros.at[idx].set(ok)``: XLA-lowered cumsums, cummaxes and
// scatters, not Pallas kernels.
//
// What it computes, for sorted int32 keys [N] and non-negative values
// [N, R] (R <= 4, f32 or int32), column by column:
//   incl = cumsum(values)             (XLA:CPU's association, below)
//   m    = start ? incl - values : 0  (start: first element of its key run)
//   base = cummax(m)
//   excl = (incl - values) - base     (the exclusive sum within the run)
// and, with checks, each element's verdict: the AND over the checks of
//   cap:   base_tab[key] + (excl[col] + own) <= limit[key] + 1e-6
//   floor: base_tab[key] - (excl[col] + own) >= limit[key] - 1e-6
// (own: values[own_col], or 1.0; an element a check's gate leaves out
// passes it), written at the element's original position perm[i].
//
// The association. XLA:CPU blocks an f32 cumsum by 16: level L's sequence
// S_L (S_0 the values, S_{L+1} the totals of S_L's blocks of 16, the last
// block padded with zeros) has inner prefixes, sequential inside each
// block, and incl_L[x] = inner_L[x] + incl_{L+1}[x / 16 - 1] (+ 0.0 for
// the first block) when S_L has more than 16 entries, else inner_L[x]
// (utils/numerics.py::xla_cumsum). A tile of 16^3 = 4,096 elements is one
// block of level 2: its levels 0-2 inner prefixes are its own, and an
// element's inclusive sum needs from outside the tile only incl_3 of the
// tile before it (OFF), the level-2 inclusive value of the previous
// tile's last level-1 block (P2) and the level-1 inclusive value of its
// last level-0 block (P1). Those three follow from the previous tile's
// last two level-2 inner prefixes and last level-1 inner prefix and the
// scan of the tile totals, which is the same association one level up;
// so every add is the reference's add and no look-back reorders it. The
// running maximum is exact in any order (a tile's maximum and a carry
// over the tiles before it). No multiply feeds an add, so no contraction
// can change a rounding. int32 sums are exact (modulo 2**32) in any order
// and go the same way.
//
// Bound on this card: bytes -- the keys and the N * R values read once,
// the N * R sums and the verdicts written once: 0.0369 ms for 3M x 4 f32
// with checks at 7k brokers / 1M partitions, at 3.35 TB/s.
//
// Design: one cooperative launch (every CTA co-resident), no memset.
//  1. levels: each CTA stages its tiles' values in shared memory (a
//     column a row, a word of padding every 16 so a thread's block of 16
//     reads without bank conflicts), a thread a level-0 block sums its 16
//     values, 16 threads a column the level-1 blocks, one thread a column
//     the level-2 block; the tile's boundary prefixes go to global memory,
//     and the CTAs zero the running-maximum look-back words.
//  2. after a grid barrier, CTA 0 scans the tile totals (the same 16-
//     blocked recursion); each tile's OFF, P2 and P1 follow from that scan
//     and the previous tile's prefixes, read by the CTA that needs them.
//  3. after a second barrier, each CTA restages its tiles (values and
//     keys: values read twice, keys once), adds the offsets level by
//     level, takes each thread's running maximum of the segment starts,
//     the CTA's prefix of those and, by decoupled look-back over the
//     tiles before (a warp a column, 32 tiles a round trip: the tiles of
//     a wave publish together, so a one-tile walk would cost a round trip
//     a tile of the wave), the carry; then writes the exclusive sums
//     through shared memory as coalesced runs; the walk also judges each
//     element's checks (its values still in registers) and the verdicts
//     are scattered through perm (read in runs). Checks on the same sum
//     (column, own column, base, gate, direction) are one comparison with
//     their tightest limit a key, which each tile stages in shared memory
//     for its keys when they span few enough (else the walk reads them).
// Per call: one launch.
//
// The file also compiles as host C++ (without __CUDACC__): the same phase
// code runs with one "thread" that walks each phase's items in order, the
// CTAs' tiles in turn between the barriers, so the look-back finds its
// predecessors published (cc_segment_scan_host), which the CPU tests hold
// against the twin.
#include <cstdint>
#include <cstring>
#include <type_traits>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
#define CC_HD __device__ __forceinline__
#define CC_UNROLL _Pragma("unroll")
#define CC_UNROLL2 _Pragma("unroll 2")
#define TID static_cast<int>(threadIdx.x)
#define BARRIER() __syncthreads()
#else
#include <vector>
#define CC_HD static inline
#define CC_UNROLL
#define CC_UNROLL2
#define TID 0
#define BARRIER() ((void)0)
#endif

namespace {

constexpr int kMaxChecks = 12;
constexpr int kTile = 4096;            // 16^3 elements: a level-2 block
constexpr int kL0 = kTile / 16;        // level-0 blocks a tile
constexpr int kL1 = kL0 / 16;          // level-1 blocks a tile
constexpr int kPad = kTile + kTile / 16;
constexpr int kStride = kPad + 8;      // a column's row in shared memory
#ifdef __CUDACC__
constexpr int kT = 256;                // a thread a level-0 block
static_assert(kT == kL0, "a thread a level-0 block");
#else
constexpr int kT = 1;
#endif
constexpr int kMaxCtas = 2048;
constexpr int kStageGroups = 4;   // check groups whose tables a tile stages
constexpr int kKeyStage = 256;    // ... over at most this many keys

}  // namespace

// The parameter block, passed by value (its layout is checked from
// Python through the params_bytes entry).
struct Desc {
  int column, own_column, floor, pad;
  const float* base;
  const float* limit;
  const uint8_t* gate;
};

struct ScanParams {
  long long n;
  int R, is_int, num_checks, pad;
  const int* keys;
  const void* values;
  void* excl;
  const int* perm;
  uint8_t* verdict;
  void* scratch;
  Desc checks[kMaxChecks];
};

namespace {

// Checks that read the same sum (column, own column, base table, gate)
// in the same direction: their verdict is one comparison against the
// tightest of their limits, per key.
struct Group {
  int column, own_column, floor, count;
  const float* base;
  const uint8_t* gate;
  const float* limit[kMaxChecks];
};

// Adds that wrap for int32 (exact modulo 2**32, as the twin's cumsum).
template <typename T>
CC_HD T add(T a, T b) {
  if constexpr (std::is_same<T, int>::value)
    return static_cast<int>(static_cast<uint32_t>(a) +
                            static_cast<uint32_t>(b));
  else
    return a + b;
}

template <typename T>
CC_HD T sub(T a, T b) {
  if constexpr (std::is_same<T, int>::value)
    return static_cast<int>(static_cast<uint32_t>(a) -
                            static_cast<uint32_t>(b));
  else
    return a - b;
}

// The running maximum keeps the later of equal values, as torch.cummax.
template <typename T>
CC_HD T later_max(T run, T x) { return x >= run ? x : run; }

template <typename T>
CC_HD uint32_t to_bits(T x) {
  uint32_t b;
#ifdef __CUDACC__
  if constexpr (std::is_same<T, int>::value) b = static_cast<uint32_t>(x);
  else b = __float_as_uint(x);
#else
  std::memcpy(&b, &x, sizeof b);
#endif
  return b;
}

template <typename T>
CC_HD T from_bits(uint32_t b) {
  T x;
#ifdef __CUDACC__
  if constexpr (std::is_same<T, int>::value) x = static_cast<int>(b);
  else x = __uint_as_float(b);
#else
  std::memcpy(&x, &b, sizeof x);
#endif
  return x;
}

// The least value: the running maximum's start.
template <typename T>
CC_HD T lowest() {
  return from_bits<T>(std::is_same<T, int>::value ? 0x80000000u
                                                   : 0xff800000u);
}

// The scan's working set in global scratch.
template <typename T>
struct Work {
  int tiles;
  int add0, add1, add2;    // levels 0-2 hold more than 16 entries
  T* tail;     // [tiles][R][3]: inner2[15] (the tile total), inner2[14], inner1[255]
  T* levels;   // the tile totals' scan and its levels
  unsigned long long* look;   // [tiles][R]: flag << 32 | max bits
};

constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

template <typename T, int R>
struct TileSmem {
  T v[R][kStride];      // values, then the exclusive sums; e at e + e / 16
  int key[kPad];        // keys, the same layout
  T l1[R][kL0];         // level-0 totals, level-1 inner, level-1 inclusive
  T l2[R][kL1];         // level-1 totals, level-2 inner, level-2 inclusive
  T tmax[R][kL0];       // each level-0 block's maximum, then its prefix
  T warp_max[R][kL0 / 32];
  T carry[R];
  T bound[R][3];        // the tile's OFF, P2, P1 (tile_bounds)
  Group groups[kMaxChecks];  // the checks, grouped, read from here (a
                             // reference into the parameter block would
                             // copy it to local memory)
  float thr[kStageGroups][kKeyStage];   // a staged group's limit a key
  float tab[kStageGroups][kKeyStage];   // ... and its base entry
  uint8_t ok[kTile];                    // each element's verdict
  int num_groups, key_lo, staged;
  int before;           // the key of the element before the tile
};

CC_HD int at(int e) { return e + (e >> 4); }

// The tile's values (and with keys, its keys) into shared memory;
// elements past N read as 0. Four columns load as one 16-byte word an
// element, keys four to a word (a full tile from a 16-byte aligned array;
// else word by word).
template <typename T, int R>
CC_HD void stage(const ScanParams& p, TileSmem<T, R>& sm, int tile,
                 bool keys) {
  const long long base = static_cast<long long>(tile) * kTile;
  const int count = p.n - base < kTile ? static_cast<int>(p.n - base) : kTile;
  const T* vals = static_cast<const T*>(p.values) + base * R;
#ifdef __CUDACC__
  const bool full = count == kTile;
  if (R == 4 && full && (reinterpret_cast<uintptr_t>(vals) & 15) == 0) {
    for (int e = TID; e < kTile; e += kT) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(vals) + e);
      sm.v[0][at(e)] = from_bits<T>(static_cast<uint32_t>(x.x));
      sm.v[R > 1 ? 1 : 0][at(e)] = from_bits<T>(static_cast<uint32_t>(x.y));
      sm.v[R > 2 ? 2 : 0][at(e)] = from_bits<T>(static_cast<uint32_t>(x.z));
      sm.v[R > 3 ? 3 : 0][at(e)] = from_bits<T>(static_cast<uint32_t>(x.w));
    }
  } else
#endif
  {
    for (int q = TID; q < kTile * R; q += kT) {
      const int e = q / R, r = q % R;
      sm.v[r][at(e)] = e < count ? vals[q] : T(0);
    }
  }
  if (keys) {
    const int* kp = p.keys + base;
#ifdef __CUDACC__
    if (full && (reinterpret_cast<uintptr_t>(kp) & 15) == 0) {
      for (int q = TID; q < kTile / 4; q += kT) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(kp) + q);
        sm.key[at(4 * q)] = x.x;
        sm.key[at(4 * q + 1)] = x.y;
        sm.key[at(4 * q + 2)] = x.z;
        sm.key[at(4 * q + 3)] = x.w;
      }
    } else
#endif
    {
      for (int e = TID; e < count; e += kT) sm.key[at(e)] = kp[e];
    }
    if (TID == 0) sm.before = base > 0 ? p.keys[base - 1] : 0;
  }
  BARRIER();
}

// Levels 0-2 of the staged tile: l1 = level-1 inner prefixes of the
// level-0 totals, l2 = level-2 inner prefixes of the level-1 totals.
template <typename T, int R>
CC_HD void tile_levels(TileSmem<T, R>& sm) {
  for (int t = TID; t < kL0; t += kT)
CC_UNROLL
    for (int r = 0; r < R; ++r) {
      const T* x = &sm.v[r][17 * t];
      T acc = x[0];
      for (int k = 1; k < 16; ++k) acc = add(acc, x[k]);
      sm.l1[r][t] = acc;
    }
  BARRIER();
  // The in-place prefixes read their 16 entries first (stores between
  // the reads would make each read wait for the store before it).
  for (int q = TID; q < kL1 * R; q += kT) {
    const int r = q / kL1, x = q % kL1;
    T* y = &sm.l1[r][16 * x];
    T z[16];
CC_UNROLL
    for (int k = 0; k < 16; ++k) z[k] = y[k];
CC_UNROLL
    for (int k = 1; k < 16; ++k) y[k] = z[k] = add(z[k - 1], z[k]);
    sm.l2[r][x] = z[15];
  }
  BARRIER();
  for (int r = TID; r < R; r += kT) {
    T z[kL1];
CC_UNROLL
    for (int k = 0; k < kL1; ++k) z[k] = sm.l2[r][k];
CC_UNROLL
    for (int k = 1; k < kL1; ++k) sm.l2[r][k] = z[k] = add(z[k - 1], z[k]);
  }
  BARRIER();
}

// 1. A tile's levels and its boundary prefixes.
template <typename T, int R>
CC_HD void phase_levels(const ScanParams& p, const Work<T>& w,
                        TileSmem<T, R>& sm, int tile) {
  stage(p, sm, tile, false);
  tile_levels(sm);
  for (int r = TID; r < R; r += kT) {
    T* tl = w.tail + (static_cast<size_t>(tile) * R + r) * 3;
    tl[0] = sm.l2[r][15];
    tl[1] = sm.l2[r][14];
    tl[2] = sm.l1[r][kL0 - 1];
  }
  BARRIER();
}

// 2. The tile totals' inclusive scan in XLA's association (one CTA), then
// each tile's OFF, P2 and P1.
template <typename T, int R>
CC_HD void phase_upper(const Work<T>& w) {
  int m[8];
  T* a[8];
  m[0] = w.tiles;
  a[0] = w.levels;
  for (int q = TID; q < w.tiles * R; q += kT) a[0][q] = w.tail[q * 3];
  BARRIER();
  int top = 0;
  while (m[top] > 16) {
    const int nb = (m[top] + 15) / 16;
    a[top + 1] = a[top] + static_cast<size_t>(m[top]) * R;
    for (int q = TID; q < nb * R; q += kT) {
      const int j = q / R, r = q % R;
      T x[16];
CC_UNROLL
      for (int k = 0; k < 16; ++k)
        x[k] = 16 * j + k < m[top] ? a[top][(16 * j + k) * R + r] : T(0);
      T acc = x[0];
CC_UNROLL
      for (int k = 0; k < 16; ++k) {
        if (k > 0) acc = add(acc, x[k]);
        if (16 * j + k < m[top]) a[top][(16 * j + k) * R + r] = acc;
      }
      a[top + 1][q] = acc;
    }
    BARRIER();
    m[top + 1] = nb;
    ++top;
  }
  for (int r = TID; r < R; r += kT)
    for (int x = 1; x < m[top]; ++x)
      a[top][x * R + r] = add(a[top][(x - 1) * R + r], a[top][x * R + r]);
  BARRIER();
  for (int l = top - 1; l >= 0; --l) {
    for (int q = TID; q < m[l] * R; q += kT) {
      const int j = q / R / 16, r = q % R;
      a[l][q] = add(a[l][q], j == 0 ? T(0) : a[l + 1][(j - 1) * R + r]);
    }
    BARRIER();
  }
  // w.levels[t * R + r] now holds incl_3 of tile t.
}

// Tile `tile`'s OFF, P2 and P1 of column r from the tile totals' scan
// (w.levels) and the previous tile's boundary prefixes.
template <typename T>
CC_HD void tile_bounds(const Work<T>& w, int R, int tile, int r, T* b) {
  const T* incl3 = w.levels;
  b[0] = tile == 0 ? T(0) : incl3[(tile - 1) * R + r];
  b[1] = b[2] = T(0);
  if (tile >= 1) {
    // The previous tile's level-2 offset; levels 1 and 2 hold more than
    // 16 entries once there are two tiles.
    const T off = tile == 1 ? T(0) : incl3[(tile - 2) * R + r];
    const T* tl = w.tail + (static_cast<size_t>(tile - 1) * R + r) * 3;
    b[1] = add(tl[0], off);
    b[2] = add(tl[2], add(tl[1], off));
  }
}

// --- 3. the tile's sums, maxima, exclusive sums and checks -------------------

CC_HD void publish(unsigned long long* word, unsigned long long v) {
#ifdef __CUDACC__
  *reinterpret_cast<volatile unsigned long long*>(word) = v;
#else
  *word = v;
#endif
}

#ifdef __CUDACC__
// The carry of column r over the tiles before `tile`, by one warp: lane j
// reads the word of the j-th tile back, 32 tiles a round trip, until a
// round holds an inclusive word (the nearest one ends the walk). The
// maximum is exact in any order.
template <typename T>
__device__ T warp_look_back(const Work<T>& w, int R, int tile, int r) {
  const int lane = TID & 31;
  T carry = lowest<T>();
  for (int t0 = tile - 1; t0 >= 0; t0 -= 32) {
    const int t = t0 - lane;
    const unsigned long long* at_w = w.look + static_cast<size_t>(t) * R + r;
    unsigned long long s = kInclusive;
    if (t >= 0) s = *reinterpret_cast<const volatile unsigned long long*>(at_w);
    while (__any_sync(0xffffffffu, (s >> 32) == 0ull))
      if ((s >> 32) == 0ull)
        s = *reinterpret_cast<const volatile unsigned long long*>(at_w);
    const unsigned incl = __ballot_sync(0xffffffffu, (s & kInclusive) != 0);
    const int stop = incl != 0u ? __ffs(incl) - 1 : 31;
    T v = t >= 0 && lane <= stop ? from_bits<T>(static_cast<uint32_t>(s))
                                 : lowest<T>();
CC_UNROLL
    for (int o = 16; o > 0; o >>= 1)
      v = later_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    carry = later_max(v, carry);
    if (incl != 0u) break;
  }
  return carry;
}
#endif

template <typename T>
CC_HD T look_back(const Work<T>& w, int R, int tile, int r) {
  T carry = lowest<T>();
  for (int t = tile - 1; t >= 0; --t) {
    const unsigned long long* at_w = w.look + static_cast<size_t>(t) * R + r;
    unsigned long long s;
    do {
#ifdef __CUDACC__
      s = *reinterpret_cast<const volatile unsigned long long*>(at_w);
#else
      s = *at_w;
#endif
    } while ((s >> 32) == 0ull);
    // Earlier tiles first in the order of the elements: the later value
    // wins a tie.
    carry = later_max(from_bits<T>(static_cast<uint32_t>(s)), carry);
    if (s & kInclusive) break;
  }
  return carry;
}

template <typename W>
CC_HD W read_only(const W* p, long long i) {
#ifdef __CUDACC__
  return __ldg(p + i);
#else
  return p[i];
#endif
}

// The tightest limit of a group for one key: the least of the caps'
// limit + 1e-6, the greatest of the floors' limit - 1e-6 (a NaN limit
// makes the group fail, as it makes its check fail).
CC_HD float group_limit(const Group& gr, int key) {
  float out = 0.0f;
  for (int m = 0; m < gr.count; ++m) {
    const float lim = read_only(gr.limit[m], key);
    const float edge = gr.floor ? lim - 1e-6f : lim + 1e-6f;
    if (m == 0 || edge != edge) out = edge;   // the first, or a NaN
    else if (out == out) out = gr.floor ? (edge > out ? edge : out)
                                        : (edge < out ? edge : out);
  }
  return out;
}

// The checks grouped, by thread 0 of each CTA, once a call.
CC_HD void group_checks(const ScanParams& p, Group* groups, int* num) {
  int n = 0;
  for (int c = 0; c < p.num_checks; ++c) {
    const Desc d = p.checks[c];
    int g = 0;
    while (g < n && !(groups[g].column == d.column &&
                      groups[g].own_column == d.own_column &&
                      groups[g].floor == d.floor &&
                      groups[g].base == d.base && groups[g].gate == d.gate))
      ++g;
    if (g == n) {
      groups[n] = Group{d.column, d.own_column, d.floor, 0, d.base, d.gate,
                        {}};
      ++n;
    }
    groups[g].limit[groups[g].count++] = d.limit;
  }
  *num = n;
}

// The element's verdict: every group's sum against its tightest limit
// (staged for the tile's keys, or read), a gated group passing where its
// gate is off. Each check compared x = base +- (pre[col] + own) with its
// own limit +- 1e-6; x is the same for a group, so the AND is one
// comparison with the tightest.
template <typename T, int R>
CC_HD bool judge(const TileSmem<T, R>& sm, const float (&pre)[R],
                 const float (&val)[R], int key, long long i) {
  bool ok = true;
  for (int g = 0; g < sm.num_groups; ++g) {
    const Group& gr = sm.groups[g];
    float own = 1.0f, pc = pre[0];
CC_UNROLL
    for (int r = 0; r < R; ++r) {
      if (r == gr.own_column) own = val[r];
      if (r == gr.column) pc = pre[r];
    }
    const float tt = pc + own;
    float tab, lim;
    if (sm.staged) {
      tab = sm.tab[g][key - sm.key_lo];
      lim = sm.thr[g][key - sm.key_lo];
    } else {
      tab = gr.base != nullptr ? read_only(gr.base, key) : 0.0f;
      lim = group_limit(gr, key);
    }
    const bool cond = gr.floor ? (tab - tt >= lim) : (tab + tt <= lim);
    ok &= cond || (gr.gate != nullptr && read_only(gr.gate, i) == 0);
  }
  return ok;
}

// A staged tile's groups, their fields in registers for a whole walk.
struct StagedGroups {
  int num, column[kStageGroups], own[kStageGroups], floor[kStageGroups];
  const uint8_t* gate[kStageGroups];
};

template <typename T, int R>
CC_HD StagedGroups staged_groups(const TileSmem<T, R>& sm) {
  StagedGroups sg{};
  sg.num = sm.num_groups;
CC_UNROLL
  for (int g = 0; g < kStageGroups; ++g) {
    const Group& gr = sm.groups[g < sg.num ? g : 0];
    sg.column[g] = gr.column;
    sg.own[g] = gr.own_column;
    sg.floor[g] = gr.floor;
    sg.gate[g] = gr.gate;
  }
  return sg;
}

// Column c of a row held as scalars (a select, no indexing, so the row
// stays in registers).
CC_HD float column_of(int c, float x0, float x1, float x2, float x3) {
  return c == 0 ? x0 : c == 1 ? x1 : c == 2 ? x2 : x3;
}

// judge() on a staged tile: the same comparisons, the groups' fields from
// registers (every slot evaluated, the ones past num masked), their limits
// and base entries from shared memory.
template <typename T, int R>
CC_HD bool judge_staged(const TileSmem<T, R>& sm, const StagedGroups& sg,
                        const float (&pre)[R], const float (&val)[R],
                        int key, long long i) {
  const float p0 = pre[0], p1 = pre[R > 1 ? 1 : 0], p2 = pre[R > 2 ? 2 : 0],
              p3 = pre[R > 3 ? 3 : 0];
  const float v0 = val[0], v1 = val[R > 1 ? 1 : 0], v2 = val[R > 2 ? 2 : 0],
              v3 = val[R > 3 ? 3 : 0];
  const int at_key = key - sm.key_lo;
  bool ok = true;
CC_UNROLL
  for (int g = 0; g < kStageGroups; ++g) {
    const bool live = g < sg.num;
    const float own = sg.own[g] >= 0 ? column_of(sg.own[g], v0, v1, v2, v3)
                                     : 1.0f;
    const float tt = column_of(sg.column[g], p0, p1, p2, p3) + own;
    const float tab = sm.tab[g][at_key], lim = sm.thr[g][at_key];
    const bool cond = sg.floor[g] ? (tab - tt >= lim) : (tab + tt <= lim);
    ok &= !live || cond ||
          (sg.gate[g] != nullptr && read_only(sg.gate[g], i) == 0);
  }
  return ok;
}

// One level-0 block's elements in order: their inclusive and exclusive
// sums; `run` carries each column's running maximum of the starts (from
// `carry` on), and with `finish` the exclusive sums replace the values.
template <typename T, int R, bool kFinish>
CC_HD void walk_block(const ScanParams& p, const Work<T>& w,
                      TileSmem<T, R>& sm, int tile, int t, T (&run)[R]) {
  const long long base = static_cast<long long>(tile) * kTile;
  const int count = p.n - base < kTile ? static_cast<int>(p.n - base) : kTile;
  T off[R], acc[R] = {};
CC_UNROLL
  for (int r = 0; r < R; ++r)
    off[r] = t >= 1 ? sm.l1[r][t - 1] : sm.bound[r][2];
  int prev = t >= 1 ? sm.key[at(16 * t - 1)] : sm.before;
  constexpr bool kChecks = kFinish && std::is_floating_point<T>::value;
  const bool checks = kChecks && p.num_checks > 0;
  StagedGroups sg{};
  if constexpr (kChecks)
    if (checks && sm.staged) sg = staged_groups(sm);
  // Element k + 1's values and key are read before element k's sums are
  // stored over its values (the compiler cannot tell the two apart, and
  // would otherwise wait for each read in turn).
  T next[R];
  int next_key = sm.key[at(16 * t)];
CC_UNROLL
  for (int r = 0; r < R; ++r) next[r] = sm.v[r][at(16 * t)];
  // Unrolled by two, not sixteen: the walk, with the judging inlined,
  // would otherwise outgrow the instruction cache.
CC_UNROLL2
  for (int k = 0; k < 16; ++k) {
    const int e = 16 * t + k;
    const int key = next_key;
    T pre[R], val[R];
CC_UNROLL
    for (int r = 0; r < R; ++r) val[r] = next[r];
    if (k + 1 < 16) {
      next_key = sm.key[at(e + 1)];
CC_UNROLL
      for (int r = 0; r < R; ++r) next[r] = sm.v[r][at(e + 1)];
    }
    const bool start = (base + e == 0) || key != prev;
    prev = key;
CC_UNROLL
    for (int r = 0; r < R; ++r) {
      acc[r] = k == 0 ? val[r] : add(acc[r], val[r]);
      const T incl = w.add0 ? add(acc[r], off[r]) : acc[r];
      const T cum_ex = sub(incl, val[r]);
      run[r] = later_max(run[r], start ? cum_ex : T(0));
      pre[r] = sub(cum_ex, run[r]);
    }
    if constexpr (kFinish) {
      if (e >= count) continue;
      if constexpr (kChecks)
        if (checks)
          sm.ok[e] = (sm.staged ? judge_staged<T, R>(sm, sg, pre, val, key,
                                                     base + e)
                                : judge<T, R>(sm, pre, val, key, base + e))
                         ? 1 : 0;
CC_UNROLL
      for (int r = 0; r < R; ++r) sm.v[r][at(e)] = pre[r];
    }
  }
}

template <typename T, int R>
CC_HD void phase_finish(const ScanParams& p, const Work<T>& w,
                        TileSmem<T, R>& sm, int tile) {
  const long long base = static_cast<long long>(tile) * kTile;
  const int count = p.n - base < kTile ? static_cast<int>(p.n - base) : kTile;
  for (int r = TID; r < R; r += kT) tile_bounds(w, R, tile, r, sm.bound[r]);
  stage(p, sm, tile, true);
  if constexpr (std::is_floating_point<T>::value) {
    if (p.num_checks > 0) {
      // The groups' limits and base entries for the tile's keys (sorted,
      // so a span), when few enough; else each element reads them.
      const int lo = sm.key[at(0)], span = sm.key[at(count - 1)] - lo + 1;
      const bool staged = sm.num_groups <= kStageGroups && span <= kKeyStage;
      for (int q = TID; staged && q < sm.num_groups * span; q += kT) {
        const int g = q / span, key = lo + q % span;
        const Group& gr = sm.groups[g];
        sm.thr[g][q % span] = group_limit(gr, key);
        sm.tab[g][q % span] =
            gr.base != nullptr ? read_only(gr.base, key) : 0.0f;
      }
      if (TID == 0) {
        sm.key_lo = lo;
        sm.staged = staged;
      }
      BARRIER();
    }
  }
  tile_levels(sm);
  // Level 2 inclusive, then level 1.
  for (int r = TID; r < R; r += kT)
    for (int x = 0; x < kL1; ++x)
      if (w.add2) sm.l2[r][x] = add(sm.l2[r][x], sm.bound[r][0]);
  BARRIER();
  for (int t = TID; t < kL0; t += kT)
CC_UNROLL
    for (int r = 0; r < R; ++r) {
      const int x = t / 16;
      const T prev2 = x >= 1 ? sm.l2[r][x - 1] : sm.bound[r][1];
      if (w.add1) sm.l1[r][t] = add(sm.l1[r][t], prev2);
    }
  BARRIER();
  // Each level-0 block's maximum of its starts.
  for (int t = TID; t < kL0; t += kT) {
    T run[R];
CC_UNROLL
    for (int r = 0; r < R; ++r) run[r] = lowest<T>();
    walk_block<T, R, false>(p, w, sm, tile, t, run);
CC_UNROLL
    for (int r = 0; r < R; ++r) sm.tmax[r][t] = run[r];
  }
  BARRIER();
  // The blocks' exclusive prefix maxima and the tile's maximum.
#ifdef __CUDACC__
  {
    const int lane = TID & 31, warp = TID >> 5;
    T incl[R];
CC_UNROLL
    for (int r = 0; r < R; ++r) {
      incl[r] = sm.tmax[r][TID];
CC_UNROLL
      for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, incl[r], o);
        if (lane >= o) incl[r] = later_max(y, incl[r]);
      }
      if (lane == 31) sm.warp_max[r][warp] = incl[r];
    }
    __syncthreads();
CC_UNROLL
    for (int r = 0; r < R; ++r) {
      T ex = lowest<T>();
      for (int q = 0; q < warp; ++q) ex = later_max(ex, sm.warp_max[r][q]);
      const T up = __shfl_up_sync(0xffffffffu, incl[r], 1);
      if (lane >= 1) ex = later_max(ex, up);
      sm.tmax[r][TID] = ex;
    }
  }
#else
  for (int r = 0; r < R; ++r) {
    T ex = lowest<T>();
    for (int t = 0; t < kL0; ++t) {
      const T mine = sm.tmax[r][t];
      sm.tmax[r][t] = ex;
      ex = later_max(ex, mine);
    }
    sm.warp_max[r][0] = ex;
  }
#endif
#ifdef __CUDACC__
  // Warp r publishes column r's tile maximum, looks back, publishes the
  // inclusive maximum.
  if ((TID >> 5) < R) {
    const int r = TID >> 5;
    T agg = lowest<T>();
    for (int q = 0; q < kL0 / 32; ++q) agg = later_max(agg, sm.warp_max[r][q]);
    unsigned long long* word = w.look + static_cast<size_t>(tile) * R + r;
    if ((TID & 31) == 0)
      publish(word, (tile == 0 ? kInclusive : kAggregate) | to_bits(agg));
    T carry = lowest<T>();
    if (tile > 0) {
      carry = warp_look_back(w, R, tile, r);
      if ((TID & 31) == 0)
        publish(word, kInclusive | to_bits(later_max(carry, agg)));
    }
    if ((TID & 31) == 0) sm.carry[r] = carry;
  }
#else
  for (int r = 0; r < R; ++r) {
    const T agg = sm.warp_max[r][0];
    unsigned long long* word = w.look + static_cast<size_t>(tile) * R + r;
    publish(word, (tile == 0 ? kInclusive : kAggregate) | to_bits(agg));
    T carry = lowest<T>();
    if (tile > 0) {
      carry = look_back(w, R, tile, r);
      publish(word, kInclusive | to_bits(later_max(carry, agg)));
    }
    sm.carry[r] = carry;
  }
#endif
  BARRIER();
  for (int t = TID; t < kL0; t += kT) {
    T run[R];
CC_UNROLL
    for (int r = 0; r < R; ++r) run[r] = later_max(sm.carry[r], sm.tmax[r][t]);
    walk_block<T, R, true>(p, w, sm, tile, t, run);
  }
  BARRIER();
  // The exclusive sums out, a thread an element (16-byte words when R is
  // 4).
  T* out = static_cast<T*>(p.excl) + base * R;
  for (int e = TID; e < count; e += kT) {
#ifdef __CUDACC__
    if (R == 4 && (reinterpret_cast<uintptr_t>(out) & 15) == 0)
      reinterpret_cast<int4*>(out)[e] = make_int4(
          static_cast<int>(to_bits(sm.v[0][at(e)])),
          static_cast<int>(to_bits(sm.v[R > 1 ? 1 : 0][at(e)])),
          static_cast<int>(to_bits(sm.v[R > 2 ? 2 : 0][at(e)])),
          static_cast<int>(to_bits(sm.v[R > 3 ? 3 : 0][at(e)])));
    else
#endif
CC_UNROLL
      for (int r = 0; r < R; ++r)
        out[static_cast<long long>(e) * R + r] = sm.v[r][at(e)];
  }
  // The verdicts, judged in the walk, scattered through perm (read in
  // runs).
  if constexpr (std::is_floating_point<T>::value)
    if (p.num_checks > 0)
      for (int e = TID; e < count; e += kT)
        p.verdict[read_only(p.perm, base + e)] = sm.ok[e];
  BARRIER();
}

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

int tiles_for(long long n) { return static_cast<int>((n + kTile - 1) / kTile); }

// Bytes of the tile totals' scan and its levels.
size_t level_bytes(int tiles, int R) {
  size_t words = 0;
  for (int m = tiles; ; m = (m + 15) / 16) {
    words += static_cast<size_t>(m) * R;
    if (m <= 16) break;
  }
  return align_up(words * 4);
}

size_t scratch_bytes(long long n, int R) {
  const int tiles = tiles_for(n);
  return align_up(static_cast<size_t>(tiles) * R * 3 * 4) +
         level_bytes(tiles, R) + align_up(static_cast<size_t>(tiles) * R * 8);
}

template <typename T>
Work<T> make_work(const ScanParams& p) {
  Work<T> w{};
  w.tiles = tiles_for(p.n);
  w.add0 = p.n > 16;
  w.add1 = (p.n + 15) / 16 > 16;
  w.add2 = (p.n + 255) / 256 > 16;
  char* s = static_cast<char*>(p.scratch);
  const size_t tb = align_up(static_cast<size_t>(w.tiles) * p.R * 3 * 4);
  w.tail = reinterpret_cast<T*>(s);
  w.levels = reinterpret_cast<T*>(s + tb);
  w.look = reinterpret_cast<unsigned long long*>(
      s + tb + level_bytes(w.tiles, p.R));
  return w;
}

bool params_ok(const ScanParams& p) {
  if (p.n <= 0 || p.n >= (1ll << 29) || p.R < 1 || p.R > 4 ||
      p.num_checks < 0 || p.num_checks > kMaxChecks ||
      (p.is_int && p.num_checks > 0))
    return false;
  for (int c = 0; c < p.num_checks; ++c) {
    const Desc& d = p.checks[c];
    if (d.column < 0 || d.column >= p.R || d.own_column >= p.R ||
        d.limit == nullptr || p.perm == nullptr || p.verdict == nullptr)
      return false;
  }
  return true;
}

#ifdef __CUDACC__
template <typename T, int R>
__global__ void __launch_bounds__(kT) scan_kernel(const ScanParams p,
                                                  const Work<T> w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<T, R>& sm = *reinterpret_cast<TileSmem<T, R>*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  for (int q = blockIdx.x * kT + TID; q < w.tiles * R; q += gridDim.x * kT)
    w.look[q] = 0ull;
  for (int tile = blockIdx.x; tile < w.tiles; tile += gridDim.x)
    phase_levels<T, R>(p, w, sm, tile);
  grid.sync();
  if (blockIdx.x == 0) phase_upper<T, R>(w);
  if constexpr (std::is_floating_point<T>::value)
    if (TID == 0 && p.num_checks > 0)
      group_checks(p, sm.groups, &sm.num_groups);
  grid.sync();
  for (int tile = blockIdx.x; tile < w.tiles; tile += gridDim.x)
    phase_finish<T, R>(p, w, sm, tile);
}

// The instance's co-resident CTAs (0: it cannot launch), once per process.
template <typename T, int R>
int max_ctas() {
  static int ctas = -1;
  if (ctas < 0) {
    ctas = 0;
    const int bytes = static_cast<int>(sizeof(TileSmem<T, R>));
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(scan_kernel<T, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, scan_kernel<T, R>, kT, bytes) != cudaSuccess)
      return 0;
    ctas = sms * per_sm < kMaxCtas ? sms * per_sm : kMaxCtas;
  }
  return ctas;
}

template <typename T, int R>
int launch(const ScanParams& p, cudaStream_t stream) {
  const int most = max_ctas<T, R>();
  if (most < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Work<T> w = make_work<T>(p);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(w.tiles < most ? w.tiles : most);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = sizeof(TileSmem<T, R>);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, scan_kernel<T, R>, p, w);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const ScanParams& p, cudaStream_t stream) {
  switch (p.R) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    default: return launch<T, 4>(p, stream);
  }
}
#else
template <typename T, int R>
int host_run(const ScanParams& p, int ctas) {
  const Work<T> w = make_work<T>(p);
  std::vector<TileSmem<T, R>> sm(1);
  for (int q = 0; q < w.tiles * R; ++q) w.look[q] = 0ull;
  for (int c = 0; c < ctas; ++c)
    for (int tile = c; tile < w.tiles; tile += ctas)
      phase_levels<T, R>(p, w, sm[0], tile);
  phase_upper<T, R>(w);
  if constexpr (std::is_floating_point<T>::value)
    if (p.num_checks > 0) group_checks(p, sm[0].groups, &sm[0].num_groups);
  // Tiles in order: each finds its predecessors' words published.
  for (int tile = 0; tile < w.tiles; ++tile)
    phase_finish<T, R>(p, w, sm[0], tile);
  return 0;
}

template <typename T>
int host_dispatch(const ScanParams& p, int ctas) {
  switch (p.R) {
    case 1: return host_run<T, 1>(p, ctas);
    case 2: return host_run<T, 2>(p, ctas);
    case 3: return host_run<T, 3>(p, ctas);
    default: return host_run<T, 4>(p, ctas);
  }
}
#endif

}  // namespace

extern "C" long long cc_segment_scan_params_bytes() {
  return static_cast<long long>(sizeof(ScanParams));
}

extern "C" long long cc_segment_scan_scratch_bytes(long long n, int R) {
  if (n <= 0 || R < 1) return 0;
  return static_cast<long long>(scratch_bytes(n, R));
}

#ifdef __CUDACC__
extern "C" int cc_segment_scan(const ScanParams* params, void* stream_) {
  const ScanParams p = *params;
  if (!params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  return p.is_int ? run<int>(p, stream) : run<float>(p, stream);
}
#else
// The same phases on the host: phase 1 over `ctas` CTAs' tiles in turn,
// then phase 2, then the tiles in order; scratch of
// cc_segment_scan_scratch_bytes in params->scratch.
extern "C" int cc_segment_scan_host(const ScanParams* params, int ctas) {
  const ScanParams p = *params;
  if (!params_ok(p) || ctas < 1 || ctas > kMaxCtas) return 1;
  return p.is_int ? host_dispatch<int>(p, ctas) : host_dispatch<float>(p, ctas);
}
#endif
