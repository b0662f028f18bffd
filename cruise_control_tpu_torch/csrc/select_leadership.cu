// K2's leadership mode (select_leadership): the leadership block's
// partitions.
//
// Replaces (JAX) cruise_control_tpu/analyzer/candidates.py:315-326: the
// stable top-k (k <= 2048) of the leader slots' weights on positive-score
// brokers over all P*S slots (every other slot -inf), as (top_lw [k],
// lp [k]): value descending in IEEE total order (-0.0 below +0.0), the
// lower flat index first among equals, as lax.top_k orders it. Only a
// partition's leader slot can key above -inf, so the selection runs over
// one key a partition. When fewer than k keys are finite, top_k pads with
// the lowest flat indices whose key is -inf, non-leader slots included:
// those lie in [0, k). A leader weight below -inf in the total order (a
// NaN with its sign bit set) is taken as -inf.
//
// Bound on this card: bytes -- the leader slot, the partition mask and
// each leader slot's weight, assignment and score read once, O(k) output:
// ~0.004 ms at 1M partitions.
//
// Design: one cooperative launch (every CTA co-resident, grid barriers
// between the phases; one CTA of 1,024 threads an SM, at least 1,024
// partitions a CTA), each partition's key made once. Each CTA owns a
// contiguous range of partitions.
//  1. keys: each CTA builds its partitions' 32-bit keys (the ordered bits
//     of the leader weight, 0 where off source or -inf) into shared
//     memory (a global scratch beyond kKeyCap a CTA) and histograms their
//     top 11 bits; the CTAs zero the global histograms meanwhile.
//  2. passes over the value bits, 11/11/10: each CTA adds its shared
//     histogram into the pass's global one; after a grid barrier every
//     CTA reads the same merged histogram and picks the same digit (no
//     "last CTA"), then histograms the next digit of the keys that match.
//     The search ends at the first pass whose picked bin leaves at most
//     kBuf keys at or above its low edge, few enough for the CTAs to rank
//     (kRankWork compares a CTA), or with fewer than k finite keys; else
//     after the last digit. The result: a boundary value T, the A keys
//     above it, and (after the last digit only) `take` of the keys equal
//     to T.
//  3. collect: keys above T go to a buffer (A <= kBuf); each CTA counts
//     its keys equal to T where some are taken. Ties need no 64-bit keys: the flat index of a
//     partition's leader slot rises with the partition, and CTAs own
//     ranges in partition order, so the first `take` ties are found by an
//     exclusive prefix of the CTAs' counts (after the barrier) and a scan
//     inside the CTA, and written at rows A + rank. With fewer than k
//     finite keys, the last CTA writes top_k's -inf padding.
//  4. write: the buffered keys are ranked by counting (a warp a key,
//     against the buffer staged in shared memory; value, then partition)
//     and those of rank below min(k, finite keys) written at their ranks.
// Per call: one launch and no memset, with 2 to 5 grid barriers.
//
// The file also compiles as host C++ (without __CUDACC__): the same phase
// code runs with one "thread" that walks each phase's items in order, the
// CTAs one after the other between the grid barriers, atomics that are
// plain loads and stores (cc_select_leadership_host), which the CPU tests
// hold against the twin.
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
#define CC_HD __device__ __forceinline__
#define CC_BOTH __host__ __device__ __forceinline__
#define CC_UNROLL _Pragma("unroll")
#define TID static_cast<int>(threadIdx.x)
#define BARRIER() __syncthreads()
#else
#include <vector>
#define CC_HD static inline
#define CC_BOTH static inline
#define CC_UNROLL
#define TID 0
#define BARRIER() ((void)0)
#endif

namespace {

#ifdef __CUDACC__
constexpr int kT = 1024;   // threads a CTA, one CTA an SM
#else
constexpr int kT = 1;      // the host's one "thread"
#endif
constexpr int kWarps = kT >= 32 ? kT / 32 : 1;
constexpr int kBins = 2048;
constexpr int kPasses = 3;
constexpr int kItems = 8;          // partitions a thread loads at once
constexpr int kKeyCap = 8192;      // keys a CTA keeps in shared memory
constexpr int kMaxK = 2048;
// The most keys the search may hand to the ranking (at or above a picked
// bin's low edge), and the compares a CTA may spend on ranking them.
constexpr int kBuf = 8192;
constexpr unsigned long long kRankWork = 1ull << 19;
constexpr int kMaxCtas = 2048;
constexpr int kMinPerCta = 1024;   // partitions a CTA at least
constexpr uint32_t kNegInfOrd = 0x007FFFFFu;  // ordered bits of -inf

struct Args {
  const float* weight;
  const float* score;
  const int* assignment;
  const uint8_t* partition_mask;
  const int* leader_slot;
  float* top_lw;
  int* lp;
  int P, S, B, k;
  int ctas, per;      // CTAs, partitions a CTA
  int key_cap;        // keys a CTA keeps in shared memory
};

// Global scratch: the three passes' histograms and the buffer's counter
// (zeroed by the kernel), the CTAs' tie counts, the buffer, and the keys
// of CTAs whose range exceeds key_cap.
struct Scratch {
  uint32_t* hist;      // [kPasses][kBins], then the counter
  uint32_t* ties;      // [ctas]
  unsigned long long* buf;  // [k]
  uint32_t* keys;      // [P], or null
};

constexpr int kZeroWords = kPasses * kBins + 1;

// The search's state; every CTA computes the same.
struct Sel {
  uint32_t F;      // finite keys
  uint32_t need;   // min(k, F): rows that are not padding
  uint32_t T;      // boundary value: keys above it are all taken
  uint32_t A;      // keys above T (found so far)
  uint32_t take;   // keys equal to T taken, in partition order
  uint32_t pfx;    // bits above the next pass's digit
  uint32_t done;
};

struct Smem {
  uint32_t hist[kBins];
  uint32_t warp_tmp[kWarps];
  uint32_t pick[3];          // bin, keys above it, its count
  Sel sel;
  unsigned long long rank[kBuf];
  uint32_t keys[kKeyCap];
};

struct Cta {
  int id;
  int p0, n;       // its partitions [p0, p0 + n)
  uint32_t* keys;  // n keys
};

CC_HD uint32_t f2u(float v) {
#ifdef __CUDACC__
  return __float_as_uint(v);
#else
  uint32_t b;
  std::memcpy(&b, &v, sizeof b);
  return b;
#endif
}

CC_HD float u2f(uint32_t b) {
#ifdef __CUDACC__
  return __uint_as_float(b);
#else
  float v;
  std::memcpy(&v, &b, sizeof v);
  return v;
#endif
}

CC_HD uint32_t ordered_bits(float v) {
  const uint32_t b = f2u(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

CC_HD float unordered_float(uint32_t o) {
  return u2f((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// The lowest bit of pass `pass`'s digit: digits of 11, 11 and 10 bits.
CC_HD int shift_of(int pass) { return pass == 0 ? 21 : pass == 1 ? 10 : 0; }

CC_HD uint32_t load_cg(const uint32_t* p) {
#ifdef __CUDACC__
  return __ldcg(p);
#else
  return *p;
#endif
}

// Partition p's key from its loaded leader slot and mask: the ordered
// bits of the leader weight where the leader replica is on a
// positive-score broker and its weight is above -inf, else 0.
CC_HD uint32_t lead_key(const Args& a, int p, int ls, bool pm) {
  if (!pm || ls < 0 || ls >= a.S) return 0u;
  const long long flat = static_cast<long long>(p) * a.S + ls;
  const int b = a.assignment[flat];
  if (b < 0 || b >= a.B || !(a.score[b] > 0.0f)) return 0u;
  const uint32_t o = ordered_bits(a.weight[flat]);
  return o > kNegInfOrd ? o : 0u;
}

// Exclusive prefix of v over the CTA's threads in thread order, and the
// CTA's total. Every thread calls it.
CC_HD uint32_t block_scan(uint32_t v, uint32_t* warp_tmp, uint32_t& total) {
#ifdef __CUDACC__
  const int lane = TID & 31, warp = TID >> 5;
  uint32_t x = v;
CC_UNROLL
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_tmp[lane] : 0u;
CC_UNROLL
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_tmp[lane] = w;
  }
  __syncthreads();
  const uint32_t before = (warp > 0 ? warp_tmp[warp - 1] : 0u) + x - v;
  total = warp_tmp[kWarps - 1];
  __syncthreads();
  return before;
#else
  (void)warp_tmp;
  total = v;
  return 0u;
#endif
}

// hist[bin] += 1 where `on`; the lanes of a warp with equal bins add once.
// Every lane calls it.
CC_HD void hist_add(uint32_t* hist, bool on, uint32_t bin) {
#ifdef __CUDACC__
  const unsigned active = __ballot_sync(0xffffffffu, on);
  if (on) {
    const unsigned peers = __match_any_sync(active, bin);
    if ((TID & 31) == __ffs(peers) - 1)
      atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
  }
#else
  if (on) ++hist[bin];
#endif
}

// A slot in the buffer for each lane with `on`. Every lane calls it.
CC_HD uint32_t claim(bool on, uint32_t* counter) {
#ifdef __CUDACC__
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  uint32_t pos = 0;
  if (mask) {
    const int lane = TID & 31, leader = __ffs(mask) - 1;
    if (lane == leader) pos = atomicAdd(counter, __popc(mask));
    pos = __shfl_sync(0xffffffffu, pos, leader) +
          __popc(mask & ((1u << lane) - 1u));
  }
  return pos;
#else
  return on ? (*counter)++ : 0u;
#endif
}

CC_HD void atomic_add(uint32_t* p, uint32_t v) {
#ifdef __CUDACC__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

// 1. The CTA's keys and the histogram of their top digit; the global
// histograms and counter zeroed (read only after a grid barrier).
CC_HD void phase_keys(const Args& a, const Scratch& s, const Cta& c,
                      Smem& sm) {
  for (int w = c.id * kT + TID; w < kZeroWords; w += a.ctas * kT)
    s.hist[w] = 0u;
  for (int b = TID; b < kBins; b += kT) sm.hist[b] = 0u;
  BARRIER();
  for (int base = 0; base < c.n; base += kT * kItems) {
    int ls[kItems];
    bool pm[kItems];
CC_UNROLL
    for (int r = 0; r < kItems; ++r) {
      const int q = base + r * kT + TID;
      ls[r] = q < c.n ? a.leader_slot[c.p0 + q] : -1;
      pm[r] = q < c.n && a.partition_mask[c.p0 + q];
    }
    // Each item's loads issued together: slot, then broker, then score.
    int flat[kItems], broker[kItems];
    float w[kItems];
CC_UNROLL
    for (int r = 0; r < kItems; ++r) {
      const bool has = pm[r] && ls[r] >= 0 && ls[r] < a.S;
      flat[r] = has ? (c.p0 + base + r * kT + TID) * a.S + ls[r] : -1;
      broker[r] = has ? a.assignment[flat[r]] : -1;
      w[r] = has ? a.weight[flat[r]] : 0.0f;
    }
CC_UNROLL
    for (int r = 0; r < kItems; ++r) {
      const int q = base + r * kT + TID;
      const bool on = broker[r] >= 0 && broker[r] < a.B &&
                      a.score[broker[r]] > 0.0f;
      const uint32_t o = ordered_bits(w[r]);
      const uint32_t key = on && o > kNegInfOrd ? o : 0u;
      if (q < c.n) c.keys[q] = key;
      hist_add(sm.hist, key != 0u, key >> shift_of(0));
    }
  }
  BARRIER();
}

// 2a. The CTA's histogram of pass `pass` into the global one.
CC_HD void phase_merge(const Scratch& s, Smem& sm, int pass) {
  uint32_t* g = s.hist + pass * kBins;
  for (int b = TID; b < kBins; b += kT)
    if (sm.hist[b]) atomic_add(&g[b], sm.hist[b]);
}

// 2b. Every CTA picks the same digit from the merged histogram of pass
// `pass`, and updates sm.sel.
CC_HD void phase_pick(const Args& a, const Scratch& s, Smem& sm, int pass) {
  constexpr int kPer = kBins / kT;   // bins a thread, from the top
  const uint32_t* g = s.hist + pass * kBins;
  uint32_t count[kPer];
  uint32_t sum = 0;
CC_UNROLL
  for (int r = 0; r < kPer; ++r) {
    count[r] = load_cg(&g[kBins - 1 - (TID * kPer + r)]);
    sum += count[r];
  }
  uint32_t total;
  uint32_t before = block_scan(sum, sm.warp_tmp, total);
  Sel sel = sm.sel;
  if (pass == 0) {
    sel.F = total;
    sel.need = total < static_cast<uint32_t>(a.k) ? total
                                                  : static_cast<uint32_t>(a.k);
    sel.A = 0u;
    sel.pfx = 0u;
    sel.take = 0u;
    sel.done = 0u;
  }
  if (pass == 0 && sel.need == sel.F) {
    // Every finite key is taken (none, or fewer than k).
    if (TID == 0) {
      sel.T = 0u;
      sel.A = sel.F;
      sel.done = 1u;
      sm.sel = sel;
    }
    BARRIER();
    return;
  }
  const uint32_t rem = sel.need - sel.A;
CC_UNROLL
  for (int r = 0; r < kPer; ++r) {
    if (before < rem && rem <= before + count[r]) {
      sm.pick[0] = static_cast<uint32_t>(kBins - 1 - (TID * kPer + r));
      sm.pick[1] = before;
      sm.pick[2] = count[r];
    }
    before += count[r];
  }
  BARRIER();
  if (TID == 0) {
    const uint32_t bin = sm.pick[0], above = sm.pick[1], cnt = sm.pick[2];
    const int bits = pass == 0 ? 32 - shift_of(0)
                               : shift_of(pass - 1) - shift_of(pass);
    const uint32_t pfx = (sel.pfx << bits) | bin;
    const unsigned long long m = sel.A + above + cnt;
    sel.A += above;
    sel.pfx = pfx;
    if (m <= kBuf && m * m <= static_cast<unsigned long long>(a.ctas) *
                                  kRankWork) {
      // Few keys at or above the bin's low edge: all go to the buffer and
      // the ranking keeps the first `need` (value, then partition), so no
      // later pass and no tie scan runs.
      sel.T = (pfx << shift_of(pass)) - 1u;
      sel.A = static_cast<uint32_t>(m);
      sel.done = 1u;
    } else if (shift_of(pass) == 0) {
      sel.T = pfx;
      sel.take = sel.need - sel.A;
      sel.done = 1u;
    }
    sm.sel = sel;
  }
  BARRIER();
}

// 2c. The CTA's histogram of pass `pass`'s digit over the keys that
// match the digits picked so far.
CC_HD void phase_hist(const Cta& c, Smem& sm, int pass) {
  for (int b = TID; b < kBins; b += kT) sm.hist[b] = 0u;
  BARRIER();
  const uint32_t pfx = sm.sel.pfx;
  const int top = shift_of(pass - 1);
  const uint32_t mask = (1u << (top - shift_of(pass))) - 1u;
  for (int q0 = 0; q0 < c.n; q0 += kT) {
    const int q = q0 + TID;
    const uint32_t key = q < c.n ? c.keys[q] : 0u;
    hist_add(sm.hist, key != 0u && (key >> top) == pfx,
             (key >> shift_of(pass)) & mask);
  }
  BARRIER();
}

// 3. Keys above T into the buffer, the CTA's count of keys equal to T,
// and (last CTA, fewer than k finite keys) top_k's -inf padding.
CC_HD void phase_collect(const Args& a, const Scratch& s, const Cta& c,
                         Smem& sm) {
  const Sel sel = sm.sel;
  uint32_t ties = 0;
  for (int q0 = 0; q0 < c.n; q0 += kT) {
    const int q = q0 + TID;
    const uint32_t key = q < c.n ? c.keys[q] : 0u;
    const bool above = key > sel.T;
    const uint32_t pos = claim(above, s.hist + kPasses * kBins);
    if (above)
      s.buf[pos] = (static_cast<unsigned long long>(key) << 32) |
                   (0xFFFFFFFFu - static_cast<uint32_t>(c.p0 + q));
    ties += sel.take > 0u && key != 0u && key == sel.T ? 1u : 0u;
  }
  if (sel.take > 0u) {
    uint32_t total;
    block_scan(ties, sm.warp_tmp, total);
    if (TID == 0) s.ties[c.id] = total;
  }
  if (sel.F >= static_cast<uint32_t>(a.k) || c.id != a.ctas - 1) return;
  // Padding: rows F.. k-1, the lowest flat indices whose key is -inf.
  uint32_t next = sel.F;
  for (int i0 = 0; i0 < a.k && next < static_cast<uint32_t>(a.k);
       i0 += kT) {
    const int i = i0 + TID;
    bool pad = false;
    if (i < a.k) {
      const int p = i / a.S;
      const int ls = a.leader_slot[p];
      pad = !(ls == i % a.S &&
              lead_key(a, p, ls, a.partition_mask[p] != 0) != 0u);
    }
    uint32_t total;
    const uint32_t r = next + block_scan(pad ? 1u : 0u, sm.warp_tmp, total);
    if (pad && r < static_cast<uint32_t>(a.k)) {
      a.top_lw[r] = u2f(0xff800000u);
      a.lp[r] = i / a.S;
    }
    next += total;
  }
}

// 4a. The CTA's keys equal to T, ranked by the CTAs before it and its own
// scan, written at rows A + rank < A + take.
CC_HD void phase_ties(const Args& a, const Scratch& s, const Cta& c,
                      Smem& sm) {
  const Sel sel = sm.sel;
  if (sel.take == 0u) return;
  uint32_t before = 0;
  for (int o = TID; o < c.id; o += kT) before += load_cg(&s.ties[o]);
  uint32_t total;
  block_scan(before, sm.warp_tmp, total);
  uint32_t next = total;
  const float value = unordered_float(sel.T);
  for (int q0 = 0; q0 < c.n && next < sel.take; q0 += kT) {
    const int q = q0 + TID;
    const bool tie = q < c.n && c.keys[q] == sel.T;
    const uint32_t r = next + block_scan(tie ? 1u : 0u, sm.warp_tmp, total);
    if (tie && r < sel.take) {
      a.top_lw[sel.A + r] = value;
      a.lp[sel.A + r] = c.p0 + q;
    }
    next += total;
  }
}

// 4b. The buffered keys, ceil(A / ctas) a CTA, ranked against the whole
// buffer (staged in shared memory) and written at their ranks.
CC_HD void phase_rank(const Args& a, const Scratch& s, const Cta& c,
                      Smem& sm) {
  const int m = static_cast<int>(sm.sel.A);
  const int per = (m + a.ctas - 1) / a.ctas;
  const int j0 = c.id * per;
  const int j1 = j0 + per < m ? j0 + per : m;
  if (j0 >= j1) return;
  for (int j = TID; j < m; j += kT) {
#ifdef __CUDACC__
    sm.rank[j] = __ldcg(&s.buf[j]);
#else
    sm.rank[j] = s.buf[j];
#endif
  }
  BARRIER();
#ifdef __CUDACC__
  const int lane = TID & 31;
  for (int j = j0 + (TID >> 5); j < j1; j += kWarps) {
    const unsigned long long key = sm.rank[j];
    uint32_t greater = 0;
    for (int t = lane; t < m; t += 32) greater += sm.rank[t] > key ? 1u : 0u;
CC_UNROLL
    for (int o = 16; o > 0; o >>= 1)
      greater += __shfl_xor_sync(0xffffffffu, greater, o);
    if (lane == 0 && greater < sm.sel.need) {
      a.top_lw[greater] = unordered_float(static_cast<uint32_t>(key >> 32));
      a.lp[greater] = static_cast<int>(0xFFFFFFFFu -
                                       static_cast<uint32_t>(key));
    }
  }
#else
  for (int j = j0; j < j1; ++j) {
    const unsigned long long key = sm.rank[j];
    uint32_t greater = 0;
    for (int t = 0; t < m; ++t) greater += sm.rank[t] > key ? 1u : 0u;
    if (greater >= sm.sel.need) continue;
    a.top_lw[greater] = unordered_float(static_cast<uint32_t>(key >> 32));
    a.lp[greater] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
  }
#endif
}

CC_BOTH Cta cta_of(const Args& a, const Scratch& s, int id,
                   uint32_t* smem_keys) {
  Cta c;
  c.id = id;
  c.p0 = id * a.per;
  const int left = a.P - c.p0;
  c.n = left <= 0 ? 0 : (left < a.per ? left : a.per);
  c.keys = a.per <= a.key_cap ? smem_keys : s.keys + (c.p0 < a.P ? c.p0 : 0);
  return c;
}

bool args_ok(int P, int S, int k) {
  const long long n = static_cast<long long>(P) * S;
  return P >= 1 && S >= 1 && k >= 1 && k <= kMaxK && k <= n &&
         n < (1LL << 31);
}

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// Scratch layout: {ties, buf, keys, total} offsets in bytes.
struct Layout {
  size_t ties, buf, keys, total;
  Layout(int P, int ctas, int per, int key_cap) {
    ties = align256(sizeof(uint32_t) * kZeroWords);
    buf = align256(ties + sizeof(uint32_t) * ctas);
    keys = align256(buf + sizeof(unsigned long long) * kBuf);
    total = per <= key_cap ? keys
                           : align256(keys + sizeof(uint32_t) * P);
  }
};

Scratch scratch_at(void* base, const Layout& L, int per, int key_cap) {
  char* b = static_cast<char*>(base);
  Scratch s;
  s.hist = reinterpret_cast<uint32_t*>(b);
  s.ties = reinterpret_cast<uint32_t*>(b + L.ties);
  s.buf = reinterpret_cast<unsigned long long*>(b + L.buf);
  s.keys = per <= key_cap ? nullptr : reinterpret_cast<uint32_t*>(b + L.keys);
  return s;
}

int per_cta(int P, int ctas) { return (P + ctas - 1) / ctas; }

#ifdef __CUDACC__
__global__ void __launch_bounds__(kT, 1)
leadership_kernel(const Args a, const Scratch s) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  cg::grid_group grid = cg::this_grid();
  const Cta c = cta_of(a, s, static_cast<int>(blockIdx.x), sm.keys);
  phase_keys(a, s, c, sm);
  grid.sync();
  for (int pass = 0; pass < kPasses; ++pass) {
    phase_merge(s, sm, pass);
    grid.sync();
    phase_pick(a, s, sm, pass);
    if (sm.sel.done) break;
    phase_hist(c, sm, pass + 1);
  }
  phase_collect(a, s, c, sm);
  if (sm.sel.need == 0u) return;
  grid.sync();
  phase_ties(a, s, c, sm);
  phase_rank(a, s, c, sm);
}

// CTAs that can be co-resident (at most one an SM), once per process.
int max_ctas() {
  static int ctas = 0;
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(leadership_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sizeof(Smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, leadership_kernel, kT, sizeof(Smem)) != cudaSuccess)
      return 0;
    ctas = sms * (per_sm < 1 ? per_sm : 1);
    if (ctas > kMaxCtas) ctas = kMaxCtas;
  }
  return ctas;
}

int grid_for(int P) {
  const int most = max_ctas();
  const int want = (P + kMinPerCta - 1) / kMinPerCta;
  return want < most ? want : most;
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" long long cc_select_leadership_scratch_bytes(int P, int k) {
  if (P < 1 || k < 1 || k > kMaxK) return 0;
  const int ctas = grid_for(P);
  if (ctas < 1) return 0;
  return static_cast<long long>(
      Layout(P, ctas, per_cta(P, ctas), kKeyCap).total);
}

// The stable top-k of the leader slots' weights on positive-score brokers
// over the P*S slots, as (top_lw [k], lp [k]): one cooperative launch.
extern "C" int cc_select_leadership(
    const float* weight, const float* score, const int* assignment,
    const uint8_t* partition_mask, const int* leader_slot, int P, int S,
    int B, int k, float* top_lw, int* lp, void* scratch, void* stream_) {
  if (!args_ok(P, S, k) || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = grid_for(P);
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per = per_cta(P, ctas);
  const Args a{weight, score, assignment, partition_mask, leader_slot,
               top_lw, lp, P, S, B, k, ctas, per, kKeyCap};
  const Scratch s = scratch_at(scratch, Layout(P, ctas, per, kKeyCap),
                               per, kKeyCap);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = static_cast<cudaStream_t>(stream_);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, leadership_kernel, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
#else
// The same phases on the host, `ctas` CTAs in turn between the grid
// barriers, each keeping at most `key_cap` keys in its shared memory.
extern "C" int cc_select_leadership_host(
    const float* weight, const float* score, const int* assignment,
    const uint8_t* partition_mask, const int* leader_slot, int P, int S,
    int B, int k, float* top_lw, int* lp, int ctas, int key_cap) {
  if (!args_ok(P, S, k) || B < 1 || ctas < 1 || ctas > kMaxCtas ||
      key_cap < 1 || key_cap > kKeyCap)
    return 1;
  const int per = per_cta(P, ctas);
  const Args a{weight, score, assignment, partition_mask, leader_slot,
               top_lw, lp, P, S, B, k, ctas, per, key_cap};
  const Layout L(P, ctas, per, key_cap);
  std::vector<unsigned long long> mem((L.total + 7) / 8);
  const Scratch s = scratch_at(mem.data(), L, per, key_cap);
  std::vector<Smem> sm(ctas);
  std::vector<Cta> cs;
  for (int c = 0; c < ctas; ++c) cs.push_back(cta_of(a, s, c, sm[c].keys));
  for (int c = 0; c < ctas; ++c) phase_keys(a, s, cs[c], sm[c]);
  for (int pass = 0; pass < kPasses; ++pass) {
    for (int c = 0; c < ctas; ++c) phase_merge(s, sm[c], pass);
    for (int c = 0; c < ctas; ++c) phase_pick(a, s, sm[c], pass);
    if (sm[0].sel.done) break;
    for (int c = 0; c < ctas; ++c) phase_hist(cs[c], sm[c], pass + 1);
  }
  for (int c = 0; c < ctas; ++c) phase_collect(a, s, cs[c], sm[c]);
  if (sm[0].sel.need == 0u) return 0;
  for (int c = 0; c < ctas; ++c) phase_ties(a, s, cs[c], sm[c]);
  for (int c = 0; c < ctas; ++c) phase_rank(a, s, cs[c], sm[c]);
  return 0;
}
#endif
