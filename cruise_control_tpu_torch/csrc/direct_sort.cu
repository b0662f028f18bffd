// KD1: the direct-assignment transport's stable sort (direct_sort).
//
// Replaces the reference's lax.sort calls of analyzer/direct.py
// (cruise_control_tpu/analyzer/direct.py:473-895: lines 473, 512, 535,
// 653, 676, 758, 825, 874, 895), XLA-lowered sorts, not Pallas kernels:
// the (cell, weight) mover sort with its permutation, and the dst-, src-
// and topic-keyed sorts whose second key is the element's position.
//
// What it computes: for int32 keys in [0, 2**key_bits) and an optional
// f32 second key, the stable order of (key, second), as (sorted keys,
// permutation); the second key in lax.sort's float order (IEEE order with
// -0.0 equal to +0.0, every NaN equal and above +inf), taken as the
// unsigned order of its "sort bits". Without a second key the position is
// the tie-break, so stable passes over the key suffice.
//
// Bound on this card: bytes. The least work reads (key, second) once and
// writes (key, perm) once, 16 B an element: 0.0143 ms for the 3M-element
// mover sort at 7k brokers / 1M partitions at 3.35 TB/s. A k-pass radix
// sort moves about 24 B an element a pass, ~0.15 ms for 7 passes there.
//
// Design: a onesweep LSD radix sort (Merrill and Garland, "Onesweep",
// 2022), 8-bit digits: 4 passes over the second key's sort bits, then
// ceil(key_bits / 8) over the key.
//  - count (one cooperative launch): the CTAs zero the look-back words,
//    then histogram every pass's digits in one read of (key, second),
//    four copies of each histogram in shared memory against collisions --
//    the multiset of a pass's digits does not depend on the order the
//    earlier passes leave -- and, after a grid barrier, one CTA a pass
//    turns its histogram into each digit's first output position and
//    marks the pass trivial when one digit holds all N elements.
//  - one launch a pass. A trivial pass returns at once (a stable pass
//    over one digit is the identity); the rest route around them: the
//    first pass that runs reads the inputs (and makes the sort bits and
//    the identity permutation on the fly), the last one writes the
//    outputs, the ones between ping-pong two scratch buffers, and the
//    second key is carried only while a later pass reads it. A CTA takes
//    the next tile of 4,096 elements from an atomic counter (so every
//    earlier tile is held by a running CTA) and ranks it in shared
//    memory: a warp an interleaved 512 elements, 16 steps of 32 lanes in
//    index order, the lanes of one digit found by eight ballots, their
//    leader adding their count to the warp's counter, so each element's
//    rank among its tile's equal digits follows its index (stable). Its
//    digit counts go out at once (aggregate), each thread then looks back
//    over the earlier tiles' words of its digit, 8 tiles a round trip,
//    until an inclusive one and publishes its own inclusive count. The tile is reordered by
//    (digit, rank) in shared memory and written out in runs, one word
//    (digit word, key, permutation) a round.
// Per call: 1 + passes launches and no memset; 8 for the mover sort,
// 3 for a position-keyed sort over 13-bit keys. Look-back words carry
// their pass in a tag, so one array serves every pass.
//
// The file also compiles as host C++ (without __CUDACC__): the count
// phases run over the CTAs in turn between the grid barriers, a tile is
// ranked by one "thread" in index order, tiles run in order so the
// look-back finds its predecessors published (cc_direct_sort_host),
// which the CPU tests hold against the twin.
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
#define TID 0
#define BARRIER() ((void)0)
#endif

namespace {

constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kMaxPasses = 8;   // 4 over the second key, <= 4 over the key
constexpr int kTile = 4096;     // elements a tile
#ifdef __CUDACC__
constexpr int kT = 256;         // threads a CTA: one a digit
constexpr int kWarps = kT / 32;
constexpr int kItems = kTile / kT;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kT == kBins, "the look-back gives each thread one digit");
#else
constexpr int kT = 1;
constexpr int kWarps = 1;
#endif
constexpr int kMaxCtas = 2048;  // of the count launch

// Look-back words: [tag: pass + 1, from bit 34][flag: bits 32-33][count].
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

struct Plan {
  const int* key;
  const float* second;   // null without a second key
  int n, tiles, sec_passes, passes;
  int* sorted_key;
  int* perm;
  uint32_t* kbuf[2];
  uint32_t* sbuf[2];
  int* pbuf[2];
  uint32_t* start;       // [kMaxPasses][kBins]: counts, then first positions
  int* trivial;          // [kMaxPasses]
  uint32_t* next_tile;   // [kMaxPasses]
  unsigned long long* status;   // [tiles][kBins]
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

// lax.sort's float order as an unsigned order: -0.0 as +0.0, every NaN as
// the positive quiet NaN (above +inf).
CC_HD uint32_t sort_bits(float v) {
  if (v != v) return 0xFFC00000u;
  const uint32_t b = float_bits(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

CC_HD uint32_t digit_of(const Plan& g, int p, uint32_t word) {
  const int shift = kBits * (p < g.sec_passes ? p : p - g.sec_passes);
  return (word >> shift) & (kBins - 1);
}

// Where pass p reads and writes, around the trivial passes.
struct Route {
  int skip, first, last, src, dst, keep_sec;
};

CC_HD Route route(const Plan& g, int p) {
  int before = 0, after = 0, sec_after = 0;
  for (int q = 0; q < g.passes; ++q) {
    if (g.trivial[q]) continue;
    if (q < p) ++before;
    if (q > p) {
      ++after;
      if (q < g.sec_passes) sec_after = 1;
    }
  }
  // The c-th pass that runs writes buffer c & 1 and reads (c - 1) & 1.
  return Route{g.trivial[p], before == 0, after == 0, (before + 1) & 1,
               before & 1, sec_after};
}

// Pass p's source and destination arrays, picked by selects (a runtime
// index into the parameter block's arrays would copy it to local memory).
struct Io {
  const uint32_t* key;
  const uint32_t* sec;
  const int* perm;
  uint32_t* key_out;
  uint32_t* sec_out;
  int* perm_out;
};

CC_HD Io io_of(const Plan& g, const Route& r) {
  const bool s1 = r.src == 1, d1 = r.dst == 1;
  return Io{s1 ? g.kbuf[1] : g.kbuf[0], s1 ? g.sbuf[1] : g.sbuf[0],
            s1 ? g.pbuf[1] : g.pbuf[0],
            r.last ? reinterpret_cast<uint32_t*>(g.sorted_key)
                   : (d1 ? g.kbuf[1] : g.kbuf[0]),
            r.keep_sec ? (d1 ? g.sbuf[1] : g.sbuf[0]) : nullptr,
            r.last ? g.perm : (d1 ? g.pbuf[1] : g.pbuf[0])};
}

template <typename W>
CC_HD W read_only(const W* p, int i) {
#ifdef __CUDACC__
  return __ldg(p + i);
#else
  return p[i];
#endif
}

CC_HD uint32_t load_key(const Plan& g, const Route& r, const Io& io, int i) {
  return r.first ? static_cast<uint32_t>(read_only(g.key, i))
                 : read_only(io.key, i);
}

CC_HD uint32_t load_sec(const Plan& g, const Route& r, const Io& io, int i) {
  return r.first ? sort_bits(read_only(g.second, i)) : read_only(io.sec, i);
}

CC_HD int load_perm(const Route& r, const Io& io, int i) {
  return r.first ? i : read_only(io.perm, i);
}

// --- look-back words --------------------------------------------------------

CC_HD void publish(const Plan& g, int p, int tile, int d, uint32_t count,
                   unsigned long long flag) {
  const unsigned long long w =
      (static_cast<unsigned long long>(p + 1) << 34) | flag | count;
#ifdef __CUDACC__
  *reinterpret_cast<volatile unsigned long long*>(
      g.status + static_cast<size_t>(tile) * kBins + d) = w;
#else
  g.status[static_cast<size_t>(tile) * kBins + d] = w;
#endif
}

CC_HD unsigned long long read_word(const unsigned long long* at) {
#ifdef __CUDACC__
  return *reinterpret_cast<const volatile unsigned long long*>(at);
#else
  return *at;
#endif
}

// Elements of digit d in the tiles before `tile`: the words of up to
// kAhead earlier tiles are read together, then taken in order (a word not
// yet published for this pass is read again) until an inclusive one. The
// tiles of one wave publish their aggregates together, so a tile walks
// back over most of the wave before it; the window cuts the round trips
// that walk costs kAhead-fold.
constexpr int kAhead = 8;

CC_HD uint32_t look_back(const Plan& g, int p, int tile, int d) {
  const unsigned long long tag = static_cast<unsigned long long>(p + 1);
  uint32_t prior = 0;
  for (int t0 = tile - 1; t0 >= 0; t0 -= kAhead) {
    unsigned long long w[kAhead];
CC_UNROLL
    for (int j = 0; j < kAhead; ++j)
      w[j] = t0 - j >= 0
          ? read_word(g.status + static_cast<size_t>(t0 - j) * kBins + d)
          : 0ull;
    for (int j = 0; j < kAhead && t0 - j >= 0; ++j) {
      const unsigned long long* at =
          g.status + static_cast<size_t>(t0 - j) * kBins + d;
      while ((w[j] >> 34) != tag) w[j] = read_word(at);
      prior += static_cast<uint32_t>(w[j]);
      if (w[j] & kInclusive) return prior;
    }
  }
  return prior;
}

// --- count: zero, histogram, first positions ----------------------------

CC_HD void phase_zero(const Plan& g, int cta, int ctas) {
  const size_t words = static_cast<size_t>(g.tiles) * kBins;
  for (size_t x = static_cast<size_t>(cta) * kT + TID; x < words;
       x += static_cast<size_t>(ctas) * kT)
    g.status[x] = 0ull;
  for (int x = cta * kT + TID; x < kMaxPasses * kBins; x += ctas * kT)
    g.start[x] = 0u;
  if (cta == 0)
    for (int x = TID; x < kMaxPasses; x += kT) g.next_tile[x] = 0u;
}

// One CTA's contiguous range of elements into the passes' histograms,
// kCopies of each in shared memory (lane mod kCopies picks one), so that
// lanes of one digit, as the sentinel key's are, collide at most
// 32 / kCopies deep.
constexpr int kCopies = 4;

CC_HD void phase_count(const Plan& g, uint32_t (*hist)[kBins], int cta,
                       int ctas) {
  for (int x = TID; x < kMaxPasses * kBins * kCopies; x += kT)
    hist[x / kBins][x % kBins] = 0u;
  BARRIER();
  const long long per = ((static_cast<long long>(g.n) + ctas - 1) / ctas +
                         31) & ~31ll;
  const long long lo0 = per * cta;
  const int lo = static_cast<int>(lo0 < g.n ? lo0 : g.n);
  const int hi = static_cast<int>(lo0 + per < g.n ? lo0 + per : g.n);
#ifdef __CUDACC__
  uint32_t (*mine)[kBins] = hist + (TID % kCopies) * kMaxPasses;
  for (int i = lo + TID; i < hi; i += kT) {
    const uint32_t kw = static_cast<uint32_t>(__ldg(g.key + i));
    const uint32_t sw = g.second != nullptr ? sort_bits(__ldg(g.second + i))
                                            : 0u;
    for (int p = 0; p < g.passes; ++p)
      atomicAdd(&mine[p][digit_of(g, p, p < g.sec_passes ? sw : kw)], 1u);
  }
  BARRIER();
  for (int x = TID; x < kMaxPasses * kBins; x += kT) {
    uint32_t c = 0;
    for (int q = 0; q < kCopies; ++q)
      c += hist[q * kMaxPasses + x / kBins][x % kBins];
    if (c != 0u) atomicAdd(&g.start[x], c);
  }
#else
  for (int i = lo; i < hi; ++i) {
    const uint32_t kw = static_cast<uint32_t>(g.key[i]);
    const uint32_t sw = g.second != nullptr ? sort_bits(g.second[i]) : 0u;
    for (int p = 0; p < g.passes; ++p)
      ++hist[p][digit_of(g, p, p < g.sec_passes ? sw : kw)];
  }
  for (int x = 0; x < kMaxPasses * kBins; ++x)
    g.start[x] += hist[x / kBins][x % kBins];
#endif
}

#ifdef __CUDACC__
// Exclusive sum over the CTA's threads (one value each).
__device__ uint32_t block_exclusive(uint32_t x, uint32_t* warp_tot) {
  const int lane = TID & 31, warp = TID >> 5;
  uint32_t incl = x;
CC_UNROLL
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  uint32_t off = 0;
  for (int w = 0; w < warp; ++w) off += warp_tot[w];
  __syncthreads();
  return off + incl - x;
}
#endif

// Pass c's histogram into each digit's first output position; the pass is
// trivial when one digit holds every element.
CC_HD void phase_starts(const Plan& g, int c, uint32_t* warp_tot) {
  uint32_t* s = g.start + c * kBins;
#ifdef __CUDACC__
  const uint32_t cnt = s[TID];
  const int one = __syncthreads_or(cnt == static_cast<uint32_t>(g.n));
  s[TID] = block_exclusive(cnt, warp_tot);
  if (TID == 0) g.trivial[c] = one;
#else
  (void)warp_tot;
  uint32_t run = 0;
  int one = 0;
  for (int d = 0; d < kBins; ++d) {
    const uint32_t cnt = s[d];
    one |= cnt == static_cast<uint32_t>(g.n);
    s[d] = run;
    run += cnt;
  }
  g.trivial[c] = one;
#endif
}

// --- a pass -----------------------------------------------------------------

struct PassSmem {
  uint32_t warp_count[kWarps][kBins];   // counts, then exclusive over warps
  uint32_t tile_start[kBins];           // a digit's first position in the tile
  uint32_t out_at[kBins];               // ... and in the output
  uint32_t warp_tot[kWarps];
  uint32_t buf[kTile];                  // the tile reordered, a word a round
  int dest[kTile];                      // each reordered position's output
  int tile;
};

// All passes trivial: every element has one key, the order is the input's.
CC_HD void identity(const Plan& g, int i) {
  g.sorted_key[i] = g.key[i];
  g.perm[i] = i;
}

// One word of one round to its output position: the digit word's round
// writes the word (the second key's sort bits only while a later pass
// reads them), the key and permutation rounds theirs.
CC_HD void write_word(const Io& io, int kind, int dest, uint32_t w) {
  if (kind == 0) {
    if (io.sec_out != nullptr) io.sec_out[dest] = w;
  } else if (kind == 1) {
    io.key_out[dest] = w;
  } else {
    io.perm_out[dest] = static_cast<int>(w);
  }
}

// The tile's digit totals: published, looked back over, scanned. On entry
// warp_count holds each warp's counts; on exit its exclusive prefixes.
CC_HD void tile_offsets(const Plan& g, int p, int tile, PassSmem& sm) {
  for (int d = TID; d < kBins; d += kT) {
    uint32_t total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = sm.warp_count[w][d];
      sm.warp_count[w][d] = total;
      total += c;
    }
    publish(g, p, tile, d, total, tile == 0 ? kInclusive : kAggregate);
    uint32_t prior = 0;
    if (tile > 0) {
      prior = look_back(g, p, tile, d);
      publish(g, p, tile, d, prior + total, kInclusive);
    }
    sm.out_at[d] = g.start[p * kBins + d] + prior;
    sm.tile_start[d] = total;   // scanned below
  }
#ifdef __CUDACC__
  const uint32_t total = sm.tile_start[TID];
  sm.tile_start[TID] = block_exclusive(total, sm.warp_tot);
  __syncthreads();
#else
  uint32_t run = 0;
  for (int d = 0; d < kBins; ++d) {
    const uint32_t t = sm.tile_start[d];
    sm.tile_start[d] = run;
    run += t;
  }
#endif
}

#ifdef __CUDACC__
__device__ void run_tile(const Plan& g, int p, const Route& r, PassSmem& sm,
                         int tile) {
  const Io io = io_of(g, r);
  const int lane = TID & 31, warp = TID >> 5;
  const int base = tile * kTile;
  const int count = g.n - base < kTile ? g.n - base : kTile;
  const bool on_sec = p < g.sec_passes;
  for (int d = lane; d < kBins; d += 32) sm.warp_count[warp][d] = 0u;
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const int first = base + warp * (kItems * 32) + lane;   // item 0's index
  const int live = count - (first - base);   // items k with 32 k < live
  // The digit word now; the key and permutation in their rounds (loading
  // them here too costs more in registers, and so in CTAs an SM, than the
  // round trips it saves).
  uint32_t word[kItems], pos[kItems];
CC_UNROLL
  for (int k = 0; k < kItems; ++k) {
    const int i = first + 32 * k;
    word[k] = 32 * k < live ? (on_sec ? load_sec(g, r, io, i)
                                      : load_key(g, r, io, i))
                            : 0u;
  }
CC_UNROLL
  for (int k = 0; k < kItems; ++k) {
    const bool valid = 32 * k < live;
    const uint32_t d = digit_of(g, p, word[k]);
    // The lanes of this step with the same digit (or, past the end, the
    // other lanes past it): eight ballots, cheaper here than a match.
    unsigned peers = __ballot_sync(kFull, valid);
    if (!valid) peers = ~peers;
CC_UNROLL
    for (int b = 0; b < kBits; ++b) {
      const unsigned bit = __ballot_sync(kFull, (d >> b) & 1u);
      peers &= ((d >> b) & 1u) ? bit : ~bit;
    }
    const int leader = __ffs(peers) - 1;
    uint32_t before = 0u;
    if (valid && lane == leader) {
      before = sm.warp_count[warp][d];
      sm.warp_count[warp][d] = before + __popc(peers);
    }
    before = __shfl_sync(kFull, before, leader);
    pos[k] = before + __popc(peers & lower);   // rank in the warp's digit
    __syncwarp();
  }
  __syncthreads();
  tile_offsets(g, p, tile, sm);
CC_UNROLL
  for (int k = 0; k < kItems; ++k)
    if (32 * k < live) {
      const uint32_t d = digit_of(g, p, word[k]);
      pos[k] += sm.tile_start[d] + sm.warp_count[warp][d];
      sm.buf[pos[k]] = word[k];
    }
  __syncthreads();
  for (int s = TID; s < count; s += kT) {
    const uint32_t w = sm.buf[s];
    const uint32_t d = digit_of(g, p, w);
    const int dest = static_cast<int>(sm.out_at[d] + (s - sm.tile_start[d]));
    sm.dest[s] = dest;
    write_word(io, on_sec ? 0 : 1, dest, w);
  }
  for (int kind = on_sec ? 1 : 2; kind <= 2; ++kind) {
CC_UNROLL
    for (int k = 0; k < kItems; ++k)
      if (32 * k < live)
        word[k] = kind == 1 ? load_key(g, r, io, first + 32 * k)
                            : static_cast<uint32_t>(
                                  load_perm(r, io, first + 32 * k));
    __syncthreads();
CC_UNROLL
    for (int k = 0; k < kItems; ++k)
      if (32 * k < live) sm.buf[pos[k]] = word[k];
    __syncthreads();
    for (int s = TID; s < count; s += kT)
      write_word(io, kind, sm.dest[s], sm.buf[s]);
  }
}

__global__ void __launch_bounds__(kT) count_kernel(const Plan g) {
  __shared__ uint32_t hist[kCopies * kMaxPasses][kBins];
  __shared__ uint32_t warp_tot[kWarps];
  cg::grid_group grid = cg::this_grid();
  phase_zero(g, blockIdx.x, gridDim.x);
  grid.sync();
  phase_count(g, hist, blockIdx.x, gridDim.x);
  grid.sync();
  for (int c = blockIdx.x; c < g.passes; c += gridDim.x)
    phase_starts(g, c, warp_tot);
}

__global__ void __launch_bounds__(kT, 3) pass_kernel(const Plan g,
                                                    int p) {
  __shared__ PassSmem sm;
  const Route r = route(g, p);
  if (r.skip) {
    if (p == g.passes - 1 && r.first)
      for (int i = blockIdx.x * kT + TID; i < g.n; i += gridDim.x * kT)
        identity(g, i);
    return;
  }
  if (TID == 0) sm.tile = static_cast<int>(atomicAdd(&g.next_tile[p], 1u));
  __syncthreads();
  run_tile(g, p, r, sm, sm.tile);
}

// CTAs of the count launch that can be co-resident, once per process.
int max_ctas() {
  static int ctas = 0;
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_kernel,
                                                      kT, 0) != cudaSuccess)
      return 0;
    // Four CTAs an SM keep enough loads in flight; more only add
    // grid-barrier and global-atomic traffic.
    ctas = sms * (per_sm < 4 ? per_sm : 4);
    if (ctas > kMaxCtas) ctas = kMaxCtas;
  }
  return ctas;
}
#else
// One tile by one "thread": counts, offsets, then the elements in index
// order into the reorder buffer, and the rounds out of it.
void run_tile(const Plan& g, int p, const Route& r, PassSmem& sm, int tile) {
  const Io io = io_of(g, r);
  const int base = tile * kTile;
  const int count = g.n - base < kTile ? g.n - base : kTile;
  const bool on_sec = p < g.sec_passes;
  std::vector<uint32_t> word(count), pos(count);
  for (int d = 0; d < kBins; ++d) sm.warp_count[0][d] = 0u;
  for (int s = 0; s < count; ++s) {
    const int i = base + s;
    word[s] = on_sec ? load_sec(g, r, io, i) : load_key(g, r, io, i);
    pos[s] = sm.warp_count[0][digit_of(g, p, word[s])]++;
  }
  tile_offsets(g, p, tile, sm);
  for (int s = 0; s < count; ++s) {
    const uint32_t d = digit_of(g, p, word[s]);
    pos[s] += sm.tile_start[d] + sm.warp_count[0][d];
    sm.buf[pos[s]] = word[s];
  }
  for (int s = 0; s < count; ++s) {
    const uint32_t d = digit_of(g, p, sm.buf[s]);
    sm.dest[s] = static_cast<int>(sm.out_at[d] + (s - sm.tile_start[d]));
    write_word(io, on_sec ? 0 : 1, sm.dest[s], sm.buf[s]);
  }
  for (int kind = on_sec ? 1 : 2; kind <= 2; ++kind) {
    for (int s = 0; s < count; ++s) {
      const int i = base + s;
      sm.buf[pos[s]] = kind == 1 ? load_key(g, r, io, i)
                                 : static_cast<uint32_t>(load_perm(r, io, i));
    }
    for (int s = 0; s < count; ++s)
      write_word(io, kind, sm.dest[s], sm.buf[s]);
  }
}
#endif

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

int tiles_for(int n) { return (n + kTile - 1) / kTile; }

int passes_for(int key_bits, bool second, int* sec_passes) {
  *sec_passes = second ? 32 / kBits : 0;
  return *sec_passes + (key_bits + kBits - 1) / kBits;
}

bool args_ok(int n, int key_bits) {
  return n > 0 && n < 2147483647 - kTile && key_bits >= 1 && key_bits <= 31;
}

// The scratch carved into the plan's buffers.
void carve(Plan& g, char* s, int n) {
  const size_t words = align_up(static_cast<size_t>(n) * 4);
  for (int b = 0; b < 2; ++b) {
    g.kbuf[b] = reinterpret_cast<uint32_t*>(s);
    s += words;
    g.sbuf[b] = reinterpret_cast<uint32_t*>(s);
    s += words;
    g.pbuf[b] = reinterpret_cast<int*>(s);
    s += words;
  }
  g.start = reinterpret_cast<uint32_t*>(s);
  s += align_up(kMaxPasses * kBins * 4);
  g.trivial = reinterpret_cast<int*>(s);
  s += align_up(kMaxPasses * 4);
  g.next_tile = reinterpret_cast<uint32_t*>(s);
  s += align_up(kMaxPasses * 4);
  g.status = reinterpret_cast<unsigned long long*>(s);
}

size_t scratch_bytes(int n) {
  return 6 * align_up(static_cast<size_t>(n) * 4) +
         align_up(kMaxPasses * kBins * 4) + 2 * align_up(kMaxPasses * 4) +
         align_up(static_cast<size_t>(tiles_for(n)) * kBins * 8);
}

Plan make_plan(const int* key, const float* second, int n, int key_bits,
               int* sorted_key, int* perm, void* scratch) {
  Plan g{};
  g.key = key;
  g.second = second;
  g.n = n;
  g.tiles = tiles_for(n);
  g.passes = passes_for(key_bits, second != nullptr, &g.sec_passes);
  g.sorted_key = sorted_key;
  g.perm = perm;
  carve(g, static_cast<char*>(scratch), n);
  return g;
}

}  // namespace

extern "C" long long cc_direct_sort_scratch_bytes(int n) {
  if (n <= 0) return 0;
  return static_cast<long long>(scratch_bytes(n));
}

#ifdef __CUDACC__
// key [n] int32 in [0, 2**key_bits); second [n] f32 or null; sorted_key,
// perm [n] int32 out.
extern "C" int cc_direct_sort(const int* key, const float* second, int n,
                              int key_bits, int* sorted_key, int* perm,
                              void* scratch, void* stream_) {
  if (!args_ok(n, key_bits)) return static_cast<int>(cudaErrorInvalidValue);
  const int most = max_ctas();
  if (most < kMaxPasses) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Plan g = make_plan(key, second, n, key_bits, sorted_key, perm,
                           scratch);
  int ctas = (n + kTile - 1) / kTile;
  if (ctas < kMaxPasses) ctas = kMaxPasses;
  if (ctas > most) ctas = most;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, count_kernel, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int p = 0; p < g.passes; ++p)
    pass_kernel<<<g.tiles, kT, 0, stream>>>(g, p);
  return static_cast<int>(cudaGetLastError());
}
#else
// The same phases on the host: the count phases over `ctas` CTAs in turn,
// then each pass's tiles in order.
extern "C" int cc_direct_sort_host(const int* key, const float* second,
                                   int n, int key_bits, int* sorted_key,
                                   int* perm, int ctas) {
  if (!args_ok(n, key_bits) || ctas < 1 || ctas > kMaxCtas) return 1;
  std::vector<unsigned long long> scratch(scratch_bytes(n) / 8 + 1);
  Plan g = make_plan(key, second, n, key_bits, sorted_key, perm,
                     scratch.data());
  for (int c = 0; c < ctas; ++c) phase_zero(g, c, ctas);
  static uint32_t hist[kCopies * kMaxPasses][kBins];
  for (int c = 0; c < ctas; ++c) phase_count(g, hist, c, ctas);
  uint32_t warp_tot[1];
  for (int c = 0; c < g.passes; ++c) phase_starts(g, c, warp_tot);
  static PassSmem sm;
  for (int p = 0; p < g.passes; ++p) {
    const Route r = route(g, p);
    if (r.skip) {
      if (p == g.passes - 1 && r.first)
        for (int i = 0; i < n; ++i) identity(g, i);
      continue;
    }
    for (int t = 0; t < g.tiles; ++t) run_tile(g, p, r, sm, t);
  }
  return 0;
}
#endif
