// K1 segment_reduce: the per-broker aggregates of the search's carry.
//
// Replaces (JAX) cruise_control_tpu/analyzer/agg.py:70 compute_agg — the
// segment sums of model/tensors.py:157-229 (broker_load, replica and
// leader counts, per-(topic, broker) replica counts, potential_nw_out,
// leader_bytes_in) — and, in offline mode, the per-round
// offline_per_broker segment sum of analyzer/chain.py:234-238.
//
// Bound on this card: bytes. One pass reads the [P, S] assignment and the
// per-partition loads (~0.6 MB at 100 brokers / 10k partitions, ~58 MB at
// 7,000 brokers / 1M partitions); the work per byte is a handful of adds,
// far below the H100's ridge.
//
// Design (full mode): a stable counting sort of the slots by broker, then
// one serial fold per broker in bucket (= flat) order. Deterministic, with
// no float atomics. The flat [P·S] slot axis is cut into CTA tiles of a
// power of two of slots, 1,024 to 8,192, about kTargetTiles of them:
//  1. count: each CTA builds its tile's per-broker replica and leader
//     histograms in shared memory and writes the replica histogram as row
//     `tile` of a [tiles, B] table (no memset: every row is written); the
//     integer outputs (leader counts, the [T, B] topic plane) are integer
//     atomics, exact in any order;
//  2. column scan: per broker, exclusive offsets down its column of the
//     table (8 warps split the tiles, 32 brokers a CTA), and its total;
//  3. base scan: one CTA scans the totals into each broker's base;
//  4. place: each CTA walks its tile in flat order, 32 slots a warp
//     (__match_any_sync ranks the lanes that share a broker), its warps
//     taking their positions in turn from a shared-memory cursor per
//     broker; each slot writes one 4-byte entry, its partition and
//     whether it leads, so every bucket lists its slots in flat order;
//  5. fold: one warp per broker gathers 32 entries' six addends (four
//     load columns, potential NW-out, leader NW-in or +0.0) into shared
//     memory, the next 32 loading while lanes 0-5 fold these, one column
//     each, serially in bucket order with __fadd_rn (the loads do not
//     depend on the sums, so they pipeline).
// Step 5 is the reference's sequential segment sum (adding +0.0 for a
// follower's leader NW-in leaves any sum that starts at +0.0 unchanged),
// so the f32 results carry the same bits as the plain twin's index_add_
// on the CPU. Placement writes 4-byte entries, not the 24 bytes of
// addends: scattering the addends themselves took 0.82 ms a call at
// 7k/1M on an H100 against 0.25 ms for this design (PERF.md).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCountThreads = 1024;
constexpr int kTargetTiles = 528;  // 4 CTAs on each of 132 SMs
constexpr int kMinTile = 1024;
constexpr int kMaxTile = 8192;
constexpr int kMaxBrokers = 16384;
constexpr int kNwIn = 1;
constexpr int kNwOut = 2;
constexpr int kR = 4;
constexpr int kCols = kR + 2;
constexpr int kDead = 1;

// Slot indices fit int: P·S < 2**31 is checked on the host.
__device__ __forceinline__ int slot_broker(const int* __restrict__ assignment,
                                           const uint8_t* __restrict__ pmask,
                                           int i, int S, int B) {
  const int b = assignment[i];
  return (b >= 0 && b < B && pmask[i / S]) ? b : -1;
}

// 1. per-tile replica histogram row, leader counts and the topic plane.
// Dynamic shared memory: 2B ints.
__global__ void __launch_bounds__(kCountThreads) count_kernel(
    const int* __restrict__ assignment, const int* __restrict__ leader_slot,
    const uint8_t* __restrict__ pmask, const int* __restrict__ topic, int n,
    int S, int B, int T, int tile, int* __restrict__ cnt,
    int* __restrict__ broker_leaders, int* __restrict__ topic_counts) {
  extern __shared__ int hist[];  // [B] replicas, then [B] leaders
  int* lhist = hist + B;
  for (int b = threadIdx.x; b < 2 * B; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int lo = blockIdx.x * tile;
  const int hi = min(n, lo + tile);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int b = slot_broker(assignment, pmask, i, S, B);
    if (b < 0) continue;
    atomicAdd(&hist[b], 1);
    const int p = i / S;
    if (leader_slot[p] == i - p * S) atomicAdd(&lhist[b], 1);
    const int t = topic[p];
    if (t >= 0 && t < T)
      atomicAdd(&topic_counts[static_cast<long long>(t) * B + b], 1);
  }
  __syncthreads();
  int* row = cnt + static_cast<long long>(blockIdx.x) * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    row[b] = hist[b];
    if (lhist[b]) atomicAdd(&broker_leaders[b], lhist[b]);
  }
}

// 2. per broker: exclusive offsets down its column of the tile table and
// its total. A CTA takes 32 brokers (one per lane); its 8 warps split the
// tiles into contiguous ranges.
__global__ void __launch_bounds__(kThreads) column_scan_kernel(
    int B, int tiles, int* __restrict__ cnt, int* __restrict__ total) {
  __shared__ int part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const int per = (tiles + kWarps - 1) / kWarps;
  const int t0 = min(tiles, warp * per), t1 = min(tiles, t0 + per);
  int sum = 0;
  if (b < B)
    for (int t = t0; t < t1; ++t) sum += cnt[static_cast<long long>(t) * B + b];
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = part[w][lane];
      part[w][lane] = run;
      run += v;
    }
    if (b < B) total[b] = run;
  }
  __syncthreads();
  if (b >= B) return;
  int run = part[warp][lane];
  for (int t = t0; t < t1; ++t) {
    int* c = cnt + static_cast<long long>(t) * B + b;
    const int v = *c;
    *c = run;
    run += v;
  }
}

// 3. one CTA: exclusive scan of the brokers' totals (any B, in chunks)
__global__ void base_scan_kernel(int B, const int* __restrict__ total,
                                 int* __restrict__ base,
                                 int* __restrict__ broker_replicas) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int chunk = 0; chunk < B; chunk += blockDim.x) {
    const int b = chunk + threadIdx.x;
    const int v = b < B ? total[b] : 0;
    int x = v;  // inclusive warp scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (b < B) {
      base[b] = before + x - v;
      broker_replicas[b] = v;
    }
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = before + x;
    __syncthreads();
  }
}

// 4. stable placement of each slot's entry, (partition << 1) | leads.
// Dynamic shared memory: B ints, each broker's next free position.
__global__ void __launch_bounds__(kThreads) place_kernel(
    const int* __restrict__ assignment, const int* __restrict__ leader_slot,
    const uint8_t* __restrict__ pmask, int n, int S, int B, int tile,
    const int* __restrict__ cnt, const int* __restrict__ base,
    uint32_t* __restrict__ order) {
  extern __shared__ int cursor_mem[];
  volatile int* cursor = cursor_mem;
  __shared__ int turn_mem;
  volatile int* turn = &turn_mem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* row = cnt + static_cast<long long>(blockIdx.x) * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    cursor[b] = base[b] + row[b];
  if (threadIdx.x == 0) *turn = 0;
  __syncthreads();
  const int lo = blockIdx.x * tile;
  const int hi = min(n, lo + tile);
  const unsigned below = (1u << lane) - 1u;
  int step = warp;
  for (int g = lo; g < hi; g += kThreads, step += kWarps) {
    const int i = g + warp * 32 + lane;
    const int b = i < hi ? slot_broker(assignment, pmask, i, S, B) : -1;
    uint32_t entry = 0;
    if (b >= 0) {
      const int p = i / S;
      entry = (static_cast<uint32_t>(p) << 1) |
              (leader_slot[p] == i - p * S ? 1u : 0u);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int first = __ffs(peers) - 1;
    // This warp's turn: every earlier group of 32 slots of the tile has
    // taken its positions.
    while (*turn != step) {
    }
    __threadfence_block();
    int old = 0;
    if (b >= 0 && lane == first) {
      old = cursor[b];
      cursor[b] = old + __popc(peers);
    }
    __syncwarp();
    __threadfence_block();
    if (lane == 0) *turn = step + 1;
    const int pos = __shfl_sync(0xffffffffu, old, first) +
                    __popc(peers & below);
    if (b >= 0) order[pos] = entry;
  }
}

// The six addends of a bucket entry (valid lanes only).
__device__ __forceinline__ void gather_addends(
    bool valid, uint32_t entry, const float* __restrict__ leader_load,
    const float* __restrict__ follower_load, float* v) {
  if (!valid) return;
  const long long p = entry >> 1;
  const bool lead = entry & 1u;
  const float* r = (lead ? leader_load : follower_load) + p * kR;
#pragma unroll
  for (int c = 0; c < kR; ++c) v[c] = r[c];
  v[kR] = leader_load[p * kR + kNwOut];
  v[kR + 1] = lead ? leader_load[p * kR + kNwIn] : 0.0f;
}

// 5. per-broker serial folds in bucket order, one warp each. Two stages
// run ahead of the fold: the rows of the next 32 entries and the entries
// of the 32 after them.
__global__ void __launch_bounds__(kThreads) bucket_fold_kernel(
    int B, const int* __restrict__ base, const int* __restrict__ total,
    const uint32_t* __restrict__ order, const float* __restrict__ leader_load,
    const float* __restrict__ follower_load, float* __restrict__ broker_load,
    float* __restrict__ pot, float* __restrict__ lbi) {
  __shared__ float buf[kWarps][32 * kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  float* sm = buf[warp];
  const uint32_t* bucket = order + base[b];
  const int count = total[b];
  float acc = 0.0f;
  float v[kCols];
  gather_addends(lane < count, lane < count ? bucket[lane] : 0u, leader_load,
                 follower_load, v);
  uint32_t ahead = 32 + lane < count ? bucket[32 + lane] : 0u;
  for (int e0 = 0; e0 < count; e0 += 32) {
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kCols; ++c) sm[lane * kCols + c] = v[c];
    __syncwarp();
    gather_addends(e0 + 32 + lane < count, ahead, leader_load, follower_load,
                   v);
    ahead = e0 + 64 + lane < count ? bucket[e0 + 64 + lane] : 0u;
    if (lane < kCols) {
      const int m = min(32, count - e0);
      for (int e = 0; e < m; ++e) acc = __fadd_rn(acc, sm[e * kCols + lane]);
    }
  }
  if (lane < kR) broker_load[b * kR + lane] = acc;
  else if (lane == kR) pot[b] = acc;
  else if (lane == kR + 1) lbi[b] = acc;
}

__global__ void offline_count_kernel(const int* __restrict__ assignment,
                                     const uint8_t* __restrict__ pmask,
                                     const int8_t* __restrict__ broker_state,
                                     const uint8_t* __restrict__ broker_mask,
                                     int n, int S, int B,
                                     int* __restrict__ hist) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int b = slot_broker(assignment, pmask, i, S, B);
    if (b >= 0 && (broker_state[b] == kDead || !broker_mask[b]))
      atomicAdd(&hist[b], 1);
  }
}

__global__ void to_float_kernel(int B, const int* __restrict__ hist,
                                float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) out[b] = static_cast<float>(hist[b]);
}

// CTA tile of the full mode: the power of two of slots, from kMinTile to
// kMaxTile, nearest above n / kTargetTiles.
inline int tile_of(long long n) {
  int t = kMinTile;
  while (t < kMaxTile && static_cast<long long>(t) * kTargetTiles < n)
    t <<= 1;
  return t;
}

inline long long tiles_of(long long n) {
  return (n + tile_of(n) - 1) / tile_of(n);
}

}  // namespace

// Int32 words of scratch the full mode needs for n slots and B brokers:
// the [tiles, B] table, totals and bases [B] each, and the bucket entries
// [n].
extern "C" long long cc_segment_reduce_scratch_words(long long n, int B) {
  return tiles_of(n) * B + 2LL * B + n;
}

extern "C" int cc_segment_reduce_full(
    const int* assignment, const int* leader_slot,
    const uint8_t* partition_mask, const float* leader_load,
    const float* follower_load, const int* topic, int P, int S, int B, int T,
    float* broker_load, int* broker_replicas, int* broker_leaders,
    float* pot, float* lbi, int* topic_counts, int* scratch,
    long long scratch_words, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n = static_cast<long long>(P) * S;
  if (n >= (1LL << 31) || B < 1 || B > kMaxBrokers ||
      scratch_words < cc_segment_reduce_scratch_words(n, B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(broker_leaders, 0, sizeof(int) * B, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(topic_counts, 0,
                          sizeof(int) * static_cast<size_t>(T) * B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) {
    err = cudaMemsetAsync(broker_replicas, 0, sizeof(int) * B, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(broker_load, 0, sizeof(float) * kR * B, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(pot, 0, sizeof(float) * B, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(lbi, 0, sizeof(float) * B, stream);
    return static_cast<int>(err);
  }
  // Once per process: the most shared memory the two kernels can take.
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(int) * 2 * kMaxBrokers));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(place_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizeof(int) * kMaxBrokers));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int ni = static_cast<int>(n);
  const int tile = tile_of(n);
  const int tiles = static_cast<int>(tiles_of(n));
  int* cnt = scratch;
  int* total = cnt + static_cast<long long>(tiles) * B;
  int* base = total + B;
  uint32_t* order = reinterpret_cast<uint32_t*>(base + B);
  count_kernel<<<tiles, kCountThreads, sizeof(int) * 2 * B, stream>>>(
      assignment, leader_slot, partition_mask, topic, ni, S, B, T, tile, cnt,
      broker_leaders, topic_counts);
  column_scan_kernel<<<(B + 31) / 32, kThreads, 0, stream>>>(B, tiles, cnt,
                                                             total);
  base_scan_kernel<<<1, 1024, 0, stream>>>(B, total, base, broker_replicas);
  place_kernel<<<tiles, kThreads, sizeof(int) * B, stream>>>(
      assignment, leader_slot, partition_mask, ni, S, B, tile, cnt, base,
      order);
  bucket_fold_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      B, base, total, order, leader_load, follower_load, broker_load, pot,
      lbi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_segment_reduce_offline(
    const int* assignment, const uint8_t* partition_mask,
    const int8_t* broker_state, const uint8_t* broker_mask, int P, int S,
    int B, int* hist, float* out, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long n = static_cast<long long>(P) * S;
  if (n >= (1LL << 31) || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 1056 ? want : 1056);
  offline_count_kernel<<<blocks, 256, 0, stream>>>(
      assignment, partition_mask, broker_state, broker_mask,
      static_cast<int>(n), S, B, hist);
  to_float_kernel<<<(B + 255) / 256, 256, 0, stream>>>(B, hist, out);
  return static_cast<int>(cudaGetLastError());
}
