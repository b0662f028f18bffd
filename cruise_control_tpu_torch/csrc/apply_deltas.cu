// K4 apply_deltas: scatter the accepted batch's effect onto the carry.
//
// Replaces (JAX) cruise_control_tpu/analyzer/agg.py:98
// apply_deltas_to_agg: per aggregate, `.at[src].add(-delta)` then
// `.at[dst].add(delta)` over the selected rows (unselected rows route out
// of bounds and are dropped), for the per-broker load [B, R], replica and
// leader counts, potential NW-out, leader bytes-in and the per-(topic,
// broker) replica counts.
//
// Bound on this card: bytes. The function is out-of-place, so the carry
// (dominated by the [T, B] topic plane: 0.4 MB at 1k brokers / 100
// topics, 19.6 MB at 7k / 700) is read once and written once; the batch
// itself touches at most 2m brokers and 2m topic cells.
//
// Design: work proportional to m, plus one bytes-bound copy.
//  1. carry_copy_kernel, over all SMs: out = in for the six aggregates
//     (16-byte vectors where the pointers allow).
//  2. event_fold_kernel, one CTA, after the copy on the same stream:
//     - integer outputs by atomics, one thread per selected row: integer
//       adds are exact in any order;
//     - float outputs in the reference's order: each selected row gives
//       two events, (src broker, phase 0, row) and (dst broker, phase 1,
//       row), packed into one 32-bit key; a block-wide radix sort (CUB's
//       BlockRadixSort, a building block inside this kernel) orders them
//       by (broker, phase, row); each sorted event's six signed deltas
//       are staged in shared memory in that order; the thread at the
//       start of each run of one broker finds the run's end by binary
//       search and folds the run serially from the input value with
//       __fadd_rn, six columns at once, over addresses that do not depend
//       on the sums. That is exactly the twin's sequence of adds per cell
//       (every source row in row order, then every destination row in row
//       order), so the f32 outputs carry the CPU twin's bits.
// Out-of-range brokers or topics are dropped, as JAX's mode="drop" does.
#include <cub/block/block_radix_sort.cuh>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kCopyThreads = 256;
constexpr int kR = 4;
constexpr int kCols = kR + 2;   // four load columns, pot, lbi
constexpr int kMaxM = 2048;     // 2m events in kThreads x 4 sort items
constexpr int kRowBits = 12;    // a row index, < 4096
constexpr int kEventBits = kRowBits + 1;  // + the phase bit
constexpr uint32_t kPad = 0xFFFFFFFFu;

// out[0, n) = in[0, n) for 4-byte words, by 16-byte vectors when both
// pointers are 16-byte aligned; grid-stride over all CTAs.
__device__ __forceinline__ void copy_words(const void* __restrict__ in,
                                           void* __restrict__ out,
                                           long long n) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(in) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const long long n4 = n >> 2;
    const int4* src = static_cast<const int4*>(in);
    int4* dst = static_cast<int4*>(out);
    for (long long i = tid; i < n4; i += stride) dst[i] = src[i];
    done = n4 << 2;
  }
  const int* src = static_cast<const int*>(in);
  int* dst = static_cast<int*>(out);
  for (long long i = done + tid; i < n; i += stride) dst[i] = src[i];
}

__global__ void carry_copy_kernel(const float* __restrict__ load_in,
                            const int* __restrict__ reps_in,
                            const int* __restrict__ leads_in,
                            const float* __restrict__ pot_in,
                            const float* __restrict__ lbi_in,
                            const int* __restrict__ topic_in, int B, int T,
                            float* __restrict__ load_out,
                            int* __restrict__ reps_out,
                            int* __restrict__ leads_out,
                            float* __restrict__ pot_out,
                            float* __restrict__ lbi_out,
                            int* __restrict__ topic_out) {
  copy_words(topic_in, topic_out, static_cast<long long>(T) * B);
  copy_words(load_in, load_out, static_cast<long long>(B) * kR);
  copy_words(reps_in, reps_out, B);
  copy_words(leads_in, leads_out, B);
  copy_words(pot_in, pot_out, B);
  copy_words(lbi_in, lbi_out, B);
}

__device__ __forceinline__ float delta_of(
    int row, int c, const float* __restrict__ load_delta,
    const float* __restrict__ pot_delta,
    const float* __restrict__ lbi_delta) {
  return c < kR ? load_delta[row * kR + c]
                : (c == kR ? pot_delta[row] : lbi_delta[row]);
}

// kItems sort items a thread: 2m <= kThreads * kItems events. Dynamic
// shared memory: the sorted events' signed deltas [kThreads * kItems][6],
// then their keys [kThreads * kItems].
template <int kItems>
__global__ void __launch_bounds__(kThreads) event_fold_kernel(
    const float* __restrict__ load_in, const float* __restrict__ pot_in,
    const float* __restrict__ lbi_in, const int* __restrict__ src,
    const int* __restrict__ dst, const float* __restrict__ load_delta,
    const int* __restrict__ rep, const int* __restrict__ lead,
    const int* __restrict__ topic, const uint8_t* __restrict__ sel,
    const float* __restrict__ pot_delta, const float* __restrict__ lbi_delta,
    int m, int B, int T, int key_bits, float* __restrict__ load_out,
    int* __restrict__ reps_out, int* __restrict__ leads_out,
    float* __restrict__ pot_out, float* __restrict__ lbi_out,
    int* __restrict__ topic_out) {
  constexpr int kN = kThreads * kItems;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems>;
  __shared__ typename Sort::TempStorage sort_temp;
  extern __shared__ float sorted_delta[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(sorted_delta + kN * kCols);
  // integer outputs: exact in any order
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (!sel[i]) continue;
    const int s = src[i], d = dst[i], r = rep[i], l = lead[i], t = topic[i];
    const bool t_ok = t >= 0 && t < T;
    if (s >= 0 && s < B) {
      atomicSub(&reps_out[s], r);
      atomicSub(&leads_out[s], l);
      if (t_ok) atomicSub(&topic_out[static_cast<long long>(t) * B + s], r);
    }
    if (d >= 0 && d < B) {
      atomicAdd(&reps_out[d], r);
      atomicAdd(&leads_out[d], l);
      if (t_ok) atomicAdd(&topic_out[static_cast<long long>(t) * B + d], r);
    }
  }
  // Events 2i (source) and 2i + 1 (destination) of row i, blocked: thread
  // t holds events t * kItems ... t * kItems + kItems - 1.
  uint32_t key[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = threadIdx.x * kItems + k;
    const int row = e >> 1, phase = e & 1;
    key[k] = kPad;
    if (row < m && sel[row]) {
      const int b = phase ? dst[row] : src[row];
      if (b >= 0 && b < B)
        key[k] = (static_cast<uint32_t>(b) << kEventBits) |
                 (static_cast<uint32_t>(phase) << kRowBits) |
                 static_cast<uint32_t>(row);
    }
  }
  // Stable on (broker, phase, row) within key_bits; the pad, all ones
  // there, sorts last.
  Sort(sort_temp).Sort(key, 0, key_bits);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = threadIdx.x * kItems + k;
    keys[e] = key[k];
    if (key[k] == kPad) continue;
    const int row = static_cast<int>(key[k] & ((1u << kRowBits) - 1u));
    const bool gain = (key[k] >> kRowBits) & 1u;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float v = delta_of(row, c, load_delta, pot_delta, lbi_delta);
      sorted_delta[e * kCols + c] = gain ? v : -v;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kN; j += blockDim.x) {
    const uint32_t kj = keys[j];
    if (kj == kPad) continue;
    const uint32_t b = kj >> kEventBits;
    if (j > 0 && (keys[j - 1] >> kEventBits) == b) continue;
    // The run of broker b is [j, end): the pad's broker field is above
    // every broker's.
    int end = j + 1, hi = kN;
    while (end < hi) {
      const int mid = (end + hi) >> 1;
      if ((keys[mid] >> kEventBits) > b) hi = mid;
      else end = mid + 1;
    }
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kR; ++c) acc[c] = load_in[b * kR + c];
    acc[kR] = pot_in[b];
    acc[kR + 1] = lbi_in[b];
#pragma unroll 4
    for (int e = j; e < end; ++e) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[c] = __fadd_rn(acc[c], sorted_delta[e * kCols + c]);
    }
#pragma unroll
    for (int c = 0; c < kR; ++c) load_out[b * kR + c] = acc[c];
    pot_out[b] = acc[kR];
    lbi_out[b] = acc[kR + 1];
  }
}

// Sizes and launches the event kernel for kItems sort items a thread.
template <int kItems>
cudaError_t launch_events(
    cudaStream_t stream, const float* load_in, const float* pot_in,
    const float* lbi_in, const int* src, const int* dst,
    const float* load_delta, const int* rep, const int* lead,
    const int* topic, const uint8_t* sel, const float* pot_delta,
    const float* lbi_delta, int m, int B, int T, int key_bits,
    float* load_out, int* reps_out, int* leads_out, float* pot_out,
    float* lbi_out, int* topic_out) {
  const int smem = static_cast<int>((sizeof(float) * kCols + sizeof(uint32_t)) *
                                    kThreads * kItems);
  static bool sized = false;  // once per process
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        event_fold_kernel<kItems>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  event_fold_kernel<kItems><<<1, kThreads, smem, stream>>>(
      load_in, pot_in, lbi_in, src, dst, load_delta, rep, lead, topic, sel,
      pot_delta, lbi_delta, m, B, T, key_bits, load_out, reps_out,
      leads_out, pot_out, lbi_out, topic_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cc_apply_deltas(
    const float* load_in, const int* reps_in, const int* leads_in,
    const float* pot_in, const float* lbi_in, const int* topic_in,
    const int* src, const int* dst, const float* load_delta, const int* rep,
    const int* lead, const int* topic, const uint8_t* sel,
    const float* pot_delta, const float* lbi_delta, int m, int B, int T,
    float* load_out, int* reps_out, int* leads_out, float* pot_out,
    float* lbi_out, int* topic_out, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (m < 0 || m > kMaxM || B < 1 || B >= (1 << (32 - kEventBits)) || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long words = static_cast<long long>(T) * B;
  const long long want = (words / 4 + kCopyThreads - 1) / kCopyThreads;
  const int copy_blocks = static_cast<int>(want < 1 ? 1
                                           : (want > 1056 ? 1056 : want));
  carry_copy_kernel<<<copy_blocks, kCopyThreads, 0, stream>>>(
      load_in, reps_in, leads_in, pot_in, lbi_in, topic_in, B, T, load_out,
      reps_out, leads_out, pot_out, lbi_out, topic_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  // Key bits that hold every broker: the pad is all ones within them.
  int key_bits = kEventBits + 1;
  while (key_bits < 32 && (1u << (key_bits - kEventBits)) < static_cast<unsigned>(B))
    ++key_bits;
  err = 2 * m <= kThreads
            ? launch_events<1>(stream, load_in, pot_in, lbi_in, src, dst,
                               load_delta, rep, lead, topic, sel, pot_delta,
                               lbi_delta, m, B, T, key_bits, load_out,
                               reps_out, leads_out, pot_out, lbi_out,
                               topic_out)
            : launch_events<4>(stream, load_in, pot_in, lbi_in, src, dst,
                               load_delta, rep, lead, topic, sel, pot_delta,
                               lbi_delta, m, B, T, key_bits, load_out,
                               reps_out, leads_out, pot_out, lbi_out,
                               topic_out);
  return static_cast<int>(err);
}
