// Shared helpers of the port's hand-written Hopper kernels.
//
// Keys for top-k: an f32 value and its row index packed into one uint64
// whose unsigned order is (value descending in IEEE total order, then
// index ascending) — the order of lax.top_k, which puts -0.0 below +0.0
// and the lower index first among equal values. Sorting packed keys
// descending therefore reproduces the reference's top-k rows exactly.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cc {

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ uint32_t ordered_bits(float v) {
  uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered_float(uint32_t o) {
  uint32_t b = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(b);
}

__device__ __forceinline__ unsigned long long pack_key(float v, uint32_t idx) {
  return (static_cast<unsigned long long>(ordered_bits(v)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - idx);
}

__device__ __forceinline__ uint32_t key_index(unsigned long long k) {
  return 0xFFFFFFFFu - static_cast<uint32_t>(k & 0xFFFFFFFFull);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  return unordered_float(static_cast<uint32_t>(k >> 32));
}

}  // namespace cc
