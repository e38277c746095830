// Device functions and launch helpers shared by the Dash kernels (hashmix.cu,
// probe.cu, fused.cu).
//
// hash_pair is the port of repro.core.hashing.hash_pair: murmur3 fmix32 of
// lo ^ seed, a boost-style combine with fmix32(hi + seed), then fmix32 again,
// all mod 2^32. uint32_t arithmetic wraps exactly as the reference's uint32
// lanes do, so no masking is needed here.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dash {

constexpr uint32_t SEED1 = 0x9E3779B9u;  // addressing hash
constexpr uint32_t SEED2 = 0x85EBCA6Bu;  // fingerprint hash
constexpr int NSLOTS = 14;               // bits of the packed alloc bitmap
constexpr uint32_t SLOT_MASK = (1u << NSLOTS) - 1u;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_pair(uint32_t hi, uint32_t lo,
                                              uint32_t seed) {
  uint32_t h = fmix32(lo ^ seed);
  h ^= fmix32(hi + seed) + 0x9E3779B9u + (h << 6) + (h >> 2);
  return fmix32(h);
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

// Streaming multiprocessors of the current device (132 on an H100 SXM),
// read once per process.
inline int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return count;
}

}  // namespace dash
