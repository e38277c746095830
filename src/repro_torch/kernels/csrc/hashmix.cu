// bulk_hash: (h1, h2, fp) for N (hi, lo) key pairs.
//
// Replaces the Pallas TPU kernel repro/kernels/hashmix.py:bulk_hash (body
// _mix_block), which hashes (1024,)-key VMEM tiles with both seeds.
//
// Bound on the H100: bytes. Each key reads 8 bytes and writes 12; the two
// hash_pair calls are ~40 integer ops, far under the card's integer rate for
// that traffic. The design therefore only has to stream: one thread per key
// in a grid-stride loop, neighbouring threads on neighbouring words so every
// load and store is coalesced, and each key's words read once for both
// seeds. The ragged edge is masked by the loop bound, so N is any size (the
// TPU kernel demanded N % 1024 == 0).
#include "dash_common.cuh"

namespace {

__global__ void bulk_hash_kernel(const uint32_t* __restrict__ hi,
                                 const uint32_t* __restrict__ lo,
                                 uint32_t* __restrict__ h1,
                                 uint32_t* __restrict__ h2,
                                 int32_t* __restrict__ fp, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t a = hi[i];
    const uint32_t b = lo[i];
    const uint32_t y = dash::hash_pair(a, b, dash::SEED2);
    h1[i] = dash::hash_pair(a, b, dash::SEED1);
    h2[i] = y;
    fp[i] = static_cast<int32_t>(y & 0xFFu);
  }
}

}  // namespace

extern "C" int dash_bulk_hash(const void* hi, const void* lo, void* h1,
                              void* h2, void* fp, long long n, void* stream) {
  if (n > 0) {
    // enough blocks to fill 132 SMs several times over; the loop covers the rest
    unsigned int blocks = dash::blocks_for(n);
    if (blocks > 132u * 16u) blocks = 132u * 16u;
    bulk_hash_kernel<<<blocks, dash::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<uint32_t*>(h1), static_cast<uint32_t*>(h2),
        static_cast<int32_t*>(fp), n);
  }
  return static_cast<int>(cudaGetLastError());
}
