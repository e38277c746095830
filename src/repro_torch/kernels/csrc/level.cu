// level_scan: one batch of level-hashing inserts, in batch order, in one launch.
//
// No Pallas kernel stands behind it: the reference runs the batch as one
// jitted lax.scan over level_insert_one (repro/core/baselines.py:134, :192),
// and this kernel is the port's counterpart of that single device program.
//
// Bound on the H100: latency. Each key's step reads what the previous key
// wrote, so the batch is one serial chain: a round of dependent loads per key
// (the four candidate buckets' alloc words and key slots), a second one when
// every candidate is full (the alternate top bucket of the record that would
// move), then the commit. One warp walks the batch so that a key costs one
// memory round trip where it can: its 32 lanes load and hash 32 keys at a
// time, and for each key lanes 0-15 load the 16 candidate slots (4 buckets x
// 4 slots, in the order top-a, top-b, bottom-a, bottom-b) together, so the
// uniqueness probe, the bucket counts and the free-slot search need no
// further load. Every lane then takes the same decision from shuffled words;
// lane 0 commits the stores in the reference's order, and __syncwarp orders
// them before the next key's loads.
//
// Semantics are the reference's, bit for bit: uint32 masks with XLA's rule
// that a shift by 32 or more gives 0; the less-loaded top bucket first, top-a
// on a tie; the first free slot of the first bucket with one; else slot 0 of
// top-a moves to its record's alternate top bucket; else NEED_SPLIT. Keys
// with valid == 0 are NOT_FOUND and change nothing; n_items grows by the
// INSERTED count.
#include "dash_common.cuh"

namespace {

constexpr int32_t INSERTED = 0, EXISTS = 1, NEED_SPLIT = 2, NOT_FOUND = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t low_mask(uint32_t n) {
  return (n < 32u ? (1u << n) : 0u) - 1u;
}

__device__ __forceinline__ int first_free(uint32_t a) {  // -1 if all 4 taken
  const uint32_t f = ~a & 0xFu;
  return f ? __ffs(f) - 1 : -1;
}

// The planes are read back after lane 0's stores, so they carry no __restrict__.
__global__ void level_scan_kernel(uint32_t* key_hi, uint32_t* key_lo, uint32_t* val,
                                  uint32_t* alloc,
                                  const int32_t* __restrict__ k_ptr,
                                  int32_t* __restrict__ n_items,
                                  const uint32_t* __restrict__ q_hi,
                                  const uint32_t* __restrict__ q_lo,
                                  const uint32_t* __restrict__ q_v,
                                  const uint8_t* __restrict__ valid,
                                  int32_t* __restrict__ status, long long n,
                                  int max_log2) {
  const int lane = threadIdx.x;
  const uint32_t kt = static_cast<uint32_t>(*k_ptr);
  const uint32_t mt = low_mask(kt), mb = low_mask(kt - 1u);
  const long long boff = 1LL << max_log2;
  // lanes 0-15 hold slot s of candidate bucket q
  const int q = (lane >> 2) & 3, s = lane & 3;
  int inserted = 0;
  for (long long base = 0; base < n; base += 32) {
    const long long i = base + lane;
    uint32_t my_hi = 0, my_lo = 0, my_v = 0, my_h1 = 0, my_h2 = 0;
    int my_ok = 0;
    if (i < n) {
      my_hi = q_hi[i];
      my_lo = q_lo[i];
      my_v = q_v[i];
      my_ok = valid[i] != 0;
      my_h1 = dash::hash_pair(my_hi, my_lo, dash::SEED1);
      my_h2 = dash::hash_pair(my_hi, my_lo, dash::SEED2);
    }
    int32_t my_status = NOT_FOUND;
    const int m = static_cast<int>(n - base < 32 ? n - base : 32);
    for (int j = 0; j < m; ++j) {
      if (!__shfl_sync(FULL, my_ok, j)) continue;  // warp-uniform
      const uint32_t hi = __shfl_sync(FULL, my_hi, j);
      const uint32_t lo = __shfl_sync(FULL, my_lo, j);
      const uint32_t v = __shfl_sync(FULL, my_v, j);
      const uint32_t h1 = __shfl_sync(FULL, my_h1, j);
      const uint32_t h2 = __shfl_sync(FULL, my_h2, j);
      const long long ta = h1 & mt, tb = h2 & mt;
      const long long ba = boff + (h1 & mb), bb = boff + (h2 & mb);
      const long long bq = q == 0 ? ta : q == 1 ? tb : q == 2 ? ba : bb;
      uint32_t a = 0, kh = 0, kl = 0;
      if (lane < 16) {
        a = alloc[bq];
        kh = key_hi[bq * 4 + s];
        kl = key_lo[bq * 4 + s];
      }
      const bool hit = lane < 16 && ((a >> s) & 1u) && kh == hi && kl == lo;
      const bool exists = __any_sync(FULL, hit);
      const uint32_t a_ta = __shfl_sync(FULL, a, 0), a_tb = __shfl_sync(FULL, a, 4);
      const uint32_t a_ba = __shfl_sync(FULL, a, 8), a_bb = __shfl_sync(FULL, a, 12);
      const uint32_t r_hi = __shfl_sync(FULL, kh, 0);  // slot 0 of top-a
      const uint32_t r_lo = __shfl_sync(FULL, kl, 0);
      int32_t st = EXISTS;
      if (!exists) {
        const bool a_first = __popc(a_ta & 0xFu) <= __popc(a_tb & 0xFu);
        const long long ob[4] = {a_first ? ta : tb, a_first ? tb : ta, ba, bb};
        const uint32_t oa[4] = {a_first ? a_ta : a_tb, a_first ? a_tb : a_ta, a_ba, a_bb};
        int which = -1, slot = -1;
        for (int w = 0; w < 4 && which < 0; ++w) {
          slot = first_free(oa[w]);
          if (slot >= 0) which = w;
        }
        if (which >= 0) {
          if (lane == 0) {
            const long long b = ob[which];
            key_hi[b * 4 + slot] = hi;
            key_lo[b * 4 + slot] = lo;
            val[b * 4 + slot] = v;
            alloc[b] = oa[which] | (1u << slot);
          }
          st = INSERTED;
        } else {
          const long long mta = dash::hash_pair(r_hi, r_lo, dash::SEED1) & mt;
          const long long mtb = dash::hash_pair(r_hi, r_lo, dash::SEED2) & mt;
          const long long alt = mta == ta ? mtb : mta;
          const uint32_t a_alt = alloc[alt];
          const int mv = first_free(a_alt);
          if (mv >= 0) {
            if (lane == 0) {  // the reference's store order, read back as it goes
              const uint32_t r_v = val[ta * 4];
              key_hi[alt * 4 + mv] = r_hi;
              key_lo[alt * 4 + mv] = r_lo;
              val[alt * 4 + mv] = r_v;
              alloc[alt] = a_alt | (1u << mv);
              alloc[ta] = alloc[ta] & ~1u;
              key_hi[ta * 4] = hi;
              key_lo[ta * 4] = lo;
              val[ta * 4] = v;
              alloc[ta] = alloc[ta] | 1u;
            }
            st = INSERTED;
          } else {
            st = NEED_SPLIT;
          }
        }
      }
      inserted += st == INSERTED;
      if (lane == j) my_status = st;
      __syncwarp();
    }
    if (i < n) status[i] = my_status;
  }
  if (lane == 0) *n_items += inserted;
}

}  // namespace

extern "C" int dash_level_scan(void* key_hi, void* key_lo, void* val, void* alloc,
                               const void* k, void* n_items, const void* hi,
                               const void* lo, const void* vals, const void* valid,
                               void* status, long long n, int max_log2,
                               void* stream) {
  if (n > 0) {
    level_scan_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(key_hi), static_cast<uint32_t*>(key_lo),
        static_cast<uint32_t*>(val), static_cast<uint32_t*>(alloc),
        static_cast<const int32_t*>(k), static_cast<int32_t*>(n_items),
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<const uint32_t*>(vals), static_cast<const uint8_t*>(valid),
        static_cast<int32_t*>(status), n, max_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
