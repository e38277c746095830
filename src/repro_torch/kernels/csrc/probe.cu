// fingerprint_probe: per lane, the 14-bit fingerprint match bitmaps and the
// free-slot bitmaps of the target and probing buckets.
//
// Replaces the Pallas TPU kernel repro/kernels/probe.py:fingerprint_probe
// (body _probe_block). That kernel gathers bucket rows with one-hot MXU
// matmuls over (S, 128, 128) padded fingerprint tiles and (S, C) routed
// lanes; both are TPU tiling. Here each lane carries its segment id and the
// kernel reads the table's natural planes in place: fp (S, BT, 16) uint8 and
// meta (S, BT) u32, whose low 14 bits are the alloc bitmap.
//
// Bound on the H100: by the guide's count, bytes (lane words in and out plus
// the 32-byte sectors of the fp rows and meta words touched, 65 B a lane at
// 1M lanes). What holds the kernel back from that bound is the rate of
// scattered requests, not HBM: each lane makes four random 16- or 4-byte
// loads, and chip_smoke.py times the kernel nearly as slow with the planes
// already in L2 as with L2 flushed. The design therefore cuts requests and
// stalls, not bytes:
//  - fp rows and meta words go through L1 (__ldg): the probing bucket is
//    usually b + 1, whose fp row and meta word share a sector or line with
//    bucket b's, so the second load of a lane usually hits L1;
//  - every row load of a thread's lanes is issued before any compare: row
//    and segment indices are clamped to in-bounds addresses and the
//    out-of-range rules applied by selects once the words have arrived, so
//    no load waits on a branch;
//  - a thread takes 2 lanes, N / 2 apart, once the batch fills the card
//    with them (1 below), so every lane load and store stays coalesced
//    across the warp; the block size is chosen from N and the SM count, so
//    every batch the planner gives the kernel (1025 lanes to 1M) spreads
//    over the whole card.
//
// Semantics match the reference kernel exactly on every input: a lane whose
// bucket index is < 0 (padding) gets 0 for that bucket; a bucket index >= BT
// reads as an empty row (bits 0, free 0x3FFF), as the zero padding rows of
// the reference's tiles do. A segment id outside [0, S) marks a padding lane.
#include <algorithm>

#include "dash_common.cuh"

namespace {

// Bit j set where fingerprint byte j of the row equals qfp (qfp may be any
// int: -1 on a padding lane matches no byte).
__device__ __forceinline__ uint32_t fp_matches(uint4 w, int qfp) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < dash::NSLOTS; ++j) {
    const int byte = static_cast<int>((words[j >> 2] >> (8 * (j & 3))) & 0xFFu);
    m |= static_cast<uint32_t>(byte == qfp) << j;
  }
  return m;
}

// Thread t serves lanes t, t + T, .., t + (LPT - 1) T, T the grid's thread
// count. out holds four rows of n words: bits_b, bits_pb, free_b, free_pb.
template <int LPT>
__global__ void fingerprint_probe_kernel(
    const uint8_t* __restrict__ fp, const uint32_t* __restrict__ meta,
    long long num_segments, int bt, const int32_t* __restrict__ q_seg,
    const int32_t* __restrict__ q_fp, const int32_t* __restrict__ q_b,
    const int32_t* __restrict__ q_pb, long long n, int32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int32_t seg[LPT], qfp[LPT], row[2][LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const long long i = t + k * stride;
    const bool in = i < n;
    seg[k] = in ? q_seg[i] : -1;
    qfp[k] = in ? q_fp[i] : -1;
    row[0][k] = in ? q_b[i] : -1;
    row[1][k] = in ? q_pb[i] : -1;
  }

  // Every row load of every lane is in flight before the first compare.
  uint4 w[2][LPT];
  uint32_t a[2][LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const long long s = seg[k] >= 0 && seg[k] < num_segments ? seg[k] : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = s * bt + min(max(row[h][k], 0), bt - 1);
      w[h][k] = __ldg(reinterpret_cast<const uint4*>(fp + r * 16));
      a[h][k] = __ldg(meta + r);
    }
  }

#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const long long i = t + k * stride;
    if (i >= n) continue;
    const bool seg_ok = seg[k] >= 0 && seg[k] < num_segments;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rw = row[h][k];
      const uint32_t alloc = rw < bt ? (a[h][k] & dash::SLOT_MASK) : 0u;
      const bool live = seg_ok && rw >= 0;
      out[h * n + i] = live ? static_cast<int32_t>(fp_matches(w[h][k], qfp[k]) & alloc) : 0;
      out[(2 + h) * n + i] = live ? static_cast<int32_t>(~alloc & dash::SLOT_MASK) : 0;
    }
  }
}

template <int LPT>
void launch(const uint8_t* fp, const uint32_t* meta, long long num_segments, int bt,
            const int32_t* q_seg, const int32_t* q_fp, const int32_t* q_b,
            const int32_t* q_pb, long long n, int32_t* out, cudaStream_t stream) {
  // At most 256 threads a block, at least one warp, and as many blocks as the
  // batch allows up to one per SM before blocks grow.
  const long long sms = dash::sm_count();
  const long long threads = (n + LPT - 1) / LPT;
  const long long per_sm = (threads + sms - 1) / sms;
  const int block = static_cast<int>(std::min(256LL, std::max(32LL, (per_sm + 31) / 32 * 32)));
  const unsigned int grid = static_cast<unsigned int>((threads + block - 1) / block);
  fingerprint_probe_kernel<LPT><<<grid, block, 0, stream>>>(
      fp, meta, num_segments, bt, q_seg, q_fp, q_b, q_pb, n, out);
}

}  // namespace

// out: (4, n) int32.
extern "C" int dash_fingerprint_probe(const void* fp, const void* meta,
                                      long long num_segments, int bt,
                                      const void* q_seg, const void* q_fp,
                                      const void* q_b, const void* q_pb,
                                      long long n, void* out, void* stream) {
  if (n > 0) {
    const auto* f = static_cast<const uint8_t*>(fp);
    const auto* m = static_cast<const uint32_t*>(meta);
    const auto* a = static_cast<const int32_t*>(q_seg);
    const auto* b = static_cast<const int32_t*>(q_fp);
    const auto* c = static_cast<const int32_t*>(q_b);
    const auto* d = static_cast<const int32_t*>(q_pb);
    auto* o = static_cast<int32_t*>(out);
    auto* s = static_cast<cudaStream_t>(stream);
    // 2 lanes a thread once that still gives every SM 2048 threads.
    if (n >= 2 * 2048LL * dash::sm_count()) {
      launch<2>(f, m, num_segments, bt, a, b, c, d, n, o, s);
    } else {
      launch<1>(f, m, num_segments, bt, a, b, c, d, n, o, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
