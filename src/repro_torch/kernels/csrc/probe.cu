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
// Bound on the H100: bytes, and random ones. A lane reads 16 bytes of lane
// words, two 16-byte fp rows and two meta words from anywhere in a plane far
// larger than the 50 MB L2, and writes 16 bytes; at 32-byte sector
// granularity that is ~160 bytes of HBM traffic per lane, against a dozen
// integer ops. The design is one thread per lane (no cross-lane reuse to
// exploit), each fp row fetched as one 16-byte uint4 load and each meta word
// as one 4-byte load, and lane inputs/outputs coalesced across the warp.
//
// Semantics match the reference kernel exactly on every input: a lane whose
// bucket index is < 0 (padding) gets 0 for that bucket; a bucket index >= BT
// reads as an empty row (bits 0, free 0x3FFF), as the zero padding rows of
// the reference's tiles do. A segment id outside [0, S) marks a padding lane.
#include "dash_common.cuh"

namespace {

__device__ __forceinline__ void match_row(const uint8_t* __restrict__ fp,
                                          const uint32_t* __restrict__ meta,
                                          long long seg, int bt, int row, int qfp,
                                          int32_t* bits, int32_t* free_bits) {
  if (row < 0) {
    *bits = 0;
    *free_bits = 0;
    return;
  }
  if (row >= bt) {
    *bits = 0;
    *free_bits = static_cast<int32_t>(dash::SLOT_MASK);
    return;
  }
  const long long r = seg * bt + row;
  const uint4 w = *reinterpret_cast<const uint4*>(fp + r * 16);
  const uint32_t alloc = meta[r] & dash::SLOT_MASK;
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < dash::NSLOTS; ++j) {
    const int byte = static_cast<int>((words[j >> 2] >> (8 * (j & 3))) & 0xFFu);
    m |= static_cast<uint32_t>(byte == qfp) << j;
  }
  *bits = static_cast<int32_t>(m & alloc);
  *free_bits = static_cast<int32_t>(~alloc & dash::SLOT_MASK);
}

__global__ void fingerprint_probe_kernel(
    const uint8_t* __restrict__ fp, const uint32_t* __restrict__ meta,
    long long num_segments, int bt, const int32_t* __restrict__ q_seg,
    const int32_t* __restrict__ q_fp, const int32_t* __restrict__ q_b,
    const int32_t* __restrict__ q_pb, long long n, int32_t* __restrict__ bits_b,
    int32_t* __restrict__ bits_pb, int32_t* __restrict__ free_b,
    int32_t* __restrict__ free_pb) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long seg = q_seg[i];
  int32_t bb = 0, bp = 0, fb = 0, fpb = 0;
  if (seg >= 0 && seg < num_segments) {
    const int qfp = q_fp[i];
    match_row(fp, meta, seg, bt, q_b[i], qfp, &bb, &fb);
    match_row(fp, meta, seg, bt, q_pb[i], qfp, &bp, &fpb);
  }
  bits_b[i] = bb;
  bits_pb[i] = bp;
  free_b[i] = fb;
  free_pb[i] = fpb;
}

}  // namespace

extern "C" int dash_fingerprint_probe(const void* fp, const void* meta,
                                      long long num_segments, int bt,
                                      const void* q_seg, const void* q_fp,
                                      const void* q_b, const void* q_pb,
                                      long long n, void* bits_b, void* bits_pb,
                                      void* free_b, void* free_pb, void* stream) {
  if (n > 0) {
    fingerprint_probe_kernel<<<dash::blocks_for(n), dash::THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(fp), static_cast<const uint32_t*>(meta),
        num_segments, bt, static_cast<const int32_t*>(q_seg),
        static_cast<const int32_t*>(q_fp), static_cast<const int32_t*>(q_b),
        static_cast<const int32_t*>(q_pb), n, static_cast<int32_t*>(bits_b),
        static_cast<int32_t*>(bits_pb), static_cast<int32_t*>(free_b),
        static_cast<int32_t*>(free_pb));
  }
  return static_cast<int>(cudaGetLastError());
}
