// fused_probe: per lane, the lowest allocated slot whose fingerprint, key_hi
// and key_lo all match, visiting the target bucket, then the probing bucket,
// then the stash rows nb .. nb + min(stash_active[seg], ns) - 1. Returns
// (found, value).
//
// Replaces the Pallas TPU kernel repro/kernels/fused.py:fused_probe (body
// _fused_read_block). That kernel splits keys and values into 16-bit halves
// and gathers rows with f32 one-hot MXU matmuls so that every compare is
// exact on the TPU's matrix unit, over (U, 128, 128) padded tiles built for
// every segment of the table. None of that is needed here: each lane carries
// its segment id, the kernel reads the natural planes (fp (S, BT, 16) uint8,
// meta (S, BT), key_hi / key_lo / val (S, BT, SL) u32, stash_active (S,)) in
// place and compares native uint32 words.
//
// Fingerprints are compared only when the table keeps them (use_fp). The
// reference's routed TPU path feeds real fingerprint bytes against a zeroed
// fp plane when fingerprints are off and so misses nearly every key; this
// kernel follows the per-key search semantics instead.
//
// Bound on the H100: latency, not bytes. A 256-lane serving tick needs about
// 0.1 MB of HBM traffic (0.03 us at 3.35 TB/s), but each lane's answer sits
// behind dependent loads: its lane words name the rows, and only a row's
// words name the value. The shortest chain is an empty launch plus three
// dependent HBM round trips (lane words -> every candidate row -> value),
// with the 430 MB planes cold in the 50 MB L2. One thread per lane walking
// its rows one after another (meta, then fp, then keys slot by slot, then
// the next row) made that 10-12 round trips on one SM.
//
// The design cuts the chain to those three round trips:
//  - a half-warp of 16 threads serves one lane, thread j owning slot
//    position j, so a 256-lane tick spreads over 32 blocks on 32 SMs;
//  - once the lane words are in, each thread issues every load of the lane's
//    candidate rows before any compare: meta, its fp byte and its key_hi and
//    key_lo words of the target, probing and stash rows (4 rows at once;
//    configs with more stash rows loop over groups of 4), plus
//    stash_active[seg]. Rows past the stash gate or at or past BT load from
//    clamped in-bounds addresses and are masked afterwards;
//  - the first hit in visit order (rows b, pb, stash 0.., then slots) comes
//    from a half-warp __ballot_sync per row and __ffs; only the winning
//    slot's thread loads the value and writes (found, value), and a lane
//    with no hit is written by its thread 0.
#include "dash_common.cuh"

namespace {

// Plane pointers and geometry, validated and laid out by the Python wrapper
// (kernels/fused.py:_Planes mirrors this struct field for field).
struct FusedPlanes {
  const uint8_t* fp;
  const uint32_t* meta;
  const uint32_t* key_hi;
  const uint32_t* key_lo;
  const uint32_t* val;
  const int32_t* stash_active;
  long long num_segments;
  int bt;
  int sl;
  int nb;
  int ns;
  int use_fp;
};

constexpr int GROUP = 16;   // threads per lane: one per slot position (SL <= 16)
constexpr int ROWS = 4;     // candidate rows whose loads are in flight together
constexpr int BLOCK = 128;  // 8 lanes per block

__global__ void __launch_bounds__(BLOCK)
    fused_probe_kernel(const FusedPlanes p, const int32_t* __restrict__ q_seg,
                       const int32_t* __restrict__ q_fp, const int32_t* __restrict__ q_b,
                       const int32_t* __restrict__ q_pb,
                       const uint32_t* __restrict__ q_hi,
                       const uint32_t* __restrict__ q_lo, long long n,
                       int32_t* __restrict__ found, uint32_t* __restrict__ val_out) {
  const long long lane = (static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x) / GROUP;
  if (lane >= n) return;  // a half-warp shares its lane, so it leaves whole
  const int j = static_cast<int>(threadIdx.x % GROUP);
  const unsigned shift = threadIdx.x & 16u;  // this lane's half of the warp
  const unsigned half = 0xFFFFu << shift;

  // Round trip 1: the lane's words (one broadcast load each for the group).
  const int seg_in = q_seg[lane];
  const int b = q_b[lane];
  const int pb_in = q_pb[lane];
  const int qfp = q_fp[lane];
  const uint32_t qhi = q_hi[lane];
  const uint32_t qlo = q_lo[lane];
  const bool live = b >= 0 && seg_in >= 0 && seg_in < p.num_segments;
  const long long seg = live ? seg_in : 0;
  const long long base = seg * p.bt;
  const int pb = pb_in < 0 ? 0 : pb_in;  // the reference clips row ids
  const int slot = j < p.sl ? j : p.sl - 1;

  // Round trip 2: the stash gate and every candidate row's words of this
  // slot position, all issued before the first compare.
  const int active = min(__ldg(p.stash_active + seg), p.ns);
  const int visits = 2 + p.ns;
  long long win_row = -1;
  int win_slot = 0;
  for (int g = 0; g < visits; g += ROWS) {
    long long r[ROWS];
    uint32_t m[ROWS], f[ROWS], kh[ROWS], kl[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int v = g + k;
      const int row = v == 0 ? b : v == 1 ? pb : p.nb + v - 2;
      r[k] = base + min(max(row, 0), p.bt - 1);
      m[k] = __ldg(p.meta + r[k]);
      f[k] = __ldg(p.fp + r[k] * 16 + slot);
      kh[k] = __ldg(p.key_hi + r[k] * p.sl + slot);
      kl[k] = __ldg(p.key_lo + r[k] * p.sl + slot);
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int v = g + k;
      const int row = v == 0 ? b : v == 1 ? pb : p.nb + v - 2;
      const bool gate = v < visits && row < p.bt && (v < 2 || v - 2 < active);
      const bool hit = live && gate && j < p.sl &&
                       (((m[k] & dash::SLOT_MASK) >> j) & 1u) &&
                       (!p.use_fp || static_cast<int>(f[k]) == qfp) && kh[k] == qhi &&
                       kl[k] == qlo;
      const unsigned bits = (__ballot_sync(half, hit) & half) >> shift;
      if (win_row < 0 && bits != 0) {
        win_row = r[k];
        win_slot = __ffs(bits) - 1;
      }
    }
  }

  // Round trip 3: the winning slot's value.
  if (win_row >= 0) {
    if (j == win_slot) {
      found[lane] = 1;
      val_out[lane] = __ldg(p.val + win_row * p.sl + win_slot);
    }
  } else if (j == 0) {
    found[lane] = 0;
    val_out[lane] = 0u;
  }
}

__global__ void noop_kernel() {}

// One thread follows a chain of dependent loads: the floor each of
// fused_probe's round trips stands on.
__global__ void chase_kernel(const uint32_t* __restrict__ next, long long steps,
                             uint32_t* __restrict__ out) {
  uint32_t i = 0;
  for (long long s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;
}

}  // namespace

// out: (2, n) int32, found then value.
extern "C" int dash_fused_probe(const void* planes, const void* q_seg, const void* q_fp,
                                const void* q_b, const void* q_pb, const void* q_hi,
                                const void* q_lo, long long n, void* out, void* stream) {
  if (n > 0) {
    const unsigned int grid = static_cast<unsigned int>((n * GROUP + BLOCK - 1) / BLOCK);
    fused_probe_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        *static_cast<const FusedPlanes*>(planes), static_cast<const int32_t*>(q_seg),
        static_cast<const int32_t*>(q_fp), static_cast<const int32_t*>(q_b),
        static_cast<const int32_t*>(q_pb), static_cast<const uint32_t*>(q_hi),
        static_cast<const uint32_t*>(q_lo), n, static_cast<int32_t*>(out),
        static_cast<uint32_t*>(out) + n);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty launch on the same stream: the fixed cost under every kernel.
extern "C" int dash_noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// `steps` dependent loads through the permutation `next` (u32 indices, one
// cycle over a buffer far larger than L2), by one thread; out gets the last
// index so the chain cannot be elided.
extern "C" int dash_latency_chase(const void* next, long long steps, void* out,
                                  void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(next), steps, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
