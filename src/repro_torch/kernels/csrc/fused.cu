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
// Bound on the H100: launch latency at the serving tick's size. A 256-lane
// tick touches well under 0.2 MB (a few 32-byte sectors per bucket row), so
// the bytes take a fraction of a microsecond and the fixed cost of a launch
// dominates. The design keeps it to one launch per tick, one thread per lane,
// and exits a lane at its first hit.
#include "dash_common.cuh"

namespace {

struct Planes {
  const uint8_t* fp;
  const uint32_t* meta;
  const uint32_t* key_hi;
  const uint32_t* key_lo;
  const uint32_t* val;
  int bt;
  int sl;
  int use_fp;
};

// First matching slot of one bucket row; returns true and sets *out on a hit.
__device__ __forceinline__ bool row_hit(const Planes& p, long long seg, int row,
                                        int qfp, uint32_t qhi, uint32_t qlo,
                                        uint32_t* out) {
  if (row >= p.bt) return false;
  const long long r = seg * p.bt + row;
  const uint32_t alloc = p.meta[r] & dash::SLOT_MASK;
  if (alloc == 0) return false;
  const uint8_t* fr = p.fp + r * 16;
  const uint32_t* kh = p.key_hi + r * p.sl;
  const uint32_t* kl = p.key_lo + r * p.sl;
  for (int j = 0; j < p.sl; ++j) {
    if (!((alloc >> j) & 1u)) continue;
    if (p.use_fp && static_cast<int>(fr[j]) != qfp) continue;
    if (kh[j] == qhi && kl[j] == qlo) {
      *out = p.val[r * p.sl + j];
      return true;
    }
  }
  return false;
}

__global__ void fused_probe_kernel(Planes p, const int32_t* __restrict__ stash_active,
                                   long long num_segments, int nb, int ns,
                                   const int32_t* __restrict__ q_seg,
                                   const int32_t* __restrict__ q_fp,
                                   const int32_t* __restrict__ q_b,
                                   const int32_t* __restrict__ q_pb,
                                   const uint32_t* __restrict__ q_hi,
                                   const uint32_t* __restrict__ q_lo, long long n,
                                   int32_t* __restrict__ found,
                                   uint32_t* __restrict__ val_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long seg = q_seg[i];
  const int b = q_b[i];
  uint32_t v = 0;
  bool hit = false;
  if (b >= 0 && seg >= 0 && seg < num_segments) {
    const int qfp = q_fp[i];
    const uint32_t qhi = q_hi[i];
    const uint32_t qlo = q_lo[i];
    const int pb = q_pb[i] < 0 ? 0 : q_pb[i];  // the reference clips row ids
    hit = row_hit(p, seg, b, qfp, qhi, qlo, &v) ||
          row_hit(p, seg, pb, qfp, qhi, qlo, &v);
    int active = stash_active[seg];
    active = active < ns ? active : ns;
    for (int s = 0; !hit && s < active; ++s) {
      hit = row_hit(p, seg, nb + s, qfp, qhi, qlo, &v);
    }
  }
  found[i] = hit ? 1 : 0;
  val_out[i] = hit ? v : 0u;
}

__global__ void noop_kernel() {}

}  // namespace

extern "C" int dash_fused_probe(const void* fp, const void* meta, const void* key_hi,
                                const void* key_lo, const void* val,
                                const void* stash_active, long long num_segments,
                                int bt, int sl, int nb, int ns, int use_fp,
                                const void* q_seg, const void* q_fp, const void* q_b,
                                const void* q_pb, const void* q_hi, const void* q_lo,
                                long long n, void* found, void* val_out,
                                void* stream) {
  if (n > 0) {
    Planes p{static_cast<const uint8_t*>(fp),     static_cast<const uint32_t*>(meta),
             static_cast<const uint32_t*>(key_hi), static_cast<const uint32_t*>(key_lo),
             static_cast<const uint32_t*>(val),    bt, sl, use_fp};
    fused_probe_kernel<<<dash::blocks_for(n), dash::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const int32_t*>(stash_active), num_segments, nb, ns,
        static_cast<const int32_t*>(q_seg), static_cast<const int32_t*>(q_fp),
        static_cast<const int32_t*>(q_b), static_cast<const int32_t*>(q_pb),
        static_cast<const uint32_t*>(q_hi), static_cast<const uint32_t*>(q_lo), n,
        static_cast<int32_t*>(found), static_cast<uint32_t*>(val_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty launch on the same stream: the floor a launch-bound kernel such as
// fused_probe at tick size is measured against.
extern "C" int dash_noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
