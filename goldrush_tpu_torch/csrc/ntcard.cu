// ntcard_count (K22): ntCard's sampled counters of every seed of a batch of
// reads, in one launch.
//
// Replaces goldrush_tpu/utils/ntcard.py:_sample_and_count (:41) and the
// hashing and stale-tail clamp of estimate_genome_size that feed it
// (:82-116): for every read, every position p < len - k + 1 (seed 0's
// frames) and every seed s, the canonical spaced-seed hash h of seed s at
// position min(p, max(len - k - s, 0)) (the lockstep iterator repeats a
// seed's last frame; ops/nthash.py hash_positions' values, codes past the
// read reading as A) goes to bank 0 if h >> (63 - sbits) == 1, else to
// bank 1 if h >> (64 - sbits) == 2^(sbits-1) - 1, and then adds one to
// counters[s][bank * 2^rbits + (h & (2^rbits - 1))].  `counters` is h banks
// of 2 * 2^rbits uint32, one per seed.
//
// Design.  The work list holds one item per (read, chunk of kChunk
// positions), built on the host (ntcard.py pack_batch), so reads of any
// length share a launch without padding; one CTA per item stages the
// chunk's codes and hashes them with kernel A's device code
// (seed_hash.cuh: the left-half partials in registers, the right-half
// ones once per position in shared memory, every seed from the same
// partials).  A seed's stale tail is not hashed again: its last own
// position carries the weight of the frames that repeat it (len - k + 1 -
// that position), added in one atomic, so the counters equal the JAX
// loop's one-by-one increments (uint32 sums wrap alike, and their order
// does not matter).
//
// Unsampled hashes are skipped: all but 2^-8 + 2^-7 ~ 1.2% of uniform
// hashes at sbits 7, 1.6% of the bench reads' (the canonical minimum
// leans low).  The JAX function sends them to a discard slot past the two
// banks, which the estimate never reads; one slot taking ~99% of a
// launch's atomics would serialise them on one address (ROADMAP queue 3).
//
// Bound.  The hash's integer work: per position the left partials (two
// XORs of 64-bit values per left care offset) and its right partials (the
// same per right care offset), per seed the rotates, XORs and unsigned min
// and the bank test, with no slot map; chip_smoke.py counts it with
// ntcard_ops.  Bytes: the codes, offsets and work list once and one 32-byte
// sector per atomic, one per sampled own frame; the counters (96 MB at
// rbits 22, 3 GiB at rbits 27 for h = 3) are touched only there.
// chip_smoke.py phase 8(a) prints the bound and the kernel's time on a
// bench batch of 16.8 Mbp of 20 kb reads (PERF.md, the K22 row).
#include "seed_hash.cuh"

namespace gr {

constexpr int kNtThreads = 256;
constexpr int kChunk = 1024;  // positions per CTA (ntcard.py CHUNK)

// grid (items): item i is read item_read[i]'s positions item_p0[i] ..
// + kChunk (of its len - k + 1).
__global__ void __launch_bounds__(kNtThreads) ntcard_count_kernel(
    const uint8_t* __restrict__ codes, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ item_read,
    const int64_t* __restrict__ item_p0, const Family f, int rbits,
    int sbits, uint32_t* __restrict__ counters) {
  extern __shared__ ulonglong2 smem[];
  const int r = item_read[blockIdx.x];
  const int64_t p0 = item_p0[blockIdx.x];
  const int64_t start = offsets[r];
  const int64_t len = offsets[r + 1] - start;
  const int64_t n_frames = len - f.k + 1;  // seed 0's frames
  if (p0 >= n_frames) return;
  const int n = static_cast<int>(min64(kChunk, n_frames - p0));
  // seed s at window position i reads right partial i + s
  const int m = n + f.h - 1;
  const Stage st(smem, f, m);
  stage(f, codes + start, len, p0, m, 1, st);
  const uint64_t rmask = (1ull << rbits) - 1;
  const uint64_t smask = (1ull << (sbits - 1)) - 1;
  const int64_t bank_words = 2ll << rbits;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t q = p0 + i;
    const ulonglong2 left = left_at(f, st, i);
    for (int s = 0; s < f.h; ++s) {
      // seed s's own frames: q < own; its last one carries the tail
      const int64_t own = max64(n_frames - s, 1);
      if (q >= own) break;  // own only shrinks with s
      const uint64_t hv = canon(st, left, i, s);
      int64_t bank;
      if (hv >> (63 - sbits) == 1) {
        bank = 0;
      } else if (hv >> (64 - sbits) == smask) {
        bank = 1;
      } else {
        continue;
      }
      const uint32_t w =
          q == own - 1 ? static_cast<uint32_t>(n_frames - own + 1) : 1u;
      atomicAdd(counters + s * bank_words + (bank << rbits) + (hv & rmask),
                w);
    }
  }
}

}  // namespace gr

extern "C" {

// codes: uint8 [offsets[B]] (A=0 C=1 G=2 T=3; the low two bits are read);
// offsets: int64 [B + 1]; item_read int32 / item_p0 int64 [items];
// counters: uint32 [h, 2 * 2^rbits].
int gr_ntcard_count(const uint8_t* codes, const int64_t* offsets,
                    const int32_t* item_read, const int64_t* item_p0,
                    int64_t items, const uint64_t* fam_table, int h, int k,
                    int half, int nl, int nr, int pad, int rbits, int sbits,
                    uint32_t* counters, cudaStream_t stream) {
  if (items < 0 || items > 0x7FFFFFFF || h < 1 || rbits < 1 || rbits > 40 ||
      sbits < 1 || sbits > 63)
    return cudaErrorInvalidValue;
  if (items == 0) return gr::kNoLaunch;
  const gr::Family f{h, k, half, nl, nr, pad, fam_table};
  const size_t smem = gr::stage_bytes(f, gr::kChunk + h - 1);
  const cudaError_t err = gr::allow_smem(gr::ntcard_count_kernel, smem);
  if (err != cudaSuccess) return err;
  gr::ntcard_count_kernel<<<static_cast<unsigned>(items), gr::kNtThreads,
                            smem, stream>>>(codes, offsets, item_read,
                                            item_p0, f, rbits, sbits,
                                            counters);
  return cudaGetLastError();
}

}  // extern "C"
