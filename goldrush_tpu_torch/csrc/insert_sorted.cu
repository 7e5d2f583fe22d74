// Kernel D: exact reservoir insert of one recruit's tile blocks, the key
// space partitioned across the SMs.
//
// Replaces build_insert_keys + insert_read_sorted (goldrush_tpu/mibf/
// mibf.py:524-634) and their rank-keyed twins (compressed.py:398-476) with
// the semantics of MIBFConstructSupport.hpp:247-283 and process_read
// (goldrush_path.cpp:983-994, :1041-1053).  The grid holds slots (direct
// filter: real iff < size, the word becomes PRESENT | id) or ranks
// (compressed filter: real iff < the sentinel rank, the rank-indexed id
// becomes id); `limit` and `or_bits` say which.  Below, "key" stands for
// either.
//
// A key's result depends on that key's own occurrences only: its j-th
// distinct block m (ascending, j from 1) sees the counter
// cnt = counts[key] + j (u32) and accepts iff
// (u32(key) ^ id_m) % max(cnt, 1) == cnt - 1, and the last accepting
// block's id wins.  The JAX version recovers j and the last accepting block
// with segmented scans over the read's sorted (key << 16 | tile) list.
// Here every key belongs to one of gridDim.x CTAs, part(key) = a
// multiplicative hash of the key scaled to [0, gridDim.x) (a hash, since
// present ranks may fill only the low end of [0, limit)), so CTAs share no
// key and need no order between them, and one launch covers every block of
// the recruit:
//   1. every CTA streams the whole window grid[:, lo*F : (hi+1)*F] from L2
//      (16-byte loads where aligned) and appends each entry it owns to its
//      shared memory as (key << 16 | m), m = (t - lo) / bs, in 64 bits: a
//      rank at or above 2^32 (a filter of more than 2^32 present slots)
//      keeps its high bits;
//   2. each CTA sorts its entries (bitonic, in shared memory): a key's
//      entries become one run in ascending m, repeated (key, m) side by
//      side;
//   3. one thread per distinct key walks its run, skips repeated (key, m),
//      and writes counts[key] once and the word at most once.
// Exact for any input: a CTA owning more entries than its shared memory
// holds (a read whose repeated k-mers pile onto few keys) takes a slice of
// the wrapper's global scratch buffer, streams the whole window again into
// it and sorts there.  Slices are power-of-two sized, so all of them
// together take less than twice the window.
//
// This is the insert the consume kernel runs (insert.cuh insert_window),
// launched alone at the consume kernel's shape on an H100 (one CTA of 512
// threads per SM, mibf.py INSERT_PARTS), so that it can be held against
// its plain version and timed.  It has no thread-block clusters: the
// consume kernel's cooperative launch takes none.
//
// Bound.  Each CTA reads the whole window from L2: H * nf * 8 bytes, 480
// KB for a 20-tile recruit at the defaults, ~63 MB in all at 132 CTAs.
// From memory it must move the window once, and each distinct key's
// counter read and written and the words it accepts written, random
// accesses into the 570 MB words/counts (or the 251 MB rank tables).
#include <algorithm>

#include "insert.cuh"

namespace gr {

__global__ void __launch_bounds__(1024)
insert_sorted_kernel(uint32_t* __restrict__ words,
                     uint32_t* __restrict__ counts,
                     const int64_t* __restrict__ slots, int H, int64_t TF,
                     int F, int64_t limit, uint32_t or_bits, int lo, int hi,
                     uint32_t base, int trimmed, int bs, int cap,
                     unsigned long long* scratch) {
  __shared__ int fill;
  const int nf = max(0, min(hi, static_cast<int>(TF / F) - 1) - lo + 1) * F;
  insert_window<false>(words, counts, slots, H, TF, F, limit, or_bits, lo,
                       nf, base, trimmed, bs,
                       reinterpret_cast<uint64_t*>(gr_smem), cap, &fill,
                       scratch, reinterpret_cast<uint64_t*>(scratch + 1));
}

}  // namespace gr

extern "C" int gr_insert_sorted(uint32_t* words, uint32_t* counts,
                                const int64_t* slots, int H, int64_t TF, int F,
                                int64_t limit, uint32_t or_bits, int lo, int hi,
                                uint32_t base, int trimmed, int bs, int parts,
                                int threads, int cap,
                                unsigned long long* scratch,
                                cudaStream_t stream) {
  if (F <= 0 || bs <= 0 || TF % F || lo < 0 || limit < 0 || parts <= 0 ||
      threads <= 0 || threads > 1024 || cap <= 0 || (cap & (cap - 1)))
    return cudaErrorInvalidValue;
  if (hi < lo) return gr::kNoLaunch;
  const int64_t window =
      static_cast<int64_t>(H) *
      std::max<int64_t>(0, std::min<int64_t>(hi, TF / F - 1) - lo + 1) * F;
  // without scratch no CTA may own more than `cap` entries
  if (!scratch && window > cap) return cudaErrorInvalidValue;
  cudaError_t err;
  if (scratch) {
    err = cudaMemsetAsync(scratch, 0, sizeof(*scratch), stream);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = static_cast<size_t>(cap) * sizeof(uint64_t);
  err = gr::allow_smem(gr::insert_sorted_kernel, smem);
  if (err != cudaSuccess) return err;
  gr::insert_sorted_kernel<<<parts, threads, smem, stream>>>(
      words, counts, slots, H, TF, F, limit, or_bits, lo, hi, base, trimmed,
      bs, cap, scratch);
  return cudaGetLastError();
}
