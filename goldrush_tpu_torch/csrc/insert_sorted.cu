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
// either.  It also replaces the blockwise inserts of both filters'
// `insert_read` (goldrush_tpu/mibf/mibf.py:449, compressed.py:338), which
// the JAX train_step runs: their per-block sort and loop over the blocks
// are XLA's form of the same rule (tests/test_insert_sorted.py).  For them
// the accepted entry keeps bits of its old value (`keep`: SAT | PRESENT
// in the direct filter, SAT in the compressed one), the wrapper limits
// the tiles to the first max_blocks blocks, and the compressed filter's
// grid holds slots, each mapped to its rank as the window is read (the
// kRankMap instantiation, insert.cuh WindowOf).
//
// A key's result depends on that key's own occurrences only: its j-th
// distinct block m (ascending, j from 1) sees the counter
// cnt = counts[key] + j (u32) and accepts iff
// (u32(key) ^ id_m) % max(cnt, 1) == cnt - 1, and the last accepting
// block's id wins.  The JAX version recovers j and the last accepting block
// with segmented scans over the read's sorted (key << 16 | tile) list.
// Here every key belongs to one of `parts` CTAs, part(key) = a
// multiplicative hash of the key scaled to [0, parts) (a hash, since
// present ranks may fill only the low end of [0, limit)), so CTAs share no
// key and need no order between them.  One cooperative launch covers every
// block of the recruit (insert.cuh):
//   1. every CTA reads its own 1/parts slice of the window
//      grid[:, lo*F : (hi+1)*F] once, counts its real entries per owner in
//      shared memory, reserves each owner's run in that owner's bucket with
//      one global atomic, and writes the entries (key << 16 | tile, 64 bits:
//      a rank at or above 2^32 keeps its high bits) there; the buckets
//      (`cap` entries each, 8.6 MB at 132 x 8,192) stay in L2;
//   2. a grid barrier;
//   3. each CTA sorts its bucket (bitonic, in shared memory): a key's
//      entries become one run in ascending tile, so in ascending block m;
//      one thread per distinct key walks its run, skips repeated (key, m),
//      and writes counts[key] once and the word at most once.
// Exact for any input: a CTA owning more entries than its bucket holds (a
// read whose repeated k-mers pile onto few keys) re-reads the whole window
// and keeps each distinct (key, tile) entry once, in a hash set in shared
// memory (a repeated entry changes nothing); past half its bucket of
// distinct entries it takes a slice of the global spill buffer, re-reads
// the window into it and sorts there.  Slices are power-of-two sized, so
// all of them together take less than twice the window.
//
// This is the insert the consume kernel runs (consume.cu: there the
// scatter of a probed read overlaps its classification, and the sort its
// wait for the decision), launched alone at the consume kernel's shape on
// an H100 (one CTA of 512 threads per SM, mibf.py INSERT_PARTS), so that
// it can be held against its plain version and timed.  It replaces a
// design in which every CTA streamed the whole window from L2 (~63 MB of L2
// reads for a 20-tile recruit at 132 CTAs) and kept what it owned.
//
// Bound.  From memory it must move the window once (H * nf * 8 bytes, 480
// KB for a 20-tile recruit at the defaults), and each distinct key's
// counter read and written and the words it accepts written, random
// accesses into the 570 MB words/counts (or the 251 MB rank tables); with
// a keep mask the accepted entries are also read.  The rank map reads each
// window entry's bitrank word (8 random bytes, twice for an owner that
// re-reads its window).  The buckets add one write and one read of the
// window's real entries in L2.
#include <cooperative_groups.h>

#include <algorithm>

#include "insert.cuh"

namespace cg = cooperative_groups;

namespace gr {

template <typename Filt, bool kRankMap>
__global__ void __launch_bounds__(1024)
insert_sorted_kernel(const Filt filt, const int64_t* __restrict__ slots,
                     const unsigned long long* __restrict__ bitrank,
                     const unsigned long long* __restrict__ supers,
                     int n_super, int64_t size, int H, int64_t TF,
                     int F, int64_t limit, uint32_t or_bits, uint32_t keep,
                     int lo, int last, uint32_t base, int trimmed, int bs,
                     int cap, unsigned* bucket_count,
                     unsigned long long* bucket, unsigned long long* spill) {
  const WindowOf<kRankMap> w{slots, H, TF, F, lo, last + 1, limit,
                             bitrank, supers, n_super, size};
  scatter_window(w, blockIdx.x, gridDim.x, gridDim.x, cap, bucket_count,
                 bucket);
  cg::this_grid().sync();
  int n = 0;
  uint64_t* sbuf = reinterpret_cast<uint64_t*>(gr_smem);
  const uint64_t* buf =
      owner_sort(w, blockIdx.x, gridDim.x, cap, bucket_count, bucket, sbuf,
                 sbuf + cap, spill, reinterpret_cast<uint64_t*>(spill + 1),
                 &n);
  owner_apply(filt, buf, n, nullptr, lo, last, base, trimmed, bs, or_bits,
              keep);
}

}  // namespace gr

// table/counts/n_banks/bank_len/remote: the bank view of the words (or
// ids) and counters (common.cuh make_banks); bitrank/supers: null, or the
// compressed filter's rank structure (n_super superblocks of a filter of
// `size` slots) through which the grid's slots map to ranks below the
// sentinel `limit`; keep: the bits an accepted entry keeps;
// bucket_count: uint32 [parts]; bucket: uint64 [parts * cap]; spill: its
// allocation counter, then less than twice the window (or null when the
// window fits one bucket).  The entry zeroes the counters.
extern "C" int gr_insert_sorted(void* const* table, void* const* counts,
                                int n_banks, int64_t bank_len, int remote,
                                const int64_t* slots,
                                const unsigned long long* bitrank,
                                const unsigned long long* supers, int n_super,
                                int64_t size, int H, int64_t TF, int F,
                                int64_t limit, uint32_t or_bits, uint32_t keep,
                                int lo, int hi, uint32_t base, int trimmed,
                                int bs, int parts, int threads, int cap,
                                unsigned* bucket_count,
                                unsigned long long* bucket,
                                unsigned long long* spill,
                                cudaStream_t stream) {
  gr::Banks banks;
  const bool ranked = bitrank != nullptr;
  if (!counts ||
      !gr::make_banks(table, counts, n_banks, bank_len, remote, &banks) ||
      (ranked && (!supers || n_super < 1 || size <= 0)) ||
      F <= 0 || bs <= 0 || TF % F || TF / F >= (1 << 16) || lo < 0 ||
      limit < 0 || parts <= 0 || parts > gr::kMaxParts || threads <= 0 ||
      threads > 1024 || cap < 4 * threads || (cap & (cap - 1)) ||
      !bucket_count || !bucket)
    return cudaErrorInvalidValue;
  int last = static_cast<int>(std::min<int64_t>(hi, TF / F - 1));
  if (last < lo) return gr::kNoLaunch;
  const int64_t window = static_cast<int64_t>(H) * (last - lo + 1) * F;
  // without a spill buffer no CTA may own more than `cap` entries
  if (!spill && window > cap) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(bucket_count, 0, sizeof(unsigned) * parts,
                                    stream);
  if (err != cudaSuccess) return err;
  if (spill) {
    err = cudaMemsetAsync(spill, 0, sizeof(*spill), stream);
    if (err != cudaSuccess) return err;
  }
  // the bucket's entries, and half as many for owner_distinct
  const size_t smem = static_cast<size_t>(cap) * sizeof(uint64_t) * 3 / 2;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  return gr::with_view(banks, [&](auto filt) {
    const auto kernel =
        ranked ? gr::insert_sorted_kernel<decltype(filt), true>
               : gr::insert_sorted_kernel<decltype(filt), false>;
    cudaError_t e = gr::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, smem)) != cudaSuccess)
      return e;
    // a cooperative grid must be resident at once
    if (static_cast<int64_t>(per_sm) * sms < parts)
      return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&filt, &slots, &bitrank, &supers, &n_super, &size,
                    &H, &TF, &F, &limit, &or_bits, &keep, &lo, &last,
                    &base, &trimmed, &bs, &cap, &bucket_count, &bucket,
                    &spill};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(parts), dim3(threads), args, smem,
                                    stream);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}
