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

// The batch entry: every recruit of a classified batch of n reads in one
// cooperative launch, exact for the same reason as one recruit's (a key's
// result depends only on its own occurrences, in (read, tile) order; see
// insert.cuh).  Each CTA first works out every read's tiles and ids from
// C's decisions on the card (batch_read), so nothing is fetched to the
// host; then step 1 over the whole batch's window, the keys owned by
// `parts` buckets (a multiple of the CTAs, sized by the wrapper so that a
// bucket expects at most 3/4 of `cap` entries), and the grid barrier; then
// each CTA takes its buckets one after another, grouping each bucket's
// entries by key in shared memory (owner_group_batch: only the keys that
// occur more than once are sorted), or, past the group's capacity, sorting
// the whole bucket (owner_sort).  It replaces one launch of the
// single-recruit entry per recruit, each with a window of ~60,000 entries
// at the bench width, in which the scatter, the grid barrier and the sort's
// fixed cost dominated (0.017 ms a recruit against a bound of 0.0004).  On
// an H100 a bench step's batch (3.84 M grid entries, 64 recruits) takes
// 0.52 ms at 1,024 threads a CTA, the launches a recruit 1.50 ms
// (tools/torch_port_insert_batch_variants.py): 0.10 the scatter, 0.16 the
// grouping, 0.25 the reservoir rule's random reads and writes of the
// 570 MB tables.
template <typename Filt>
__global__ void __launch_bounds__(1024)
insert_batch_kernel(const Filt filt, const int64_t* __restrict__ slots,
                    const int* __restrict__ decision,
                    const int* __restrict__ trim_start,
                    const int* __restrict__ trim_end,
                    const int* __restrict__ lengths,
                    const int64_t* __restrict__ base_ids, int n,
                    int tile_length, int max_blocks, int H, int T, int F,
                    int64_t limit, uint32_t or_bits, uint32_t keep, int bs,
                    int tile_bits, int shift, int parts, int cap,
                    unsigned* bucket_count, unsigned long long* bucket,
                    unsigned long long* spill) {
  __shared__ int4 s_reads[kBatchReads];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s_reads[i] = batch_read(decision[i], trim_start[i], trim_end[i],
                            lengths[i], tile_length, max_blocks, bs, T,
                            static_cast<uint32_t>(base_ids[i]));
  __syncthreads();
  const BatchWindow w(slots, s_reads, n, H, T, F, limit, tile_bits, shift);
  scatter_window<kBatchParts>(w, blockIdx.x, gridDim.x, parts, cap,
                              bucket_count, bucket);
  cg::this_grid().sync();
  __shared__ int s_n;
  uint64_t* sbuf = reinterpret_cast<uint64_t*>(gr_smem);
  for (int p = blockIdx.x; p < parts; p += gridDim.x) {
    __syncthreads();
    if (threadIdx.x == 0) s_n = static_cast<int>(__ldcg(bucket_count + p));
    __syncthreads();
    if (s_n <= cap &&
        owner_group_batch(filt, bucket + static_cast<int64_t>(p) * cap, s_n,
                          cap, gr_smem, s_reads, shift, tile_bits, bs,
                          or_bits, keep))
      continue;
    // past its bucket or its list of repeated keys: the whole bucket
    // sorted (owner_sort), then walked key by key
    int m = 0;
    const uint64_t* buf =
        owner_sort(w, p, parts, cap, bucket_count, bucket, sbuf, sbuf + cap,
                   spill, reinterpret_cast<uint64_t*>(spill + 1), &m);
    owner_apply_batch(filt, buf, m, s_reads, shift, tile_bits, bs, or_bits,
                      keep);
  }
}

// The cooperative launch of `kernel` on `ctas` CTAs of `threads` with
// `smem` bytes of dynamic shared memory, after checking that they are
// resident at once (a grid barrier needs every CTA resident).
template <typename Kern>
cudaError_t launch_cooperative(Kern kernel, int ctas, int threads,
                               size_t smem, void** args,
                               cudaStream_t stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (static_cast<int64_t>(per_sm) * sms < ctas)
    return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(ctas),
                                  dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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
  return gr::with_view(banks, [&](auto filt) {
    const auto kernel =
        ranked ? gr::insert_sorted_kernel<decltype(filt), true>
               : gr::insert_sorted_kernel<decltype(filt), false>;
    void* args[] = {&filt, &slots, &bitrank, &supers, &n_super, &size,
                    &H, &TF, &F, &limit, &or_bits, &keep, &lo, &last,
                    &base, &trimmed, &bs, &cap, &bucket_count, &bucket,
                    &spill};
    return gr::launch_cooperative(kernel, parts, threads, smem, args,
                                  stream);
  });
}

// The batch entry (insert_batch_kernel): the bank view as gr_insert_sorted
// takes it; slots int64 [n, H, T * F]; decision, trim_start, trim_end,
// lengths int32 [n] and base_ids int64 [n] (low 32 bits) on the card;
// tile_bits >= bits(T - 1) and read_bits >= bits(n - 1) with
// bits(limit - 1) + tile_bits + read_bits <= 63, so that every entry lies
// below the sort's sentinel, and tile_bits + read_bits <= 32 (an order
// field of 32 bits); `parts` owners (a multiple of `ctas`, at most
// kBatchParts), each a bucket of `cap` entries; spill: its allocation
// counter, then less than twice the window (n * H * T * F entries).  The
// entry zeroes the counters.
extern "C" int gr_insert_batch(void* const* table, void* const* counts,
                               int n_banks, int64_t bank_len, int remote,
                               const int64_t* slots, const int* decision,
                               const int* trim_start, const int* trim_end,
                               const int* lengths, const int64_t* base_ids,
                               int n, int tile_length, int max_blocks, int H,
                               int T, int F, int64_t limit, uint32_t or_bits,
                               uint32_t keep, int bs, int tile_bits,
                               int read_bits, int ctas, int parts,
                               int threads, int cap, unsigned* bucket_count,
                               unsigned long long* bucket,
                               unsigned long long* spill,
                               cudaStream_t stream) {
  gr::Banks banks;
  int key_bits = 0;
  while (key_bits < 63 && (limit - 1) >> key_bits) ++key_bits;
  const int64_t window = static_cast<int64_t>(n) * H * T * F;
  if (!counts ||
      !gr::make_banks(table, counts, n_banks, bank_len, remote, &banks) ||
      n < 0 || n > gr::kBatchReads || H <= 0 || T <= 0 || F <= 0 ||
      tile_length <= 0 || max_blocks < 0 || bs <= 0 || limit <= 0 ||
      window >= (int64_t{1} << 31) || tile_bits < 0 || read_bits < 0 ||
      (T - 1) >> tile_bits || (n > 0 && (n - 1) >> read_bits) ||
      key_bits + tile_bits + read_bits > 63 || tile_bits + read_bits > 32 ||
      ctas <= 0 || parts < ctas ||
      parts % ctas || parts > gr::kBatchParts || threads <= 0 ||
      threads > 1024 || cap < 4 * threads || (cap & (cap - 1)) ||
      !bucket_count || !bucket || !spill || !slots || !decision ||
      !trim_start || !trim_end || !lengths || !base_ids)
    return cudaErrorInvalidValue;
  if (n == 0) return gr::kNoLaunch;
  cudaError_t err = cudaMemsetAsync(bucket_count, 0, sizeof(unsigned) * parts,
                                    stream);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(spill, 0, sizeof(*spill), stream)) !=
      cudaSuccess)
    return err;
  // owner_group_batch's table and list (owner_sort takes 12 bytes an entry)
  const size_t smem = static_cast<size_t>(cap) * 20;
  int shift = tile_bits + read_bits;
  return gr::with_view(banks, [&](auto filt) {
    void* args[] = {&filt, &slots, &decision, &trim_start, &trim_end,
                    &lengths, &base_ids, &n, &tile_length, &max_blocks, &H,
                    &T, &F, &limit, &or_bits, &keep, &bs, &tile_bits, &shift,
                    &parts, &cap, &bucket_count, &bucket, &spill};
    return gr::launch_cooperative(
        gr::insert_batch_kernel<decltype(filt)>, ctas, threads, smem, args,
        stream);
  });
}
