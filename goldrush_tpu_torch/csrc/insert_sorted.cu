// Kernel D: exact reservoir insert of one recruit's tile blocks.
//
// Replaces build_insert_keys + insert_read_sorted (goldrush_tpu/mibf/
// mibf.py:524-634) and their rank-keyed twins (compressed.py:398-476) with
// the semantics of MIBFConstructSupport.hpp:247-283 and process_read
// (goldrush_path.cpp:983-994, :1041-1053).  The grid holds slots (direct
// filter: real iff < size, the word becomes PRESENT | id) or ranks
// (compressed filter: real iff < the sentinel rank, the rank-indexed id
// becomes id); `limit` and `or_bits` say which.  Below, "slot" stands
// for either.
//
// The JAX version sorts the read's whole (slot, tile) key list once and
// recovers
// the sequential per-block counter values and the last accepting block per
// slot with segmented cumsum/cummax passes, because XLA cannot loop over a
// filter-sized carry cheaply.  Here one CTA walks the blocks
// m = 0 .. nb-1 IN ORDER, so "last accepting block wins" needs no
// segmented scan:
//   1. gather the block's slots (all seeds, tiles lo+m*bs .. min(hi,
//      lo+(m+1)*bs-1)), real slots only (< limit);
//   2. sort them and drop duplicates;
//   3. each distinct slot does cnt = ++counts[slot] (distinct within the
//      block, so no race) and, iff (u32(slot) ^ id) % cnt == cnt - 1,
//      words[slot] = or_bits | id;
//   4. barrier, next block (a block's writes are visible to the next one:
//      the same CTA, ordered by __syncthreads).
// A block's list is bs*TL*h keys: 30,000 x 4 B = 117 KB at the defaults,
// sorted in shared memory.  When next_pow2 of that exceeds the shared
// memory a block can have, the wrapper passes a global scratch buffer and
// the same sort runs there.
//
// Bound.  One CTA on one SM: the sorts (120 barrier stages at 32,768 keys)
// and ~2 random read-modify-writes per distinct slot into the 570 MB
// words/counts arrays.
#include "common.cuh"

namespace gr {

constexpr int kInsertThreads = 1024;

extern __shared__ __align__(16) unsigned char gr_smem[];

__global__ void insert_sorted_kernel(uint32_t* __restrict__ words,
                                     uint32_t* __restrict__ counts,
                                     const int64_t* __restrict__ slots, int H,
                                     int64_t TF, int F, int64_t limit,
                                     uint32_t or_bits, int lo, int hi,
                                     uint32_t base, int trimmed, int bs,
                                     uint32_t* scratch) {
  uint32_t* buf = scratch ? scratch : reinterpret_cast<uint32_t*>(gr_smem);
  const int T = static_cast<int>(TF / F);
  for (int m = 0; lo + m * bs <= hi; ++m) {
    const int t0 = lo + m * bs;
    const int t1 = min(min(hi, t0 + bs - 1), T - 1);
    if (t0 > t1) break;
    const uint32_t id = base + static_cast<uint32_t>(
        trimmed ? (m * bs + 1) / bs : m);
    const int nf = (t1 - t0 + 1) * F;          // frames in the block
    const int n = H * nf;
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
      uint32_t v = kSentinel32;
      if (i < n) {
        const int s = i / nf;
        const int64_t sl = slots[s * TF + static_cast<int64_t>(t0) * F + (i - s * nf)];
        if (sl < limit) v = static_cast<uint32_t>(sl);
      }
      buf[i] = v;
    }
    __syncthreads();
    block_bitonic_sort(buf, n2);
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
      const uint32_t v = buf[i];
      if (v == kSentinel32 || (i > 0 && buf[i - 1] == v)) continue;
      const uint32_t cnt = counts[v] + 1u;
      counts[v] = cnt;
      if ((v ^ id) % cnt == cnt - 1u) words[v] = or_bits | id;
    }
    __syncthreads();
  }
}

}  // namespace gr

extern "C" int gr_insert_sorted(uint32_t* words, uint32_t* counts,
                                const int64_t* slots, int H, int64_t TF, int F,
                                int64_t limit, uint32_t or_bits, int lo, int hi,
                                uint32_t base, int trimmed, int bs,
                                uint32_t* scratch, int n2, cudaStream_t stream) {
  if (F <= 0 || bs <= 0 || TF % F) return cudaErrorInvalidValue;
  if (hi < lo) return gr::kNoLaunch;
  const size_t smem = scratch ? 0 : static_cast<size_t>(n2) * sizeof(uint32_t);
  cudaError_t err = gr::allow_smem(gr::insert_sorted_kernel, smem);
  if (err != cudaSuccess) return err;
  gr::insert_sorted_kernel<<<1, gr::kInsertThreads, smem, stream>>>(
      words, counts, slots, H, TF, F, limit, or_bits, lo, hi, base, trimmed,
      bs, scratch);
  return cudaGetLastError();
}
