// Kernel B, the standalone launch: one CTA per (read, tile) of a batch;
// the tile's code, its design and its bound are in probe_vote.cuh.
#include "probe_vote.cuh"

namespace gr {

template <typename Filt>
__global__ void probe_vote_kernel(
    const Filt filt, const int64_t* __restrict__ slots,
    int ranked, int64_t limit, const bool* __restrict__ frame_ok, int H,
    int T, int F, int K, int vote_min, int threshold, int bits,
    int32_t* __restrict__ curr_id, int32_t* __restrict__ top_count,
    int32_t* __restrict__ cand_ids, int32_t* __restrict__ cand_counts,
    bool* __restrict__ bool_init, int32_t* __restrict__ overflow,
    unsigned long long* __restrict__ queries,
    unsigned long long* __restrict__ hits,
    unsigned long long* __restrict__ misses) {
  probe_vote_tile<false>(TableWord<Filt>{filt}, slots, ranked, limit,
                         frame_ok, H, T, F, K, vote_min, threshold, bits,
                         blockIdx.x,
                         blockIdx.y, curr_id, top_count, cand_ids,
                         cand_counts, bool_init, overflow, queries, hits,
                         misses);
}

}  // namespace gr

// table/counts/n_banks/bank_len/remote: the filter's bank view
// (common.cuh make_banks; counts unused).
extern "C" int gr_probe_vote(
    void* const* table, void* const* counts, int n_banks, int64_t bank_len,
    int remote, const int64_t* slots, int ranked, int64_t limit,
    const bool* frame_ok, int B, int H, int T, int F, int K, int vote_min,
    int threshold, int32_t* curr_id, int32_t* top_count, int32_t* cand_ids,
    int32_t* cand_counts, bool* bool_init, int32_t* overflow,
    unsigned long long* queries, unsigned long long* hits,
    unsigned long long* misses, cudaStream_t stream) {
  // the vote table: the least power of two >= H*F entries (4,096, 32 KB,
  // at H*F = 3,000), beside the candidate list of kThreads entries
  int bits = 1;
  while ((1 << bits) < H * F) ++bits;
  gr::Banks banks;
  if (H > gr::kMaxH || K < 1 || K > H * F || bits > 14 ||
      !gr::make_banks(table, counts, n_banks, bank_len, remote, &banks))
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return gr::kNoLaunch;
  const size_t smem = ((static_cast<size_t>(1) << bits) + gr::kThreads) *
                      sizeof(unsigned long long);
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(B));
  return gr::with_view(banks, [&](auto filt) {
    const auto kernel = gr::probe_vote_kernel<decltype(filt)>;
    cudaError_t err = gr::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, gr::kThreads, smem, stream>>>(
        filt, slots, ranked, limit, frame_ok, H, T, F, K, vote_min,
        threshold, bits, curr_id, top_count, cand_ids, cand_counts,
        bool_init, overflow, queries, hits, misses);
    return cudaGetLastError();
  });
}
