// Kernel B: miBF probe + per-tile id vote.
//
// Replaces probe_and_vote (goldrush_tpu/mibf/mibf.py:361-441) and its
// rank-compressed twin (goldrush_tpu/mibf/compressed.py:248-334), i.e. the
// reference's per-tile vote (goldrush_path.cpp:544-634).  One CTA per
// (read, tile):
//   1. per frame, gather the H words (direct: words[slot]; compressed:
//      PRESENT | ids[rank] for a real rank, 0 for the sentinel), apply the
//      all-seeds PRESENT gate (atRank) and frame_ok, take id = word &
//      ID_MASK (the saturation unmask), count hits/misses, and dedupe ids
//      within the frame (the reference's per-frame unique_ids set);
//   2. sort the tile's H*F ids in shared memory and run-length them: a
//      block-wide running max of run-start positions (the per-block cummax
//      of tools/probe_pallas.py:98, the cummin of compressed.py:302) gives
//      every position the start of its run, and each run's last position
//      emits the run's key;
//   3. key every distinct id as (H*F + 1 - count) << 32 | id and sort the
//      keys, which orders ids by (count desc, id asc) - std::map iteration
//      order with the max-count / smallest-id tie rule;
//   4. emit curr_id/top_count (first key), the top K ids with count >
//      vote_min, overflow, bool_init; queries/hits/misses are summed per
//      read with integer atomics (order-free, so deterministic).
// The JAX version does the same two sorts as XLA row sorts over [B*T, H*F];
// here both stay in shared memory (2 x 8 B x next_pow2(H*F): 64 KB at
// H*F = 3000, plus 2 KB of scan scratch), and nothing but the outputs
// reaches device memory.
//
// Bound.  H random 4-byte gathers per frame from the 570 MB words array
// (3 x 20,000 per 20-tile read, each its own 32-byte sector) and the two
// bitonic sorts (78 barrier stages each at 4096 keys); the per-read live
// re-probe launches 20 CTAs, so there it is latency-bound.
#include "common.cuh"

namespace gr {

constexpr int kMaxH = 8;
constexpr int kThreads = 256;

extern __shared__ __align__(16) unsigned char gr_smem[];

__global__ void probe_vote_kernel(
    const uint32_t* __restrict__ words, const int64_t* __restrict__ slots,
    int ranked, int64_t limit, const bool* __restrict__ frame_ok, int H,
    int T, int F, int K,
    int vote_min, int threshold, int n2, int32_t* __restrict__ curr_id,
    int32_t* __restrict__ top_count, int32_t* __restrict__ cand_ids,
    int32_t* __restrict__ cand_counts, bool* __restrict__ bool_init,
    int32_t* __restrict__ overflow, unsigned long long* __restrict__ queries,
    unsigned long long* __restrict__ hits,
    unsigned long long* __restrict__ misses) {
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(gr_smem);
  unsigned long long* keys2 = keys + n2;
  // block counters live after the two key arrays: queries, hits, misses,
  // candidates over vote_min; then the scan scratch, one per thread
  unsigned long long* cnt = keys2 + n2;
  long long* scan = reinterpret_cast<long long*>(cnt + 4);
  const int t = blockIdx.x, b = blockIdx.y;
  const int64_t TF = static_cast<int64_t>(T) * F;
  const int FH = H * F;
  if (threadIdx.x < 4) cnt[threadIdx.x] = 0;
  for (int i = FH + threadIdx.x; i < n2; i += blockDim.x) keys[i] = kSentinel64;

  unsigned long long q = 0, nh = 0, nm = 0;
  for (int fr = threadIdx.x; fr < F; fr += blockDim.x) {
    const int64_t col = static_cast<int64_t>(t) * F + fr;
    uint32_t id[kMaxH];
    bool present = frame_ok[b * TF + col];
    q += present;
    if (present) {
      uint32_t all = kPresent;
      for (int s = 0; s < H; ++s) {
        const int64_t x = slots[(static_cast<int64_t>(b) * H + s) * TF + col];
        const uint32_t w = !ranked ? words[x] : x < limit ? kPresent | words[x] : 0u;
        all &= w;
        id[s] = w & kIdMask;
      }
      present = all != 0;
    }
    for (int s = 0; s < H; ++s) {
      if (!present) {
        id[s] = 0;
        continue;
      }
      if (id[s]) ++nh; else ++nm;
    }
    for (int j = 1; j < H; ++j)
      for (int i = 0; i < j; ++i)
        if (id[j] == id[i]) id[j] = 0;
    for (int s = 0; s < H; ++s)
      keys[s * F + fr] = id[s] ? id[s] : kSentinel64;
  }
  __syncthreads();
  atomicAdd(cnt + 0, q);
  atomicAdd(cnt + 1, nh);
  atomicAdd(cnt + 2, nm);
  block_bitonic_sort(keys, n2);

  // run lengths: thread j owns positions [i0, i1); the exclusive block max
  // of the run starts before i0 seeds its walk
  const int per = (n2 + blockDim.x - 1) / blockDim.x;
  const int i0 = min(static_cast<int>(threadIdx.x) * per, n2);
  const int i1 = min(i0 + per, n2);
  long long last = -1;
  for (int i = i0; i < i1; ++i)
    if (keys[i] != kSentinel64 && (i == 0 || keys[i - 1] != keys[i])) last = i;
  long long start = block_exclusive_scan(last, -1LL, scan, MaxOp());
  unsigned long long over = 0;
  for (int i = i0; i < i1; ++i) {
    const unsigned long long v = keys[i];
    unsigned long long key = kSentinel64;
    if (v != kSentinel64) {
      if (i == 0 || keys[i - 1] != v) start = i;
      if (i == n2 - 1 || keys[i + 1] != v) {
        const int run = i - static_cast<int>(start) + 1;
        key = (static_cast<unsigned long long>(FH + 1 - run) << 32) | v;
        over += run > vote_min;
      }
    }
    keys2[i] = key;
  }
  atomicAdd(cnt + 3, over);
  __syncthreads();
  block_bitonic_sort(keys2, n2);

  const int64_t bt = static_cast<int64_t>(b) * T + t;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const unsigned long long v = j < n2 ? keys2[j] : kSentinel64;
    const int c = v == kSentinel64 ? 0 : FH + 1 - static_cast<int>(v >> 32);
    const int32_t i = c > 0 ? static_cast<int32_t>(v & 0xFFFFFFFFull) : 0;
    const bool cand = c > vote_min;
    cand_ids[bt * K + j] = cand ? i : 0;
    cand_counts[bt * K + j] = cand ? c : 0;
    if (j == 0) {
      curr_id[bt] = i;
      top_count[bt] = c;
      bool_init[bt] = cand && c > threshold;
    }
  }
  if (threadIdx.x == 0) {
    overflow[bt] = max(static_cast<int>(cnt[3]) - K, 0);
    atomicAdd(queries + b, cnt[0]);
    atomicAdd(hits + b, cnt[1]);
    atomicAdd(misses + b, cnt[2]);
  }
}

}  // namespace gr

extern "C" int gr_probe_vote(
    const uint32_t* words, const int64_t* slots, int ranked, int64_t limit,
    const bool* frame_ok, int B, int H, int T, int F, int K, int vote_min,
    int threshold, int n2,
    int32_t* curr_id, int32_t* top_count, int32_t* cand_ids,
    int32_t* cand_counts, bool* bool_init, int32_t* overflow,
    unsigned long long* queries, unsigned long long* hits,
    unsigned long long* misses, cudaStream_t stream) {
  if (H > gr::kMaxH || K < 1 || n2 < H * F) return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return gr::kNoLaunch;
  const size_t smem =
      (2 * static_cast<size_t>(n2) + 4 + gr::kThreads) * sizeof(unsigned long long);
  cudaError_t err = gr::allow_smem(gr::probe_vote_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(B));
  gr::probe_vote_kernel<<<grid, gr::kThreads, smem, stream>>>(
      words, slots, ranked, limit, frame_ok, H, T, F, K, vote_min, threshold,
      n2, curr_id, top_count, cand_ids, cand_counts, bool_init, overflow,
      queries, hits, misses);
  return cudaGetLastError();
}
