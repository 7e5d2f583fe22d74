// Kernel B: miBF probe + per-tile id vote.
//
// Replaces probe_and_vote (goldrush_tpu/mibf/mibf.py:361-441) and its
// rank-compressed twin (goldrush_tpu/mibf/compressed.py:248-334), i.e. the
// reference's per-tile vote (goldrush_path.cpp:544-634).  One CTA per
// (read, tile):
//   1. gather: a thread takes a frame, loads frame_ok and its H grid
//      entries, then all H words (direct: words[slot]; compressed:
//      PRESENT | ids[rank] for a real rank, 0 for the sentinel) before it
//      uses any, so one round trip to memory covers the tile.  It applies
//      the all-seeds PRESENT gate (atRank) and frame_ok, takes id = word &
//      ID_MASK (the saturation unmask), counts hits/misses and dedupes ids
//      within the frame (the reference's per-frame unique_ids set);
//   2. count: every id goes into an open-addressing table in shared memory
//      (entry id << 32 | count, linear probing from a multiplicative hash;
//      atomicCAS claims an entry, atomicAdd counts).  The lanes of a warp
//      that vote the same id add once (__match_any_sync).  The table has a
//      power of two >= H*F entries, so it holds every vote of a tile and
//      needs no overflow path;
//   3. rank: each entry becomes the key (H*F + 1 - count) << 32 | id, whose
//      ascending order is (count desc, id asc): std::map iteration with the
//      max-count / smallest-id tie rule.  A block min gives curr_id and
//      top_count; the candidates (count > vote_min) are a prefix of that
//      order.  Up to blockDim candidates are compacted and each takes its
//      rank by counting the smaller keys (keys are distinct); more (a
//      vote_min of 0, degenerate tiles) sort the whole table in place;
//   4. emit curr_id/top_count, the top K candidates, overflow, bool_init;
//      queries/hits/misses are summed per read with integer atomics
//      (order-free, so deterministic).
// The JAX version sorts [B*T, H*F] votes twice and takes each id's run
// length from a running min of run starts (mibf.py:408); here the table's
// counts are those run lengths, and no vote is sorted.
//
// Bound.  Bytes: the tile's H*F int64 grid entries, F frame_ok bytes and
// the H*F 4-byte words of its present frames (each a random gather from a
// 570 MB array, so its own 32-byte sector), plus ~0.3 KB of outputs; at
// B = 32, T = 20, H = 3, F = 1000 that is ~23 MB, ~7 us at 3.35 TB/s.
// The work after the gather is shared-memory atomics and one or two block
// reductions, so a tile costs about two dependent DRAM round trips plus a
// few barriers; the B = 1 re-probe (20 CTAs) is latency-bound.
#include "common.cuh"

namespace gr {

constexpr int kMaxH = 8;
// threads per CTA, one CTA per tile: 2 frames each at F = 1,000, and four
// CTAs (36 KB of shared memory each at H*F = 3,000) on an SM
constexpr int kThreads = 512;

extern __shared__ __align__(16) unsigned char gr_smem[];

// Add `add` votes for `id` (nonzero) to the table of 2^bits entries.  An
// entry's id never changes once claimed, so a stale read is either 0
// (settled by the CAS) or the right id with a stale count.
__device__ void table_add(unsigned long long* tab, int bits, uint32_t id,
                          unsigned add) {
  const unsigned mask = (1u << bits) - 1u;
  unsigned h = (id * 0x9E3779B1u) >> (32 - bits);
  for (;;) {
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(tab + h);
    if (cur == 0) {
      cur = atomicCAS(tab + h, 0ull,
                      (static_cast<unsigned long long>(id) << 32) | add);
      if (cur == 0) return;
    }
    if (static_cast<uint32_t>(cur >> 32) == id) {
      atomicAdd(tab + h, static_cast<unsigned long long>(add));
      return;
    }
    h = (h + 1u) & mask;
  }
}

// Warp-wide min of v[0] and sums of v[1..4], in every lane.
__device__ __forceinline__ void warp_reduce5(unsigned long long v[5]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long m = __shfl_xor_sync(kFull, v[0], o);
    v[0] = m < v[0] ? m : v[0];
#pragma unroll
    for (int j = 1; j < 5; ++j) v[j] += __shfl_xor_sync(kFull, v[j], o);
  }
}

// Block-wide min of v[0] and sums of v[1..4]; every thread of the block
// calls it once and gets the result.  `red` holds 5 x 32 values.
__device__ void block_reduce5(unsigned long long v[5],
                              unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce5(v);
  if (lane == 0)
    for (int j = 0; j < 5; ++j) red[j * 32 + warp] = v[j];
  __syncthreads();
  // every warp reduces the per-warp partials itself
  const bool in = lane < static_cast<int>((blockDim.x + 31) >> 5);
#pragma unroll
  for (int j = 0; j < 5; ++j)
    v[j] = in ? red[j * 32 + lane] : j ? 0ull : kSentinel64;
  warp_reduce5(v);
}

__device__ __forceinline__ void emit(unsigned long long key, int FH,
                                     int vote_min, int32_t* ids,
                                     int32_t* counts) {
  const int c =
      key == kSentinel64 ? 0 : FH + 1 - static_cast<int>(key >> 32);
  const bool cand = c > vote_min && c > 0;
  *ids = cand ? static_cast<int32_t>(key & 0xFFFFFFFFull) : 0;
  *counts = cand ? c : 0;
}

__global__ void probe_vote_kernel(
    const uint32_t* __restrict__ words, const int64_t* __restrict__ slots,
    int ranked, int64_t limit, const bool* __restrict__ frame_ok, int H,
    int T, int F, int K, int vote_min, int threshold, int bits,
    int32_t* __restrict__ curr_id, int32_t* __restrict__ top_count,
    int32_t* __restrict__ cand_ids, int32_t* __restrict__ cand_counts,
    bool* __restrict__ bool_init, int32_t* __restrict__ overflow,
    unsigned long long* __restrict__ queries,
    unsigned long long* __restrict__ hits,
    unsigned long long* __restrict__ misses) {
  __shared__ unsigned long long red[5 * 32];
  __shared__ unsigned fill;
  const int S = 1 << bits;
  unsigned long long* tab = reinterpret_cast<unsigned long long*>(gr_smem);
  unsigned long long* cand = tab + S;
  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t TF = static_cast<int64_t>(T) * F;
  const int FH = H * F;
  for (int i = threadIdx.x; i < S; i += blockDim.x) tab[i] = 0;
  if (threadIdx.x == 0) fill = 0;
  __syncthreads();

  // 1-2. gather, gate, dedupe, count; every lane of a warp runs every
  // round so that the warp collectives see all 32 lanes
  unsigned long long q = 0, nh = 0, nm = 0;
  for (int f0 = 0; f0 < F; f0 += blockDim.x) {
    const int fr = f0 + threadIdx.x;
    const int64_t col = static_cast<int64_t>(t) * F + fr;
    bool ok = false;
    int64_t x[kMaxH] = {};
    uint32_t id[kMaxH] = {};
    if (fr < F) {
      ok = frame_ok[b * TF + col];
#pragma unroll
      for (int s = 0; s < kMaxH; ++s)
        if (s < H)
          x[s] = slots[(static_cast<int64_t>(b) * H + s) * TF + col];
    }
    if (ok) {
#pragma unroll
      for (int s = 0; s < kMaxH; ++s)
        if (s < H)
          id[s] = !ranked ? words[x[s]]
                  : x[s] < limit ? kPresent | words[x[s]] : 0u;
    }
    // every loop over the seeds is unrolled to kMaxH so that x and id stay
    // in registers
    uint32_t all = ok ? kPresent : 0u;
#pragma unroll
    for (int s = 0; s < kMaxH; ++s) {
      if (s < H) all &= id[s];
      id[s] &= kIdMask;
    }
    const bool present = all != 0;
    q += ok;
#pragma unroll
    for (int s = 0; s < kMaxH; ++s) {
      if (s >= H) continue;
      if (!present) id[s] = 0;
      else if (id[s]) ++nh;
      else ++nm;
    }
#pragma unroll
    for (int j = 1; j < kMaxH; ++j)
#pragma unroll
      for (int i = 0; i < j; ++i)
        if (id[j] == id[i]) id[j] = 0;
#pragma unroll
    for (int s = 0; s < kMaxH; ++s) {
      if (s >= H) break;
      const unsigned peers = __match_any_sync(kFull, id[s]);
      if (id[s] && lane == __ffs(peers) - 1)
        table_add(tab, bits, id[s], __popc(peers));
    }
  }
  __syncthreads();

  // 3. key every entry in place; block min, candidate count and the read's
  // counters in one reduction
  unsigned long long v[5] = {kSentinel64, 0, q, nh, nm};
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const unsigned long long e = tab[i];
    unsigned long long key = kSentinel64;
    if (e) {
      const int c = static_cast<int>(e & 0xFFFFFFFFull);
      key = (static_cast<unsigned long long>(FH + 1 - c) << 32) | (e >> 32);
      v[1] += c > vote_min;
      v[0] = key < v[0] ? key : v[0];
    }
    tab[i] = key;
  }
  block_reduce5(v, red);
  const int M = static_cast<int>(v[1]);
  const int64_t bt = static_cast<int64_t>(b) * T + t;
  int32_t* ci = cand_ids + bt * K;
  int32_t* cc = cand_counts + bt * K;
  if (M <= static_cast<int>(blockDim.x)) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const unsigned long long key = tab[i];
      if (key != kSentinel64 &&
          FH + 1 - static_cast<int>(key >> 32) > vote_min)
        cand[atomicAdd(&fill, 1u)] = key;
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < M) {
      const unsigned long long key = cand[threadIdx.x];
      int r = 0;
      for (int j = 0; j < M; ++j) r += cand[j] < key;
      if (r < K) emit(key, FH, vote_min, ci + r, cc + r);
    }
    for (int j = M + threadIdx.x; j < K; j += blockDim.x) ci[j] = cc[j] = 0;
  } else {
    block_bitonic_sort(tab, S);
    for (int j = threadIdx.x; j < K; j += blockDim.x)
      emit(tab[j], FH, vote_min, ci + j, cc + j);
  }
  if (threadIdx.x == 0) {
    const unsigned long long best = v[0];
    const int c =
        best == kSentinel64 ? 0 : FH + 1 - static_cast<int>(best >> 32);
    curr_id[bt] = c > 0 ? static_cast<int32_t>(best & 0xFFFFFFFFull) : 0;
    top_count[bt] = c;
    bool_init[bt] = c > vote_min && c > threshold;
    overflow[bt] = max(M - K, 0);
    atomicAdd(queries + b, v[2]);
    atomicAdd(hits + b, v[3]);
    atomicAdd(misses + b, v[4]);
  }
}

}  // namespace gr

extern "C" int gr_probe_vote(
    const uint32_t* words, const int64_t* slots, int ranked, int64_t limit,
    const bool* frame_ok, int B, int H, int T, int F, int K, int vote_min,
    int threshold, int32_t* curr_id, int32_t* top_count, int32_t* cand_ids,
    int32_t* cand_counts, bool* bool_init, int32_t* overflow,
    unsigned long long* queries, unsigned long long* hits,
    unsigned long long* misses, cudaStream_t stream) {
  // the vote table: the least power of two >= H*F entries (4,096, 32 KB,
  // at H*F = 3,000), beside the candidate list of kThreads entries
  int bits = 1;
  while ((1 << bits) < H * F) ++bits;
  if (H > gr::kMaxH || K < 1 || K > H * F || bits > 14)
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return gr::kNoLaunch;
  const size_t smem = ((static_cast<size_t>(1) << bits) + gr::kThreads) *
                      sizeof(unsigned long long);
  cudaError_t err = gr::allow_smem(gr::probe_vote_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(B));
  gr::probe_vote_kernel<<<grid, gr::kThreads, smem, stream>>>(
      words, slots, ranked, limit, frame_ok, H, T, F, K, vote_min, threshold,
      bits, curr_id, top_count, cand_ids, cand_counts, bool_init, overflow,
      queries, hits, misses);
  return cudaGetLastError();
}
