// kmer_count / kmer_query (K21): the k-mer polisher's read table.
// Replaces goldrush_tpu/stages/polish.py: _count_kmers (:82) and
// _query_kmers (:93).  For row b of a batch of base codes [B, L] and
// position p < P = L - k + 1, the canonical unspaced ntHash h of
// codes[b, p : p+k] (low two bits of each code read) maps to the slot
// floor(h * size / 2^64) = __umul64hi(h, size), which is the JAX
// function's fastrange for size < 2^32 (the wrapper checks).
//
//   count: counts[slot] += 1 for every valid position, p < lengths[b] - k
//          + 1.  The JAX function sends invalid positions (and the rows and
//          columns of its power-of-two padding) to the sentinel slot
//          `size` instead; this kernel skips them, so counts[size] stays as
//          it was.  Nothing reads the sentinel (fastrange < size).
//   query: out[b, p] = counts[slot] for every p < P, valid or not, as the
//          JAX function returns it before the caller's [:B, :P] slice.
//
// One thread per run of kRun consecutive positions of one row, hashed with
// the rolling recurrence (common.cuh: NtRoll) from the codes in device
// memory (neighbouring threads share their codes through L1).  The count's
// atomics are aggregated over the lanes of a warp that hit one slot
// (__match_any_sync), so a homopolymer batch adds 32 at a time.  The table
// is per goldtig in the pipeline (8 slots per read base, ~10-30 MB) and
// stays in L2.  Bound: the codes in and one read-modify-write (count) or
// read (query) per distinct slot plus the query's output, over the device
// memory rate; the rolling hash and slot map are ~25 integer operations
// per position.
#include "common.cuh"

namespace gr {

constexpr int kKmerThreads = 256;
constexpr int kKmerRun = 16;

struct RowRun {
  int64_t b, p0;
};

__device__ __forceinline__ RowRun row_run(int64_t gid, int64_t runs) {
  return RowRun{gid / runs, (gid % runs) * kKmerRun};
}

__global__ void __launch_bounds__(kKmerThreads) kmer_count_kernel(
    const uint8_t* __restrict__ codes, int64_t L, int64_t P,
    const int64_t* __restrict__ lengths, int64_t total, int64_t runs, int k,
    uint64_t size, unsigned* __restrict__ counts) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool live = gid < total;
  RowRun rr{0, 0};
  int64_t n_valid = 0;
  if (live) {
    rr = row_run(gid, runs);
    n_valid = min64(lengths[rr.b] - k + 1, P);
  }
  const uint8_t* row = codes + rr.b * L;
  NtRoll h(k);
  const unsigned lane = threadIdx.x & 31u;
  // every lane runs all kKmerRun steps, so each __match_any_sync has the
  // whole warp; a valid slot is below size < 2^32 - 1
  for (int q = 0; q < kKmerRun; ++q) {
    const int64_t p = rr.p0 + q;
    const bool valid = p < n_valid;
    unsigned slot = 0xFFFFFFFFu;
    if (valid) {
      if (q == 0) {
        h.init([&](unsigned j) { return row[p + j] & 3u; });
      } else {
        h.roll(row[p - 1] & 3u, row[p + k - 1] & 3u);
      }
      slot = static_cast<unsigned>(__umul64hi(h.canonical(), size));
    }
    const unsigned peers = __match_any_sync(kFull, slot);
    if (valid && lane == static_cast<unsigned>(__ffs(peers) - 1)) {
      atomicAdd(counts + slot, static_cast<unsigned>(__popc(peers)));
    }
  }
}

__global__ void __launch_bounds__(kKmerThreads) kmer_query_kernel(
    const uint8_t* __restrict__ codes, int64_t L, int64_t P, int64_t total,
    int64_t runs, int k, uint64_t size, const unsigned* __restrict__ counts,
    unsigned* __restrict__ out) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (gid >= total) return;
  const RowRun rr = row_run(gid, runs);
  const uint8_t* row = codes + rr.b * L;
  const int64_t end = min64(rr.p0 + kKmerRun, P);
  NtRoll h(k);
  h.init([&](unsigned j) { return row[rr.p0 + j] & 3u; });
  for (int64_t p = rr.p0;; ++p) {
    const uint64_t slot = __umul64hi(h.canonical(), size);
    out[rr.b * P + p] = counts[slot];
    if (p + 1 >= end) break;
    h.roll(row[p] & 3u, row[p + k] & 3u);
  }
}

inline unsigned kmer_blocks(int64_t total) {
  return static_cast<unsigned>((total + kKmerThreads - 1) / kKmerThreads);
}

}  // namespace gr

extern "C" {

// codes: uint8 [B, L]; lengths: int64 [B]; counts: int32 [size + 1]
// (uint32 bits), updated in place.  Needs 1 <= k, 0 < size < 2^32.
int gr_kmer_count(const uint8_t* codes, int B, int64_t L,
                  const int64_t* lengths, int k, uint64_t size, int* counts,
                  cudaStream_t stream) {
  if (B < 0 || L < 0 || k < 1 || size == 0 || size >= (1ull << 32))
    return cudaErrorInvalidValue;
  const int64_t P = L - k + 1;
  if (B == 0 || P <= 0) return gr::kNoLaunch;
  const int64_t runs = (P + gr::kKmerRun - 1) / gr::kKmerRun;
  const int64_t total = runs * B;
  gr::kmer_count_kernel<<<gr::kmer_blocks(total), gr::kKmerThreads, 0,
                          stream>>>(codes, L, P, lengths, total, runs, k,
                                    size, reinterpret_cast<unsigned*>(counts));
  return cudaGetLastError();
}

// out: int32 [B, L - k + 1] (uint32 bits) = counts[slot of each k-mer].
int gr_kmer_query(const uint8_t* codes, int B, int64_t L, int k,
                  uint64_t size, const int* counts, int* out,
                  cudaStream_t stream) {
  if (B < 0 || L < 0 || k < 1 || size == 0 || size >= (1ull << 32))
    return cudaErrorInvalidValue;
  const int64_t P = L - k + 1;
  if (B == 0 || P <= 0) return gr::kNoLaunch;
  const int64_t runs = (P + gr::kKmerRun - 1) / gr::kKmerRun;
  const int64_t total = runs * B;
  gr::kmer_query_kernel<<<gr::kmer_blocks(total), gr::kKmerThreads, 0,
                          stream>>>(codes, L, P, total, runs, k, size,
                                    reinterpret_cast<const unsigned*>(counts),
                                    reinterpret_cast<unsigned*>(out));
  return cudaGetLastError();
}

}  // extern "C"
