// Rank structure of the rank-compressed miBF: the freeze.
//
// The compressed filter keeps one presence bit per slot and a rank-indexed
// id/counter pair per present slot (MIBloomFilter.hpp:94-101).  bitrank[w]
// holds the presence bits of slots 32w .. 32w+31 in its low 32 bits and, in
// its high 32 bits, the number of present slots before slot 32w within its
// superblock of 2^32 slots (2^27 words); supers[s] holds the number of
// present slots before superblock s, and a zero word is appended to
// bitrank.  A slot's rank is supers[slot >> 32] + the high half of its word
// + the popcount of the bits below it (_rank_lookup, compressed.py:218).
//
// Three kernels, the counterparts of the Pallas probes of
// tools/probe_pallas.py and of the JAX functions that do that work
// (_rank_from_bits, compressed.py:153-169, on the bits of
// _freeze_from_bits, :194; the byte transient of fill_bytes/freeze_device,
// :65/:104, is the fill's bitmap here):
//
//   rank_pack   the per-64k-block cumsum (pallas_cumsum_blocks, :80).  One
//               CTA per 65,536 slots (2,048 words): each thread reads two
//               words of the presence bitmap pass 1 filled (bit slot & 31
//               of word slot >> 5) with one 8-byte load, masks the slots at
//               or past size, popcounts them, and writes each word's
//               exclusive in-block prefix and the block's total.  A
//               superblock is exactly 65,536 blocks, so no block straddles
//               two.
//   rank_scan   the carried block sum of pallas_sweep (:126), restarted at
//               every superblock.  One CTA per superblock turns its 65,536
//               block totals, in place, into each block's carry (the totals
//               of the blocks before it in its superblock) and writes the
//               superblock's total to supers[s]; a second one-CTA launch
//               turns supers into the exclusive prefix of those totals (the
//               JAX package's super_base) and writes pop.  Linear in the
//               blocks: 868,948 at 56,947,329,536 slots.
//   rank_carry  the add of pallas_sweep: each word's high half gains its
//               block's carry; the appended word is zeroed.
//
// The lookup of P1 (pallas_gather, :59), slot -> rank through bitrank and
// supers, is fused into kernel A's rank grid (seed_hash.cu).
//
// Bound.  rank_pack reads the 4-byte bitmap words once (17.8 MB at the
// 5 Mbp sizing, 7.1 GB at 56,947,329,536 slots) and writes the 8-byte
// bitrank words: bandwidth-bound; rank_scan reads and writes the block
// totals (8 bytes per 65,536 slots); rank_carry is a read-modify-write of
// bitrank.
#include "common.cuh"

namespace gr {

constexpr int kRankBlockWords = 2048;       // 65,536 slots per block
constexpr int kRankThreads = 1024;          // two words per thread
constexpr int64_t kSuperBlocks = 65536;     // blocks per 2^32 slots
constexpr int kScanPerThread = kSuperBlocks / kRankThreads;

__global__ void rank_pack_kernel(const uint32_t* __restrict__ bitmap,
                                 int64_t size, int64_t nw,
                                 unsigned long long* __restrict__ bitrank,
                                 unsigned long long* __restrict__ totals) {
  __shared__ unsigned long long scan[kRankThreads];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kRankBlockWords +
                     2 * static_cast<int64_t>(threadIdx.x);
  uint32_t bits[2] = {0u, 0u};
  if (w0 + 1 < nw) {
    const uint2 v = *reinterpret_cast<const uint2*>(bitmap + w0);
    bits[0] = v.x;
    bits[1] = v.y;
  } else if (w0 < nw) {
    bits[0] = bitmap[w0];
  }
  for (int j = 0; j < 2; ++j) {
    const int64_t tail = size - (w0 + j) * 32;   // slots >= size are not real
    if (tail < 32) bits[j] &= tail > 0 ? (1u << tail) - 1u : 0u;
  }
  const unsigned long long p0 = __popc(bits[0]), p1 = __popc(bits[1]);
  const unsigned long long pre =
      block_exclusive_scan(p0 + p1, 0ull, scan, AddOp());
  if (w0 < nw) bitrank[w0] = (pre << 32) | bits[0];
  if (w0 + 1 < nw) bitrank[w0 + 1] = ((pre + p0) << 32) | bits[1];
  if (threadIdx.x == blockDim.x - 1) totals[blockIdx.x] = pre + p0 + p1;
}

// grid n_super: CTA s owns blocks [s * 65,536, min(nblk, (s + 1) * 65,536))
// and thread t of it the 64 consecutive blocks from s * 65,536 + 64 t.
__global__ void rank_scan_kernel(unsigned long long* __restrict__ totals,
                                 int64_t nblk,
                                 unsigned long long* __restrict__ supers) {
  __shared__ unsigned long long scan[kRankThreads];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kSuperBlocks +
                     static_cast<int64_t>(threadIdx.x) * kScanPerThread;
  const int64_t b1 = min64(b0 + kScanPerThread, nblk);
  unsigned long long part = 0;
  for (int64_t b = b0; b < b1; ++b) part += totals[b];
  unsigned long long carry = block_exclusive_scan(part, 0ull, scan, AddOp());
  if (threadIdx.x == blockDim.x - 1) supers[blockIdx.x] = carry + part;
  for (int64_t b = b0; b < b1; ++b) {
    const unsigned long long t = totals[b];
    totals[b] = carry;
    carry += t;
  }
}

// one CTA: supers (each superblock's total) -> the exclusive prefix of the
// totals, and their sum into pop.
__global__ void rank_supers_kernel(unsigned long long* __restrict__ supers,
                                   int64_t n_super,
                                   unsigned long long* __restrict__ pop) {
  __shared__ unsigned long long scan[kRankThreads];
  unsigned long long base = 0;
  for (int64_t s0 = 0; s0 < n_super; s0 += blockDim.x) {
    const int64_t s = s0 + threadIdx.x;
    const unsigned long long v = s < n_super ? supers[s] : 0ull;
    const unsigned long long pre = block_exclusive_scan(v, 0ull, scan,
                                                        AddOp());
    if (s < n_super) supers[s] = base + pre;
    // the last thread's inclusive sum is the chunk's total: broadcast it
    if (threadIdx.x == blockDim.x - 1) scan[0] = pre + v;
    __syncthreads();
    base += scan[0];
  }
  if (threadIdx.x == 0) *pop = base;
}

__global__ void rank_carry_kernel(
    unsigned long long* __restrict__ bitrank,
    const unsigned long long* __restrict__ carries, int64_t nw) {
  const unsigned long long carry = carries[blockIdx.x];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kRankBlockWords +
                     2 * static_cast<int64_t>(threadIdx.x);
  for (int j = 0; j < 2; ++j)
    if (w0 + j < nw) bitrank[w0 + j] += carry << 32;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) bitrank[nw] = 0;
}

inline int64_t rank_blocks(int64_t nw) {
  return (nw + kRankBlockWords - 1) / kRankBlockWords;
}

}  // namespace gr

extern "C" {

// bitmap: ceil(size / 32) = nw words, 8-byte aligned.
int gr_rank_pack(const uint32_t* bitmap, int64_t size, int64_t nw,
                 unsigned long long* bitrank, unsigned long long* totals,
                 cudaStream_t stream) {
  if (nw <= 0 || size > nw * 32 || size <= (nw - 1) * 32)
    return cudaErrorInvalidValue;
  gr::rank_pack_kernel<<<static_cast<unsigned>(gr::rank_blocks(nw)),
                         gr::kRankThreads, 0, stream>>>(bitmap, size, nw,
                                                        bitrank, totals);
  return cudaGetLastError();
}

// totals: the rank_pack totals of nw words, made each block's carry in
// place; supers: ceil(nw / 2^27) entries; pop: one.
int gr_rank_scan(unsigned long long* totals, int64_t nw,
                 unsigned long long* supers, unsigned long long* pop,
                 cudaStream_t stream) {
  if (nw <= 0) return cudaErrorInvalidValue;
  const int64_t nblk = gr::rank_blocks(nw);
  const int64_t n_super = (nblk + gr::kSuperBlocks - 1) / gr::kSuperBlocks;
  gr::rank_scan_kernel<<<static_cast<unsigned>(n_super), gr::kRankThreads, 0,
                         stream>>>(totals, nblk, supers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gr::rank_supers_kernel<<<1, gr::kRankThreads, 0, stream>>>(supers, n_super,
                                                             pop);
  return cudaGetLastError();
}

int gr_rank_carry(unsigned long long* bitrank,
                  const unsigned long long* carries, int64_t nw,
                  cudaStream_t stream) {
  if (nw <= 0) return cudaErrorInvalidValue;
  gr::rank_carry_kernel<<<static_cast<unsigned>(gr::rank_blocks(nw)),
                          gr::kRankThreads, 0, stream>>>(bitrank, carries,
                                                         nw);
  return cudaGetLastError();
}

}  // extern "C"
