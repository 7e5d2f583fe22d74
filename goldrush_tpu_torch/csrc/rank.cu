// Rank structure of the rank-compressed miBF: the freeze.
//
// The compressed filter keeps one presence bit per slot and a rank-indexed
// id/counter pair per present slot (MIBloomFilter.hpp:94-101).  bitrank[w]
// holds the presence bits of slots 32w .. 32w+31 in its low 32 bits and, in
// its high 32 bits, the number of present slots before slot 32w (below
// 2^32 slots there is one superblock, so the rank relative to it is the
// rank), with a zero word appended.
//
// Two kernels, each the counterpart of one Pallas probe of
// tools/probe_pallas.py and of the JAX function that does that work:
//
//   rank_pack   the per-64k-block cumsum (pallas_cumsum_blocks, :80).  One
//               CTA per 65,536 slots (2,048 words): each thread reads two
//               words of the presence bitmap pass 1 filled (bit slot & 31
//               of word slot >> 5) with one 8-byte load, masks the slots at
//               or past size, popcounts them, and writes each word's
//               exclusive in-block prefix and the block's total.
//               _rank_from_bits, compressed.py:153-169 (the bits of
//               _freeze_from_bits, :194).
//   rank_carry  the fused gather + carried block cumsum + add
//               (pallas_sweep, :126).  CTA b gathers the totals of blocks
//               0 .. b-1 into its carry and adds it to its words' prefixes.
//               On the TPU the carry rode in SMEM across sequential grid
//               steps; here every CTA recomputes it from the totals, which
//               stay in L2 (2,173 totals at the 5 Mbp sizing, at most 65,536
//               below 2^32 slots), so the CTAs run in parallel and nothing
//               spins on a predecessor.
//
// The lookup of P1 (pallas_gather, :59), slot -> rank through bitrank, is
// fused into kernel A's rank grid (seed_hash.cu).
//
// Bound.  rank_pack reads the 4-byte bitmap words once (17.8 MB at the
// 5 Mbp sizing) and writes the 8-byte bitrank words (35.6 MB): bandwidth-
// bound; rank_carry is a read-modify-write of bitrank.
#include "common.cuh"

namespace gr {

constexpr int kRankBlockWords = 2048;   // 65,536 slots per block
constexpr int kRankThreads = 1024;      // two words per thread

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

__global__ void rank_carry_kernel(unsigned long long* __restrict__ bitrank,
                                  const unsigned long long* __restrict__ totals,
                                  int64_t nw, unsigned long long* __restrict__ pop) {
  __shared__ unsigned long long scan[kRankThreads];
  unsigned long long part = 0;
  for (unsigned j = threadIdx.x; j < blockIdx.x; j += blockDim.x)
    part += totals[j];
  const unsigned long long pre = block_exclusive_scan(part, 0ull, scan, AddOp());
  // the last thread's inclusive sum is the carry: broadcast it
  if (threadIdx.x == blockDim.x - 1) scan[0] = pre + part;
  __syncthreads();
  const unsigned long long carry = scan[0];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kRankBlockWords +
                     2 * static_cast<int64_t>(threadIdx.x);
  for (int j = 0; j < 2; ++j)
    if (w0 + j < nw) bitrank[w0 + j] += carry << 32;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    *pop = carry + totals[blockIdx.x];
    bitrank[nw] = 0;
  }
}

}  // namespace gr

extern "C" {

// bitmap: ceil(size / 32) = nw words, 8-byte aligned.
int gr_rank_pack(const uint32_t* bitmap, int64_t size, int64_t nw,
                 unsigned long long* bitrank, unsigned long long* totals,
                 cudaStream_t stream) {
  if (nw <= 0 || size > nw * 32 || size <= (nw - 1) * 32)
    return cudaErrorInvalidValue;
  const unsigned nblk = static_cast<unsigned>(
      (nw + gr::kRankBlockWords - 1) / gr::kRankBlockWords);
  gr::rank_pack_kernel<<<nblk, gr::kRankThreads, 0, stream>>>(
      bitmap, size, nw, bitrank, totals);
  return cudaGetLastError();
}

int gr_rank_carry(unsigned long long* bitrank, const unsigned long long* totals,
                  int64_t nw, unsigned long long* pop, cudaStream_t stream) {
  if (nw <= 0) return cudaErrorInvalidValue;
  const unsigned nblk = static_cast<unsigned>(
      (nw + gr::kRankBlockWords - 1) / gr::kRankBlockWords);
  gr::rank_carry_kernel<<<nblk, gr::kRankThreads, 0, stream>>>(
      bitrank, totals, nw, pop);
  return cudaGetLastError();
}

}  // extern "C"
