// Rank structure of the rank-compressed miBF: the freeze and the lookup.
//
// The compressed filter keeps one presence bit per slot and a rank-indexed
// id/counter pair per present slot (MIBloomFilter.hpp:94-101).  bitrank[w]
// holds the presence bits of slots 32w .. 32w+31 in its low 32 bits and, in
// its high 32 bits, the number of present slots before slot 32w (below
// 2^32 slots there is one superblock, so the rank relative to it is the
// rank), with a zero word appended.
//
// Three kernels, each the counterpart of one Pallas probe of
// tools/probe_pallas.py and of the JAX function that does that work:
//
//   rank_pack   the per-64k-block cumsum (pallas_cumsum_blocks, :80).  One
//               CTA per 65,536 slots (2,048 words): pack the PRESENT bits
//               (bit 30) of the filled direct words into 32-bit words,
//               popcount them, and write each word's exclusive in-block
//               prefix and the block's total.  freeze_device_words +
//               _rank_from_bits, compressed.py:132-169.
//   rank_carry  the fused gather + carried block cumsum + add
//               (pallas_sweep, :126).  CTA b gathers the totals of blocks
//               0 .. b-1 into its carry and adds it to its words' prefixes.
//               On the TPU the carry rode in SMEM across sequential grid
//               steps; here every CTA recomputes it from the totals, which
//               stay in L2 (2,173 totals at the 5 Mbp sizing, at most 65,536
//               below 2^32 slots), so the CTAs run in parallel and nothing
//               spins on a predecessor.
//   rank_lookup the resident-table gather (pallas_gather, :59).  One thread
//               per grid entry maps a slot to its rank: bitrank[slot >> 5]
//               (35.6 MB at the 5 Mbp sizing, L2-sized where the TPU kept a
//               VMEM window), the presence bit, and rank = rel + popcount of
//               the bits below; absent and sentinel slots map to the
//               sentinel rank.  _rank_lookup/rank_grid, compressed.py:218-244,
//               :506-517.
//
// Bound.  rank_pack reads the 4-byte direct words once (570 MB at the 5 Mbp
// sizing) and is bandwidth-bound; rank_carry is a read-modify-write of
// bitrank; rank_lookup is one random 8-byte gather per grid entry.
#include "common.cuh"

namespace gr {

constexpr int kRankBlockWords = 2048;   // 65,536 slots per block
constexpr int kRankThreads = 1024;      // two words per thread

__global__ void rank_pack_kernel(const uint32_t* __restrict__ words,
                                 int64_t size, int64_t nw,
                                 unsigned long long* __restrict__ bitrank,
                                 unsigned long long* __restrict__ totals) {
  __shared__ unsigned long long scan[kRankThreads];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kRankBlockWords +
                     2 * static_cast<int64_t>(threadIdx.x);
  uint32_t bits[2] = {0u, 0u};
  for (int j = 0; j < 2; ++j) {
    const int64_t w = w0 + j;
    if (w >= nw) break;
    // 32 slot words, 128-byte aligned: eight 16-byte loads
    const uint4* p = reinterpret_cast<const uint4*>(words + w * 32);
    uint32_t b = 0;
    for (int q = 0; q < 8; ++q) {
      const uint4 v = p[q];
      b |= ((v.x >> 30) & 1u) << (4 * q);
      b |= ((v.y >> 30) & 1u) << (4 * q + 1);
      b |= ((v.z >> 30) & 1u) << (4 * q + 2);
      b |= ((v.w >> 30) & 1u) << (4 * q + 3);
    }
    const int64_t tail = size - w * 32;   // slots >= size are not real
    if (tail < 32) b &= (1u << tail) - 1u;
    bits[j] = b;
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

__global__ void rank_lookup_kernel(const int64_t* __restrict__ slots, int64_t n,
                                   const unsigned long long* __restrict__ bitrank,
                                   int64_t size, int64_t sentinel,
                                   int64_t* __restrict__ ranks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = slots[i];
  int64_t r = sentinel;
  if (s >= 0 && s < size) {
    const unsigned long long e = bitrank[s >> 5];
    const uint32_t bits = static_cast<uint32_t>(e);
    const unsigned b = static_cast<unsigned>(s & 31);
    if ((bits >> b) & 1u)
      r = static_cast<int64_t>(e >> 32) + __popc(bits & ((1u << b) - 1u));
  }
  ranks[i] = r;
}

}  // namespace gr

extern "C" {

int gr_rank_pack(const uint32_t* words, int64_t size, int64_t nw,
                 unsigned long long* bitrank, unsigned long long* totals,
                 cudaStream_t stream) {
  if (nw <= 0 || size > nw * 32 || size <= (nw - 1) * 32)
    return cudaErrorInvalidValue;
  const unsigned nblk = static_cast<unsigned>(
      (nw + gr::kRankBlockWords - 1) / gr::kRankBlockWords);
  gr::rank_pack_kernel<<<nblk, gr::kRankThreads, 0, stream>>>(
      words, size, nw, bitrank, totals);
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

int gr_rank_lookup(const int64_t* slots, int64_t n,
                   const unsigned long long* bitrank, int64_t size,
                   int64_t sentinel, int64_t* ranks, cudaStream_t stream) {
  if (n == 0) return gr::kNoLaunch;
  const int64_t nblk = (n + 255) / 256;
  if (nblk > 0x7FFFFFFF) return cudaErrorInvalidValue;
  gr::rank_lookup_kernel<<<static_cast<unsigned>(nblk), 256, 0, stream>>>(
      slots, n, bitrank, size, sentinel, ranks);
  return cudaGetLastError();
}

}  // extern "C"
