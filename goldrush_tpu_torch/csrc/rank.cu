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
//               every superblock: a segmented exclusive scan of the block
//               totals, in place, each becoming its block's carry (the
//               totals of the blocks before it in its superblock), with
//               supers (the present slots before each superblock, the JAX
//               package's super_base) and pop.  Two launches spread it over
//               the card: tiles of kScanTile = 2,048 totals (a superblock
//               is 32 of them, so no tile straddles two) are summed, one
//               CTA each; then each CTA takes its carry from the sums of
//               the tiles before it in its superblock (at most 31), scans
//               its tile in registers and shared memory (coalesced 16-byte
//               loads and stores), and the first tile of each superblock
//               writes supers[s] and the last tile pop from the tile sums.
//               Linear in the blocks: 868,948 at 56,947,329,536 slots, 425
//               CTAs.
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

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanPairs = 4;                         // 16-byte pairs a thread
constexpr int kScanTile = 2 * kScanPairs * kScanThreads;   // totals a CTA
constexpr int kScanTilesPerSuper = kSuperBlocks / kScanTile;

// pair r of this thread in its tile (lane-strided, so a warp's 16-byte
// loads and stores are contiguous): totals 2u and 2u + 1 of the tile, u =
// tid + r * kScanThreads; zero past nblk
__device__ __forceinline__ longlong2 scan_pair(
    const unsigned long long* totals, int64_t t0, int64_t nblk, int r) {
  const int64_t i = t0 + 2 * (threadIdx.x + r * kScanThreads);
  if (i + 1 < nblk) return *reinterpret_cast<const longlong2*>(totals + i);
  return make_longlong2(i < nblk ? static_cast<long long>(totals[i]) : 0, 0);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// the sum of v over the block, to every thread; `red` holds kScanWarps
// values; starts and ends with a barrier
__device__ unsigned long long block_sum(unsigned long long v,
                                        unsigned long long* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long s = 0;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// grid ceil(nblk / kScanTile): each tile's sum
__global__ void __launch_bounds__(kScanThreads) rank_tile_sums_kernel(
    const unsigned long long* __restrict__ totals, int64_t nblk,
    unsigned long long* __restrict__ sums) {
  __shared__ unsigned long long red[kScanWarps];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kScanTile;
  unsigned long long v = 0;
#pragma unroll
  for (int r = 0; r < kScanPairs; ++r) {
    const longlong2 p = scan_pair(totals, t0, nblk, r);
    v += static_cast<unsigned long long>(p.x) +
         static_cast<unsigned long long>(p.y);
  }
  const unsigned long long s = block_sum(v, red);
  if (threadIdx.x == 0) sums[blockIdx.x] = s;
}

// grid ceil(nblk / kScanTile): the tile's totals become their carries
__global__ void __launch_bounds__(kScanThreads) rank_scan_kernel(
    unsigned long long* __restrict__ totals, int64_t nblk,
    const unsigned long long* __restrict__ sums, int n_tiles,
    unsigned long long* __restrict__ supers,
    unsigned long long* __restrict__ pop) {
  __shared__ unsigned long long red[kScanWarps];
  __shared__ unsigned long long wtot[kScanPairs][kScanWarps];
  __shared__ unsigned long long tile_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int first = tile - tile % kScanTilesPerSuper;  // its superblock's
  const int64_t t0 = static_cast<int64_t>(tile) * kScanTile;
  // the superblock's base and pop, from the tile sums: the first tile of
  // each superblock and the last tile (every thread of the CTA takes part)
  if (tile == first) {
    unsigned long long v = 0;
    for (int i = tid; i < first; i += kScanThreads) v += sums[i];
    v = block_sum(v, red);
    if (tid == 0) supers[tile / kScanTilesPerSuper] = v;
  }
  if (tile == n_tiles - 1) {
    unsigned long long v = 0;
    for (int i = tid; i < n_tiles; i += kScanThreads) v += sums[i];
    v = block_sum(v, red);
    if (tid == 0) *pop = v;
  }
  // this tile's pairs, each pair's sum scanned across the warp
  longlong2 p[kScanPairs];
  unsigned long long inc[kScanPairs];
#pragma unroll
  for (int r = 0; r < kScanPairs; ++r) {
    p[r] = scan_pair(totals, t0, nblk, r);
    inc[r] = static_cast<unsigned long long>(p[r].x) +
             static_cast<unsigned long long>(p[r].y);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int r = 0; r < kScanPairs; ++r) {
      const unsigned long long x = __shfl_up_sync(kFull, inc[r], d);
      if (lane >= d) inc[r] += x;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int r = 0; r < kScanPairs; ++r) wtot[r][warp] = inc[r];
  }
  // the carry from the tiles before this one in its superblock
  if (warp == 0) {
    const unsigned long long v =
        first + lane < tile ? sums[first + lane] : 0ull;
    const unsigned long long c = warp_sum(v);
    if (lane == 0) tile_carry = c;
  }
  __syncthreads();
  unsigned long long base = tile_carry;
#pragma unroll
  for (int r = 0; r < kScanPairs; ++r) {
    unsigned long long before = base;     // rows before r, warps before
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) {
      const unsigned long long t = wtot[r][w];
      if (w < warp) before += t;
      base += t;
    }
    const unsigned long long x = before + inc[r] -
        static_cast<unsigned long long>(p[r].x) -
        static_cast<unsigned long long>(p[r].y);
    const int64_t i = t0 + 2 * (tid + r * kScanThreads);
    const longlong2 out = make_longlong2(
        static_cast<long long>(x),
        static_cast<long long>(x + static_cast<unsigned long long>(p[r].x)));
    if (i + 1 < nblk) {
      *reinterpret_cast<longlong2*>(totals + i) = out;
    } else if (i < nblk) {
      totals[i] = static_cast<unsigned long long>(out.x);
    }
  }
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

// totals: the rank_pack totals of nw words (16-byte aligned), made each
// block's carry in place; sums: ceil(blocks / 2,048) entries of scratch;
// supers: ceil(nw / 2^27) entries; pop: one.
int gr_rank_scan(unsigned long long* totals, int64_t nw,
                 unsigned long long* sums, unsigned long long* supers,
                 unsigned long long* pop, cudaStream_t stream) {
  if (nw <= 0) return cudaErrorInvalidValue;
  const int64_t nblk = gr::rank_blocks(nw);
  const int64_t n_tiles = (nblk + gr::kScanTile - 1) / gr::kScanTile;
  if (n_tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  gr::rank_tile_sums_kernel<<<static_cast<unsigned>(n_tiles),
                              gr::kScanThreads, 0, stream>>>(totals, nblk,
                                                             sums);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gr::rank_scan_kernel<<<static_cast<unsigned>(n_tiles), gr::kScanThreads, 0,
                         stream>>>(totals, nblk, sums,
                                   static_cast<int>(n_tiles), supers, pop);
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
