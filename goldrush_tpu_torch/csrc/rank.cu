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
// rank_build computes the whole structure in one pass over the presence
// bitmap pass 1 filled (bit slot & 31 of word slot >> 5): the counterpart
// of the Pallas probes pallas_cumsum_blocks and pallas_sweep
// (tools/probe_pallas.py:80, :126) and of the JAX function they serve,
// one global cumsum of the words' popcounts less each superblock's base
// (_rank_from_bits, compressed.py:153-169, on the bits of
// _freeze_from_bits, :194; the byte transient of fill_bytes/freeze_device,
// :65/:104, is the fill's bitmap here).  The sweep carries its sum in SMEM
// scratch across a sequential TPU grid; on this card the carry is a
// single-pass scan with decoupled look-back (Merrill & Garland):
//
//   tiles       a CTA of 128 threads takes a tile of 8,192 words (a
//               superblock is 16,384 tiles, so no tile straddles two), its
//               id from an atomic ticket: every tile before it has started,
//               so the look-back cannot wait on a tile that never runs.
//               Thread t copies row r's words 4 (128 r + t) .. + 3 of the
//               tile to shared memory with one 16-byte cp.async (a warp's
//               copies are 512 contiguous bytes), 16 rows: 256 bytes in
//               flight a thread and 32 KB a CTA, none of them held in
//               registers; each word is masked past `size` and
//               popcounted, each row's sums scanned across the warp by
//               shuffles, the warps' row totals combined after one
//               barrier;
//   look-back   the tile publishes its aggregate in its 64-bit status word
//               (flag in bits 62-63, value below), then warp 0 reads its
//               predecessors 32 at a time, nearest first, until an
//               inclusive value or the first tile of its superblock, which
//               starts at 0 (super_base restarts there), and publishes its
//               own inclusive value: the present slots of its superblock
//               through its last word (at most 2^32, a fully set
//               superblock);
//   output      every word is written once, final, (rank within its
//               superblock) << 32 | bits (at most 2^32 - 32 above), with
//               16-byte stores; the last tile writes the appended word;
//   supers/pop  the last tile of each superblock writes its count to
//               supers[s]; the superblock that finishes last (a counter
//               after a fence) turns the counts into their exclusive sum
//               and writes pop.
//
// Bound.  The bitmap read once and bitrank written once: 12 bytes a word
// (4.45e6 words at the 5 Mbp sizing, 1.78e9 at 56,947,329,536 slots), plus
// 8 bytes of status a tile: bandwidth-bound.  What keeps a CTA from the
// memory is its ticket, its look-back and its barriers, so the bytes in
// flight come from six CTAs an SM (shared memory), each with its whole
// tile's copies in flight at once, none in registers; a tile held in
// registers left the memory about half idle, and this shape comes within
// ~15% of a kernel that only widens the words to 8 bytes
// (tools/torch_port_rank_variants.py times both).

// The lookup of P1 (pallas_gather, :59), slot -> rank through bitrank and
// supers, is fused into kernel A's rank grid (seed_hash.cu).
#include "common.cuh"

namespace gr {

constexpr int kBuildThreads = 128;
constexpr int kBuildWarps = kBuildThreads / 32;
constexpr int kBuildRows = 16;                    // 16-byte copies a thread
constexpr int64_t kTileWords = 4 * kBuildRows * kBuildThreads;   // 8,192
constexpr int64_t kSuperTiles = (int64_t{1} << 27) / kTileWords;
// a tile's status word: 0 until published, then its aggregate or its
// inclusive value (within its superblock) under the flag
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1ull;
// a look-back that polls this often means a fault: the launch fails
// instead of hanging the card
constexpr long long kMaxPolls = 1ll << 26;

__device__ __forceinline__ unsigned long long load_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_volatile(unsigned long long* p,
                                               unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// 16 bytes from global to shared memory, asynchronously (cp.async: no
// register holds them in flight); past `bytes` the copy is zero-filled
__device__ __forceinline__ void copy16_async(uint4* dst, const uint32_t* src,
                                             int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// word w's bits with the slots at or past size cleared
__device__ __forceinline__ uint32_t real_bits(uint32_t bits, int64_t w,
                                              int64_t size) {
  const int64_t tail = size - w * 32;
  if (tail >= 32) return bits;
  return tail > 0 ? bits & ((1u << tail) - 1u) : 0u;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The tile's exclusive prefix within its superblock, by warp 0: its
// aggregate `agg` published, then the predecessors' status words read 32
// at a time until an inclusive one; its inclusive value published.  Lane
// 0's return is the prefix.
__device__ unsigned long long look_back(unsigned long long* status,
                                        int64_t tile, uint32_t agg) {
  const int lane = threadIdx.x & 31;
  const int64_t first = tile - tile % kSuperTiles;
  if (tile == first) {
    if (lane == 0) store_volatile(status + tile, kInclusive | agg);
    return 0ull;
  }
  if (lane == 0) store_volatile(status + tile, kAggregate | agg);
  unsigned long long excl = 0ull;
  for (int64_t j = tile - 1;; j -= 32) {
    const int64_t p = j - lane;
    // before the superblock's first tile: an inclusive 0
    unsigned long long s = kInclusive;
    if (p >= first) {
      long long polls = 0;
      while ((s = load_volatile(status + p)) == 0ull)
        if (++polls > kMaxPolls) __trap();
    }
    const unsigned incl = __ballot_sync(kFull, (s & kInclusive) != 0ull);
    // the nearest inclusive predecessor ends the sum
    const int stop = incl ? __ffs(incl) - 1 : 31;
    excl += warp_sum(lane <= stop ? s & kValue : 0ull);
    if (incl) break;
  }
  if (lane == 0) store_volatile(status + tile, kInclusive | (excl + agg));
  return excl;
}

// grid n_tiles, one tile a CTA; scratch: [0] the tile ticket, [1] the
// superblocks finished, [2 ..] a status word per tile, zeroed.  Thread t's
// row r is the tile's words 4 (r * kBuildThreads + t) .. + 3, copied to
// shared memory and read back by t alone.
__global__ void __launch_bounds__(kBuildThreads) rank_build_kernel(
    const uint32_t* __restrict__ bitmap, int64_t size, int64_t nw,
    int64_t n_tiles, int n_super, unsigned long long* __restrict__ bitrank,
    unsigned long long* __restrict__ supers,
    unsigned long long* __restrict__ pop,
    unsigned long long* __restrict__ scratch) {
  __shared__ uint4 stage[kBuildRows][kBuildThreads];
  __shared__ int64_t tile_s;
  __shared__ uint32_t wtot[kBuildRows][kBuildWarps];
  __shared__ unsigned long long excl_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0)
    tile_s = static_cast<int64_t>(atomicAdd(scratch, 1ull));
  __syncthreads();
  const int64_t tile = tile_s;
  const int64_t w0 = tile * kTileWords + 4 * tid;
#pragma unroll
  for (int r = 0; r < kBuildRows; ++r) {
    const int64_t w = w0 + 4 * r * kBuildThreads;
    const int64_t n = nw - w < 4 ? (nw - w > 0 ? nw - w : 0) : 4;
    copy16_async(&stage[r][tid], n ? bitmap + w : bitmap,
                 static_cast<int>(4 * n));
  }
  copies_wait();
  // each row's words masked past size (kept for the output) and
  // popcounted; the rows' sums scanned across the warp
  uint32_t row[kBuildRows], inc[kBuildRows];
#pragma unroll
  for (int r = 0; r < kBuildRows; ++r) {
    const int64_t w = w0 + 4 * r * kBuildThreads;
    uint4 v = stage[r][tid];
    v.x = real_bits(v.x, w, size);
    v.y = real_bits(v.y, w + 1, size);
    v.z = real_bits(v.z, w + 2, size);
    v.w = real_bits(v.w, w + 3, size);
    stage[r][tid] = v;
    row[r] = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    inc[r] = row[r];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int r = 0; r < kBuildRows; ++r) {
      const uint32_t x = __shfl_up_sync(kFull, inc[r], d);
      if (lane >= d) inc[r] += x;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int r = 0; r < kBuildRows; ++r) wtot[r][warp] = inc[r];
  }
  __syncthreads();
  // this thread's rows' offsets in the tile, and the tile's aggregate
  uint32_t agg = 0u;
#pragma unroll
  for (int r = 0; r < kBuildRows; ++r) {
    uint32_t before = agg;
#pragma unroll
    for (int v = 0; v < kBuildWarps; ++v) {
      const uint32_t t = wtot[r][v];
      if (v < warp) before += t;
      agg += t;
    }
    inc[r] = before + inc[r] - row[r];
  }
  unsigned long long* status = scratch + 2;
  if (warp == 0) {
    const unsigned long long excl = look_back(status, tile, agg);
    if (lane == 0) excl_s = excl;
  }
  __syncthreads();
  const unsigned long long excl = excl_s;
#pragma unroll
  for (int r = 0; r < kBuildRows; ++r) {
    const int64_t w = w0 + 4 * r * kBuildThreads;
    const uint4 v = stage[r][tid];
    const uint32_t b[4] = {v.x, v.y, v.z, v.w};
    unsigned long long out[4];
    unsigned long long rank = excl + inc[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j] = rank << 32 | b[j];
      rank += __popc(b[j]);
    }
    if (w + 3 < nw) {
      reinterpret_cast<ulonglong2*>(bitrank + w)[0] =
          make_ulonglong2(out[0], out[1]);
      reinterpret_cast<ulonglong2*>(bitrank + w)[1] =
          make_ulonglong2(out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w + j < nw) bitrank[w + j] = out[j];
    }
  }
  if (tid != 0) return;
  if (tile == n_tiles - 1) bitrank[nw] = 0ull;
  const int64_t s = tile / kSuperTiles;
  const int64_t last = s * kSuperTiles + kSuperTiles - 1;
  if (tile != (last < n_tiles ? last : n_tiles - 1)) return;
  // the superblock's count; the superblock that finishes last turns the
  // counts into their exclusive sum
  supers[s] = excl + agg;
  __threadfence();
  const unsigned long long done = atomicAdd(scratch + 1, 1ull);
  if (done != static_cast<unsigned long long>(n_super) - 1ull) return;
  __threadfence();
  unsigned long long run = 0ull;
  for (int i = 0; i < n_super; ++i) {
    const unsigned long long c = load_volatile(supers + i);
    supers[i] = run;
    run += c;
  }
  *pop = run;
}

}  // namespace gr

extern "C" {

// bitmap: ceil(size / 32) = nw words, 16-byte aligned; bitrank: nw + 1
// words, 16-byte aligned; supers: ceil(nw / 2^27) entries; pop: one;
// scratch: ceil(nw / 8,192) + 2 words, zeroed.
int gr_rank_build(const uint32_t* bitmap, int64_t size, int64_t nw,
                  unsigned long long* bitrank, unsigned long long* supers,
                  unsigned long long* pop, unsigned long long* scratch,
                  cudaStream_t stream) {
  if (nw <= 0 || size > nw * 32 || size <= (nw - 1) * 32 ||
      reinterpret_cast<uintptr_t>(bitmap) % 16 ||
      reinterpret_cast<uintptr_t>(bitrank) % 16)
    return cudaErrorInvalidValue;
  const int64_t n_tiles = (nw + gr::kTileWords - 1) / gr::kTileWords;
  const int64_t n_super = (n_tiles + gr::kSuperTiles - 1) / gr::kSuperTiles;
  if (n_tiles > 0x7FFFFFFF || n_super > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  gr::rank_build_kernel<<<static_cast<unsigned>(n_tiles), gr::kBuildThreads,
                          0, stream>>>(bitmap, size, nw, n_tiles,
                                       static_cast<int>(n_super), bitrank,
                                       supers, pop, scratch);
  return cudaGetLastError();
}

}  // extern "C"
