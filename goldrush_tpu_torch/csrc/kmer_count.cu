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
// Bound: the codes in (B * L bytes), the query's output (4 B per
// position), and one read (query) or one read-modify-write (count) of a
// 32-byte sector per distinct slot, over the device memory rate; or the
// integer operations per position (both strands' hash, the canonical min,
// the slot's multiply: ~50, chip_smoke.py's count) over the card's 32-bit
// integer rate, whichever is longer.  The table (8 slots per read base,
// ~10-30 MB in the pipeline) stays in L2, so the gathers and atomics are
// L2 sector traffic; what the design attacks is the work per position.
//
// Design.  Every k-mer's hash comes from one prefix-XOR scan of the CTA's
// codes (nthash_scan.cuh, shared with minimizers.cu): no serial roll, no
// hash rebuilt from nothing.
//  1. A CTA of 128 threads takes W consecutive outputs o = b * P + p (W <=
//     1,024, fewer when short rows would not fit; `kmer_tile`).  A k-mer
//     never crosses its row, so the codes they read form one range of the
//     dense [B, L] layout, at most kKmerCap = 1,024 codes from a 16-byte-
//     aligned start t0.  Short rows (the polisher's candidate windows, P =
//     k + 3) pack side by side; a long row (a 1 Mbp contig) splits over
//     many CTAs.  Each thread loads its run of 8 codes with one 8-byte load.
//  2. The scan (`nt_prefix_scan`, runs of 8): the rotated constants as
//     immediates, a byte permutation, a warp scan and the warps' carries
//     put S and R in shared memory, 16 B per code.  (A table of the 256
//     rotated constants in shared memory cost more: a 16-byte read per
//     code.)
//  3. One lane per output, up to 8 a thread, 4 at a time, at a stride of
//     the CTA's width: the row from a multiply-high by a reciprocal of P,
//     two reads of (S, R), two rotations and a min.  The query's gathers
//     are independent, so a warp keeps its gathers in flight, and its
//     4-byte stores are coalesced.  The count's lanes hold consecutive
//     positions; where two neighbouring lanes share a slot, the lanes that
//     hit one slot make one atomic (__match_any_sync), and a leader keeps
//     its (slot, count) across its outputs while the slot repeats, so a
//     homopolymer batch makes one atomic per warp per 4-8 outputs a lane.
#include "nthash_scan.cuh"

namespace gr {

constexpr int kKmerThreads = 128;
constexpr int kKmerWarps = kKmerThreads / 32;
constexpr int kKmerPer = 8;                          // most outputs a thread
constexpr int kKmerChunk = 4;                        // taken at a time
constexpr int kKmerTile = kKmerThreads * kKmerPer;   // most outputs a CTA
constexpr int kKmerRun = 8;                          // codes a thread scans
constexpr int kKmerCap = kKmerThreads * kKmerRun;    // codes a CTA scans

struct KmerArgs {
  const uint8_t* codes;
  int64_t BL, L, P, total, W;
  uint64_t recip;          // floor((2^64 - 1) / P) + 1, or 0: divide
  double inv_p;            // 1 / P
  int k;
  uint32_t size;
  const int64_t* lengths;  // count
  unsigned* counts;        // count: updated; query: read
  unsigned* out;           // query
};

// floor(x * m / 2^64) for m < 2^32: the slot map, and the row of a
// position (x the reciprocal, m the position within 2^32)
__device__ __forceinline__ uint64_t mulhi_u32(uint64_t x, uint32_t m) {
  return ((x >> 32) * m + __umulhi(static_cast<unsigned>(x), m)) >> 32;
}

template <bool kCount>
__global__ void __launch_bounds__(kKmerThreads) kmer_kernel(KmerArgs a) {
  __shared__ ulonglong2 sr[kKmerCap + 1];
  __shared__ ulonglong2 wsum[kKmerWarps];
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t o0 = static_cast<int64_t>(blockIdx.x) * a.W;
  const int n_out = static_cast<int>(min64(a.W, a.total - o0));
  // the tile's first row and position: a double reciprocal of P, then one
  // correction (exact while o0 < 2^52)
  int64_t b0 = static_cast<int64_t>(static_cast<double>(o0) * a.inv_p);
  int64_t p0 = o0 - b0 * a.P;
  if (p0 < 0) {
    --b0;
    p0 += a.P;
  } else if (p0 >= a.P) {
    ++b0;
    p0 -= a.P;
  }
  const int64_t first = b0 * a.L + p0;
  const int64_t t0 = first - static_cast<int64_t>(
      (reinterpret_cast<uintptr_t>(a.codes) + first) & 15u);

  // the scan: this thread's run of codes (8 bytes from t0's 16-byte-
  // aligned address, zero outside the batch), then S and R of the tile.
  // Codes past the tile's last k-mer only make entries of S and R that no
  // output reads.
  unsigned cw[kKmerRun / 4];
  {
    const int64_t g = t0 + kKmerRun * tid;
    if (g >= 0 && g + kKmerRun <= a.BL) {
      const uint2 v = *reinterpret_cast<const uint2*>(a.codes + g);
      cw[0] = v.x;
      cw[1] = v.y;
    } else {
      unsigned char b[kKmerRun];
#pragma unroll
      for (int q = 0; q < kKmerRun; ++q)
        b[q] = g + q >= 0 && g + q < a.BL ? a.codes[g + q] : 0;
      cw[0] = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
      cw[1] = b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24;
    }
  }
  nt_prefix_scan<kKmerRun, kKmerThreads>(cw, sr, wsum);

  // one lane per output, a chunk of kKmerChunk a thread at a time: its
  // row, then the identity's hash and slot
  const int base = static_cast<int>(first - t0);
  unsigned held = 0, n_held = 0;     // count: a leader's slot and its adds
#pragma unroll
  for (int q0 = 0; q0 < kKmerPer; q0 += kKmerChunk) {
    if (q0 * kKmerThreads >= n_out) break;
    unsigned slot[kKmerChunk];
    bool valid[kKmerChunk];
#pragma unroll
    for (int q = 0; q < kKmerChunk; ++q) {
      const int i = tid + (q0 + q) * kKmerThreads;
      valid[q] = i < n_out;
      slot[q] = 0xFFFFFFFFu;
      if (!valid[q]) continue;
      const int64_t u = p0 + i;
      const int64_t row = a.recip
          ? static_cast<int64_t>(mulhi_u32(a.recip, static_cast<uint32_t>(u)))
          : u / a.P;
      const int j = base + i + static_cast<int>(row) * (a.k - 1);
      slot[q] = static_cast<unsigned>(mulhi_u32(
          nt_scan_hash(sr[nt_swz<kKmerRun>(j)], sr[nt_swz<kKmerRun>(j + a.k)],
                       j, a.k),
          a.size));
      if constexpr (kCount)
        valid[q] = u - row * a.P < a.lengths[b0 + row] - a.k + 1;
    }
    if constexpr (kCount) {
      // every lane runs every step, so each collective has the whole warp;
      // a valid slot is below size < 2^32 - 1.  The match runs where two
      // neighbouring lanes share a slot (a homopolymer, a repeat), not on
      // every step, where it costs more than it saves on random reads
      // (tools/torch_port_kmer_parts.py, variant match_always).
#pragma unroll
      for (int q = 0; q < kKmerChunk; ++q) {
        const unsigned key = valid[q] ? slot[q] : 0xFFFFFFFFu;
        const unsigned left = __shfl_up_sync(kFull, key, 1);
        const bool repeat =
            __any_sync(kFull, valid[q] && lane > 0 && key == left);
        unsigned peers = 1u << lane;
        if (repeat) peers = __match_any_sync(kFull, key);
        if (valid[q] && lane == __ffs(peers) - 1) {
          if (n_held && held == key) {
            n_held += __popc(peers);
          } else {
            if (n_held) atomicAdd(a.counts + held, n_held);
            held = key;
            n_held = __popc(peers);
          }
        }
      }
    } else {
      unsigned got[kKmerChunk];
#pragma unroll
      for (int q = 0; q < kKmerChunk; ++q)
        if (valid[q]) got[q] = __ldg(a.counts + slot[q]);
#pragma unroll
      for (int q = 0; q < kKmerChunk; ++q)
        if (valid[q]) a.out[o0 + tid + (q0 + q) * kKmerThreads] = got[q];
    }
  }
  if constexpr (kCount) {
    if (n_held) atomicAdd(a.counts + held, n_held);
  }
}

// The most outputs a CTA takes so that the codes they read, from a
// 16-byte-aligned start, fit kKmerCap: W + 15 + rows * (k - 1) codes for
// at most ceil((W - 1) / P) + 1 rows, which grows with W.  0 if not even
// one fits.
inline int64_t kmer_tile(int64_t P, int k) {
  int64_t lo = 0, hi = kKmerTile;
  while (lo < hi) {
    const int64_t W = (lo + hi + 1) / 2;
    if (W + 15 + ((W + P - 2) / P + 1) * (k - 1) <= kKmerCap) {
      lo = W;
    } else {
      hi = W - 1;
    }
  }
  return lo;
}

// Fills the launch geometry of a batch; false if its k does not fit a
// tile (k > kKmerCap - 15) or its grid is too large.
inline bool kmer_args(KmerArgs& a, const uint8_t* codes, int B, int64_t L,
                      int k, uint64_t size, unsigned* grid) {
  a.codes = codes;
  a.L = L;
  a.P = L - k + 1;
  a.BL = static_cast<int64_t>(B) * L;
  a.total = static_cast<int64_t>(B) * a.P;
  a.W = kmer_tile(a.P, k);
  a.recip = a.P >= 2 && a.P < (1ll << 31)
      ? ~0ull / static_cast<uint64_t>(a.P) + 1 : 0;
  a.inv_p = 1.0 / static_cast<double>(a.P);
  a.k = k;
  a.size = static_cast<uint32_t>(size);
  if (a.W == 0) return false;
  const int64_t blocks = (a.total + a.W - 1) / a.W;
  if (blocks > 0x7FFFFFFF || a.total >= (1ll << 52)) return false;
  *grid = static_cast<unsigned>(blocks);
  return true;
}

}  // namespace gr

extern "C" {

// codes: uint8 [B, L]; lengths: int64 [B]; counts: int32 [size + 1]
// (uint32 bits), updated in place.  Needs 1 <= k <= 1,009 (a k-mer's codes
// fit a tile), 0 < size < 2^32.
int gr_kmer_count(const uint8_t* codes, int B, int64_t L,
                  const int64_t* lengths, int k, uint64_t size, int* counts,
                  cudaStream_t stream) {
  if (B < 0 || L < 0 || k < 1 || size == 0 || size >= (1ull << 32))
    return cudaErrorInvalidValue;
  if (B == 0 || L - k + 1 <= 0) return gr::kNoLaunch;
  gr::KmerArgs a{};
  unsigned grid = 0;
  if (!gr::kmer_args(a, codes, B, L, k, size, &grid))
    return cudaErrorInvalidValue;
  a.lengths = lengths;
  a.counts = reinterpret_cast<unsigned*>(counts);
  gr::kmer_kernel<true><<<grid, gr::kKmerThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// out: int32 [B, L - k + 1] (uint32 bits) = counts[slot of each k-mer].
int gr_kmer_query(const uint8_t* codes, int B, int64_t L, int k,
                  uint64_t size, const int* counts, int* out,
                  cudaStream_t stream) {
  if (B < 0 || L < 0 || k < 1 || size == 0 || size >= (1ull << 32))
    return cudaErrorInvalidValue;
  if (B == 0 || L - k + 1 <= 0) return gr::kNoLaunch;
  gr::KmerArgs a{};
  unsigned grid = 0;
  if (!gr::kmer_args(a, codes, B, L, k, size, &grid))
    return cudaErrorInvalidValue;
  a.counts = const_cast<unsigned*>(reinterpret_cast<const unsigned*>(counts));
  a.out = reinterpret_cast<unsigned*>(out);
  gr::kmer_kernel<false><<<grid, gr::kKmerThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
