// ntcard_count (K22): ntCard's sampled counters of every seed of a batch of
// reads, in one launch.
//
// Replaces goldrush_tpu/utils/ntcard.py:_sample_and_count (:41) and the
// hashing and stale-tail clamp of estimate_genome_size that feed it
// (:82-116): for every read, every position p < len - k + 1 (seed 0's
// frames) and every seed s, the canonical spaced-seed hash h of seed s at
// position min(p, max(len - k - s, 0)) (the lockstep iterator repeats a
// seed's last frame; ops/nthash.py hash_positions' values, codes past the
// read reading as A) goes to bank 0 if h >> (63 - sbits) == 1, else to
// bank 1 if h >> (64 - sbits) == 2^(sbits-1) - 1, and then adds one to
// counters[s][bank * 2^rbits + (h & (2^rbits - 1))].  `counters` is h banks
// of 2 * 2^rbits uint32, one per seed.
//
// Design.  Seed s = left + s zeros + right factorises (ops/nthash.py):
// fwd_s(p) = rol64(FL(p), s) ^ FR(p + s), rev_s(p) = RL(p) ^ rol64(RR(p +
// s), s), with the left partials (FL, RL) over the codes p .. p + half and
// the right ones (FR, RR) over p + half + s ...  Each half's window is cut
// into blocks of 4 positions, and a block's 256-entry table
// (SeedFamily.block_table) holds, for every 4 codes, the XOR of the
// (fwd, rev) constants of the care offsets inside it: a partial is kNb
// lookups, indexed straight by a byte of the 2-bit-packed codes, with no
// care offset or code byte loaded.
//   - Persistent CTAs (SMs x resident CTAs) stage the tables once, each in
//     kRep copies interleaved by 16 bytes: lane l reads copy l % kRep, so
//     with 8 copies the 8 lanes of a quarter warp read 8 different banks
//     and a random 16-byte lookup costs one wavefront, not ~2.6.
//   - A warp takes one half of a work item (kNtUnit positions) at a time:
//     it packs the unit's codes into 32-bit words of its own slice of
//     shared memory (16 codes a word, no block barrier), and lane l hashes
//     the run of kNtRun = 16 positions from 16 l.  The lane slides a
//     64-bit window of 32 codes over its run with funnel shifts, one for
//     the left half and one, kMaxH - 1 positions ahead, for the right, and
//     keeps the right partials of the last kMaxH positions in a register
//     ring: each position builds one right partial, and seed s reads the
//     one of position p + s.
//   - The bank test needs only the hash's high word, which is the minimum
//     of the two strands' high words: seeds test that, and only a sampled
//     hash (~1.6% of them) builds its whole canonical value.
// The family's halves must each fit the 32-code window (half <= 32, the
// last right care offset < 32, so k <= 64), h <= 8 and sbits <= 31 (the
// bank test on the high word); the wrapper (utils/ntcard.py) raises
// ValueError for other families, which the plain version takes.  A seed's
// stale tail is not hashed again: its last own position carries the
// weight of the frames that repeat it (len - k + 1 - that position), added
// in one atomic, so the counters equal the JAX loop's one-by-one
// increments (uint32 sums wrap alike, and their order does not matter).
//
// Unsampled hashes are skipped: all but 2^-8 + 2^-7 ~ 1.2% of uniform
// hashes at sbits 7, 1.6% of the bench reads' (the canonical minimum
// leans low).  The JAX function sends them to a discard slot past the two
// banks, which the estimate never reads; one slot taking ~99% of a
// launch's atomics would serialise them on one address (ROADMAP queue 3).
//
// Bound.  The hash's integer work, counted two ways by chip_smoke.py:
// ntcard_ops, per position two XORs of 64-bit values per care offset and
// per hash the rotates, XORs, min and bank test on whole 64-bit values (the
// per-care-offset form); ntcard_block_ops, per position two XORs of 64-bit
// values per block lookup and per hash the high words' rotates, XORs, min
// and bank test (this kernel's form).  Bytes: the codes, offsets and work
// list once and one 32-byte sector per atomic, one per sampled own frame;
// the counters (96 MB at rbits 22, 3 GiB at rbits 27 for h = 3) are
// touched only there.  chip_smoke.py phase 8(a) prints both bounds and the
// kernel's time on a bench batch of 16.8 Mbp of 20 kb reads (PERF.md, the
// K22 row); tools/torch_port_ntcard_parts.py splits a launch by step.
#include "common.cuh"

namespace gr {

constexpr int kNtRun = 16;               // positions a lane: one packed word
constexpr int kNtUnit = 32 * kNtRun;     // positions a warp unit: half an item
constexpr int kNtUnitWords = 40;         // packed words a unit stages
constexpr int kNtEntries = 256;          // entries of a block table

// Threads a CTA: 1,024 where the ring of 4 partials fits the 64 registers
// a thread that allows, 512 for the ring of 8.
template <int kMaxH>
constexpr int nt_threads() {
  return kMaxH <= 4 ? 1024 : 512;
}

// A launch's arguments.  Work item i is read item_read[i]'s positions
// item_p0[i] .. + 2 * kNtUnit (ntcard.py CHUNK) of its len - k + 1; unit u
// is half u & 1 of item u >> 1.  `table`: the left half's kNb block tables,
// then the right half's, kNtEntries (fwd, rev) pairs each.
struct NtArgs {
  const uint8_t* codes;
  const int64_t* offsets;
  const int32_t* item_read;
  const int64_t* item_p0;
  const ulonglong2* table;
  int64_t n_codes, units;
  int h, k, half, rbits, sbits;
  uint32_t* counters;
};

// XOR into (fw, rv) the entries of a half's block tables kB .. kNb - 1 for
// the window (lo, hi) of 32 codes, 2 bits each from bit 0: block b is
// indexed by byte b.  `t`: the shared-memory address of the lane's copy
// of the half's first table; an entry is one 16-byte load at t + the
// block's offset (an immediate) + the byte times the entries' stride.
template <int kRep, int kNb, int kB = 0>
__device__ __forceinline__ void block_xor_from(uint32_t lo, uint32_t hi,
                                               uint32_t t, uint64_t& fw,
                                               uint64_t& rv) {
  if constexpr (kB < kNb) {
    const uint32_t idx = __byte_perm(kB < 4 ? lo : hi, 0, 0x4440 | (kB & 3));
    uint64_t x, y;
    asm("ld.shared.v2.u64 {%0, %1}, [%2+%3];"
        : "=l"(x), "=l"(y)
        : "r"(t + idx * (kRep * 16)), "n"(kB * kNtEntries * kRep * 16));
    fw ^= x;
    rv ^= y;
    block_xor_from<kRep, kNb, kB + 1>(lo, hi, t, fw, rv);
  }
}

// A half's partials (fwd, rev) for the window (lo, hi): the XOR of its kNb
// blocks' entries.
template <int kRep, int kNb>
__device__ __forceinline__ ulonglong2 block_xor(uint32_t lo, uint32_t hi,
                                                uint32_t t) {
  uint64_t fw = 0, rv = 0;
  block_xor_from<kRep, kNb>(lo, hi, t, fw, rv);
  return make_ulonglong2(fw, rv);
}

// The high word of rol64(x, s), s < 32 (a constant once the seeds' loop is
// unrolled).
__device__ __forceinline__ uint32_t rol_hi(uint64_t x, int s) {
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  return s == 0 ? hi : __funnelshift_l(static_cast<uint32_t>(x), hi, s);
}

// 4 code bytes (low two bits each) as 8 bits, byte t at bits 2t.
__device__ __forceinline__ uint32_t pack4(uint32_t v) {
  v &= 0x03030303u;
  v |= v >> 6;
  v |= v >> 12;
  return v & 0xFFu;
}

// The 16 codes at p, whole inside the batch's codes, as one packed word:
// five aligned 4-byte loads (the last one only where p is not aligned).
__device__ __forceinline__ uint32_t pack16(const uint8_t* p) {
  const uint32_t* b = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(p) & ~uintptr_t{3});
  const unsigned sh = 8 * (reinterpret_cast<uintptr_t>(p) & 3);
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = b[i];
  v[4] = sh ? b[4] : 0u;
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x |= pack4(__funnelshift_r(v[i], v[i + 1], sh)) << (8 * i);
  }
  return x;
}

// The 64-bit window (lo, hi) of the 32 codes from code o of `words`.
__device__ __forceinline__ uint2 window_at(const uint32_t* words, int o) {
  const uint32_t* w = words + (o >> 4);
  const unsigned sh = 2 * (o & 15);
  return make_uint2(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh));
}

template <int kRep, int kMaxH, int kNb>
__global__ void __launch_bounds__(nt_threads<kMaxH>()) ntcard_block_kernel(
    const NtArgs a) {
  constexpr int kTab = 2 * kNb * kNtEntries * kRep;  // entries, all copies
  ulonglong2* tab = reinterpret_cast<ulonglong2*>(gr_smem);
  for (int e = threadIdx.x; e < kTab; e += blockDim.x) {
    tab[e] = a.table[e / kRep];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint32_t* words = reinterpret_cast<uint32_t*>(tab + kTab) +
                    (threadIdx.x >> 5) * kNtUnitWords;
  const uint32_t tl = static_cast<uint32_t>(
      __cvta_generic_to_shared(tab + (lane & (kRep - 1))));
  const uint32_t tr = tl + kNb * kNtEntries * kRep * 16;
  const uint64_t rmask = (1ull << a.rbits) - 1;
  const int64_t bank_words = 2ll << a.rbits;
  // the bank test on the canonical hash's high word m (sbits <= 31)
  const unsigned sh0 = 31 - a.sbits, sh1 = 32 - a.sbits;
  const uint32_t smask = (1u << (a.sbits - 1)) - 1;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                   (threadIdx.x >> 5);
       u < a.units; u += warps) {
    const int64_t item = u >> 1;
    const int r = a.item_read[item];
    const int64_t start = a.offsets[r];
    const int64_t len = a.offsets[r + 1] - start;
    const int64_t n_frames = len - a.k + 1;  // seed 0's frames
    const int64_t q0 = a.item_p0[item] + (u & 1) * kNtUnit;
    if (q0 >= n_frames) continue;  // the empty half of a short item
    const uint8_t* row = a.codes + start;
    // word w: codes q0 + 16 w .. + 16 (zero at or past len), code t at
    // bits 2t
    __syncwarp();
    for (int w = lane; w < kNtUnitWords; w += 32) {
      const int64_t qb = q0 + kNtRun * w;
      uint32_t x = 0;
      if (qb + kNtRun <= len && start + qb + 20 <= a.n_codes) {
        x = pack16(row + qb);
      } else {
        for (int t = 0; t < kNtRun && qb + t < len; ++t) {
          x |= (row[qb + t] & 3u) << (2 * t);
        }
      }
      words[w] = x;
    }
    __syncwarp();
    // the unit's codes are staged: hash the lane's run
    const int64_t qa = q0 + kNtRun * lane;  // the lane's first position
    if (qa >= n_frames) continue;
    // left window: codes qa .. + 48; right window: codes qa + half .. + 64
    uint32_t l0 = words[lane], l1 = words[lane + 1], l2 = words[lane + 2];
    const int wr = lane + (a.half >> 4);
    const unsigned rs = 2 * (a.half & 15);
    uint32_t r0 = __funnelshift_r(words[wr], words[wr + 1], rs);
    uint32_t r1 = __funnelshift_r(words[wr + 1], words[wr + 2], rs);
    uint32_t r2 = __funnelshift_r(words[wr + 2], words[wr + 3], rs);
    uint32_t r3 = __funnelshift_r(words[wr + 3], words[wr + 4], rs);
    // ring[(j + s) % kMaxH]: the right partials of run positions j + s
    ulonglong2 ring[kMaxH];
#pragma unroll
    for (int t = 0; t + 1 < kMaxH; ++t) {
      ring[t] = block_xor<kRep, kNb>(r0, r1, tr);
      r0 = __funnelshift_r(r0, r1, 2);
      r1 = __funnelshift_r(r1, r2, 2);
      r2 = __funnelshift_r(r2, r3, 2);
      r3 >>= 2;
    }
    // bit j of pend[s]: seed s's hash at run position j is sampled
    uint32_t pend[kMaxH] = {};
    uint32_t bit = 1;  // 1 << j
    const int lim = static_cast<int>(min64(n_frames - qa, kNtRun));
    for (int j0 = 0; j0 < lim; j0 += kMaxH) {
#pragma unroll
      for (int jj = 0; jj < kMaxH; ++jj) {
        ring[(jj + kMaxH - 1) % kMaxH] = block_xor<kRep, kNb>(r0, r1, tr);
        r0 = __funnelshift_r(r0, r1, 2);
        r1 = __funnelshift_r(r1, r2, 2);
        r2 = __funnelshift_r(r2, r3, 2);
        r3 >>= 2;
        const ulonglong2 left = block_xor<kRep, kNb>(l0, l1, tl);
        l0 = __funnelshift_r(l0, l1, 2);
        l1 = __funnelshift_r(l1, l2, 2);
        l2 >>= 2;
#pragma unroll
        for (int s = 0; s < kMaxH; ++s) {
          if (s >= a.h) continue;
          const ulonglong2 rp = ring[(jj + s) % kMaxH];
          const uint32_t m =
              min(rol_hi(left.x, s) ^ static_cast<uint32_t>(rp.x >> 32),
                  static_cast<uint32_t>(left.y >> 32) ^ rol_hi(rp.y, s));
          if (m >> sh0 == 1 || m >> sh1 == smask) pend[s] |= bit;
        }
        bit <<= 1;
      }
    }
    // seed s's own frames: q < max(n_frames - s, 1); the last carries the
    // frames that repeat it
#pragma unroll
    for (int s = 0; s < kMaxH; ++s) {
      const int64_t own = min64(max64(max64(n_frames - s, 1) - qa, 0), 16);
      pend[s] &= (1u << own) - 1;
    }
    // the sampled hashes, again from the unit's words, one pending bit of
    // each lane at a time
#pragma unroll
    for (int s = 0; s < kMaxH; ++s) {
      while (pend[s]) {
        const int j = __ffs(pend[s]) - 1;
        pend[s] &= pend[s] - 1;
        const uint2 lw = window_at(words, kNtRun * lane + j);
        const uint2 rw = window_at(words, kNtRun * lane + a.half + j + s);
        const ulonglong2 left = block_xor<kRep, kNb>(lw.x, lw.y, tl);
        const ulonglong2 rp = block_xor<kRep, kNb>(rw.x, rw.y, tr);
        const uint64_t fwd = rol64(left.x, s) ^ rp.x;
        const uint64_t rev = left.y ^ rol64(rp.y, s);
        const uint64_t hv = fwd < rev ? fwd : rev;
        const int64_t bank = hv >> (63 - a.sbits) == 1 ? 0 : 1;
        const int64_t own = max64(n_frames - s, 1);
        const uint32_t w =
            qa + j == own - 1 ? static_cast<uint32_t>(n_frames - own + 1)
                              : 1u;
        atomicAdd(a.counters + s * bank_words + (bank << a.rbits) +
                      (hv & rmask), w);
      }
    }
  }
}

// Shared-memory bytes of a CTA: the tables' copies and each warp's words.
constexpr size_t ntcard_smem_bytes(int nb, int rep, int threads) {
  return sizeof(ulonglong2) * 2 * nb * kNtEntries * rep +
         sizeof(uint32_t) * (threads / 32) * kNtUnitWords;
}

// One persistent CTA per resident slot of the card, at most one warp a
// unit.
template <int kRep, int kMaxH, int kNb>
cudaError_t ntcard_launch(const NtArgs& a, cudaStream_t stream) {
  constexpr int kThreads = nt_threads<kMaxH>();
  const size_t smem = ntcard_smem_bytes(kNb, kRep, kThreads);
  cudaError_t err = allow_smem(ntcard_block_kernel<kRep, kMaxH, kNb>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ntcard_block_kernel<kRep, kMaxH, kNb>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  constexpr int kWarps = kThreads / 32;
  const int64_t need = (a.units + kWarps - 1) / kWarps;
  const int64_t slots = static_cast<int64_t>(per_sm) * sms;
  const int64_t grid = need < slots ? need : slots;
  ntcard_block_kernel<kRep, kMaxH, kNb>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// kMaxH: the ring's positions, the least of 4 and 8 that holds h.
template <int kRep, int kNb>
cudaError_t ntcard_launch_h(const NtArgs& a, cudaStream_t stream) {
  return a.h <= 4 ? ntcard_launch<kRep, 4, kNb>(a, stream)
                  : ntcard_launch<kRep, 8, kNb>(a, stream);
}

}  // namespace gr

extern "C" {

// codes: uint8 [n_codes] (A=0 C=1 G=2 T=3; the low two bits are read);
// offsets: int64 [B + 1]; item_read int32 / item_p0 int64 [items];
// block_table: uint64 [2 * nb * 256 * 2] (SeedFamily.block_table(nb), nb
// in {3, 4, 8}: the copies of 3 blocks a half fit 8 to an SM's shared
// memory, of 4 blocks 4, of 8 blocks 2); counters: uint32 [h, 2 * 2^rbits].
int gr_ntcard_count(const uint8_t* codes, int64_t n_codes,
                    const int64_t* offsets, const int32_t* item_read,
                    const int64_t* item_p0, int64_t items,
                    const uint64_t* block_table, int nb, int h,
                    int k, int half, int rbits, int sbits, uint32_t* counters,
                    cudaStream_t stream) {
  if (items < 0 || items > 0x7FFFFFFF || h < 1 || h > 8 || k < 1 ||
      half < 0 || half > 32 || rbits < 1 || rbits > 40 || sbits < 1 ||
      sbits > 31)
    return cudaErrorInvalidValue;
  if (items == 0) return gr::kNoLaunch;
  const gr::NtArgs a{codes, offsets, item_read, item_p0,
                     reinterpret_cast<const ulonglong2*>(block_table),
                     n_codes, 2 * items, h, k, half, rbits, sbits, counters};
  if (nb == 3) return gr::ntcard_launch_h<8, 3>(a, stream);
  if (nb == 4) return gr::ntcard_launch_h<4, 4>(a, stream);
  if (nb == 8) return gr::ntcard_launch_h<2, 8>(a, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
