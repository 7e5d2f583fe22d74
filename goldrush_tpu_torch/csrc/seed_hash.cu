// Kernel A: canonical spaced-seed ntHash -> slot, with three entries, and
// the merge that closes a presence fill of the direct filter.
//
//   seed_hash_grid       replaces hash_positions (goldrush_tpu/ops/nthash.py:
//                        131) + slot_of (mibf/mibf.py:115) + tile_slot_grid
//                        (mibf/mibf.py:158): the probe grid of a batch; at a
//                        frame stride S > 1 also hash_sampled (nthash.py:
//                        324, with hash_at :310) + tile_slot_grid_sampled
//                        and _lt (mibf/mibf.py:214-341), the sampled grid;
//   seed_hash_rank_grid  the same grid mapped through the compressed
//                        filter's frozen rank structure as it is stored:
//                        + _rank_lookup / rank_grid (goldrush_tpu/mibf/
//                        compressed.py:218, :506), the resident-table gather
//                        of tools/probe_pallas.py:59 (pallas_call :61);
//   (both grid entries)  with a query grid beside the grid: the first hq
//                        seeds at every q_step-th frame, the throughput
//                        mode's query tier written by its insert grid's
//                        launch (the sampled grid equals the dense one
//                        subsampled: mibf.py query_in_insert_grid);
//   seed_hash_fill       replaces hash_positions + slot_of + fill_presence
//                        (mibf/mibf.py:122): one batch of pass 1, into a
//                        presence bitmap;
//   presence_merge       the bitmap into the direct filter's words
//                        (PRESENT), once per fill pass; the compressed
//                        filter freezes from the bitmap itself (rank.cu).
//
// Hashing (seed_hash.cuh, shared with ntCard's counter kernel, ntcard.cu).
// Every entry stages the codes window a CTA needs in shared
// memory (zero at or past the batch width L, as hash_positions pads), with
// the seed family's per-base constants, rotations already applied, and its
// care offsets (SeedFamily.kernel_table, read from global memory once per
// CTA).  Seed s = left + s zeros + right factorises (ops/nthash.py):
//
//   fwd_s(p) = rol64(FL(p), s) ^ FR(p + half + s)
//   rev_s(p) = RL(p) ^ rol64(RR(p + half + s), s)
//
// so the left-half partials (FL, RL) of a position are XORed once in
// registers, the right-half ones (FR, RR) once per position into shared
// memory, and seed s then costs two loads, one rotate per strand and an
// unsigned min.  The per-base constants are a shared-memory lookup by the
// code (a 16-byte (fwd, rev) pair); nothing indexes constant memory by a
// base.  This is the algebra of the JAX kernel (nthash.py:229-246) in
// 64-bit registers, with the position rotations moved into the table.
//
// Bounds on the H100 (3.35 TB/s; hashing is ~100 integer operations per
// position, under the bytes' time at every shape of the path):
//  - grid: one CTA per (read, tile) writes TL/S frames x h int64 slots plus
//    frame_ok; at B=32, T=20, TL=1000, h=3, S=1 that is 15.4 MB of stores
//    for 1.28 MB of codes: store-bound, each warp storing 256 contiguous
//    bytes per seed.  At a stride S >= h (ranks: of one seed) a thread
//    takes a frame (seed_hash_sampled_kernel): at B=64, T=20, h=1, S=8
//    (the throughput mode's query grid) 1.3 MB of codes in and 1.4 MB
//    out, latency-bound.  At other strides the CTA still stages its
//    tile's whole codes window, but computes right-half partials only
//    where its frames and the stale-tail clamp read them, and hashes only
//    the frames it emits.  Written by the insert grid's
//    launch (B=64, h=3, S=1, 30.7 MB of stores) that query grid adds 1.44
//    MB of stores and no hashing: its slots (ranks) are the insert grid's
//    first hq seeds at every q_step-th frame, computed once;
//  - rank grid: the grid's stores, ranks in place of slots, plus one 8-byte
//    bitrank[slot >> 5] gather per valid entry from a 35.6 MB table (at the
//    bench sizing) that fits the 50 MB L2.  A thread computes its frame's h
//    slots and issues their h gathers before it uses any of them, so h
//    gathers are in flight per thread, not one; the slots never reach
//    device memory, which saves the separate lookup's 30.7 MB round trip
//    (slots written, read back) and its launch.  Registers decide how many
//    of the 640 CTAs of a B=32, T=20 grid run at once (four per SM at 62
//    registers a thread: two waves), so the gathers are issued in groups
//    of kGather seeds.  A filter of 2^32 slots or more also reads its
//    slot's superblock base, supers[slot >> 32], from a table of a few
//    entries (14 at 56,947,329,536 slots) that stays in L1;
//  - fill: one CTA per (read, chunk of 1,024 positions); a CTA whose chunk
//    starts past the read's last frame returns at once, so the padding of
//    the power-of-two batch width costs nothing.  Each valid hash sets bit
//    slot & 31 of word slot >> 5 of a ceil(size / 32)-word bitmap with a
//    reduction (atomicOr whose result is unused): 17.8 MB at the bench's
//    142 M slots, inside the 50 MB L2, where the direct words (570 MB)
//    would take a DRAM read-modify-write per hash.  At 56,947,329,536
//    slots the bitmap is 7.1 GB and each set bit a DRAM sector's
//    read-modify-write; its word index slot >> 5 is 64-bit.  Bound: the
//    reads' codes in and the bitmap words set out;
//  - merge: streams the bitmap once.  As the words' first write (the
//    direct filter's pass 1, into memory allocated without a zero-fill) it
//    stores every word of the allocation with no read, 16 bytes per thread:
//    bytes-bound at the bitmap in and the words out.  As an OR (a filter
//    that already holds bits) it read-modify-writes the words of every
//    group of 4 slots with a set bit.
#include "seed_hash.cuh"

namespace gr {

constexpr int kThreads = 256;     // threads per CTA of every entry
constexpr int kFillChunk = 1024;  // positions per CTA of the fill
constexpr int kGather = 4;        // rank grid: seeds whose gathers overlap
// what a grid entry stores: slots, ranks in a filter of one superblock
// (below 2^32 slots), ranks in a filter of several
constexpr int kSlots = 0, kRanks = 1, kRanksSupers = 2;

// The slot map (mibf.py slot_of): h % size, or fastrange.  Below 2^32
// slots fastrange is floor(h * size / 2^64), the exact high half; at 2^32
// and more the JAX function's two partial products wrap in uint64, so its
// slots stay below 2^32 (ROADMAP queue 3), and this computes the same wrap.
__device__ __forceinline__ uint64_t slot_of(uint64_t h, uint64_t size,
                                            int mode) {
  if (mode) return h % size;
  if (size >> 32 == 0) return __umul64hi(h, size);
  return ((h >> 32) * size + (((h & 0xFFFFFFFFull) * size) >> 32)) >> 32;
}

// The slot seed s probes at valid frame fr of a tile with frames_t frames,
// from fr's left partials `own`: position fr, or frames_t - s - 1 once fr
// reaches it (the stale tail).
__device__ __forceinline__ uint64_t frame_slot(const Family& f,
                                               const Stage& st,
                                               ulonglong2 own, int fr,
                                               int frames_t, int s,
                                               uint64_t size, int mode) {
  const int F_ts = frames_t - s;
  const int p = fr < F_ts ? fr : F_ts - 1;
  const ulonglong2 left = p == fr ? own : left_at(f, st, p);
  return slot_of(canon(st, left, p, s), size, mode);
}

// grid (T, B): one CTA per (read, tile).  Frame j < TL / S of tile t sits
// at tile position f = j * S and is valid iff t < len / TL and f <
// frames_t; seed s probes position t*TL + f, or t*TL + F_ts - 1 once f >=
// F_ts = frames_t - s (the stale tail); invalid frames get slot `size`.
// That is the stride-1 grid subsampled, which both of the JAX package's
// sampled grids equal.  Invariant: in a valid tile len - t*TL >= TL, so
// frames_t >= TL - k + 1 and, with TL >= k + h - 1 (checked by the entry),
// F_ts >= 1: every probed position p has p + s < frames_t, inside the
// tile's staged window of m = frames_t right-half partials (an unclamped
// frame reads partials f..f+s, a clamped one partial frames_t - 1).
//
// kStore kRanks: store the rank of each slot in the frozen structure
// (`bitrank`) instead, and `sentinel` for absent slots and invalid frames;
// kRanksSupers: the same in a filter of n_super > 1 superblocks, adding
// each slot's superblock base supers[slot >> 32].  A thread issues the
// gathers of up to kGather seeds of its frame before it uses any (all h =
// 3 of the path's seeds); the words are held as (bitrank word, bit) pairs,
// with the base in kRanksSupers, not slots, to keep registers for more
// CTAs per SM.  A filter of one superblock runs without the base's
// registers: with them its B=32, T=20 grid took 0.0392 ms on an H100
// against 0.0334 without (chip_smoke.py --ab).
//
// kQuery: also write the query grid [B, hq, T*Fq] and its frame_ok, Fq =
// F / q_step: frame j of a tile, when j % q_step == 0, is query frame
// j / q_step, and its first hq seeds' entries go there too.  At a stride
// S = q_step * S_ins the query frame sits at tile position (j / q_step) *
// S, which is where the sampled grid's frame probes, with the same clamp.
template <int kStore, bool kQuery>
__global__ void __launch_bounds__(kThreads) seed_hash_grid_kernel(
    const uint8_t* __restrict__ codes, int64_t L,
    const int* __restrict__ lengths, const Family f, int T, int TL, int S,
    int64_t size, int mode, const unsigned long long* __restrict__ bitrank,
    const unsigned long long* __restrict__ supers, int64_t n_super,
    int64_t sentinel, int64_t* __restrict__ grid,
    bool* __restrict__ frame_ok, int64_t* __restrict__ grid_q,
    bool* __restrict__ ok_q, int hq, int q_step) {
  extern __shared__ ulonglong2 smem[];
  const int t = blockIdx.x, b = blockIdx.y;
  const int F = TL / S;                         // frames per tile
  const int64_t TF = static_cast<int64_t>(T) * F;
  const int64_t pos0 = static_cast<int64_t>(t) * TL;  // tile's read position
  const int64_t col0 = static_cast<int64_t>(t) * F;   // its first column
  const int64_t len = lengths[b];
  const int frames_t = t < len / TL
      ? static_cast<int>(min64(TL + f.k - 1, len - pos0)) - f.k + 1 : 0;
  const uint64_t usize = static_cast<uint64_t>(size);
  bool* ok_row = frame_ok + b * TF + col0;
  int64_t* out = grid + static_cast<int64_t>(b) * f.h * TF + col0;
  // the query grid's rows of this tile (kQuery)
  int64_t TFq = 0;
  bool* okq_row = nullptr;
  int64_t* outq = nullptr;
  if constexpr (kQuery) {
    const int64_t Fq = F / q_step;
    TFq = T * Fq;
    okq_row = ok_q + b * TFq + t * Fq;
    outq = grid_q + static_cast<int64_t>(b) * hq * TFq + t * Fq;
  }
  const Stage st(smem, f, frames_t);
  if (frames_t > 0) stage(f, codes + b * L, L, pos0, frames_t, S, st);
  // j = jq * q_step + rem, kept as j steps by blockDim.x (no division a
  // frame): frame j is query frame jq when rem == 0
  int jq = 0, rem = 0, jq_step = 0, rem_step = 0;
  if constexpr (kQuery) {
    jq = threadIdx.x / q_step;
    rem = threadIdx.x - jq * q_step;
    jq_step = blockDim.x / q_step;
    rem_step = blockDim.x - jq_step * q_step;
  }
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    const int fr = j * S;
    const bool ok = fr < frames_t;
    ok_row[j] = ok;
    // the seeds of frame j that the query grid takes
    int nq = 0;
    if constexpr (kQuery) {
      nq = rem == 0 ? hq : 0;
      if (nq) okq_row[jq] = ok;
    }
    ulonglong2 own = make_ulonglong2(0, 0);
    if (ok) own = left_at(f, st, fr);
    if constexpr (kStore != kSlots) {
      for (int s0 = 0; s0 < f.h; s0 += kGather) {
        unsigned long long e[kGather] = {}, sup[kGather] = {};
        unsigned bit[kGather] = {};
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          if (ok && s0 + g < f.h) {
            const uint64_t slot =
                frame_slot(f, st, own, fr, frames_t, s0 + g, usize, mode);
            bit[g] = static_cast<unsigned>(slot & 31u);
            e[g] = bitrank[slot >> 5];
            if constexpr (kStore == kRanksSupers) {
              const uint64_t s = slot >> 32;
              sup[g] = supers[s < static_cast<uint64_t>(n_super)
                                  ? s : n_super - 1];
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          if (s0 + g < f.h) {
            const int64_t v =
                ok ? rank_in(e[g], bit[g], sup[g], sentinel) : sentinel;
            out[(s0 + g) * TF + j] = v;
            if (kQuery && s0 + g < nq) outq[(s0 + g) * TFq + jq] = v;
          }
        }
      }
    } else {
      for (int s = 0; s < f.h; ++s) {
        const int64_t v =
            ok ? static_cast<int64_t>(
                     frame_slot(f, st, own, fr, frames_t, s, usize, mode))
               : size;
        out[s * TF + j] = v;
        if (kQuery && s < nq) outq[s * TFq + jq] = v;
      }
    }
    if constexpr (kQuery) {
      jq += jq_step;
      rem += rem_step;
      if (rem >= q_step) {
        rem -= q_step;
        ++jq;
      }
    }
  }
}

// The standalone sampled grid at a stride S >= h (S > 1, no query grid
// beside it: no right-half partial serves two frames), as slots, or as
// ranks of one seed: a thread a frame,
// over the batch's frames flattened as [B, T, F] (F = TL / S), kThreads
// consecutive frames a CTA, whatever tiles they span.  The
// frames, probe positions, stale-tail clamp and stores are those of
// seed_hash_grid_kernel; only the work's layout and the hash's lookups
// differ.  A CTA stages the family's block table (SeedFamily.block_table,
// ntCard's: for each half and each block of 4 positions, the XOR of the
// block's care constants for each of the 256 codes of the 4 positions)
// behind one barrier; a thread loads its frame's codes with three 16-byte
// loads, packs them two bits a code into the 32-code window from its probe
// position (`window_at`), and takes a half's partials as one lookup a block
// of 4 window positions, a byte of the window (`half_at`): at k = 22 three
// lookups a half, where the care constants took eight.  Every care offset
// of every seed lies in the window when k + h <= 33 and the blocks' bytes
// do when 2 (half + h - 1) + 8 (nb - 1) <= 56 (the launcher checks both; a
// family past them runs the CTA-per-tile kernel).  The design this
// replaces ran a CTA per (read, tile) that staged the tile's whole codes
// window byte by byte and its right-half partials behind two barriers,
// with work for only F = TL / S of its 256 threads: at B=64, T=20, S=8
// 1,280 CTAs whose staging's latency (tools/torch_port_sampled_grid_
// variants.py: 0.009 of 0.014 ms), not their bytes, set the time.  Below
// S = h a frame shares right-half partials with the next, which the
// CTA-per-tile kernel computes once a position: there it stays, since a
// thread a frame measured slower on an H100 at S=2, h=3 (B=32: 0.0162 ms
// against 0.0137 as slots, 0.0283 against 0.0214 as ranks); so do ranks
// of several seeds, slower at S=4, h=3 (0.0150 against 0.0135; 72
// registers a thread hold fewer frames' gathers in flight), while slots
// there took 0.0096 against 0.0114 (chip_smoke.py --ab).

// 16 codes (the low two bits of 16 bytes) packed two bits a code, the
// first in the lowest bits.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  uint32_t t = x & 0x03030303u;
  t = (t | (t >> 6)) & 0x000F000Fu;
  return (t | (t >> 12)) & 0xFFu;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return pack4(v.x) | (pack4(v.y) << 8) | (pack4(v.z) << 16) |
         (pack4(v.w) << 24);
}

// Codes [q, q + 32) of a row of L codes, two bits each, code q in the
// lowest bits; 0 at or past L.  Three aligned 16-byte loads when they lie
// inside the row's L bytes, else byte by byte.
__device__ __forceinline__ uint64_t window_at(const uint8_t* __restrict__ row,
                                              int64_t L, int64_t q) {
  const uint8_t* p = row + q;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) & ~uintptr_t{15};
  if (a + 48 <= reinterpret_cast<uintptr_t>(row + L)) {
    const uint4* v = reinterpret_cast<const uint4*>(a);
    const uint32_t w0 = pack16(__ldg(v)), w1 = pack16(__ldg(v + 1)),
                   w2 = pack16(__ldg(v + 2));
    const unsigned sh = 2u * static_cast<unsigned>(
                                 reinterpret_cast<uintptr_t>(p) - a);
    const uint32_t lo = __funnelshift_r(w0, w1, sh);
    const uint32_t hi = __funnelshift_r(w1, w2, sh);
    return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
  }
  uint64_t w = 0;
  for (int i = 0; i < 32; ++i)
    if (q + i < L) w |= static_cast<uint64_t>(__ldg(p + i) & 3u) << (2 * i);
  return w;
}

// A half's partials from its nb blocks (`blk`: nb tables of 256 entries),
// its first position at window offset `base`.
__device__ __forceinline__ ulonglong2 half_at(const ulonglong2* blk, int nb,
                                              int base, uint64_t win) {
  uint64_t fw = 0, rv = 0;
  for (int b = 0; b < nb; ++b) {
    const ulonglong2 v =
        blk[256 * b + static_cast<int>((win >> (2 * base + 8 * b)) & 255u)];
    fw ^= v.x;
    rv ^= v.y;
  }
  return make_ulonglong2(fw, rv);
}

template <int kStore>
__global__ void __launch_bounds__(kThreads) seed_hash_sampled_kernel(
    const uint8_t* __restrict__ codes, int64_t L,
    const int* __restrict__ lengths, const Family f, int T, int TL, int S,
    int64_t size, int mode, const unsigned long long* __restrict__ bitrank,
    const unsigned long long* __restrict__ supers, int64_t n_super,
    int64_t sentinel, int64_t* __restrict__ grid,
    bool* __restrict__ frame_ok, uint32_t frames,
    const ulonglong2* __restrict__ blocks, int nb) {
  // the left half's nb tables, then the right half's
  ulonglong2* blk = reinterpret_cast<ulonglong2*>(gr_smem);
  for (int i = threadIdx.x; i < 2 * nb * 256; i += blockDim.x)
    blk[i] = __ldg(blocks + i);
  __syncthreads();
  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= frames) return;
  const int F = TL / S;
  const uint32_t TFu = static_cast<uint32_t>(T) * F;
  const uint32_t b = g / TFu, col = g - b * TFu;
  const int t = static_cast<int>(col / F), j = static_cast<int>(col) - t * F;
  const int64_t TF = TFu;
  const int64_t len = lengths[b];
  const int64_t pos0 = static_cast<int64_t>(t) * TL;
  const int frames_t = t < len / TL
      ? static_cast<int>(min64(TL + f.k - 1, len - pos0)) - f.k + 1 : 0;
  const int fr = j * S;
  const bool ok = fr < frames_t;
  frame_ok[static_cast<int64_t>(b) * TF + col] = ok;
  int64_t* out = grid + static_cast<int64_t>(b) * f.h * TF + col;
  if (!ok) {
    const int64_t v = kStore == kSlots ? size : sentinel;
    for (int s = 0; s < f.h; ++s) out[s * TF] = v;
    return;
  }
  const uint8_t* row = codes + static_cast<int64_t>(b) * L;
  const uint64_t usize = static_cast<uint64_t>(size);
  const uint64_t own_win = window_at(row, L, pos0 + fr);
  const ulonglong2 own = half_at(blk, nb, 0, own_win);
  for (int s0 = 0; s0 < f.h; s0 += kGather) {
    uint64_t slot[kGather];
#pragma unroll
    for (int g2 = 0; g2 < kGather; ++g2) {
      const int s = s0 + g2;
      if (s >= f.h) break;
      // position fr, or frames_t - s - 1 once fr reaches it (the stale
      // tail)
      const int F_ts = frames_t - s;
      const int p = fr < F_ts ? fr : F_ts - 1;
      const uint64_t win = p == fr ? own_win : window_at(row, L, pos0 + p);
      const ulonglong2 left = p == fr ? own : half_at(blk, nb, 0, win);
      const ulonglong2 r = half_at(blk + 256 * nb, nb, f.half + s, win);
      const uint64_t fwd = rol64(left.x, s) ^ r.x;
      const uint64_t rev = left.y ^ rol64(r.y, s);
      slot[g2] = slot_of(fwd < rev ? fwd : rev, usize, mode);
    }
    if constexpr (kStore == kSlots) {
#pragma unroll
      for (int g2 = 0; g2 < kGather; ++g2)
        if (s0 + g2 < f.h)
          out[(s0 + g2) * TF] = static_cast<int64_t>(slot[g2]);
    } else {
      // the gathers of up to kGather seeds in flight before any is used
      unsigned long long e[kGather] = {}, sup[kGather] = {};
#pragma unroll
      for (int g2 = 0; g2 < kGather; ++g2) {
        if (s0 + g2 < f.h) {
          e[g2] = bitrank[slot[g2] >> 5];
          if constexpr (kStore == kRanksSupers) {
            const uint64_t sb = slot[g2] >> 32;
            sup[g2] = supers[sb < static_cast<uint64_t>(n_super)
                                 ? sb : n_super - 1];
          }
        }
      }
#pragma unroll
      for (int g2 = 0; g2 < kGather; ++g2)
        if (s0 + g2 < f.h)
          out[(s0 + g2) * TF] = rank_in(
              e[g2], static_cast<unsigned>(slot[g2] & 31u), sup[g2],
              sentinel);
    }
  }
}

// grid (ceil(L / kFillChunk), B): one CTA per (read, chunk).  Frame p of
// seed s is valid iff p < len - span_s + 1, i.e. p + s < len - k + 1; its
// slot's bit is set in `bits`.
__global__ void __launch_bounds__(kThreads) seed_hash_fill_kernel(
    const uint8_t* __restrict__ codes, int64_t L,
    const int* __restrict__ lengths, const Family f, int64_t size, int mode,
    uint32_t* __restrict__ bits) {
  extern __shared__ ulonglong2 smem[];
  const int b = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kFillChunk;
  const int64_t rem = static_cast<int64_t>(lengths[b]) - f.k + 1 - p0;
  if (rem <= 0) return;  // the chunk holds no frame of any seed
  // positions of this chunk, and the right partials their seeds reach
  const int n = static_cast<int>(min64(kFillChunk, rem));
  const int m = static_cast<int>(min64(kFillChunk + f.h - 1, rem));
  const Stage st(smem, f, m);
  stage(f, codes + b * L, L, p0, m, 1, st);
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const ulonglong2 left = left_at(f, st, p);
    for (int s = 0; s < f.h && p + s < m; ++s) {
      const uint64_t slot =
          slot_of(canon(st, left, p, s), static_cast<uint64_t>(size), mode);
      atomicOr(bits + (slot >> 5), 1u << (slot & 31u));
    }
  }
}

// grid ceil(groups / kThreads): thread i owns words 4i..4i+3, whose slots
// below size are one nibble of the bitmap.  first_write: it stores all four
// (PRESENT where the bit is set, else 0; groups cover every word of the
// allocation, so slot `size` and the padding get 0) with one 16-byte store
// and no load.  Otherwise (groups cover the slots): if a bit is set, it
// ORs PRESENT into their words with one 16-byte load and store.
__global__ void __launch_bounds__(kThreads) presence_merge_kernel(
    const uint32_t* __restrict__ bits, int64_t size, int64_t groups,
    bool first_write, uint32_t* __restrict__ words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const int64_t s0 = 4 * i;
  uint32_t nib = 0;
  if (s0 < size) {
    nib = (bits[s0 >> 5] >> (s0 & 31)) & 0xFu;
    if (size - s0 < 4) nib &= (1u << (size - s0)) - 1u;
  }
  uint4 w;
  if (first_write) {
    w = make_uint4(0u, 0u, 0u, 0u);
  } else {
    if (nib == 0) return;
    w = reinterpret_cast<uint4*>(words)[i];
  }
  if (nib & 1u) w.x |= kPresent;
  if (nib & 2u) w.y |= kPresent;
  if (nib & 4u) w.z |= kPresent;
  if (nib & 8u) w.w |= kPresent;
  reinterpret_cast<uint4*>(words)[i] = w;
}

// A grid entry's launch of the instantiation <kStore, kQuery>.
template <int kStore, bool kQuery>
cudaError_t launch_grid_as(const uint8_t* codes, int64_t B, int64_t L,
                           const int* lengths, const Family& f, int T,
                           int TL, int S, int64_t size, int mode,
                           const unsigned long long* bitrank,
                           const unsigned long long* supers, int64_t n_super,
                           int64_t sentinel, int64_t* grid, bool* frame_ok,
                           int64_t* grid_q, bool* ok_q, int hq, int q_step,
                           cudaStream_t stream) {
  const size_t smem = stage_bytes(f, TL);
  const auto kernel = seed_hash_grid_kernel<kStore, kQuery>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks(static_cast<unsigned>(T), static_cast<unsigned>(B));
  kernel<<<blocks, kThreads, smem, stream>>>(
      codes, L, lengths, f, T, TL, S, size, mode, bitrank, supers, n_super,
      sentinel, grid, frame_ok, grid_q, ok_q, hq, q_step);
  return cudaGetLastError();
}

// Both grid entries: check the clamp invariant, the stride and the query
// grid's (none when grid_q is null: hq seeds, 1 <= hq <= h, every q_step-th
// frame, q_step dividing TL / S), and launch: a standalone sampled grid
// at S >= h, as slots or as ranks of one seed, with
// seed_hash_sampled_kernel where the family's window and blocks (`blocks`,
// nb a half) allow it, every other grid with seed_hash_grid_kernel.
template <int kStore>
int launch_grid(const uint8_t* codes, int64_t B, int64_t L, const int* lengths,
                const Family& f, const uint64_t* blocks, int nb, int T,
                int TL, int S, int64_t size, int mode,
                const unsigned long long* bitrank,
                const unsigned long long* supers, int64_t n_super,
                int64_t sentinel, int64_t* grid, bool* frame_ok,
                int64_t* grid_q, bool* ok_q, int hq, int q_step,
                cudaStream_t stream) {
  if (TL < f.k + f.h - 1) return cudaErrorInvalidValue;  // the clamp invariant
  if (S < 1 || TL % S) return cudaErrorInvalidValue;
  if (grid_q && (!ok_q || hq < 1 || hq > f.h || q_step < 1 ||
                 (TL / S) % q_step))
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return kNoLaunch;
  const int64_t frames = B * T * static_cast<int64_t>(TL / S);
  if (S > 1 && S >= f.h && (kStore == kSlots || f.h == 1) && !grid_q &&
      blocks && nb >= 1 && f.k + f.h <= 33 &&
      2 * (f.half + f.h - 1) + 8 * (nb - 1) <= 56 &&
      frames < (int64_t{1} << 32) - kThreads) {
    // the standalone sampled grid: a thread a frame
    const auto kernel = seed_hash_sampled_kernel<kStore>;
    const size_t smem = sizeof(ulonglong2) * 2 * 256 * nb;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>((frames + kThreads - 1) / kThreads),
             kThreads, smem, stream>>>(
        codes, L, lengths, f, T, TL, S, size, mode, bitrank, supers, n_super,
        sentinel, grid, frame_ok, static_cast<uint32_t>(frames),
        reinterpret_cast<const ulonglong2*>(blocks), nb);
    return cudaGetLastError();
  }
  if (grid_q)
    return launch_grid_as<kStore, true>(
        codes, B, L, lengths, f, T, TL, S, size, mode, bitrank, supers,
        n_super, sentinel, grid, frame_ok, grid_q, ok_q, hq, q_step, stream);
  return launch_grid_as<kStore, false>(
      codes, B, L, lengths, f, T, TL, S, size, mode, bitrank, supers,
      n_super, sentinel, grid, frame_ok, nullptr, nullptr, 0, 1, stream);
}

}  // namespace gr

extern "C" {

const char* gr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fam_table: the family's kernel_table on the card; h..pad its scalars;
// blocks: its block_table(nb) on the card (a standalone sampled grid's
// lookups; may be null); S the frame stride (divides TL): slots [B, h,
// T*TL/S].  With slots_q
// (else null), also the query grid [B, hq, T*TL/(S*q_step)] and ok_q.
int gr_seed_hash_grid(const uint8_t* codes, int64_t B, int64_t L,
                      const int* lengths, const uint64_t* fam_table, int h,
                      int k, int half, int nl, int nr, int pad,
                      const uint64_t* blocks, int nb, int T, int TL, int S,
                      int64_t size, int mode, int64_t* slots, bool* frame_ok,
                      int64_t* slots_q, bool* ok_q, int hq, int q_step,
                      cudaStream_t stream) {
  const gr::Family f{h, k, half, nl, nr, pad, fam_table};
  return gr::launch_grid<gr::kSlots>(codes, B, L, lengths, f, blocks, nb, T,
                                     TL, S, size, mode, nullptr, nullptr, 0,
                                     0, slots, frame_ok, slots_q, ok_q, hq,
                                     q_step, stream);
}

// bitrank, supers: the frozen structure of a filter of `size` slots
// (ceil(size / 32) + 1 words, n_super = ceil(size / 2^32) superblock
// bases); sentinel: the rank absent slots and invalid frames get.  With
// ranks_q (else null), also the query grid and ok_q, as gr_seed_hash_grid.
int gr_seed_hash_rank_grid(const uint8_t* codes, int64_t B, int64_t L,
                           const int* lengths, const uint64_t* fam_table,
                           int h, int k, int half, int nl, int nr, int pad,
                           const uint64_t* blocks, int nb, int T, int TL,
                           int S, int64_t size, int mode,
                           const unsigned long long* bitrank,
                           const unsigned long long* supers, int64_t n_super,
                           int64_t sentinel, int64_t* ranks, bool* frame_ok,
                           int64_t* ranks_q, bool* ok_q, int hq, int q_step,
                           cudaStream_t stream) {
  if (n_super < 1) return cudaErrorInvalidValue;
  const gr::Family f{h, k, half, nl, nr, pad, fam_table};
  if (n_super == 1)
    return gr::launch_grid<gr::kRanks>(codes, B, L, lengths, f, blocks, nb,
                                       T, TL, S, size, mode, bitrank, supers,
                                       n_super, sentinel, ranks, frame_ok,
                                       ranks_q, ok_q, hq, q_step, stream);
  return gr::launch_grid<gr::kRanksSupers>(
      codes, B, L, lengths, f, blocks, nb, T, TL, S, size, mode, bitrank,
      supers, n_super, sentinel, ranks, frame_ok, ranks_q, ok_q, hq, q_step,
      stream);
}

int gr_seed_hash_fill(const uint8_t* codes, int64_t B, int64_t L,
                      const int* lengths, const uint64_t* fam_table, int h,
                      int k, int half, int nl, int nr, int pad, int64_t size,
                      int mode, uint32_t* bits, cudaStream_t stream) {
  const gr::Family f{h, k, half, nl, nr, pad, fam_table};
  if (B == 0 || L == 0) return gr::kNoLaunch;
  const size_t smem = gr::stage_bytes(f, gr::kFillChunk + h - 1);
  const cudaError_t err = gr::allow_smem(gr::seed_hash_fill_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((L + gr::kFillChunk - 1) /
                                        gr::kFillChunk),
                  static_cast<unsigned>(B));
  gr::seed_hash_fill_kernel<<<grid, gr::kThreads, smem, stream>>>(
      codes, L, lengths, f, size, mode, bits);
  return cudaGetLastError();
}

// words: 16-byte aligned, n entries (n >= 4 * ceil(size / 4)); with
// first_write n is a multiple of 4 and every entry is written.
int gr_presence_merge(const uint32_t* bits, int64_t size, uint32_t* words,
                      int64_t n, int first_write, cudaStream_t stream) {
  // a bank of the words past the filter's last slot holds none (size 0):
  // its first write is all zeros
  if (size < 0 || n < 4 * ((size + 3) / 4) || (first_write && n % 4))
    return cudaErrorInvalidValue;
  const int64_t groups = first_write ? n / 4 : (size + 3) / 4;
  if (groups == 0) return gr::kNoLaunch;
  const unsigned grid =
      static_cast<unsigned>((groups + gr::kThreads - 1) / gr::kThreads);
  gr::presence_merge_kernel<<<grid, gr::kThreads, 0, stream>>>(
      bits, size, groups, first_write != 0, words);
  return cudaGetLastError();
}

}  // extern "C"
