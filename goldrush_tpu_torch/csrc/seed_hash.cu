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
//   seed_hash_fill       replaces hash_positions + slot_of + fill_presence
//                        (mibf/mibf.py:122): one batch of pass 1, into a
//                        presence bitmap;
//   presence_merge       the bitmap into the direct filter's words
//                        (PRESENT), once per fill pass; the compressed
//                        filter freezes from the bitmap itself (rank.cu).
//
// Hashing.  Every entry stages the codes window a CTA needs in shared
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
//    bytes per seed.  At a stride S the CTA still stages its tile's whole
//    codes window, but computes right-half partials only where its frames
//    and the stale-tail clamp read them, and hashes only the frames it
//    emits: at B=64, T=20, h=1, S=8 (the throughput mode's query grid)
//    1.3 MB of codes in and 1.4 MB out;
//  - rank grid: the grid's stores, ranks in place of slots, plus one 8-byte
//    bitrank[slot >> 5] gather per valid entry from a 35.6 MB table (at the
//    bench sizing) that fits the 50 MB L2.  A thread computes its frame's h
//    slots and issues their h gathers before it uses any of them, so h
//    gathers are in flight per thread, not one; the slots never reach
//    device memory, which saves the separate lookup's 30.7 MB round trip
//    (slots written, read back) and its launch.  Registers decide how many
//    of the 640 CTAs of a B=32, T=20 grid run at once (four per SM at 62
//    registers a thread: two waves), so the gathers are issued in groups
//    of kGather seeds;
//  - fill: one CTA per (read, chunk of 1,024 positions); a CTA whose chunk
//    starts past the read's last frame returns at once, so the padding of
//    the power-of-two batch width costs nothing.  Each valid hash sets bit
//    slot & 31 of word slot >> 5 of a ceil(size / 32)-word bitmap with a
//    reduction (atomicOr whose result is unused): 17.8 MB at the bench's
//    142 M slots, inside the 50 MB L2, where the direct words (570 MB)
//    would take a DRAM read-modify-write per hash.  Bound: the reads'
//    codes in and the bitmap words set out;
//  - merge: streams the bitmap once.  As the words' first write (the
//    direct filter's pass 1, into memory allocated without a zero-fill) it
//    stores every word of the allocation with no read, 16 bytes per thread:
//    bytes-bound at the bitmap in and the words out.  As an OR (a filter
//    that already holds bits) it read-modify-writes the words of every
//    group of 4 slots with a set bit.
#include "common.cuh"

namespace gr {

constexpr int kThreads = 256;     // threads per CTA of every entry
constexpr int kFillChunk = 1024;  // positions per CTA of the fill
constexpr int kGather = 4;        // rank grid: seeds whose gathers overlap

// A seed family as the kernels read it: its scalars by value, its table
// (SeedFamily.kernel_table: nl + nr care offsets, then (nl + nr) x 4 bases
// of (fwd, rev) constants) in device memory.  pad = SeedFamily.pad_needed.
struct Family {
  int h, k, half, nl, nr, pad;
  const uint64_t* table;
};

// Shared-memory bytes of a CTA that stages m right-half partials.
__host__ __device__ inline size_t stage_bytes(const Family& f, int m) {
  const int nc = f.nl + f.nr;
  return sizeof(ulonglong2) * (4 * nc + m) + sizeof(int) * nc + m + f.pad;
}

// One CTA's staged window: the family's constants and care offsets, the
// codes of window positions [0, m + pad) and the right-half partials
// (FR, RR) of window positions half + i, i < m.
struct Stage {
  ulonglong2* tab;    // [(nl + nr) * 4]
  ulonglong2* right;  // [m]
  int* care;          // [nl + nr]
  uint8_t* codes;     // [m + pad]

  __device__ Stage(ulonglong2* smem, const Family& f, int m)
      : tab(smem), right(smem + 4 * (f.nl + f.nr)),
        care(reinterpret_cast<int*>(right + m)),
        codes(reinterpret_cast<uint8_t*>(care + f.nl + f.nr)) {}
};

// Stage read positions [p0, p0 + m + pad) of `row` (zero at or past L) and
// the right-half partials of the first m window positions: all of them at
// stride 1, else those that frames at multiples of `stride` and the clamp
// read (i % stride < h, and m - 1); the rest stay unset.  Every thread of
// the CTA calls it; it ends with a barrier.
__device__ void stage(const Family& f, const uint8_t* __restrict__ row,
                      int64_t L, int64_t p0, int m, int stride,
                      const Stage& st) {
  const int nc = f.nl + f.nr;
  for (int i = threadIdx.x; i < 4 * nc; i += blockDim.x) {
    st.tab[i] = make_ulonglong2(f.table[nc + 2 * i], f.table[nc + 2 * i + 1]);
  }
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    st.care[i] = static_cast<int>(f.table[i]);
  }
  for (int i = threadIdx.x; i < m + f.pad; i += blockDim.x) {
    const int64_t q = p0 + i;
    st.codes[i] = q < L ? (row[q] & 3u) : 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (stride > 1 && i % stride >= f.h && i != m - 1) continue;
    const uint8_t* c = st.codes + f.half + i;
    uint64_t fw = 0, rv = 0;
    for (int r = f.nl; r < nc; ++r) {
      const ulonglong2 v = st.tab[4 * r + c[st.care[r]]];
      fw ^= v.x;
      rv ^= v.y;
    }
    st.right[i] = make_ulonglong2(fw, rv);
  }
  __syncthreads();
}

// Left-half partials (FL, RL) of window position p.
__device__ __forceinline__ ulonglong2 left_at(const Family& f, const Stage& st,
                                              int p) {
  uint64_t fw = 0, rv = 0;
  for (int r = 0; r < f.nl; ++r) {
    const ulonglong2 v = st.tab[4 * r + st.codes[p + st.care[r]]];
    fw ^= v.x;
    rv ^= v.y;
  }
  return make_ulonglong2(fw, rv);
}

// Canonical hash of seed s at window position p (p + s < m), from p's left
// partials.
__device__ __forceinline__ uint64_t canon(const Stage& st, ulonglong2 left,
                                          int p, int s) {
  const ulonglong2 r = st.right[p + s];
  const uint64_t fwd = rol64(left.x, s) ^ r.x;
  const uint64_t rev = left.y ^ rol64(r.y, s);
  return fwd < rev ? fwd : rev;
}

__device__ __forceinline__ uint64_t slot_of(uint64_t h, uint64_t size,
                                            int mode) {
  return mode ? h % size : __umul64hi(h, size);
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

// The rank of the slot at bit b of bitrank word e (rank.cu's layout: rank
// of the word's first slot above, presence bits below), or `sentinel` if
// the slot is absent.
__device__ __forceinline__ int64_t rank_in(unsigned long long e, unsigned b,
                                           int64_t sentinel) {
  const uint32_t bits = static_cast<uint32_t>(e);
  if (!((bits >> b) & 1u)) return sentinel;
  return static_cast<int64_t>(e >> 32) + __popc(bits & ((1u << b) - 1u));
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
// kRanked: store the rank of each slot in the frozen structure `bitrank`
// instead, and `sentinel` for absent slots and invalid frames.  A thread
// issues the gathers of up to kGather seeds of its frame before it uses
// any (all h = 3 of the path's seeds); the words are held as (bitrank
// word, bit) pairs, not slots, to keep registers for more CTAs per SM.
template <bool kRanked>
__global__ void __launch_bounds__(kThreads) seed_hash_grid_kernel(
    const uint8_t* __restrict__ codes, int64_t L,
    const int* __restrict__ lengths, const Family f, int T, int TL, int S,
    int64_t size, int mode, const unsigned long long* __restrict__ bitrank,
    int64_t sentinel, int64_t* __restrict__ grid,
    bool* __restrict__ frame_ok) {
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
  const Stage st(smem, f, frames_t);
  if (frames_t > 0) stage(f, codes + b * L, L, pos0, frames_t, S, st);
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    const int fr = j * S;
    const bool ok = fr < frames_t;
    ok_row[j] = ok;
    ulonglong2 own = make_ulonglong2(0, 0);
    if (ok) own = left_at(f, st, fr);
    if constexpr (kRanked) {
      for (int s0 = 0; s0 < f.h; s0 += kGather) {
        unsigned long long e[kGather] = {};
        unsigned bit[kGather] = {};
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          if (ok && s0 + g < f.h) {
            const uint64_t slot =
                frame_slot(f, st, own, fr, frames_t, s0 + g, usize, mode);
            bit[g] = static_cast<unsigned>(slot & 31u);
            e[g] = bitrank[slot >> 5];
          }
        }
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          if (s0 + g < f.h)
            out[(s0 + g) * TF + j] = ok ? rank_in(e[g], bit[g], sentinel)
                                        : sentinel;
        }
      }
    } else {
      for (int s = 0; s < f.h; ++s) {
        out[s * TF + j] =
            ok ? static_cast<int64_t>(
                     frame_slot(f, st, own, fr, frames_t, s, usize, mode))
               : size;
      }
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

// Both grid entries: check the clamp invariant and the stride, and launch.
template <bool kRanked>
int launch_grid(const uint8_t* codes, int64_t B, int64_t L, const int* lengths,
                const Family& f, int T, int TL, int S, int64_t size, int mode,
                const unsigned long long* bitrank, int64_t sentinel,
                int64_t* grid, bool* frame_ok, cudaStream_t stream) {
  if (TL < f.k + f.h - 1) return cudaErrorInvalidValue;  // the clamp invariant
  if (S < 1 || TL % S) return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return kNoLaunch;
  const size_t smem = stage_bytes(f, TL);
  const cudaError_t err = allow_smem(seed_hash_grid_kernel<kRanked>, smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks(static_cast<unsigned>(T), static_cast<unsigned>(B));
  seed_hash_grid_kernel<kRanked><<<blocks, kThreads, smem, stream>>>(
      codes, L, lengths, f, T, TL, S, size, mode, bitrank, sentinel, grid,
      frame_ok);
  return cudaGetLastError();
}

}  // namespace gr

extern "C" {

const char* gr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fam_table: the family's kernel_table on the card; h..pad its scalars;
// S the frame stride (divides TL): slots [B, h, T*TL/S].
int gr_seed_hash_grid(const uint8_t* codes, int64_t B, int64_t L,
                      const int* lengths, const uint64_t* fam_table, int h,
                      int k, int half, int nl, int nr, int pad, int T, int TL,
                      int S, int64_t size, int mode, int64_t* slots,
                      bool* frame_ok, cudaStream_t stream) {
  const gr::Family f{h, k, half, nl, nr, pad, fam_table};
  return gr::launch_grid<false>(codes, B, L, lengths, f, T, TL, S, size, mode,
                                nullptr, 0, slots, frame_ok, stream);
}

// bitrank: the frozen structure of a filter of `size` slots (ceil(size /
// 32) + 1 words); sentinel: the rank absent slots and invalid frames get.
int gr_seed_hash_rank_grid(const uint8_t* codes, int64_t B, int64_t L,
                           const int* lengths, const uint64_t* fam_table,
                           int h, int k, int half, int nl, int nr, int pad,
                           int T, int TL, int S, int64_t size, int mode,
                           const unsigned long long* bitrank,
                           int64_t sentinel, int64_t* ranks, bool* frame_ok,
                           cudaStream_t stream) {
  const gr::Family f{h, k, half, nl, nr, pad, fam_table};
  return gr::launch_grid<true>(codes, B, L, lengths, f, T, TL, S, size, mode,
                               bitrank, sentinel, ranks, frame_ok, stream);
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
  if (size <= 0 || n < 4 * ((size + 3) / 4) || (first_write && n % 4))
    return cudaErrorInvalidValue;
  const int64_t groups = first_write ? n / 4 : (size + 3) / 4;
  const unsigned grid =
      static_cast<unsigned>((groups + gr::kThreads - 1) / gr::kThreads);
  gr::presence_merge_kernel<<<grid, gr::kThreads, 0, stream>>>(
      bits, size, groups, first_write != 0, words);
  return cudaGetLastError();
}

}  // extern "C"
