// Kernel A: canonical spaced-seed ntHash -> slot, with two entries.
//
// Replaces the JAX package's hash_positions (goldrush_tpu/ops/nthash.py:131)
// + slot_of (mibf/mibf.py:115) + tile_slot_grid (mibf/mibf.py:158) for the
// GRID entry, and the fused hash + fill_presence (mibf/mibf.py:122,
// engine.py:405-408) for the FILL entry.
//
// Design.  The JAX kernel factors the hash into per-base rotated constants
// and correlations over shifted slices, a shape chosen for 128-lane TPU
// vectors.  Here every thread evaluates the definition directly for its own
// (read, position): fwd = XOR_j rol64(TAB[c[p+j]], span-1-j), rev = XOR_j
// rol64(TABC[c[p+j]], j), canon = min(fwd, rev), over the seed's care
// offsets (16 for the default seeds), so positions are independent and no
// rolling state or intermediate hash array exists.  fastrange is a native
// 64x64->128 __umul64hi.
//
// Bound.  The grid entry reads the reads' codes (1 B/base, served from L1
// across the ~16 neighbouring reads of a warp) and writes 8 B per slot per
// seed plus 1 B per frame: at B=32, T=20, TL=1000, h=3 that is 15.4 MB of
// output for 1.9 M hashes, so it is store-bound.  The fill entry's cost is
// its atomicOr traffic into the 570 MB words array, one random 4-byte
// read-modify-write per valid hash (the JAX path sorted and deduped first
// only to reach XLA's unique-index scatter).
#include "common.cuh"

namespace gr {

__constant__ uint64_t kTab[4] = {0x3C8BFBB395C60474ull, 0x3193C18562A02B4Cull,
                                 0x20323ED082572324ull, 0x295549F54BE24456ull};
// complement under A=0 C=1 G=2 T=3 is 3-b
__constant__ uint64_t kTabC[4] = {0x295549F54BE24456ull, 0x20323ED082572324ull,
                                  0x3193C18562A02B4Cull, 0x3C8BFBB395C60474ull};

// Seed family descriptor (ops/nthash.py SeedFamily.descriptor):
// fam = [h, k, half, nl, nr, care_left[nl]..., care_right[nr]...]; seed s
// has span k + s and care offsets care_left + (half + s + care_right).
struct Family {
  int h, k, half, nl, nr;
  const int* left;
  const int* right;
  __device__ explicit Family(const int* fam)
      : h(fam[0]), k(fam[1]), half(fam[2]), nl(fam[3]), nr(fam[4]),
        left(fam + 5), right(fam + 5 + fam[3]) {}
};

// Canonical hash of seed s at position pos of one read's codes; positions
// at or past L read as base 0 (the zero padding of hash_positions), and
// only the low 2 bits of a code are used.
__device__ __forceinline__ uint64_t canon_hash(const uint8_t* codes,
                                               int64_t L, int64_t pos,
                                               const Family& f, int s) {
  const int span = f.k + s;
  uint64_t fwd = 0, rev = 0;
  for (int i = 0; i < f.nl + f.nr; ++i) {
    const int j = i < f.nl ? f.left[i] : f.half + s + f.right[i - f.nl];
    const int64_t q = pos + j;
    const unsigned c = q < L ? (codes[q] & 3u) : 0u;
    fwd ^= rol64(kTab[c], static_cast<unsigned>(span - 1 - j));
    rev ^= rol64(kTabC[c], static_cast<unsigned>(j));
  }
  return fwd < rev ? fwd : rev;
}

__device__ __forceinline__ uint64_t slot_of(uint64_t h, uint64_t size,
                                            int mode) {
  return mode ? h % size : __umul64hi(h, size);
}

// grid (ceil(T*TL/256), B): one thread per (read, tile, frame), all seeds.
// Frame f of tile t is valid iff t < L/TL and f < frames_t; seed s probes
// position t*TL + f, or the clamp t*TL + F_ts - 1 once f >= F_ts
// (F_ts = frames_t - s: the stale tail); invalid frames get slot `size`.
__global__ void seed_hash_grid_kernel(const uint8_t* __restrict__ codes,
                                      int64_t L, const int* __restrict__ lengths,
                                      const int* __restrict__ fam, int T, int TL,
                                      int64_t size, int mode,
                                      int64_t* __restrict__ slots,
                                      bool* __restrict__ frame_ok) {
  const Family f(fam);
  const int64_t TF = static_cast<int64_t>(T) * TL;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= TF) return;
  const int b = blockIdx.y;
  const int t = static_cast<int>(col / TL);
  const int64_t fr = col - static_cast<int64_t>(t) * TL;
  const int64_t len = lengths[b];
  const int64_t tile_len = min64(static_cast<int64_t>(TL) + f.k - 1,
                                 len - static_cast<int64_t>(t) * TL);
  const int64_t frames_t = tile_len - f.k + 1;
  const bool ok = t < len / TL && fr < frames_t;
  frame_ok[b * TF + col] = ok;
  const uint8_t* rc = codes + static_cast<int64_t>(b) * L;
  for (int s = 0; s < f.h; ++s) {
    int64_t out = size;
    if (ok) {
      const int64_t F_ts = frames_t - s;
      int64_t pos = static_cast<int64_t>(t) * TL + fr;
      if (fr >= max64(F_ts, 0)) {
        pos = min64(max64(static_cast<int64_t>(t) * TL + F_ts - 1, 0), TF - 1);
      }
      out = static_cast<int64_t>(
          slot_of(canon_hash(rc, L, pos, f, s), static_cast<uint64_t>(size), mode));
    }
    slots[(static_cast<int64_t>(b) * f.h + s) * TF + col] = out;
  }
}

// grid (ceil(L/256), B): one thread per (read, position), all seeds.  Frame
// p of seed s is valid iff p < length - span_s + 1; its slot gets PRESENT.
__global__ void seed_hash_fill_kernel(const uint8_t* __restrict__ codes,
                                      int64_t L, const int* __restrict__ lengths,
                                      const int* __restrict__ fam, int64_t size,
                                      int mode, uint32_t* __restrict__ words) {
  const Family f(fam);
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= L) return;
  const int64_t len = lengths[b];
  const uint8_t* rc = codes + static_cast<int64_t>(b) * L;
  for (int s = 0; s < f.h; ++s) {
    if (p < len - (f.k + s) + 1) {
      const uint64_t slot =
          slot_of(canon_hash(rc, L, p, f, s), static_cast<uint64_t>(size), mode);
      atomicOr(words + slot, kPresent);
    }
  }
}

}  // namespace gr

extern "C" {

const char* gr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gr_seed_hash_grid(const uint8_t* codes, int64_t B, int64_t L,
                      const int* lengths, const int* fam, int T, int TL,
                      int64_t size, int mode, int64_t* slots, bool* frame_ok,
                      cudaStream_t stream) {
  const int64_t TF = static_cast<int64_t>(T) * TL;
  if (B == 0 || TF == 0) return gr::kNoLaunch;
  const dim3 grid(static_cast<unsigned>((TF + 255) / 256),
                  static_cast<unsigned>(B));
  gr::seed_hash_grid_kernel<<<grid, 256, 0, stream>>>(
      codes, L, lengths, fam, T, TL, size, mode, slots, frame_ok);
  return cudaGetLastError();
}

int gr_seed_hash_fill(const uint8_t* codes, int64_t B, int64_t L,
                      const int* lengths, const int* fam, int64_t size,
                      int mode, uint32_t* words, cudaStream_t stream) {
  if (B == 0 || L == 0) return gr::kNoLaunch;
  const dim3 grid(static_cast<unsigned>((L + 255) / 256),
                  static_cast<unsigned>(B));
  gr::seed_hash_fill_kernel<<<grid, 256, 0, stream>>>(
      codes, L, lengths, fam, size, mode, words);
  return cudaGetLastError();
}

}  // extern "C"
