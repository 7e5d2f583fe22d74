// Kernel A's spaced-seed ntHash (seed_hash.cu).
//
// A CTA stages the codes window it needs in shared memory, with the seed
// family's per-base constants, rotations already applied, and its care
// offsets (SeedFamily.kernel_table).  Seed s = left + s zeros + right
// factorises (ops/nthash.py):
//
//   fwd_s(p) = rol64(FL(p), s) ^ FR(p + half + s)
//   rev_s(p) = RL(p) ^ rol64(RR(p + half + s), s)
//
// so the left-half partials (FL, RL) of a position are XORed once in
// registers, the right-half ones (FR, RR) once per position into shared
// memory, and seed s then costs two loads, one rotate per strand and an
// unsigned min.
#pragma once

#include "common.cuh"

namespace gr {

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
__device__ inline void stage(const Family& f, const uint8_t* __restrict__ row,
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

}  // namespace gr
