// The canonical unspaced ntHash of every k-mer of a CTA's codes from one
// prefix-XOR scan, shared by kmer_count.cu (K21) and minimizers.cu (K20).
//
// The unspaced ntHash is a difference of two prefix XORs.  Over the codes
// c_i from an origin t0 (i counted from t0),
//   S(n) = XOR_{i<n} ror64(TAB[c_i], i),  R(n) = XOR_{i<n} rol64(TAB[c_i^3], i)
//   fwd(p) = rol64(S(p+k) ^ S(p), p+k-1),  rev(p) = ror64(R(p+k) ^ R(p), p)
// (rotations mod 64; tests/test_torch_kmer_scan.py and
// tests/test_torch_minimizer_scan.py hold this and the kernels' arithmetic
// to the JAX functions).  So one scan of a CTA's codes gives every k-mer's
// hash from two reads of (S, R): no serial roll, no hash rebuilt from
// nothing.
//
// The scan: each thread takes a run of kRun codes that starts at a
// multiple of kRun from t0, so its terms are the constants rotated by q <
// kRun (immediates picked by the code's two bits) XORed in registers, then
// rotated by a multiple of 8 bits, a byte permutation; a warp scan
// (__shfl_up_sync) and the warp totals give each run its carry, the XOR of
// the runs before it.  `nt_prefix_scan` stores S and R whole (K21); K20
// stores each entry's XOR within its run and the runs' carries apart, and
// adds the carries as it hashes (minimizers.cu).
//
// Device functions defined in a header are `inline`: two objects that
// include it link into one library.
#pragma once

#include "common.cuh"

namespace gr {

// a rotation by r < 64 as a swap and two funnel shifts (common.cuh's rol64
// shifts 64-bit values and tests r = 0)
__device__ __forceinline__ uint64_t rotl_var(uint64_t x, unsigned r) {
  unsigned lo = static_cast<unsigned>(x), hi = static_cast<unsigned>(x >> 32);
  if (r & 32u) {
    const unsigned t = lo;
    lo = hi;
    hi = t;
  }
  const unsigned nh = __funnelshift_l(lo, hi, r);
  const unsigned nl = __funnelshift_l(hi, lo, r);
  return (static_cast<uint64_t>(nh) << 32) | nl;
}

__device__ __forceinline__ uint64_t rotr_var(uint64_t x, unsigned r) {
  return rotl_var(x, (64u - r) & 63u);
}

// ntHash's per-base constant of base code c (A=0 C=1 G=2 T=3; its
// complement's is c ^ 3) rotated left by r, for the compiler to fold into
// immediates
__host__ __device__ constexpr uint64_t nt_rotl(int c, unsigned r) {
  const uint64_t x = c == 0   ? 0x3C8BFBB395C60474ull
                     : c == 1 ? 0x3193C18562A02B4Cull
                     : c == 2 ? 0x20323ED082572324ull
                              : 0x295549F54BE24456ull;
  return r % 64 ? (x << (r % 64)) | (x >> (64 - r % 64)) : x;
}

// one of four values by the low two bits of c
__device__ __forceinline__ uint64_t sel4(unsigned c, uint64_t v0, uint64_t v1,
                                         uint64_t v2, uint64_t v3) {
  const uint64_t x = c & 1u ? v1 : v0, y = c & 1u ? v3 : v2;
  return c & 2u ? y : x;
}

// x with its bytes permuted by two __byte_perm selectors (a rotation by a
// multiple of 8 bits)
__device__ __forceinline__ uint64_t perm64(uint64_t x, unsigned lo,
                                           unsigned hi) {
  const unsigned a = static_cast<unsigned>(x);
  const unsigned b = static_cast<unsigned>(x >> 32);
  return (static_cast<uint64_t>(__byte_perm(a, b, hi)) << 32) |
         __byte_perm(a, b, lo);
}

// where entry i of S and R lives in shared memory: the 8 runs of a quarter
// warp store entry q of their runs, kRun entries apart, to distinct banks
template <int kRun>
__device__ __forceinline__ int nt_swz(int i) {
  static_assert(kRun == 8 || kRun == 16, "a run is 8 or 16 codes");
  return i ^ ((i >> (kRun == 8 ? 3 : 4)) & 7);
}

// The terms of code c at offset q < kRun of its run, before the run's
// rotation: ror64(TAB[c], q) and rol64(TAB[c ^ 3], q).
__device__ __forceinline__ uint64_t nt_term_s(unsigned c, int q) {
  return sel4(c, nt_rotl(0, 64 - q), nt_rotl(1, 64 - q), nt_rotl(2, 64 - q),
              nt_rotl(3, 64 - q));
}

__device__ __forceinline__ uint64_t nt_term_r(unsigned c, int q) {
  return sel4(c, nt_rotl(3, q), nt_rotl(2, q), nt_rotl(1, q), nt_rotl(0, q));
}

// Code q of a run packed one per byte (low two bits read).
template <int kRun>
__device__ __forceinline__ unsigned nt_code(const unsigned (&cw)[kRun / 4],
                                            int q) {
  return (cw[q >> 2] >> (8 * (q & 3))) & 3u;
}

// A run of kRun codes starts at entry kRun * t, so its terms' rotations are
// kRun * t + q: the constants rotated by q, then the run's XORs rotated by
// kRun * t mod 64 bits, a byte permutation by these selectors.
struct NtRunPerm {
  unsigned ror_lo, ror_hi, rol_lo, rol_hi;

  // the run's XORs (S's, R's) rotated into place
  __device__ __forceinline__ uint64_t s(uint64_t x) const {
    return perm64(x, ror_lo, ror_hi);
  }
  __device__ __forceinline__ uint64_t r(uint64_t x) const {
    return perm64(x, rol_lo, rol_hi);
  }
};

template <int kRun>
__device__ __forceinline__ NtRunPerm nt_run_perm(int t) {
  const unsigned m8 = ((t * (kRun / 8)) & 7) * 0x1111u;
  return {(0x3210u + m8) & 0x7777u, (0x7654u + m8) & 0x7777u,
          (0xBA98u - m8) & 0x7777u, (0xFEDCu - m8) & 0x7777u};
}

// The XOR of the runs before this thread's in the block (its carry, into
// c_s and c_r), from each run's rotated total: a warp scan
// (__shfl_up_sync) and the warps' totals in wsum (one entry a warp; kWarps
// bounds the block's warps).  Every thread of the block calls it; it holds
// one barrier.
template <int kWarps>
__device__ __forceinline__ void nt_run_carry(uint64_t tot_s, uint64_t tot_r,
                                             ulonglong2* wsum, uint64_t& c_s,
                                             uint64_t& c_r) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t w_s = tot_s, w_r = tot_r;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t x_s = __shfl_up_sync(kFull, w_s, d);
    const uint64_t x_r = __shfl_up_sync(kFull, w_r, d);
    if (lane >= d) {
      w_s ^= x_s;
      w_r ^= x_r;
    }
  }
  if (lane == 31) wsum[warp] = make_ulonglong2(w_s, w_r);
  __syncthreads();
  c_s = w_s ^ tot_s;
  c_r = w_r ^ tot_r;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w) {
    if (w < warp) {
      c_s ^= wsum[w].x;
      c_r ^= wsum[w].y;
    }
  }
}

// S and R of the block's codes: thread t of kThreads passes its run of
// kRun codes (entries kRun * t .. kRun * t + kRun - 1 from the origin,
// packed one per byte in cw), and sr[nt_swz<kRun>(i)] receives (S(i),
// R(i)) for every i <= kRun * kThreads, each run's inclusive XORs held in
// registers until its carry is known.  wsum holds one entry per warp.
// Every thread of the block calls it; it ends with a barrier.
template <int kRun, int kThreads>
__device__ void nt_prefix_scan(const unsigned (&cw)[kRun / 4],
                               ulonglong2* sr, ulonglong2* wsum) {
  const int tid = threadIdx.x;
  const NtRunPerm pm = nt_run_perm<kRun>(tid);
  uint64_t inc_s[kRun], inc_r[kRun];
  uint64_t acc_s = 0, acc_r = 0;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const unsigned c = nt_code<kRun>(cw, q);
    acc_s ^= nt_term_s(c, q);
    acc_r ^= nt_term_r(c, q);
    inc_s[q] = acc_s;
    inc_r[q] = acc_r;
  }
  const uint64_t tot_s = pm.s(acc_s), tot_r = pm.r(acc_r);
  uint64_t c_s, c_r;
  nt_run_carry<kThreads / 32>(tot_s, tot_r, wsum, c_s, c_r);
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    sr[nt_swz<kRun>(kRun * tid + q)] = q == 0
        ? make_ulonglong2(c_s, c_r)
        : make_ulonglong2(c_s ^ pm.s(inc_s[q - 1]), c_r ^ pm.r(inc_r[q - 1]));
  if (tid == kThreads - 1)
    sr[nt_swz<kRun>(kRun * kThreads)] =
        make_ulonglong2(c_s ^ tot_s, c_r ^ tot_r);
  __syncthreads();
}

// The canonical hash of the k-mer at entry j from x = (S(j), R(j)) and
// y = (S(j + k), R(j + k)).
__device__ __forceinline__ uint64_t nt_scan_hash(ulonglong2 x, ulonglong2 y,
                                                 int j, int k) {
  const uint64_t fwd = rotl_var(x.x ^ y.x, (j + k - 1) & 63);
  const uint64_t rev = rotr_var(x.y ^ y.y, j & 63);
  return fwd < rev ? fwd : rev;
}

}  // namespace gr
