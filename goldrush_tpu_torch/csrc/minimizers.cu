// minimizer_keys (K20): the (w,k)-minimizer keys of a padded batch of
// sequences.  Replaces goldrush_tpu/ops/minimizers.py: minimizer_keys (:46)
// and _sliding_min (:31).  For every position p < P of row b the canonical
// unspaced ntHash h of codes[b, p : p+k] (codes past the row's width L read
// as A, the JAX function's zero padding), written to hashes[b, p]; its key
// (h >> 20 << 20) | p; and for every window i < P - w + 1 the unsigned
// minimum of the keys i .. i+w-1, written to keys[b, i].  Positions must
// fit the key's 20 low bits (P <= 2^20; the wrapper checks).
//
// Bound: the codes in and the keys and hashes out, 17 bytes per position,
// over the device memory rate; the work per position (both strands' hash,
// the key, about three 64-bit mins for the window) is close behind at the
// card's integer rate, so the design keeps the work per position low and
// every global access coalesced.
//
// Design.  One CTA per (row, tile of TW windows); a tile needs the TW + w
// - 1 positions of its windows and their k - 1 codes after them.
//  1. The codes: each thread loads a run of kMinRun = 16 codes from a
//     16-byte-aligned start with one 16-byte load (zero outside the row).
//     The CTA's codes bound TW, so a tile re-does its w - 1 overlap
//     positions as a small share of them: 2,048 codes (128 threads) for a
//     small k + w, 4,096 (256) above (`min_codes`).
//  2. The hash: the prefix-XOR scan of nthash_scan.cuh.  Each thread
//     stores each entry's XOR within its run (rotated into place) and the
//     CTA the runs' carries apart, so no pass over the codes waits for a
//     carry; a thread hashes the 16 positions of its run from two reads of
//     those XORs and the carries of the two or three runs they fall in.
//     The tables are padded by runs, entry e at e + e / 16, so a quarter
//     warp's 16-byte accesses of one q of their runs, and a warp's 8-byte
//     reads of consecutive entries, spread over the banks.
//  3. The window minimum, van Herk/Gil-Werman: the tile's positions fall
//     into blocks of w from its first one; out[i] = min(suffix[i],
//     prefix[i + w - 1]), the minimum from i to the end of its block and
//     from the start of the next block to i + w - 1, O(1) per window at
//     any w.  Prefix and suffix are segmented scans (a segment is a block):
//     each thread's run gives one (segment seen, min) pair per direction as
//     it hashes, a warp scans the pairs by shuffles (a 64-bit min is two
//     32-bit shuffles and a compare), one barrier carries them between
//     warps, and each run takes its carry in registers, prefix and suffix
//     side by side.
//  4. The stores: the hashes and then prefix and suffix pass through
//     shared memory (8-byte tables, padded, in the scan's space) so that
//     the hashes and the keys leave in coalesced 16-byte stores.
// Six barriers a CTA in all, none per doubling of w.
#include "nthash_scan.cuh"

namespace gr {

constexpr int kMinRun = 16;     // codes a thread loads, positions it keys
constexpr uint64_t kPosMask = (1ull << 20) - 1;
constexpr uint64_t kNoKey = ~0ull;    // a key no window takes

__device__ __forceinline__ uint64_t umin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

struct MinArgs {
  const uint8_t* codes;
  int64_t L, P, nw, TW;
  int k, w;
  unsigned period;      // bits 0, w, 2w, ... below 32: where blocks start
  int64_t* keys;
  int64_t* hashes;
};

// The terms of the code whose bits give the masks m1 = -(c & 1), m2 =
// -(c >> 1 & 1) and m3 = m1 & m2: v(c) = v0 ^ (m1 & (v0 ^ v1)) ^ (m2 & (v0
// ^ v2)) ^ (m3 & (v0 ^ v1 ^ v2 ^ v3)), one AND-XOR with an immediate a
// 32-bit half each (the four-way select of nthash_scan.cuh's sel4 needs
// its constants in registers).
__device__ __forceinline__ uint64_t masked4(unsigned m1, unsigned m2,
                                            unsigned m3, uint64_t v0,
                                            uint64_t v1, uint64_t v2,
                                            uint64_t v3) {
  const uint64_t w1 = (static_cast<uint64_t>(m1) << 32) | m1;
  const uint64_t w2 = (static_cast<uint64_t>(m2) << 32) | m2;
  const uint64_t w3 = (static_cast<uint64_t>(m3) << 32) | m3;
  return v0 ^ (w1 & (v0 ^ v1)) ^ (w2 & (v0 ^ v2)) ^ (w3 & (v0 ^ v1 ^ v2 ^ v3));
}

// Inclusive segmented min across the warp's lanes, towards higher lanes
// (kUp: the prefix) or lower ones (the suffix).  (v, seg): the min since
// the last segment start (end) in the range, and whether there is one.
template <bool kUp>
__device__ __forceinline__ void warp_seg_min(uint64_t& v, unsigned& seg,
                                             int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint64_t ov;
    unsigned os;
    bool in;
    if constexpr (kUp) {
      ov = __shfl_up_sync(kFull, v, d);
      os = __shfl_up_sync(kFull, seg, d);
      in = lane >= d;
    } else {
      ov = __shfl_down_sync(kFull, v, d);
      os = __shfl_down_sync(kFull, seg, d);
      in = lane + d < 32;
    }
    if (in) {
      if (!seg) v = umin(v, ov);
      seg |= os;
    }
  }
}

// dst[j] = src(j) for j < n by the whole block, in 16-byte stores where
// dst + j is 16-byte aligned
template <int kThreads, typename Src>
__device__ __forceinline__ void store_pairs(int64_t* dst, int n, Src src) {
  const int tid = threadIdx.x;
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 3)
                                    & 1u);
  if (tid == 0 && lead && n > 0) dst[0] = static_cast<int64_t>(src(0));
  for (int j = lead + 2 * tid; j + 1 < n; j += 2 * kThreads)
    *reinterpret_cast<longlong2*>(dst + j) = make_longlong2(
        static_cast<long long>(src(j)), static_cast<long long>(src(j + 1)));
  if (tid == 0 && n > lead && ((n - lead) & 1))
    dst[n - 1] = static_cast<int64_t>(src(n - 1));
}

// kThreads threads, 16 codes each; as many CTAs an SM as their shared
// memory allows (6 of 128 threads, 3 of 256): at most 85 registers a
// thread
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 768 / kThreads)
    minimizer_keys_kernel(MinArgs a) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kCap = kMinRun * kThreads;     // codes a CTA scans
  // a padded table: kMinRun + 1 entries a run, the tile's total, room for
  // the reads clamped to it, and the last run's carry
  constexpr int kTable = (kMinRun + 1) * (kThreads + 1);
  __shared__ ulonglong2 wsum[kWarps];
  __shared__ uint64_t pre_v[kWarps], suf_v[kWarps];
  __shared__ unsigned pre_s[kWarps], suf_s[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // entry e of a table lives at idx(e): padded by runs
  auto idx = [](int e) { return e + (e >> 4); };
  ulonglong2* loc = reinterpret_cast<ulonglong2*>(gr_smem);
  uint64_t* pre = reinterpret_cast<uint64_t*>(gr_smem);  // after the hash
  uint64_t* suf = pre + kTable;
  const int base = (kMinRun + 1) * tid;        // idx of the run's entry 0
  // run t's carry sits in the pad after its entries (the last past the
  // tile's total)
  auto carry = [loc](int t) -> ulonglong2& {
    return loc[(kMinRun + 1) * t + kMinRun];
  };
  const int64_t b = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * a.TW;
  const int w = a.w, k = a.k;
  const int n_win = static_cast<int>(min64(a.TW, a.nw - t0));
  const int n_pos = n_win + w - 1;              // the tile's positions
  const int n_own = t0 + a.TW >= a.nw ? n_pos : n_win;   // hashes it writes
  // entry e of the tile is the code at row place r0 + e, and position
  // j = e - off of the tile (t0 + j of the row); entry 0 is 16-byte aligned
  const int64_t g0 = b * a.L + t0;
  const int off = static_cast<int>(
      (reinterpret_cast<uintptr_t>(a.codes) + g0) & 15u);
  const int64_t r0 = t0 - off;

  // the scan: this thread's run of codes, zero outside its row
  unsigned cw[kMinRun / 4];
  {
    const int64_t r = r0 + kMinRun * tid;
    const uint8_t* src = a.codes + (g0 - off) + kMinRun * tid;
    if (r >= 0 && r + kMinRun <= a.L) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      cw[0] = v.x;
      cw[1] = v.y;
      cw[2] = v.z;
      cw[3] = v.w;
    } else {
      unsigned char c[kMinRun];
#pragma unroll
      for (int q = 0; q < kMinRun; ++q)
        c[q] = r + q >= 0 && r + q < a.L ? src[q] : 0;
#pragma unroll
      for (int i = 0; i < kMinRun / 4; ++i)
        cw[i] = c[4 * i] | c[4 * i + 1] << 8 | c[4 * i + 2] << 16 |
                c[4 * i + 3] << 24;
    }
  }
  // each entry's XOR within its run, then the runs' carries
  {
    const NtRunPerm pm = nt_run_perm<kMinRun>(tid);
    uint64_t acc_s = 0, acc_r = 0;
#pragma unroll
    for (int q = 0; q < kMinRun; ++q) {
      loc[base + q] = make_ulonglong2(pm.s(acc_s), pm.r(acc_r));
      const unsigned c = nt_code<kMinRun>(cw, q);
      const unsigned m1 = 0u - (c & 1u), m2 = 0u - (c >> 1), m3 = m1 & m2;
      acc_s ^= masked4(m1, m2, m3, nt_rotl(0, 64 - q), nt_rotl(1, 64 - q),
                       nt_rotl(2, 64 - q), nt_rotl(3, 64 - q));
      acc_r ^= masked4(m1, m2, m3, nt_rotl(3, q), nt_rotl(2, q),
                       nt_rotl(1, q), nt_rotl(0, q));
    }
    const uint64_t tot_s = pm.s(acc_s), tot_r = pm.r(acc_r);
    uint64_t c_s, c_r;
    nt_run_carry<kWarps>(tot_s, tot_r, wsum, c_s, c_r);
    carry(tid) = make_ulonglong2(c_s, c_r);
    if (tid == kThreads - 1) {            // S(cap): its run past the last
      carry(kThreads) = make_ulonglong2(c_s ^ tot_s, c_r ^ tot_r);
      loc[idx(kCap)] = make_ulonglong2(0, 0);
    }
  }
  __syncthreads();

  // each thread's positions: entries e0 .. e0 + 15, position j0 + q,
  // hashed where 0 <= j < n_pos (`valid`); the blocks of w from the tile's
  // first position start (`starts`) and end (`ends`) among them
  const int e0 = kMinRun * tid;
  const int j0 = e0 - off;
  unsigned valid, starts, ends;
  {
    const int lo = max(0, -j0), hi = min(kMinRun, n_pos - j0);
    valid = hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
    int r = j0 % w;
    if (r < 0) r += w;
    const int s = r ? w - r : 0;                 // the run's first start
    const unsigned long long pat =
        s <= kMinRun ? static_cast<unsigned long long>(a.period) << s : 0;
    starts = static_cast<unsigned>(pat) & ((1u << kMinRun) - 1u);
    ends = (starts >> 1) |
           (static_cast<unsigned>(pat >> kMinRun) & 1u) << (kMinRun - 1);
  }
  // the hashes, and as they come each run's (segment seen, min) pair
  // towards each end: the min from its last block start to its end, and
  // from its start to its first block end.  Every position reads (a past
  // the tile's last k-mer, a clamped entry) so the loop has no branch.
  uint64_t h[kMinRun];
  uint64_t pv = kNoKey, sv = kNoKey;
  {
    const int dt = k / kMinRun, kq = k % kMinRun;
    const ulonglong2 c0 = carry(tid);
    const ulonglong2 c1 = carry(min(tid + dt, kThreads));
    const ulonglong2 c2 = carry(min(tid + dt + 1, kThreads));
    const uint64_t x1s = c0.x ^ c1.x, x1r = c0.y ^ c1.y;
    const uint64_t x2s = c0.x ^ c2.x, x2r = c0.y ^ c2.y;
    // entry e0 + q + k: entry q + kq of run tid + dt, or q + kq - 16 of
    // the next run; clamped to the tile's total, which only positions
    // past the tile pass (the table has room for 15 entries after it)
    const int y1 = min((kMinRun + 1) * (tid + dt) + kq, idx(kCap));
    const int y2 = min((kMinRun + 1) * (tid + dt + 1) + kq - kMinRun,
                       idx(kCap));
    const uint64_t pos0 = static_cast<uint64_t>(t0 + j0);
    bool ended = false;
#pragma unroll
    for (int q = 0; q < kMinRun; ++q) {
      const ulonglong2 x = loc[base + q];
      const bool first = q + kq < kMinRun;
      const ulonglong2 y = loc[(first ? y1 : y2) + q];
      const uint64_t fwd = rotl_var(x.x ^ y.x ^ (first ? x1s : x2s),
                                    (e0 + q + k - 1) & 63);
      const uint64_t rev = rotr_var(x.y ^ y.y ^ (first ? x1r : x2r),
                                    (e0 + q) & 63);
      h[q] = fwd < rev ? fwd : rev;
      const uint64_t key = valid >> q & 1u
          ? (h[q] & ~kPosMask) | (pos0 + q) : kNoKey;
      pv = starts >> q & 1u ? key : umin(pv, key);
      if (!ended) sv = umin(sv, key);
      ended = ended || (ends >> q & 1u);
    }
  }
  __syncthreads();   // the reads of the scan are done: its space is free

  // the window minimum: the hashes to shared memory for their stores, and
  // h becomes the run's keys; the runs' pairs scanned across the warp
  {
    const uint64_t pos0 = static_cast<uint64_t>(t0 + j0);
#pragma unroll
    for (int q = 0; q < kMinRun; ++q) {
      pre[base + q] = h[q];
      h[q] = valid >> q & 1u ? (h[q] & ~kPosMask) | (pos0 + q) : kNoKey;
    }
  }
  unsigned ps = starts != 0, ss = ends != 0;
  warp_seg_min<true>(pv, ps, lane);
  warp_seg_min<false>(sv, ss, lane);
  // each lane's carry from the lanes before (after) it
  uint64_t pc = __shfl_up_sync(kFull, pv, 1);
  unsigned pcs = __shfl_up_sync(kFull, ps, 1);
  uint64_t sc = __shfl_down_sync(kFull, sv, 1);
  unsigned scs = __shfl_down_sync(kFull, ss, 1);
  if (lane == 31) {
    pre_v[warp] = pv;
    pre_s[warp] = ps;
    sc = kNoKey;
    scs = 0;
  }
  if (lane == 0) {
    suf_v[warp] = sv;
    suf_s[warp] = ss;
    pc = kNoKey;
    pcs = 0;
  }
  __syncthreads();

  // the hashes this tile owns: its TW positions, or all up to P in the
  // last tile
  const int64_t hb = b * a.P + t0;
  store_pairs<kThreads>(a.hashes + hb, n_own,
                        [&](int j) { return pre[idx(j + off)]; });
  // the warps' carries (their loads independent)
#pragma unroll
  for (int u = kWarps - 1; u >= 0; --u) {
    if (u < warp && !pcs) {
      pc = umin(pc, pre_v[u]);
      pcs = pre_s[u];
    }
  }
#pragma unroll
  for (int u = 1; u < kWarps; ++u) {
    if (u > warp && !scs) {
      sc = umin(sc, suf_v[u]);
      scs = suf_s[u];
    }
  }
  __syncthreads();   // the hashes' reads are done
  // the prefix and the suffix of each position of the run, two chains
  // side by side
#pragma unroll
  for (int q = 0; q < kMinRun; ++q) {
    const int qs = kMinRun - 1 - q;
    pc = starts >> q & 1u ? h[q] : umin(pc, h[q]);
    sc = ends >> qs & 1u ? h[qs] : umin(sc, h[qs]);
    pre[base + q] = pc;
    suf[base + qs] = sc;
  }
  __syncthreads();
  const int64_t kb = b * a.nw + t0;
  store_pairs<kThreads>(a.keys + kb, n_win, [&](int i) {
    return umin(suf[idx(i + off)], pre[idx(i + off + w - 1)]);
  });
}

// Codes a CTA: its tile holds the k + w - 1 codes a window reads and
// re-does them as a small share of its positions (chip_smoke.py and
// tools/torch_port_minimizer_parts.py time the choice).
inline int min_codes(int k, int w) { return k + w <= 512 ? 2048 : 4096; }

// Windows a tile: its positions' codes fit the CTA's codes from a
// 16-byte-aligned start (up to 15 before the tile's first), a multiple of
// 16; 0 if not even 16 fit.
inline int64_t min_tile(int codes, int k, int w) {
  const int64_t tw = (static_cast<int64_t>(codes) - k - w - 13) / 16 * 16;
  return tw >= 16 ? tw : 0;
}

template <int kThreads>
cudaError_t launch_minimizer_keys(const MinArgs& a, int B,
                                  cudaStream_t stream) {
  // the scan's padded table (the kernel's kTable)
  const size_t smem = static_cast<size_t>(kMinRun + 1) * (kThreads + 1) * 16;
  const cudaError_t e = allow_smem(minimizer_keys_kernel<kThreads>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((a.nw + a.TW - 1) / a.TW),
                  static_cast<unsigned>(B));
  minimizer_keys_kernel<kThreads><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gr

extern "C" {

// codes: uint8 [B, L]; keys: int64 [B, P - w + 1]; hashes: int64 [B, P]
// (uint64 bits).  Needs w <= P <= 2^20, k >= 1 and k + w <= 4,067 (a
// tile's codes fit the CTA's; goldrush_tpu_torch/ops/minimizers.py
// MAX_K_PLUS_W).
int gr_minimizer_keys(const uint8_t* codes, int B, int64_t L, int64_t P,
                      int k, int w, int64_t* keys, int64_t* hashes,
                      cudaStream_t stream) {
  if (B < 0 || B > 65535 || L < 0 || k < 1 || w < 1 || P < w ||
      P > (1 << 20))
    return cudaErrorInvalidValue;
  const int codes_a_cta = gr::min_codes(k, w);
  const int64_t TW = gr::min_tile(codes_a_cta, k, w);
  if (TW == 0) return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  unsigned period = 0;
  for (int i = 0; i < 32; i += w) period |= 1u << i;
  const gr::MinArgs a{codes, L, P, P - w + 1, TW, k, w, period, keys,
                      hashes};
  return codes_a_cta == 2048 ? gr::launch_minimizer_keys<128>(a, B, stream)
                             : gr::launch_minimizer_keys<256>(a, B, stream);
}

}  // extern "C"
