// minimizer_keys (K20): the (w,k)-minimizer keys of a padded batch of
// sequences.  Replaces goldrush_tpu/ops/minimizers.py: minimizer_keys (:46)
// and _sliding_min (:31).  For every position p < P of row b the canonical
// unspaced ntHash h of codes[b, p : p+k] (codes past the row's width L read
// as A, the JAX function's zero padding), written to hashes[b, p]; its key
// (h >> 20 << 20) | p; and for every window i < P - w + 1 the unsigned
// minimum of the keys i .. i+w-1, written to keys[b, i].  Positions must
// fit the key's 20 low bits (P <= 2^20; the wrapper checks).
//
// One CTA per (row, tile of kTile windows).  The CTA stages the codes of
// its tile's kTile + w - 1 positions (and the k - 1 after them) in shared
// memory, hashes them in runs of kRun consecutive positions per thread with
// the rolling recurrence (common.cuh: NtRoll), writes the hashes it owns,
// and takes the window minimum by log-doubling in shared memory, as the
// JAX function does: m_2p[i] = min(m_p[i], m_p[i+p]) until 2p > w, then
// out[i] = min(m_p[i], m_p[i+w-p]).  That is O(log w) per window at every
// w with all threads busy; a van Herk/Gil-Werman prefix/suffix minimum is
// O(1) per window but its scans over blocks of w (1,000 for targeted
// polish) run in parallel only as segmented scans of the same log depth.
// A tile's last w - 1 positions are hashed again by the next tile.
//
// Bound: the codes in and the keys and hashes out, 17 bytes per position,
// so the device memory rate; the rolling hash is ~20 integer operations
// per position and the doubling ~3 log2(w) per window, far below it.
#include "common.cuh"

namespace gr {

constexpr int kMinThreads = 256;
constexpr int kTile = 2048;   // windows per CTA
constexpr int kRun = 16;      // positions hashed in a row by one thread
constexpr uint64_t kPosMask = (1ull << 20) - 1;

__device__ __forceinline__ uint64_t umin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kMinThreads) minimizer_keys_kernel(
    const uint8_t* __restrict__ codes, int64_t L, int64_t P, int64_t nw,
    int k, int w, int64_t* __restrict__ keys, int64_t* __restrict__ hashes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t span = static_cast<int64_t>(kTile) + w - 1;
  uint64_t* buf_a = reinterpret_cast<uint64_t*>(smem);
  uint64_t* buf_b = buf_a + span;
  uint8_t* sc = reinterpret_cast<uint8_t*>(buf_b + span);

  const int64_t b = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int n = static_cast<int>(min64(span, P - t0));   // positions hashed
  const int n_codes = n + k - 1;
  const uint8_t* row = codes + b * L;
  for (int i = threadIdx.x; i < n_codes; i += blockDim.x) {
    const int64_t g = t0 + i;
    sc[i] = g < L ? (row[g] & 3u) : 0u;
  }
  __syncthreads();

  for (int r0 = threadIdx.x * kRun; r0 < n; r0 += blockDim.x * kRun) {
    NtRoll h(k);
    h.init([&](unsigned j) { return static_cast<unsigned>(sc[r0 + j]); });
    const int end = min(r0 + kRun, n);
    for (int q = r0;; ++q) {
      buf_a[q] = h.canonical();
      if (q + 1 >= end) break;
      h.roll(sc[q], sc[q + k]);
    }
  }
  __syncthreads();

  // the hashes this tile owns: its kTile positions, or all up to P in the
  // last tile; then the keys in place
  const bool last = t0 + kTile >= nw;
  const int owned = last ? n : kTile;
  int64_t* hrow = hashes + b * P + t0;
  for (int i = threadIdx.x; i < owned; i += blockDim.x) {
    hrow[i] = static_cast<int64_t>(buf_a[i]);
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    buf_a[i] = (buf_a[i] & ~kPosMask) | static_cast<uint64_t>(t0 + i);
  }
  __syncthreads();

  uint64_t* m = buf_a;
  uint64_t* nxt = buf_b;
  int len = n, p = 1;
  while (p * 2 <= w) {
    for (int i = threadIdx.x; i < len - p; i += blockDim.x) {
      nxt[i] = umin(m[i], m[i + p]);
    }
    __syncthreads();
    uint64_t* t = m;
    m = nxt;
    nxt = t;
    len -= p;
    p *= 2;
  }
  const int n_out = static_cast<int>(min64(kTile, nw - t0));
  int64_t* krow = keys + b * nw + t0;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    krow[i] = static_cast<int64_t>(umin(m[i], m[i + w - p]));
  }
}

}  // namespace gr

extern "C" {

// codes: uint8 [B, L]; keys: int64 [B, P - w + 1]; hashes: int64 [B, P]
// (uint64 bits).  Needs w <= P <= 2^20 and k >= 1.
int gr_minimizer_keys(const uint8_t* codes, int B, int64_t L, int64_t P,
                      int k, int w, int64_t* keys, int64_t* hashes,
                      cudaStream_t stream) {
  if (B < 0 || L < 0 || k < 1 || w < 1 || P < w || P > (1 << 20))
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  const int64_t nw = P - w + 1;
  const int64_t span = static_cast<int64_t>(gr::kTile) + w - 1;
  const size_t smem = static_cast<size_t>(2 * span * 8 + span + k + 15);
  const cudaError_t e = gr::allow_smem(gr::minimizer_keys_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((nw + gr::kTile - 1) / gr::kTile),
                  static_cast<unsigned>(B));
  gr::minimizer_keys_kernel<<<grid, gr::kMinThreads, smem, stream>>>(
      codes, L, P, nw, k, w, keys, hashes);
  return cudaGetLastError();
}

}  // extern "C"
