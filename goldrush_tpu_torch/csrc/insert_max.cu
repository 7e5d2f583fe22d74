// insert_max (K15): the throughput mode's max-id-wins insert of one
// recruit, in either filter.  Replaces goldrush_tpu/mibf/mibf.py:
// insert_read_max (:638) and mibf/compressed.py: insert_read_max (:480) /
// insert_ranks_max (:536): over the recruit's full-resolution insert grid
// [H, T*F] (seed-major), every entry of tiles lo..hi below `limit` raises
// table[key] to or_bits | id, id the entry's block id: base + m, or
// base + (m*bs + 1) / bs when trimmed, m = (tile - lo) / bs.
//
//   direct filter:     keys are slots, limit = size, or_bits = PRESENT;
//   compressed filter: keys are ranks, limit = the sentinel rank,
//                      or_bits = 0 (bare ids in the rank-indexed table).
//
// The table's words hold no saturation bit and ids stay below 2^30 (the
// wrapper checks base + blocks), so every value is a non-negative int32 and
// the signed atomicMax takes the same maximum as the JAX package's uint32
// scatter-max.  Max is commutative, so the result does not depend on the
// order of the atomics; the counters are not touched.
//
// One launch per recruit, one thread per entry of the window
// H x (hi - lo + 1) x F, consecutive threads on consecutive frames of a
// seed, so the window read is coalesced.  Bound at a 20-tile recruit of
// h = 3 (F = 1000): the 480 KB window in, one 32-byte sector per distinct
// key written; ~1 us at the card's rate, so a launch costs more than its
// bytes.
#include "common.cuh"

namespace gr {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads) insert_max_kernel(
    int* __restrict__ table, const int64_t* __restrict__ grid, int64_t TF,
    int F, int64_t limit, uint32_t or_bits, int lo, int64_t window,
    int64_t total, uint32_t base_id, bool trimmed, int bs) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= total) return;
  const int64_t s = e / window;
  const int64_t col = static_cast<int64_t>(lo) * F + e % window;
  const int64_t key = grid[s * TF + col];
  if (key < 0 || key >= limit) return;
  const uint32_t m = static_cast<uint32_t>(col / F - lo) / bs;
  const uint32_t id = base_id + (trimmed ? (m * bs + 1) / bs : m);
  atomicMax(table + key, static_cast<int>(or_bits | id));
}

}  // namespace gr

extern "C" {

// table: int32 [>= limit]; grid: int64 [H, TF], TF = T * F.  Launches
// nothing (kNoLaunch) for an empty tile range.
int gr_insert_max(int* table, const int64_t* grid, int H, int64_t TF, int F,
                  int64_t limit, uint32_t or_bits, int lo, int hi,
                  uint32_t base_id, int trimmed, int bs,
                  cudaStream_t stream) {
  if (H <= 0 || F <= 0 || TF % F || lo < 0 || bs <= 0)
    return cudaErrorInvalidValue;
  const int64_t T = TF / F;
  const int64_t last = hi < T - 1 ? hi : T - 1;
  if (last < lo) return gr::kNoLaunch;
  const int64_t window = (last - lo + 1) * F;
  const int64_t total = window * H;
  const unsigned blocks = static_cast<unsigned>(
      (total + gr::kMaxThreads - 1) / gr::kMaxThreads);
  gr::insert_max_kernel<<<blocks, gr::kMaxThreads, 0, stream>>>(
      table, grid, TF, F, limit, or_bits, lo, window, total, base_id,
      trimmed != 0, bs);
  return cudaGetLastError();
}

}  // extern "C"
