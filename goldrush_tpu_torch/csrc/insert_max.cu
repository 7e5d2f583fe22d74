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
// the signed maximum (red.global.max.s32) is the JAX package's uint32
// scatter-max.  Max is commutative, so the result does not depend on the
// order of the reductions; the counters are not touched.
//
// One launch per recruit of the device code the consume kernel runs for
// an insert that it did not stage (insert.cuh insert_max_loaded): one
// thread per key of the window H x (hi - lo + 1) x F, consecutive threads
// on consecutive frames of a seed, so the window read is coalesced; a
// key's seed and block by two multiply-highs, a reduction per real key.
// Bound at a 20-tile recruit of h = 3 (F = 1000): the 480 KB window in,
// one 32-byte sector per distinct key written; ~0.7 us at the card's
// rate, so a launch costs more than its bytes.
#include "insert.cuh"

namespace gr {

constexpr int kMaxThreads = 256;

template <typename Filt>
__global__ void __launch_bounds__(kMaxThreads) insert_max_kernel(
    const Banks banks, const int64_t* __restrict__ grid, int64_t TF, int F,
    int H, int64_t limit, uint32_t or_bits, int lo, int last,
    uint32_t base_id, bool trimmed, int bs) {
  insert_max_loaded(view_of<WordsOf<Filt>>(banks), grid, TF, F, H, lo,
                    last, limit, or_bits, base_id, trimmed, bs,
                    blockIdx.x * blockDim.x + threadIdx.x,
                    gridDim.x * blockDim.x);
}

}  // namespace gr

extern "C" {

// table/counts/n_banks/bank_len/remote: the bank view of the int32 table
// of >= limit entries (common.cuh make_banks; counts unused); grid: int64
// [H, TF], TF = T * F.  Launches nothing (kNoLaunch) for an empty tile
// range.
int gr_insert_max(void* const* table, void* const* counts, int n_banks,
                  int64_t bank_len, int remote, const int64_t* grid, int H,
                  int64_t TF, int F, int64_t limit, uint32_t or_bits, int lo,
                  int hi, uint32_t base_id, int trimmed, int bs,
                  cudaStream_t stream) {
  gr::Banks banks;
  // the window's entries and a block's keys are 32-bit (insert.cuh)
  if (H <= 0 || F <= 0 || TF % F || lo < 0 || bs <= 0 ||
      TF * H >= (int64_t{1} << 31) ||
      static_cast<int64_t>(F) * bs >= (int64_t{1} << 31) ||
      !gr::make_banks(table, counts, n_banks, bank_len, remote, &banks))
    return cudaErrorInvalidValue;
  const int64_t T = TF / F;
  const int64_t last = hi < T - 1 ? hi : T - 1;
  if (last < lo) return gr::kNoLaunch;
  const int64_t total = (last - lo + 1) * F * H;
  const unsigned blocks = static_cast<unsigned>(
      (total + gr::kMaxThreads - 1) / gr::kMaxThreads);
  return gr::with_view(banks, [&](auto filt) {
    gr::insert_max_kernel<decltype(filt)>
        <<<blocks, gr::kMaxThreads, 0, stream>>>(
            banks, grid, TF, F, H, limit, or_bits, lo,
            static_cast<int>(last), base_id, trimmed != 0, bs);
    return cudaGetLastError();
  });
}

}  // extern "C"
