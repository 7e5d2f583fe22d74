// Kernel C, the standalone launches: one warp per read of a batch, several
// reads per CTA; and gr_row_cummax, C's warp cummax alone.  The read's
// code, its design and its bound are in classify.cuh.
#include "classify.cuh"

namespace gr {

__global__ void classify_kernel(
    const int32_t* __restrict__ curr_id, const int32_t* __restrict__ cand_ids,
    const int32_t* __restrict__ cand_counts, const int32_t* __restrict__ n_tiles,
    int B, int T, int K, int threshold, int u_min, int a_max, int buf,
    int32_t* __restrict__ decision, int32_t* __restrict__ trim_start,
    int32_t* __restrict__ trim_end, int32_t* __restrict__ num_assigned,
    int32_t* __restrict__ ids, int32_t* __restrict__ bools,
    int32_t* __restrict__ ids_trace, int32_t* __restrict__ bools_trace) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  const int Tp = (T + 1) & ~1;
  unsigned char* base =
      gr_smem + static_cast<size_t>(warp) * (8 * static_cast<size_t>(Tp) +
                                             8 * static_cast<size_t>(buf));
  const int64_t row = static_cast<int64_t>(b) * T;
  const Decision d = classify_read<false>(
      curr_id + row, cand_ids + row * K, cand_counts + row * K, n_tiles[b],
      T, K, threshold, u_min, a_max, buf, base, lane, ids + row, bools + row,
      ids_trace ? ids_trace + row * 9 : nullptr,
      bools_trace ? bools_trace + row * 9 : nullptr);
  if (lane == 0) {
    decision[b] = d.decision;
    trim_start[b] = d.trim_start;
    trim_end[b] = d.trim_end;
    num_assigned[b] = d.num_assigned;
  }
}

__global__ void row_cummax_kernel(const int32_t* __restrict__ x, int R,
                                  int T, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp
  const int64_t off = static_cast<int64_t>(row) * T;
  int carry = INT_MIN;
  for (int base = 0; base < T; base += 32) {
    const int t = base + lane;
    const int m = warp_cummax(t < T ? x[off + t] : INT_MIN, carry, lane);
    if (t < T) out[off + t] = m;
    carry = __shfl_sync(kFull, m, 31);
  }
}

}  // namespace gr

extern "C" int gr_classify(
    const int32_t* curr_id, const int32_t* cand_ids, const int32_t* cand_counts,
    const int32_t* n_tiles, int B, int T, int K, int threshold, int u_min,
    int a_max, int32_t* decision, int32_t* trim_start, int32_t* trim_end,
    int32_t* num_assigned, int32_t* ids, int32_t* bools, int32_t* ids_trace,
    int32_t* bools_trace, cudaStream_t stream) {
  // per warp (one read): the id and bool rows, and a buffer of 8-byte
  // entries that stages the candidates of up to 32 tiles at a time, then
  // holds pass 7's sort keys (up to next_pow2(T))
  int t2 = 1;
  while (t2 < T) t2 <<= 1;
  const int chunk = (T < 32 ? T : 32) * K;
  const int buf = t2 > chunk ? t2 : chunk;
  const size_t per_warp = 8 * static_cast<size_t>(((T + 1) & ~1) + buf);
  if (K < 1 || T < 0 || B < 0 || per_warp > gr::kMaxSmem)
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  int warps = B < gr::kWarps ? B : gr::kWarps;
  while (warps * per_warp > gr::kMaxSmem) --warps;
  const size_t smem = warps * per_warp;
  cudaError_t err = gr::allow_smem(gr::classify_kernel, smem);
  if (err != cudaSuccess) return err;
  gr::classify_kernel<<<(B + warps - 1) / warps, 32 * warps, smem, stream>>>(
      curr_id, cand_ids, cand_counts, n_tiles, B, T, K, threshold, u_min,
      a_max, buf, decision, trim_start, trim_end, num_assigned, ids, bools,
      ids_trace, bools_trace);
  return cudaGetLastError();
}

extern "C" int gr_row_cummax(const int32_t* x, int R, int T, int32_t* out,
                             cudaStream_t stream) {
  if (R < 0 || T < 0) return cudaErrorInvalidValue;
  if (R == 0 || T == 0) return gr::kNoLaunch;
  gr::row_cummax_kernel<<<(R + gr::kWarps - 1) / gr::kWarps, 32 * gr::kWarps,
                          0, stream>>>(x, R, T, out);
  return cudaGetLastError();
}
