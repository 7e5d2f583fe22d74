// Kernel D: exact reservoir insert of one recruit's tile blocks, the key
// space partitioned across the SMs.
//
// Replaces build_insert_keys + insert_read_sorted (goldrush_tpu/mibf/
// mibf.py:524-634) and their rank-keyed twins (compressed.py:398-476) with
// the semantics of MIBFConstructSupport.hpp:247-283 and process_read
// (goldrush_path.cpp:983-994, :1041-1053).  The grid holds slots (direct
// filter: real iff < size, the word becomes PRESENT | id) or ranks
// (compressed filter: real iff < the sentinel rank, the rank-indexed id
// becomes id); `limit` and `or_bits` say which.  Below, "key" stands for
// either.
//
// A key's result depends on that key's own occurrences only: its j-th
// distinct block m (ascending, j from 1) sees the counter
// cnt = counts[key] + j (u32) and accepts iff
// (u32(key) ^ id_m) % max(cnt, 1) == cnt - 1, and the last accepting
// block's id wins.  The JAX version recovers j and the last accepting block
// with segmented scans over the read's sorted (key << 16 | tile) list.
// Here every key belongs to one of gridDim.x CTAs, part(key) = a
// multiplicative hash of the key scaled to [0, gridDim.x) (a hash, since
// present ranks may fill only the low end of [0, limit)), so CTAs share no
// key and need no order between them, and one launch covers every block of
// the recruit:
//   1. the CTAs of a thread-block cluster split the window
//      grid[:, lo*F : (hi+1)*F] between them (16-byte loads where aligned)
//      and append each entry owned by a CTA of the cluster to that CTA's
//      shared memory (distributed shared memory) as (key << 16 | m),
//      m = (t - lo) / bs;
//   2. each CTA sorts its entries (bitonic, in shared memory): a key's
//      entries become one run in ascending m, repeated (key, m) side by
//      side;
//   3. one thread per distinct key walks its run, skips repeated (key, m),
//      and writes counts[key] once and the word at most once.
// Exact for any input: a CTA owning more entries than its shared memory
// holds (a read whose repeated k-mers pile onto few keys) takes a slice of
// the wrapper's global scratch buffer, streams the whole window again into
// it and sorts there.  Slices are power-of-two sized, so all of them
// together take less than twice the window.
//
// Bound.  Each cluster reads the whole window from L2: H * nf * 8 bytes,
// 480 KB for a 20-tile recruit at the defaults, so gridDim.x / cluster
// times that in all (~16 MB at 264 CTAs in clusters of 8).  Each distinct
// key then costs ~2 random read-modify-writes into the 570 MB words/counts
// (or the 251 MB rank tables).  The one-SM bound of a single CTA sorting
// block after block is gone: every SM holds a share of the keys, and the
// read-modify-writes of all of them are in flight at once.  On an H100
// (700 W) a 20-tile recruit takes ~0.028 ms at the wrapper's launch shape:
// ~30% the window read, ~33% the appends across the cluster, ~30% the
// sort, the rest the read-modify-writes.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace gr {

extern __shared__ __align__(16) unsigned char gr_smem[];

// The CTA (of `parts`) that owns key k < 2^32 (mibf.py insert_part).
__device__ __forceinline__ uint32_t part_of(int64_t k, uint32_t parts) {
  return __umulhi(static_cast<uint32_t>(k) * 0x9E3779B1u, parts);
}

// Call sink(key, column) for the window entries q = first, first + step,
// ... of every seed row, with 16-byte loads when the rows allow them.
template <typename Sink>
__device__ void stream_window(const int64_t* __restrict__ slots, int H,
                              int64_t TF, int c0, int nf, int first, int step,
                              Sink sink) {
  const bool pairs =
      ((TF | c0 | nf) & 1) == 0 &&
      (reinterpret_cast<uintptr_t>(slots) & 15) == 0;
  for (int s = 0; s < H; ++s) {
    const int64_t* row = slots + s * TF + c0;
    if (pairs) {
      const longlong2* row2 = reinterpret_cast<const longlong2*>(row);
#pragma unroll 4
      for (int q = first; q < nf / 2; q += step) {
        const longlong2 v = row2[q];
        sink(v.x, c0 + 2 * q);
        sink(v.y, c0 + 2 * q + 1);
      }
    } else {
      for (int q = first; q < nf; q += step) sink(row[q], c0 + q);
    }
  }
}

__global__ void __launch_bounds__(1024)
insert_sorted_kernel(uint32_t* __restrict__ words,
                     uint32_t* __restrict__ counts,
                     const int64_t* __restrict__ slots, int H, int64_t TF,
                     int F, int64_t limit, uint32_t or_bits, int lo, int hi,
                     uint32_t base, int trimmed, int bs, int cap,
                     unsigned long long* scratch) {
  __shared__ int fill;
  __shared__ uint64_t* spill;
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t parts = gridDim.x;
  const uint32_t cs = cluster.num_blocks();
  const uint32_t p0 = blockIdx.x - cluster.block_rank();  // cluster's first
  const int c0 = lo * F;
  const int nf = max(0, min(hi, static_cast<int>(TF / F) - 1) - lo + 1) * F;
  auto pack = [&](int64_t key, int c) {
    return (static_cast<uint64_t>(key) << 16) |
           static_cast<uint64_t>((c / F - lo) / bs);
  };
  uint64_t* buf = reinterpret_cast<uint64_t*>(gr_smem);
  if (threadIdx.x == 0) fill = 0;
  cluster.sync();
  stream_window(
      slots, H, TF, c0, nf, cluster.block_rank() * blockDim.x + threadIdx.x,
      cs * blockDim.x, [&](int64_t key, int c) {
        if (key < 0 || key >= limit) return;
        const uint32_t r = part_of(key, parts) - p0;
        if (r >= cs) return;
        const int i = atomicAdd(cluster.map_shared_rank(&fill, r), 1);
        if (i < cap) cluster.map_shared_rank(buf, r)[i] = pack(key, c);
      });
  cluster.sync();  // every append into this CTA has landed
  const int n = fill;
  if (n == 0) return;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  if (n2 > cap) {
    // overflow: a power-of-two slice of the global scratch buffer
    __syncthreads();
    if (threadIdx.x == 0) {
      fill = 0;
      spill = reinterpret_cast<uint64_t*>(scratch + 1 + atomicAdd(
          scratch, static_cast<unsigned long long>(n2)));
    }
    __syncthreads();
    buf = spill;
    stream_window(slots, H, TF, c0, nf, threadIdx.x, blockDim.x,
                  [&](int64_t key, int c) {
                    if (key < 0 || key >= limit ||
                        part_of(key, parts) != blockIdx.x)
                      return;
                    buf[atomicAdd(&fill, 1)] = pack(key, c);
                  });
  }
  for (int i = n + threadIdx.x; i < n2; i += blockDim.x) buf[i] = kSentinel64;
  __syncthreads();
  block_bitonic_sort(buf, n2);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t key = static_cast<uint32_t>(buf[i] >> 16);
    if (i > 0 && static_cast<uint32_t>(buf[i - 1] >> 16) == key) continue;
    const uint32_t before = counts[key];
    uint32_t j = 0, id_won = 0;
    bool won = false;
    for (int k = i; k < n && static_cast<uint32_t>(buf[k] >> 16) == key;
         ++k) {
      if (k > i && buf[k] == buf[k - 1]) continue;
      const uint32_t m = static_cast<uint32_t>(buf[k] & 0xFFFFu);
      const uint32_t b = static_cast<uint32_t>(bs);
      const uint32_t id = base + (trimmed ? (m * b + 1u) / b : m);
      const uint32_t cnt = before + ++j;
      if ((key ^ id) % (cnt ? cnt : 1u) == cnt - 1u) {
        won = true;
        id_won = id;
      }
    }
    counts[key] = before + j;
    if (won) words[key] = or_bits | id_won;
  }
}

}  // namespace gr

extern "C" int gr_insert_sorted(uint32_t* words, uint32_t* counts,
                                const int64_t* slots, int H, int64_t TF, int F,
                                int64_t limit, uint32_t or_bits, int lo, int hi,
                                uint32_t base, int trimmed, int bs, int parts,
                                int cluster, int threads, int cap,
                                unsigned long long* scratch,
                                cudaStream_t stream) {
  if (F <= 0 || bs <= 0 || TF % F || lo < 0 || limit < 0 || parts <= 0 ||
      cluster <= 0 || parts % cluster || threads <= 0 || threads > 1024 ||
      cap <= 0 || (cap & (cap - 1)))
    return cudaErrorInvalidValue;
  if (hi < lo) return gr::kNoLaunch;
  const int64_t window =
      static_cast<int64_t>(H) *
      std::max<int64_t>(0, std::min<int64_t>(hi, TF / F - 1) - lo + 1) * F;
  // without scratch no CTA may own more than `cap` entries
  if (!scratch && window > cap) return cudaErrorInvalidValue;
  cudaError_t err;
  if (scratch) {
    err = cudaMemsetAsync(scratch, 0, sizeof(*scratch), stream);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = static_cast<size_t>(cap) * sizeof(uint64_t);
  err = gr::allow_smem(gr::insert_sorted_kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gr::insert_sorted_kernel, words, counts,
                           slots, H, TF, F, limit, or_bits, lo, hi, base,
                           trimmed, bs, cap, scratch);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
