// The two inserts' device code: kernel D (the exact reservoir insert,
// launched alone by insert_sorted.cu, whose note gives its design and
// bound) and insert_max (the throughput mode's max-id-wins insert,
// insert_max.cu), run as they are by the fused consume kernel (consume.cu).
#pragma once

#include "common.cuh"

namespace gr {

// The CTA (of `parts`) that owns key k (mibf.py insert_part): a hash of
// its low 32 bits, so keys that differ only at or above bit 32 (ranks of a
// filter with more than 2^32 present slots) may share a CTA, which tells
// them apart by the whole key.
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

// Kernel D's sort entry of the window entry `key` (below 2^48, which the
// wrappers check) at grid column c: key << 16 | m, m = (c / F - lo) / bs
// the tile's block.
__device__ __forceinline__ uint64_t insert_entry(int64_t key, int c, int F,
                                                 int lo, int bs) {
  return (static_cast<uint64_t>(key) << 16) |
         static_cast<uint64_t>((c / F - lo) / bs);
}

// Kernel D's second half in one CTA, every thread calling it: the CTA owns
// part `part` of `parts` and has appended its first min(n, cap) entries to
// `buf` (`cap` shared-memory entries, a power of two).  A CTA owning more
// takes a power-of-two slice of `spill_data` (allocated by `spill_count`)
// and streams the window again into it, counting in the shared `fill`.
// The entries are sorted, and one thread per distinct key walks its run
// and writes counts[key] once and the word at most once.  In the fused
// consume kernel (kFused) the counters, which its reset writes from other
// CTAs, are read through L2.
template <bool kFused>
__device__ void insert_owned(uint32_t* words, uint32_t* counts,
                             const int64_t* __restrict__ slots, int H,
                             int64_t TF, int F, int64_t limit,
                             uint32_t or_bits, int lo, int c0, int nf,
                             uint32_t base, int trimmed, int bs,
                             uint32_t part, uint32_t parts, uint64_t* buf,
                             int n, int cap, int* fill,
                             unsigned long long* spill_count,
                             uint64_t* spill_data) {
  __shared__ uint64_t* spill;
  if (n == 0) return;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  if (n2 > cap) {
    // overflow: a power-of-two slice of the global scratch buffer
    __syncthreads();
    if (threadIdx.x == 0) {
      *fill = 0;
      spill = spill_data +
              atomicAdd(spill_count, static_cast<unsigned long long>(n2));
    }
    __syncthreads();
    buf = spill;
    stream_window(slots, H, TF, c0, nf, threadIdx.x, blockDim.x,
                  [&](int64_t key, int c) {
                    if (key < 0 || key >= limit || part_of(key, parts) != part)
                      return;
                    buf[atomicAdd(fill, 1)] = insert_entry(key, c, F, lo, bs);
                  });
  }
  for (int i = n + threadIdx.x; i < n2; i += blockDim.x) buf[i] = kSentinel64;
  __syncthreads();
  block_bitonic_sort(buf, n2);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t key = buf[i] >> 16;
    if (i > 0 && buf[i - 1] >> 16 == key) continue;
    uint32_t before;
    if constexpr (kFused) {
      before = __ldcg(counts + key);
    } else {
      before = counts[key];
    }
    uint32_t j = 0, id_won = 0;
    bool won = false;
    for (int k = i; k < n && buf[k] >> 16 == key; ++k) {
      if (k > i && buf[k] == buf[k - 1]) continue;
      const uint32_t m = static_cast<uint32_t>(buf[k] & 0xFFFFu);
      const uint32_t b = static_cast<uint32_t>(bs);
      const uint32_t id = base + (trimmed ? (m * b + 1u) / b : m);
      const uint32_t cnt = before + ++j;
      // the accept rule keys on the key's low 32 bits, as the JAX
      // package's u32(rank) ^ id does
      if ((static_cast<uint32_t>(key) ^ id) % (cnt ? cnt : 1u) == cnt - 1u) {
        won = true;
        id_won = id;
      }
    }
    counts[key] = before + j;
    if (won) words[key] = or_bits | id_won;
  }
}

// Kernel D over the CTAs of a grid, every thread of every CTA calling it:
// CTA blockIdx.x owns the keys part_of gives it among gridDim.x.  It
// streams the recruit's whole window (the columns of tiles lo.. of every
// seed row, nf of them) from L2, appends the entries it owns to `buf`
// (`cap` shared-memory entries; the count in the shared `fill`) and hands
// them to insert_owned, which spills past `cap` through `spill_count`.
template <bool kFused>
__device__ void insert_window(uint32_t* words, uint32_t* counts,
                              const int64_t* __restrict__ slots, int H,
                              int64_t TF, int F, int64_t limit,
                              uint32_t or_bits, int lo, int nf,
                              uint32_t base, int trimmed, int bs,
                              uint64_t* buf, int cap, int* fill,
                              unsigned long long* spill_count,
                              uint64_t* spill_data) {
  const int c0 = lo * F;
  if (threadIdx.x == 0) *fill = 0;
  __syncthreads();
  stream_window(slots, H, TF, c0, nf, threadIdx.x, blockDim.x,
                [&](int64_t key, int c) {
                  if (key < 0 || key >= limit ||
                      part_of(key, gridDim.x) != blockIdx.x)
                    return;
                  const int j = atomicAdd(fill, 1);
                  if (j < cap) buf[j] = insert_entry(key, c, F, lo, bs);
                });
  __syncthreads();
  insert_owned<kFused>(words, counts, slots, H, TF, F, limit, or_bits, lo,
                       c0, nf, base, trimmed, bs, blockIdx.x, gridDim.x, buf,
                       *fill, cap, fill, spill_count, spill_data);
}

// insert_max for the window entry e of a recruit: e / window is its seed
// row of the grid [H, TF], e % window its column from tile lo.  A key below
// `limit` raises table[key] to or_bits | its block id.
__device__ __forceinline__ void insert_max_entry(
    int* table, const int64_t* __restrict__ grid, int64_t TF, int F,
    int64_t limit, uint32_t or_bits, int lo, int64_t window, int64_t e,
    uint32_t base_id, bool trimmed, int bs) {
  const int64_t s = e / window;
  const int64_t col = static_cast<int64_t>(lo) * F + e % window;
  const int64_t key = grid[s * TF + col];
  if (key < 0 || key >= limit) return;
  const uint32_t m = static_cast<uint32_t>(col / F - lo) / bs;
  const uint32_t id = base_id + (trimmed ? (m * bs + 1) / bs : m);
  atomicMax(table + key, static_cast<int>(or_bits | id));
}

}  // namespace gr
