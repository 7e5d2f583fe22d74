// Shared helpers of the goldrush_tpu_torch CUDA kernels.
//
// Filter words are uint32 bit patterns ([31] saturation, [30] presence,
// [29..0] block id) held by int32 tensors; hashes are uint64 bit patterns
// held by int64 tensors; slot and rank grids are int64.  Every kernel is
// launched through an extern "C" entry point that returns the cudaError_t
// of its launch (cudaGetLastError), so the Python wrapper raises on a
// refused one, or kNoLaunch when its inputs left nothing to launch, so the
// wrapper counts launches and not calls.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include <type_traits>

namespace gr {

constexpr int kNoLaunch = -1;
constexpr uint32_t kPresent = 0x40000000u;
constexpr uint32_t kIdMask = 0x3FFFFFFFu;
constexpr unsigned long long kSentinel64 = 0xFFFFFFFFFFFFFFFFull;
constexpr unsigned kFull = 0xFFFFFFFFu;  // all lanes of a warp

// Every kernel's dynamic shared memory.
extern __shared__ __align__(16) unsigned char gr_smem[];

// The rank of the slot at bit b of bitrank word e in the superblock whose
// base is `sup` (rank.cu's layout: the rank of the word's first slot
// within its superblock above, presence bits below), or `sentinel` if the
// slot is absent.  Kernel A's rank grid (seed_hash.cu) and kernel D's
// rank map (insert.cuh) read it.
__device__ __forceinline__ int64_t rank_in(unsigned long long e, unsigned b,
                                           unsigned long long sup,
                                           int64_t sentinel) {
  const uint32_t bits = static_cast<uint32_t>(e);
  if (!((bits >> b) & 1u)) return sentinel;
  return static_cast<int64_t>(sup + (e >> 32)) +
         __popc(bits & ((1u << b) - 1u));
}

// the most banks a filter array splits into (mibf.py MAX_BANKS)
constexpr int kMaxBanks = 8;

// The filter's id table (the direct words or the rank-indexed ids) and its
// counters as the kernels that read or write them take them: each split by
// index range into n banks of bank_len entries, key k in bank k / bank_len
// at offset k % bank_len (mibf.py Banks, bank_bounds: the banks of the
// JAX engine's model axis).  A bank is a device pointer: an allocation on
// the launching card, or peer memory on another card of the host
// (`remote`: kernels.py has checked peer access and native peer atomics,
// and the consume kernel fences such stores at system scope).  Passed by
// value.  The bank is a multiply-shift and a compare (mibf.py bank_of),
// with no 64-bit division, and the base pointer a select over constant
// indices.  The kernels take it only for n > 1: a filter of one bank
// launches them with its FlatTable (`with_view`), whose addressing is the
// kernels' before banks.
struct Banks {
  uint32_t* table[kMaxBanks];
  uint32_t* counts[kMaxBanks];
  int64_t bank_len;
  uint64_t magic;  // floor((2^64 - 1) / bank_len) + 1; 0 when n == 1
  int n;
  int remote;      // a bank lies on another card than the launching one

  __device__ __forceinline__ int bank(int64_t k) const {
    const uint64_t u = static_cast<uint64_t>(k);
    uint64_t q = __umul64hi(u, magic);
    q -= q * static_cast<uint64_t>(bank_len) > u ? 1u : 0u;
    return static_cast<int>(q);
  }
  template <bool kCounts>
  __device__ __forceinline__ uint32_t* at(int64_t k) const {
    const int b = bank(k);
    uint32_t* p = kCounts ? counts[0] : table[0];
#pragma unroll
    for (int j = 1; j < kMaxBanks; ++j)
      if (b == j) p = kCounts ? counts[j] : table[j];
    return p + (k - static_cast<int64_t>(b) * bank_len);
  }
  // the table's entry of key k, and its counter
  __device__ __forceinline__ uint32_t* word(int64_t k) const {
    return at<false>(k);
  }
  __device__ __forceinline__ uint32_t* count(int64_t k) const {
    return at<true>(k);
  }
};

// A filter of one bank: its table and counters, each one allocation.
struct FlatTable {
  uint32_t* table;
  uint32_t* counts;

  __device__ __forceinline__ uint32_t* word(int64_t k) const {
    return table + k;
  }
  __device__ __forceinline__ uint32_t* count(int64_t k) const {
    return counts + k;
  }
};

// The table alone of a filter of one bank: what a probe and insert_max
// read and write.
struct FlatWords {
  uint32_t* table;

  __device__ __forceinline__ uint32_t* word(int64_t k) const {
    return table + k;
  }
};

// The wavefront's id table and its side table (wavefront.cu: INV_BASE less
// the earliest id written at each entry), banked alike: the side table has
// the id table's shape and bounds, so key k lies in the same bank of both,
// at the same offset.  `ids` is the id table's view (its counters unused);
// `side` the side table's bank pointers.  wave_rounds takes it only for
// n > 1: a filter of one bank launches it with its FlatSide
// (`with_side_view`).
struct SideBanks {
  Banks ids;
  uint32_t* side[kMaxBanks];

  // key k's entry of the id table and of the side table: one bank
  // computation for both
  __device__ __forceinline__ void entries(int64_t k, uint32_t** word,
                                          uint32_t** side_word) const {
    const int b = ids.bank(k);
    uint32_t* p = ids.table[0];
    uint32_t* s = side[0];
#pragma unroll
    for (int j = 1; j < kMaxBanks; ++j)
      if (b == j) {
        p = ids.table[j];
        s = side[j];
      }
    const int64_t off = k - static_cast<int64_t>(b) * ids.bank_len;
    *word = p + off;
    *side_word = s + off;
  }
};

// The id table and the side table of a filter of one bank, one allocation
// each: the addressing wave_rounds had before banks.
struct FlatSide {
  uint32_t* table;
  uint32_t* side;

  __device__ __forceinline__ void entries(int64_t k, uint32_t** word,
                                          uint32_t** side_word) const {
    *word = table + k;
    *side_word = side + k;
  }
};

// The view `Tab` of the two tables, in device code.
template <typename Tab>
__device__ __forceinline__ Tab side_view_of(const SideBanks& b);
template <>
__device__ __forceinline__ FlatSide side_view_of<FlatSide>(
    const SideBanks& b) {
  return FlatSide{b.ids.table[0], b.side[0]};
}
template <>
__device__ __forceinline__ SideBanks side_view_of<SideBanks>(
    const SideBanks& b) {
  return b;
}

// Call launch(view) with the two tables' view: their FlatSide for one
// bank, else the SideBanks.
template <typename Launch>
__host__ cudaError_t with_side_view(const SideBanks& b, Launch launch) {
  if (b.ids.n == 1) return launch(FlatSide{b.ids.table[0], b.side[0]});
  return launch(b);
}

// The view of the table alone that goes with a filter's view `Filt`.
template <typename Filt>
using WordsOf =
    std::conditional_t<std::is_same<Filt, FlatTable>::value, FlatWords, Filt>;

// The view `Filt` of a filter's Banks, in device code: its first bank's
// pointers as a FlatTable (or FlatWords), or the Banks.
template <typename Filt>
__device__ __forceinline__ Filt view_of(const Banks& b);
template <>
__device__ __forceinline__ FlatTable view_of<FlatTable>(const Banks& b) {
  return FlatTable{b.table[0], b.counts[0]};
}
template <>
__device__ __forceinline__ FlatWords view_of<FlatWords>(const Banks& b) {
  return FlatWords{b.table[0]};
}
template <>
__device__ __forceinline__ Banks view_of<Banks>(const Banks& b) {
  return b;
}

// Call launch(view) with the filter's view: its FlatTable for one bank,
// else the Banks.  Kernels are templates on the view, so a filter of one
// bank runs the code it ran before banks.
template <typename Launch>
__host__ cudaError_t with_view(const Banks& b, Launch launch) {
  if (b.n == 1) return launch(FlatTable{b.table[0], b.counts[0]});
  return launch(b);
}

// The host side of a launch: the view of n banks from the pointer tables a
// wrapper passes (kernels.py banks_args; `counts` may be null), or false
// for one the kernels cannot take.
inline bool make_banks(void* const* table, void* const* counts, int n,
                       int64_t bank_len, int remote, Banks* out) {
  if (!table || n < 1 || n > kMaxBanks || bank_len < (n > 1 ? 2 : 0))
    return false;
  Banks b{};
  for (int j = 0; j < n; ++j) {
    b.table[j] = static_cast<uint32_t*>(table[j]);
    b.counts[j] = counts ? static_cast<uint32_t*>(counts[j]) : nullptr;
    if (!b.table[j]) return false;
  }
  b.bank_len = bank_len;
  b.magic = n > 1 ? ~0ull / static_cast<uint64_t>(bank_len) + 1u : 0u;
  b.n = n;
  b.remote = remote;
  *out = b;
  return true;
}

// The host side of the wavefront's view: the id table's banks (make_banks)
// and the side table's bank pointers, banked alike; false for a view the
// kernel cannot take.
inline bool make_side_banks(void* const* table, void* const* side, int n,
                            int64_t bank_len, int remote, SideBanks* out) {
  SideBanks s{};
  if (!side || !make_banks(table, nullptr, n, bank_len, remote, &s.ids))
    return false;
  for (int j = 0; j < n; ++j) {
    s.side[j] = static_cast<uint32_t*>(side[j]);
    if (!s.side[j]) return false;
  }
  *out = s;
  return true;
}

// A load of memory that another CTA of the same launch may have written
// (`kCoherent`, the fused consume kernel: through L2, never from a stale L1
// line; a grid barrier orders the write before it), or a plain load (the
// standalone kernels, whose read-only inputs the compiler sees through
// their const __restrict__ parameters).
template <bool kCoherent, typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// `load`, with the standalone path through the read-only data cache
// (ld.global.nc).  Kernel C's standalone launch reads its vote table so,
// kernel B's gathers do not: the choice that kept each within 2% of its
// time before the two shared their code with the consume kernel
// (chip_smoke.py --ab on an H100).
template <bool kCoherent, typename V>
__device__ __forceinline__ V load_ro(const V* p) {
  if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

// `load_ro`, or a plain load of `p` in shared memory (kShared: a table
// its CTA staged there).
template <bool kCoherent, bool kShared, typename V>
__device__ __forceinline__ V load_src(const V* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return load_ro<kCoherent>(p);
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint64_t rol64(uint64_t x, unsigned r) {
  r &= 63u;
  return r ? (x << r) | (x >> (64u - r)) : x;
}

__device__ __forceinline__ uint64_t ror64(uint64_t x, unsigned r) {
  return rol64(x, 64u - (r & 63u));
}

// In-block ascending bitonic sort of n (a power of two) keys; every thread
// of the block calls it, and it ends with a barrier.
template <typename K>
__device__ void block_bitonic_sort(K* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const K x = a[i], y = a[p];
          const bool up = (i & k) == 0;
          if (up ? (x > y) : (x < y)) {
            a[i] = y;
            a[p] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// block_bitonic_sort of n (a power of two) <= blockDim.x keys, one per
// thread in a register: the exchanges within a warp are shuffles, only the
// wider ones go through `a`, so a sort of 512 keys crosses 10 barriers, not
// 45.  Every thread of the block calls it; it ends with a barrier.
template <typename K>
__device__ void block_bitonic_sort_small(K* a, int n) {
  const int t = threadIdx.x;
  K x = t < n ? a[t] : a[0];
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      K y;
      if (j >= 32) {
        __syncthreads();
        if (t < n) a[t] = x;
        __syncthreads();
        y = t < n ? a[t ^ j] : x;
      } else {
        y = __shfl_xor_sync(kFull, x, j);
      }
      // the lower of a pair keeps the min in an ascending run
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      x = keep_min ? (y < x ? y : x) : (y < x ? x : y);
    }
  }
  __syncthreads();
  if (t < n) a[t] = x;
  __syncthreads();
}

// Raise a kernel's dynamic shared memory cap when it needs more than the
// default 48 KB (a no-op below that).
template <typename Kern>
__host__ cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gr
