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

namespace gr {

constexpr int kNoLaunch = -1;
constexpr uint32_t kPresent = 0x40000000u;
constexpr uint32_t kIdMask = 0x3FFFFFFFu;
constexpr unsigned long long kSentinel64 = 0xFFFFFFFFFFFFFFFFull;
constexpr unsigned kFull = 0xFFFFFFFFu;  // all lanes of a warp

// Every kernel's dynamic shared memory.
extern __shared__ __align__(16) unsigned char gr_smem[];

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

struct AddOp {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return a + b;
  }
};

// Block-wide exclusive scan of one value per thread: thread t gets
// op(v_0, ..., v_{t-1}), thread 0 the identity.  `scratch` holds blockDim.x
// values in shared memory.  Every thread of the block calls it; it starts
// and ends with a barrier.  With AddOp this is the per-block cumsum.
template <typename V, typename Op>
__device__ V block_exclusive_scan(V v, V identity, V* scratch, Op op) {
  const int t = threadIdx.x, n = blockDim.x;
  __syncthreads();
  scratch[t] = v;
  __syncthreads();
  for (int off = 1; off < n; off <<= 1) {
    const V x = t >= off ? scratch[t - off] : identity;
    __syncthreads();
    scratch[t] = op(scratch[t], x);
    __syncthreads();
  }
  const V out = t > 0 ? scratch[t - 1] : identity;
  __syncthreads();
  return out;
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
