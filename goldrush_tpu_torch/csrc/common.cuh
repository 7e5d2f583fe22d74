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
constexpr uint32_t kSentinel32 = 0xFFFFFFFFu;

struct MaxOp {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};

struct AddOp {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    return a + b;
  }
};

// Block-wide exclusive scan of one value per thread: thread t gets
// op(v_0, ..., v_{t-1}), thread 0 the identity.  `scratch` holds blockDim.x
// values in shared memory.  Every thread of the block calls it; it starts
// and ends with a barrier.  With MaxOp this is the per-block cummax, with
// AddOp the per-block cumsum.
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
