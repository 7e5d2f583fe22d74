// Launches and barriers on one GPU, for the consume kernel's design
// (csrc/consume.cu): whether a cooperative launch takes a thread-block
// cluster dimension, how many clusters of 1-16 CTAs stay resident at four
// shared-memory sizes (cudaOccupancyMaxActiveClusters), what one
// grid.sync(), one cluster barrier, a flag one CTA publishes (release
// store) and 131 await (acquire loads), and a hand-written counter
// barrier cost in a persistent grid of one CTA per SM, and how long kernel
// B's tile code takes on one CTA and kernel C's read code on one warp in
// the fused (L2-coherent) form, on a synthetic bench-shaped read (H = 3,
// T = 20, F = 1,000, K = 32, a 2^27-word table).  Prints one line each.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o smoke_work/launch_probe tools/torch_port_launch_probe.cu
//   smoke_work/launch_probe
#include <cooperative_groups.h>
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../goldrush_tpu_torch/csrc/classify.cuh"
#include "../goldrush_tpu_torch/csrc/probe_vote.cuh"

namespace cg = cooperative_groups;

#define CK(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
  printf("ERR %s: %s\n", #x, cudaGetErrorString(e_)); } } while (0)

__global__ void coop_cluster_kernel(int* out, int use_cluster) {
  cg::grid_group grid = cg::this_grid();
  if (use_cluster) cg::this_cluster().sync();
  grid.sync();
  if (threadIdx.x == 0) atomicAdd(out, 1);
}

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(1024, 1) grid_sync_loop(int n, unsigned long long* out) {
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  const unsigned long long t0 = gtime();
  for (int i = 0; i < n; ++i) grid.sync();
  const unsigned long long t1 = gtime();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = t1 - t0;
}

__global__ void cluster_sync_loop(int n, unsigned long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const unsigned long long t0 = gtime();
  for (int i = 0; i < n; ++i) cl.sync();
  const unsigned long long t1 = gtime();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = t1 - t0;
}

// one-to-all: CTA (i % gridDim) publishes generation i; everyone waits on it
__global__ void __launch_bounds__(512, 1) flag_loop(int n, unsigned* flag,
                                                    unsigned long long* out) {
  __shared__ unsigned seen;
  cg::this_grid().sync();
  const unsigned long long t0 = gtime();
  for (int i = 1; i <= n; ++i) {
    if (threadIdx.x == 0) {
      if (blockIdx.x == 0) {
        asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(flag), "r"(i) : "memory");
      } else {
        unsigned v;
        do {
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
        } while (v < static_cast<unsigned>(i));
      }
      seen = i;
    }
    __syncthreads();
  }
  const unsigned long long t1 = gtime();
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
}

// all-to-one + one-to-all (a counter barrier) written by hand
__global__ void __launch_bounds__(512, 1) counter_loop(int n, unsigned* cnt,
                                                       unsigned long long* out) {
  cg::this_grid().sync();
  const unsigned long long t0 = gtime();
  for (int i = 1; i <= n; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned v;
      asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;" : "=r"(v) : "l"(cnt) : "memory");
      const unsigned want = static_cast<unsigned>(i) * gridDim.x;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(cnt) : "memory");
      } while (v < want);
    }
    __syncthreads();
  }
  const unsigned long long t1 = gtime();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = t1 - t0;
}

// one tile of B per CTA (t = blockIdx.x), then C on CTA 0, timed
__global__ void __launch_bounds__(512, 1) bc_kernel(
    const uint32_t* words, const int64_t* slots, const bool* ok, int H, int T,
    int F, int K, int bits, unsigned long long* sums, int32_t* vals,
    bool* binit, int cbuf, unsigned long long* out, int reps) {
  cg::grid_group grid = cg::this_grid();
  int32_t* curr = vals;
  int32_t* top = curr + T;
  int32_t* over = top + T;
  int32_t* cid = over + T;
  int32_t* ccnt = cid + T * K;
  for (int r = 0; r < reps; ++r) {
    grid.sync();
    const unsigned long long t0 = gtime();
    for (int t = blockIdx.x; t < T; t += gridDim.x) {
      gr::probe_vote_tile<true>(words, slots, 0, 0, ok, H, T, F, K, 2, 10,
                                bits, t, 0, curr, top, cid, ccnt, binit, over,
                                sums, sums + T, sums + 2 * T);
      __syncthreads();
    }
    const unsigned long long t1 = gtime();
    grid.sync();
    const unsigned long long t2 = gtime();
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      const gr::Outcome o = gr::read_outcome(sums, vals, T, T, K, 10, 5, 1,
                                             cbuf, gr::gr_smem, threadIdx.x);
      if (threadIdx.x == 0) out[8 + r] = o.dec * 1000 + o.na;
    }
    const unsigned long long t3 = gtime();
    if (threadIdx.x == 0 && blockIdx.x < T) out[16 + r * 32 + blockIdx.x] = t1 - t0;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      out[0] += t2 - t1;
      out[1] += t3 - t2;
    }
  }
}

int main() {
  int dev = 0, sms = 0, optin = 0;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  CK(cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  int rt = 0, drv = 0;
  cudaRuntimeGetVersion(&rt);
  cudaDriverGetVersion(&drv);
  printf("sms=%d smem_optin=%d runtime=%d driver=%d\n", sms, optin, rt, drv);
  int* d_out;
  CK(cudaMalloc(&d_out, 4));
  unsigned long long* d_t;
  CK(cudaMalloc(&d_t, 8 * 4096));
  CK(cudaFuncSetAttribute(coop_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  CK(cudaFuncSetAttribute(cluster_sync_loop, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  for (size_t smem : {0ul, 65536ul, 150000ul, 232448ul}) {
    CK(cudaFuncSetAttribute(coop_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    for (int c : {1, 2, 4, 8, 16}) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute at[2];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = c;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      at[1].id = cudaLaunchAttributeCooperative;
      at[1].val.cooperative = 1;
      cfg.blockDim = dim3(512);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      cfg.gridDim = dim3(c);
      int nclu = -1;
      cudaError_t eo = cudaOccupancyMaxActiveClusters(&nclu, coop_cluster_kernel, &cfg);
      cudaGetLastError();
      cfg.gridDim = dim3(c * (nclu > 0 ? nclu : 1));
      cfg.numAttrs = 2;
      CK(cudaMemset(d_out, 0, 4));
      cudaError_t el = cudaLaunchKernelEx(&cfg, coop_cluster_kernel, d_out, 1);
      cudaError_t es = cudaDeviceSynchronize();
      int h = 0;
      cudaMemcpy(&h, d_out, 4, cudaMemcpyDeviceToHost);
      printf("cluster=%d smem=%zu max_active_clusters=%d (%s) coop+cluster launch grid=%d: %s / sync %s, ctas_done=%d\n",
             c, smem, nclu, cudaGetErrorString(eo), cfg.gridDim.x,
             cudaGetErrorString(el), cudaGetErrorString(es), h);
      cudaGetLastError();
    }
  }
  // grid.sync cost
  const int n = 2000;
  unsigned long long h;
  for (int thr : {512, 1024}) {
    for (int ctas : {sms, 2 * sms}) {
      void* args[] = {(void*)&n, (void*)&d_t};
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_sync_loop, thr, 0);
      if (ctas > per_sm * sms) continue;
      cudaError_t e = cudaLaunchCooperativeKernel((void*)grid_sync_loop, dim3(ctas), dim3(thr), args, 0, 0);
      CK(cudaDeviceSynchronize());
      cudaMemcpy(&h, d_t, 8, cudaMemcpyDeviceToHost);
      printf("grid.sync ctas=%d threads=%d: %s %.3f us each\n", ctas, thr, cudaGetErrorString(e), h / 1e3 / n);
    }
  }
  for (int c : {2, 4, 8, 16}) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = c;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(512);
    cfg.attrs = at;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(c);
    cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_sync_loop, n, d_t);
    CK(cudaDeviceSynchronize());
    cudaMemcpy(&h, d_t, 8, cudaMemcpyDeviceToHost);
    printf("cluster.sync cluster=%d: %s %.3f us each\n", c, cudaGetErrorString(e), h / 1e3 / n);
  }
  unsigned* d_flag;
  CK(cudaMalloc(&d_flag, 4));
  {
    CK(cudaMemset(d_flag, 0, 4));
    void* args[] = {(void*)&n, (void*)&d_flag, (void*)&d_t};
    CK(cudaLaunchCooperativeKernel((void*)flag_loop, dim3(sms), dim3(512), args, 0, 0));
    CK(cudaDeviceSynchronize());
    std::vector<unsigned long long> v(sms);
    cudaMemcpy(v.data(), d_t, 8 * sms, cudaMemcpyDeviceToHost);
    printf("flag publish (CTA 0 -> all, %d CTAs): %.3f us per generation (CTA 1), %.3f (last)\n", sms, v[1] / 1e3 / n, v[sms - 1] / 1e3 / n);
    CK(cudaMemset(d_flag, 0, 4));
    CK(cudaLaunchCooperativeKernel((void*)counter_loop, dim3(sms), dim3(512), args, 0, 0));
    CK(cudaDeviceSynchronize());
    cudaMemcpy(&h, d_t, 8, cudaMemcpyDeviceToHost);
    printf("hand counter barrier (%d CTAs): %.3f us each\n", sms, h / 1e3 / n);
  }
  // B's tile and C's read in the fused code, synthetic bench shape
  {
    const int H = 3, T = 20, F = 1000, K = 32;
    const int64_t words_n = 1ll << 27;
    uint32_t* d_words;
    int64_t* d_slots;
    bool* d_ok;
    CK(cudaMalloc(&d_words, words_n * 4));
    CK(cudaMalloc(&d_slots, 8ll * H * T * F));
    CK(cudaMalloc(&d_ok, T * F));
    std::vector<uint32_t> hw(words_n);
    srand(5);
    for (int64_t i = 0; i < words_n; ++i) hw[i] = 0x40000000u | (uint32_t)(1 + (i % 5));
    std::vector<int64_t> hs(H * T * F);
    for (auto& x : hs) x = ((int64_t)rand() * 7919 + rand()) % words_n;
    CK(cudaMemcpy(d_words, hw.data(), words_n * 4, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(d_slots, hs.data(), 8ll * H * T * F, cudaMemcpyHostToDevice));
    CK(cudaMemset(d_ok, 1, T * F));
    unsigned long long* sums;
    int32_t* vals;
    bool* binit;
    CK(cudaMalloc(&sums, 8 * 3 * T));
    CK(cudaMalloc(&vals, 4 * (3 * T + 2 * T * K)));
    CK(cudaMalloc(&binit, T));
    const int bits = gr::table_bits(H * F);
    int t2 = 1;
    while (t2 < T) t2 <<= 1;
    const int chunk = (T < 32 ? T : 32) * K;
    const int cbuf = t2 > chunk ? t2 : chunk;
    size_t smem = ((1ul << bits) + 512) * 8;
    CK(cudaFuncSetAttribute(bc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    const int reps = 8;
    CK(cudaMemset(d_t, 0, 8 * 4096));
    int ctas = sms;
    void* args[] = {&d_words, &d_slots, &d_ok, (void*)&H, (void*)&T, (void*)&F,
                    (void*)&K, (void*)&bits, &sums, &vals, &binit, (void*)&cbuf,
                    &d_t, (void*)&reps};
    CK(cudaLaunchCooperativeKernel((void*)bc_kernel, dim3(ctas), dim3(512), args, smem, 0));
    CK(cudaDeviceSynchronize());
    std::vector<unsigned long long> v(16 + reps * 32);
    cudaMemcpy(v.data(), d_t, 8 * v.size(), cudaMemcpyDeviceToHost);
    printf("fused B+C synthetic: grid.sync after tiles %.3f us, C (read_outcome, warp 0) %.3f us, outcome %llu\n",
           v[0] / 1e3 / reps, v[1] / 1e3 / reps, v[8]);
    for (int r = 0; r < reps; ++r) {
      unsigned long long mx = 0, mn = ~0ull;
      for (int t = 0; t < T; ++t) { mx = std::max(mx, v[16 + r * 32 + t]); mn = std::min(mn, v[16 + r * 32 + t]); }
      printf("  rep %d: tile time min %.3f max %.3f us\n", r, mn / 1e3, mx / 1e3);
    }
  }
  return 0;
}
