// Throughput of the shared-memory atomic adds a histogram kernel can use
// on a Hopper card: f32 atomicAdd (a compare-and-swap loop on sm_90),
// u32 atomicAdd, two u32 adds (a 64-bit fixed-point sum split in two, with
// and without the carry read back), u64 atomicAdd -- into the CTA's own
// shared memory at 8 to 28,672 cells, and into the shared memory of other
// CTAs of a thread-block cluster of 1 to 8 (distributed shared memory).
// It measured the choices of h2o_kubernetes_tpu_torch/csrc/histogram.cu.
//
//   mkdir -p build/kernels && nvcc -gencode arch=compute_90a,code=sm_90a \
//       -O3 -o build/kernels/atomics_probe tools/cuda_atomics_probe.cu
//   build/kernels/atomics_probe
//
// Each line: the add, the cluster size (0 = no cluster), the cells, the
// mean milliseconds of one launch over 5 (132 CTAs of 512 threads, 128 in
// clusters, each thread adding 1,024 times at pseudo-random cells), and
// the lane adds per second.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace cg = cooperative_groups;

// MODE 0: f32 atomicAdd; 1: u32 atomicAdd; 2: two u32 atomicAdds;
// 3: u64 atomicAdd; 4: u32 atomicAdd read back for a carry into a second
template <int MODE, bool CLUSTER>
__global__ void __launch_bounds__(512, 1)
probe(int cells, int iters, float* out, unsigned seed, int S) {
  extern __shared__ unsigned sh[];
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) sh[i] = 0;
  if constexpr (CLUSTER) cg::this_cluster().sync(); else __syncthreads();
  unsigned x = seed ^ (threadIdx.x * 2654435761u) ^ (blockIdx.x * 97u);
  const float v = 0.5f + threadIdx.x * 1e-3f;
  for (int i = 0; i < iters; ++i) {
    x = x * 1664525u + 1013904223u;
    const unsigned c = (x >> 8) % cells;
    unsigned* p = sh;
    if constexpr (CLUSTER)
      p = cg::this_cluster().map_shared_rank(sh, (x >> 3) % S);
    if (MODE == 0) atomicAdd(reinterpret_cast<float*>(p) + c, v);
    if (MODE == 1) atomicAdd(p + c, 3u);
    if (MODE == 2) {
      atomicAdd(p + 2 * c, 3u);
      atomicAdd(p + 2 * c + 1, 5u);
    }
    if (MODE == 3)
      atomicAdd(reinterpret_cast<unsigned long long*>(p) + c, 3ull);
    if (MODE == 4) {
      const unsigned o = atomicAdd(p + 2 * c, 0x90000000u);
      atomicAdd(p + 2 * c + 1, 5u + (o > 0x6fffffffu));
    }
  }
  if constexpr (CLUSTER) cg::this_cluster().sync(); else __syncthreads();
  float s = 0;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) s += sh[i];
  atomicAdd(out, s);
}

template <int MODE, bool CLUSTER>
void run(int cells, int S, const char* name) {
  float* out;
  cudaMalloc(&out, 4);
  const size_t smem = 2 * cells * 4;
  auto kern = probe<MODE, CLUSTER>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int iters = 1024, ctas = CLUSTER ? 128 : 132;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = S;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kern, cells, iters, out, 1u, S);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int r = 0; r < 5; ++r)
    cudaLaunchKernelEx(&cfg, kern, cells, iters, out, (unsigned)r, S);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double n = 5.0 * ctas * 512 * iters;
  std::printf("%-30s cluster=%d cells=%6d: %.3f ms, %.1f G lane adds/s (%s)\n",
              name, CLUSTER ? S : 0, cells, ms / 5, n / (ms * 1e-3) / 1e9,
              cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  for (int cells : {8, 256, 4096, 28672}) {
    run<0, false>(cells, 1, "f32 atomicAdd");
    run<1, false>(cells, 1, "u32 atomicAdd");
    run<2, false>(cells, 1, "2 x u32 atomicAdd");
    run<3, false>(cells, 1, "u64 atomicAdd");
    run<4, false>(cells, 1, "u32 read back + carry u32");
  }
  for (int S : {1, 2, 4, 8}) {
    run<0, true>(4096, S, "f32 atomicAdd");
    run<1, true>(4096, S, "u32 atomicAdd");
    run<4, true>(4096, S, "u32 read back + carry u32");
  }
  return 0;
}
