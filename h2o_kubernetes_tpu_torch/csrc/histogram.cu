// Per-level histogram build of the tree learners, for Hopper (sm_90a).
//
// Replaces three TPU kernels of h2o_kubernetes_tpu/ops/histogram.py:
// _hist_fact_kernel (B1, the factorized one-hot matmul used while
// ceil(n_nodes*B/128) <= 256), _hist_kernel (B2, the bin-blocked grid
// for deeper levels) and _hist_vmappable (B3, K trees' histograms
// against one binned matrix: the vmap rule relabels tree k's rows to
// nodes [k*n_nodes, (k+1)*n_nodes) and re-reads the matrix K times).
// All three compute, for tree k and its live rows (rel[k, r] >= 0),
//   hist[k, rel[k, r], f, bins[f, r], c] += vals[k, r, c]   (f32, C chans)
// into hist[K, n_nodes, F, B, C]; B1 and B2 are the K=1 case. The
// one-hot matmul and its 3-term bf16 mantissa split are how a TPU
// scatters without atomics; on Hopper the adds are plain f32 atomics
// into shared memory, so neither is carried over.
//
// What bounds it on an H100: the bytes. Per level it reads F*rows codes
// (uint8 for training, int16 for the 4096-bin AUC histogram) ONCE for
// all K trees, 4*K*rows of rel and 4*K*C*rows of vals, and writes
// 4*K*n_nodes*F*B*C — ~26 MB at 1M rows x 10 features and K=1, ~8 us
// at 3.35 TB/s — against F*C adds per live (tree, row). The simple
// design below runs well above that floor: rows that land in the same
// bin serialize on a shared-memory atomic (a column with 8 levels sends
// every row of a CTA into 8 cells), and rel and vals are re-read once
// per feature.
//
// Design: the grid is (feature, row block, node*bin range) over the
// K*n_nodes nodes of all trees. A CTA zeroes a private copy of its
// range of the feature's [K*n_nodes*B, C] histogram in shared memory. A
// thread loads a row's code once, then loops over the trees: it reads
// rel[k, r] and, for a live row whose cell falls in the CTA's range,
// adds vals[k, r, :] into cell ((k*n_nodes + node)*B + code)*C with
// shared-memory atomicAdd. The CTA then adds its nonzero cells into the
// global output with global atomicAdd. The wrapper (ops/histogram.py)
// picks the range:
// - shared mode: the whole K*n_nodes*B*C*4-byte histogram fits the
//   227 KB a block can opt into (up to 64 nodes at C=3, B=256) — one
//   range;
// - split mode: it does not (128 nodes and more at C=3, B=256), so the
//   node*bin axis is cut into ranges that fit, one per blockIdx.z, and
//   each CTA skips the cells outside its range (B2's bin-blocked grid
//   as an idea).
// Atomic order varies from run to run, so a result is reproducible only
// where every partial sum is exact (e.g. dyadic values, or DRF's
// integer counts); elsewhere it agrees with the plain version within
// f32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

template <typename Code>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const Code* __restrict__ bins,     // [F, rows]
            const int32_t* __restrict__ rel,   // [K, rows], -1 = dead
            const float* __restrict__ vals,    // [K, rows, C]
            float* __restrict__ out,           // [K, n_nodes, F, B, C], 0
            int K, int n_nodes, int F, int B, int C, long long rows,
            long long total_segs, int range_segs) {
  extern __shared__ float sh[];
  const int f = blockIdx.x;
  const long long seg_lo = static_cast<long long>(blockIdx.z) * range_segs;
  const long long left = total_segs - seg_lo;
  const int n_segs = static_cast<int>(left < range_segs ? left : range_segs);
  const int n_cells = n_segs * C;
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) sh[i] = 0.0f;
  __syncthreads();

  const long long per_block = (rows + gridDim.y - 1) / gridDim.y;
  const long long r0 = static_cast<long long>(blockIdx.y) * per_block;
  const long long r1 = r0 + per_block < rows ? r0 + per_block : rows;
  const Code* fb = bins + static_cast<size_t>(f) * rows;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int code = static_cast<int>(fb[r]);
    if (code < 0 || code >= B) continue;
    for (int k = 0; k < K; ++k) {
      const long long kr = static_cast<long long>(k) * rows + r;
      const int node = __ldg(rel + kr);
      if (node < 0 || node >= n_nodes) continue;
      const long long s =
          (static_cast<long long>(k) * n_nodes + node) * B + code - seg_lo;
      if (s < 0 || s >= n_segs) continue;
      const float* v = vals + kr * C;
      float* cell = sh + s * C;
      for (int c = 0; c < C; ++c) atomicAdd(cell + c, __ldg(v + c));
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
    const float x = sh[i];
    if (x == 0.0f) continue;
    const int s = i / C;
    const int c = i - s * C;
    const long long seg = seg_lo + s;
    const long long node = seg / B;
    const long long bin = seg - node * B;
    atomicAdd(out + ((node * F + f) * B + bin) * C + c, x);
  }
}

template <typename Code>
int launch(const void* bins, const void* rel, const void* vals, void* out,
           int K, int n_nodes, int F, int B, int C, long long rows,
           int range_segs, int row_blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long total = static_cast<long long>(K) * n_nodes * B;
  const long long n_ranges = (total + range_segs - 1) / range_segs;
  const long long seg_cap = total < range_segs ? total : range_segs;
  const size_t smem = static_cast<size_t>(seg_cap) * C * sizeof(float);
  err = cudaFuncSetAttribute(hist_kernel<Code>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(F, row_blocks, static_cast<unsigned>(n_ranges));
  hist_kernel<Code><<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Code*>(bins), static_cast<const int32_t*>(rel),
      static_cast<const float*>(vals), static_cast<float*>(out), K,
      n_nodes, F, B, C, rows, total, range_segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, one per code type. Pointers are device
// pointers; stream is a cudaStream_t. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int hist_launch_u8(const void* bins, const void* rel,
                              const void* vals, void* out, int K,
                              int n_nodes, int F, int B, int C,
                              long long rows, int range_segs,
                              int row_blocks, int device, void* stream) {
  return launch<uint8_t>(bins, rel, vals, out, K, n_nodes, F, B, C, rows,
                         range_segs, row_blocks, device, stream);
}

extern "C" int hist_launch_i16(const void* bins, const void* rel,
                               const void* vals, void* out, int K,
                               int n_nodes, int F, int B, int C,
                               long long rows, int range_segs,
                               int row_blocks, int device, void* stream) {
  return launch<int16_t>(bins, rel, vals, out, K, n_nodes, F, B, C, rows,
                         range_segs, row_blocks, device, stream);
}
