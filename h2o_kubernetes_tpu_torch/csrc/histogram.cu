// Per-level histogram build of the tree learners, for Hopper (sm_90a).
//
// Replaces two TPU kernels of h2o_kubernetes_tpu/ops/histogram.py:
// _hist_fact_kernel (B1, the factorized one-hot matmul used while
// ceil(n_nodes*B/128) <= 256) and _hist_kernel (B2, the bin-blocked grid
// for deeper levels). Both compute, for live rows (rel[r] >= 0),
//   hist[rel[r], f, bins[f, r], c] += vals[r, c]     (f32, C channels)
// into hist[n_nodes, F, B, C]. The one-hot matmul and its 3-term bf16
// mantissa split are how a TPU scatters without atomics; on Hopper the
// adds are plain f32 atomics into shared memory, so neither is carried
// over.
//
// What bounds it on an H100: the bytes. Per level it reads F*rows codes
// (uint8 for training, int16 for the 4096-bin AUC histogram), 4*rows of
// rel and 4*C*rows of vals, and writes 4*n_nodes*F*B*C — ~26 MB at 1M
// rows x 10 features, ~8 us at 3.35 TB/s — against F*C adds per live
// row. The simple design below runs well above that floor: rows that
// land in the same bin serialize on a shared-memory atomic (a column
// with 8 levels sends every row of a CTA into 8 cells), and vals are
// re-read once per feature.
//
// Design: the grid is (feature, row block, node*bin range). A CTA zeroes
// a private copy of its range of the feature's [n_nodes*B, C] histogram
// in shared memory, adds its rows into it with shared-memory atomicAdd,
// and then adds its nonzero cells into the global output with global
// atomicAdd. The wrapper (ops/histogram.py) picks the range:
// - shared mode: the whole n_nodes*B*C*4-byte histogram fits the 227 KB
//   a block can opt into (up to 64 nodes at C=3, B=256) — one range;
// - split mode: it does not (128 nodes and more at C=3, B=256), so the
//   node*bin axis is cut into ranges that fit, one per blockIdx.z, and
//   each CTA skips the rows outside its range (B2's bin-blocked grid as
//   an idea).
// Atomic order varies from run to run, so a result is reproducible only
// where every partial sum is exact (e.g. dyadic values); elsewhere it
// agrees with the plain version within f32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

template <typename Code>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const Code* __restrict__ bins,     // [F, rows]
            const int32_t* __restrict__ rel,   // [rows], -1 = dead
            const float* __restrict__ vals,    // [rows, C]
            float* __restrict__ out,           // [n_nodes, F, B, C], zeroed
            int F, int B, int C, long long rows, long long total_segs,
            int range_segs) {
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
    const int node = __ldg(rel + r);
    const int code = static_cast<int>(fb[r]);
    if (node < 0 || code < 0 || code >= B) continue;
    const long long s = static_cast<long long>(node) * B + code - seg_lo;
    if (s < 0 || s >= n_segs) continue;
    const float* v = vals + r * C;
    float* cell = sh + s * C;
    for (int c = 0; c < C; ++c) atomicAdd(cell + c, __ldg(v + c));
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
           int n_nodes, int F, int B, int C, long long rows, int range_segs,
           int row_blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long total = static_cast<long long>(n_nodes) * B;
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
      static_cast<const float*>(vals), static_cast<float*>(out), F, B, C,
      rows, total, range_segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, one per code type. Pointers are device
// pointers; stream is a cudaStream_t. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int hist_launch_u8(const void* bins, const void* rel,
                              const void* vals, void* out, int n_nodes,
                              int F, int B, int C, long long rows,
                              int range_segs, int row_blocks, int device,
                              void* stream) {
  return launch<uint8_t>(bins, rel, vals, out, n_nodes, F, B, C, rows,
                         range_segs, row_blocks, device, stream);
}

extern "C" int hist_launch_i16(const void* bins, const void* rel,
                               const void* vals, void* out, int n_nodes,
                               int F, int B, int C, long long rows,
                               int range_segs, int row_blocks, int device,
                               void* stream) {
  return launch<int16_t>(bins, rel, vals, out, n_nodes, F, B, C, rows,
                         range_segs, row_blocks, device, stream);
}
