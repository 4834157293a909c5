// Pattern-table TreeSHAP for one virtual-tree group, for Hopper (sm_90a).
//
// Replaces the TPU kernel h2o_kubernetes_tpu/ops/shap_kernel.py::
// _shap_tab_kernel (a Pallas kernel on a (row block, virtual tree) grid).
// Computes what models/tree/shap.flat_shap_tab computes: for each row,
// virtual tree t and leaf l, fold the D hot bits of the leaf's path slots
// into a pattern, read ctab[t, l, :, pattern], and add slot d's value into
// phi[feat[t, l, d]] (padding slots, feat < 0, into the bias row F); after
// the tree's leaves, add bias[t] into row F.
//
// What bounds it on an H100: the work is rows x sum_leaves(D_leaf)
// compare/fold/gather/add steps — a few thousand per row at the serving
// shape (28 features, a 20-tree depth-5 GBM) — against only
// rows*(2F+1)*4 bytes of X^T and phi^T plus the tables (a few hundred KB,
// shared by every row and cached). The card's floors for the two are of
// the same order (bytes slightly above operations; chip_smoke.py prints
// both and PERF.md records them), and this kernel runs far above both:
// every slot ends in a dependent read-modify-write of phi, so it is bound
// by instruction latency, not by bandwidth or issue rate.
//
// What the simple design does about it: one thread owns one row and runs
// t, then l, then d in order, so the f32 sum order is fixed (the same as
// the plain torch version's, which it matches bitwise) and no atomics are
// needed. Each thread accumulates into its own column of a zeroed
// phi^T [F+1, rows] in device memory: a warp's reads of X^T [F, rows] and
// its phi adds touch 32 neighbouring floats, so they coalesce. The
// per-slot tables (feat/lo/hi/na_ok, uniform across a warp) and ctab are
// read through the read-only path (__ldg). Staging the tables in shared
// memory and keeping phi in registers are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
shap_tab_kernel(const int32_t* __restrict__ feat,     // [T, L, D]
                const float* __restrict__ lo,         // [T, L, D]
                const float* __restrict__ hi,         // [T, L, D]
                const uint8_t* __restrict__ na_ok,    // [T, L, D] bool
                const float* __restrict__ bias,       // [T]
                const float* __restrict__ xt,         // [F, rows]
                const float* __restrict__ ctab,       // [T, L, D, 2^D]
                float* __restrict__ phi,              // [F+1, rows], zeroed
                int T, int L, int D, int F, int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const size_t R = static_cast<size_t>(rows);
  const size_t P = size_t(1) << D;
  for (int t = 0; t < T; ++t) {
    for (int l = 0; l < L; ++l) {
      const int slot0 = (t * L + l) * D;
      // D-bit hot pattern. Padding slots carry lo=-inf, hi=NaN,
      // na_ok=1, so their bit is 1 for every row; max(f, 0) only picks
      // which (ignored) feature row they compare.
      int pat = 0;
      for (int d = 0; d < D; ++d) {
        const int f = __ldg(feat + slot0 + d);
        const float x = __ldg(xt + static_cast<size_t>(max(f, 0)) * R + r);
        const bool hot = (x >= __ldg(lo + slot0 + d)) &&
                         !(x >= __ldg(hi + slot0 + d));
        const bool o = (isnan(x) && __ldg(na_ok + slot0 + d) != 0) || hot;
        pat |= static_cast<int>(o) << d;
      }
      const float* ct = ctab + static_cast<size_t>(slot0) * P + pat;
      for (int d = 0; d < D; ++d) {
        const int f = __ldg(feat + slot0 + d);
        float* p = phi + static_cast<size_t>(f < 0 ? F : f) * R + r;
        *p = *p + __ldg(ct + static_cast<size_t>(d) * P);
      }
    }
    float* pb = phi + static_cast<size_t>(F) * R + r;
    *pb = *pb + __ldg(bias + t);
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int shap_tab_launch(const void* feat, const void* lo,
                               const void* hi, const void* na_ok,
                               const void* bias, const void* xt,
                               const void* ctab, void* phi, int T, int L,
                               int D, int F, int rows, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((rows + kThreads - 1) / kThreads);
  shap_tab_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(feat), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const uint8_t*>(na_ok),
      static_cast<const float*>(bias), static_cast<const float*>(xt),
      static_cast<const float*>(ctab), static_cast<float*>(phi), T, L, D, F,
      rows);
  return static_cast<int>(cudaGetLastError());
}
