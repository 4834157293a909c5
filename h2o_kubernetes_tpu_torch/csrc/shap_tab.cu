// Pattern-table TreeSHAP for one virtual-tree group, for Hopper (sm_90a).
//
// Replaces the TPU kernel h2o_kubernetes_tpu/ops/shap_kernel.py::
// _shap_tab_kernel (a Pallas kernel on a (row block, virtual tree) grid).
// Computes what models/tree/shap.flat_shap_tab computes: for each row,
// virtual tree t and leaf l, fold the D hot bits of the leaf's path slots
// into a pattern, read ctab[t, l, :, pattern], and add slot d's value into
// phi[feat[t, l, d]] (padding slots, feat < 0, into the bias row F); after
// the tree's leaves, add bias[t] into row F. Every variant adds the same
// f32 values to each phi entry in that order (t, then l, then d), so each
// equals the plain torch version bitwise.
//
// What bounds it on an H100: the work is rows x sum_leaves(D) compare/
// fold/gather/add steps -- about 3,000 per row at the serving shape (28
// features, a 20-tree depth-5 GBM) -- against rows*(2F+1)*4 bytes of X and
// phi plus the tables. The floor is the operations (chip_smoke.py prints
// both floors; PERF.md records them). What the card spends is instruction
// issue and shared-memory round trips: each (row, slot) step reads its
// 16-byte slot record, the feature, the ctab entry and phi, and writes
// phi back.
//
// The design:
// - phi on chip. A block owns R rows, one thread per row, and keeps its
//   rows' phi as [R][SP] floats in shared memory, SP = (F+1) | 1: a warp
//   reading one feature of its 32 rows touches 32 distinct banks because
//   the row stride is odd. Each slot's read-modify-write is a shared-memory
//   round trip instead of an L2 one. The block writes its [R, F+1] rows of
//   the output once, coalesced, at the end.
// - X staged once. The block reads its R rows of X [rows, F] coalesced,
//   rewrites negative enum codes to NaN on the way (the NA
//   canonicalization of flat_margin), and keeps them as [R][SX], SX = F | 1.
// - Tables. Each slot is one 16-byte record, built once per model by the
//   wrapper (ops/shap_kernel.pack_slots): x = the feature's byte offset in
//   a row of X, y/z = the bits of lo/hi, w = (feature << 2) | na_ok, or -1
//   for a padding slot. A warp reads it in one broadcast load, and the
//   offsets address X and phi with one add. In the `staged` variant each
//   tree's records and ctab[t] slice (L*D*2^D floats) are copied into
//   shared memory with cp.async, double-buffered across t where two
//   buffers fit; past that size (`unstaged`, e.g. D >= 8 at 32 leaves)
//   both are read through the read-only path.
// - ILP from the depth and a software pipeline over leaves: the slot loop
//   is a template on D, so a leaf's D ctab gathers and the phi reads of its
//   real slots (distinct features) are independent and issued together,
//   while the next leaf's D records and features are already loading. The
//   bias row's terms (padding slots, then the tree's bias) are summed in a
//   register. A row's chain of dependent shared-memory round trips is then
//   about two per leaf, not two per slot.
// - Very wide F, where phi and X for 32 rows do not fit one block
//   (`global_phi`): one thread per row reads X^T [F, rows] from device
//   memory and accumulates into a zeroed phi^T [F+1, rows] there (a
//   warp's accesses to one feature coalesce).
//
// The launch plan (variant, R, stages, shared-memory bytes) is computed
// by ops/shap_kernel.shap_plan, in Python, and passed in.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxDepth = 14;
constexpr int kMaxDevices = 64;

// Through the read-only path (device memory) or a plain load (shared).
template <bool kReadOnly, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kReadOnly) {
    return __ldg(p);
  } else {
    return *p;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One row's features and phi, addressed by byte offsets: on chip (its row
// of the [R][SX] and [R][SP] arrays), already canonical.
struct SmemRow {
  const char* x;
  char* phi;
  __device__ __forceinline__ float feature(int off) const {
    return *reinterpret_cast<const float*>(x + off);
  }
  __device__ __forceinline__ float* cell(int off) const {
    return reinterpret_cast<float*>(phi + off);
  }
};

// One row in device memory: its column of X^T [F, rows] (the enum rewrite
// on each read) and of the zeroed phi^T [F+1, rows], so that a warp's
// reads of one feature coalesce.
struct GmemRow {
  const float* xt;
  float* phi;
  size_t rows;
  const uint8_t* emask;
  __device__ __forceinline__ float feature(int off) const {
    const int f = off >> 2;
    const float v = __ldg(xt + f * rows);
    return (__ldg(emask + f) != 0 && v < 0.f) ? __int_as_float(0x7fc00000)
                                               : v;
  }
  __device__ __forceinline__ float* cell(int off) const {
    return phi + (off >> 2) * rows;
  }
};

// The D-bit hot pattern of one leaf from its records and features.
// Padding slots carry lo=-inf, hi=NaN, na_ok=1, so their bit is 1 for
// every row (their x offset only picks which feature they compare).
template <int D>
__device__ __forceinline__ int leaf_pattern(const int4 (&rec)[D],
                                            const float (&x)[D]) {
  int pat = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool hot = (x[d] >= __int_as_float(rec[d].y)) &&
                     !(x[d] >= __int_as_float(rec[d].z));
    const bool o = (isnan(x[d]) && (rec[d].w & 1) != 0) || hot;
    pat |= static_cast<int>(o) << d;
  }
  return pat;
}

// One virtual tree's leaves for one row, in order. Iteration l issues the
// records of leaf l+1, then leaf l's D ctab gathers and the phi reads of
// its real slots, then leaf l+1's features, then leaf l's D adds, then
// leaf l+1's pattern. The real slots of a leaf name distinct features (a
// path's splits on one feature are merged into one slot; pack_slots
// checks it), so their read-modify-writes are independent and each
// feature still receives its terms in (leaf, slot) order. Padding terms go
// to the bias row, kept in the register pf.
template <int D, bool kReadOnly, class Row>
__device__ __forceinline__ void tree_pass(const int4* ts, const float* tc,
                                          const Row& row, int L, float& pf) {
  constexpr int P = 1 << D;
  int4 rec[D];
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) rec[d] = load<kReadOnly>(ts + d);
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = row.feature(rec[d].x);
  int pat = leaf_pattern<D>(rec, x);
  for (int l = 0; l < L; ++l) {
    int w[D];
#pragma unroll
    for (int d = 0; d < D; ++d) w[d] = rec[d].w;
    // the last iteration reloads its own leaf: no branch, no overrun
    const int4* next = ts + min(l + 1, L - 1) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) rec[d] = load<kReadOnly>(next + d);
    const float* lc = tc + static_cast<size_t>(l) * (D * P) + pat;
    float c[D];
    float v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      c[d] = load<kReadOnly>(lc + d * P);
      v[d] = 0.f;
      if (w[d] >= 0) v[d] = *row.cell(w[d] & ~3);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = row.feature(rec[d].x);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (w[d] < 0) {
        pf = pf + c[d];
      } else {
        *row.cell(w[d] & ~3) = v[d] + c[d];
      }
    }
    pat = leaf_pattern<D>(rec, x);
  }
}

// Copy tree t's slot records and ctab slice into one stage buffer
// (records first, then ctab[t]); one commit group.
__device__ __forceinline__ void stage_tree(float* buf, const int4* slots,
                                           const float* ctab, int t, int LD,
                                           int LDP, bool vec) {
  int4* bs = reinterpret_cast<int4*>(buf);
  const int4* gs = slots + static_cast<size_t>(t) * LD;
  for (int i = threadIdx.x; i < LD; i += blockDim.x)
    cp_async16(bs + i, gs + i);
  float* bc = buf + 4 * LD;
  const float* gc = ctab + static_cast<size_t>(t) * LDP;
  if (vec) {
    for (int i = threadIdx.x; i < LDP / 4; i += blockDim.x)
      cp_async16(bc + 4 * i, gc + 4 * i);
  } else {
    for (int i = threadIdx.x; i < LDP; i += blockDim.x)
      cp_async4(bc + i, gc + i);
  }
  cp_async_commit();
}

// phi and X on chip; ctab[t] staged (kStaged) or read through the
// read-only path. Shared memory: [stages x buf_floats][R x SX][R x SP]
// floats. out is [rows, F+1].
template <int D, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
shap_tab_onchip(const int4* __restrict__ slots,     // [T, L, D] records
                const float* __restrict__ bias,     // [T]
                const float* __restrict__ ctab,     // [T, L, D, 2^D]
                const float* __restrict__ X,        // [rows, F]
                const uint8_t* __restrict__ emask,  // [F] bool
                float* __restrict__ out,            // [rows, F+1]
                int T, int L, int F, int rows, int stages, int buf_floats) {
  constexpr int P = 1 << D;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int R = blockDim.x;
  const int SX = F | 1;
  const int SP = (F + 1) | 1;
  const int r = threadIdx.x;
  const int LD = L * D;
  const int LDP = LD * P;
  const bool vec =
      (LDP % 4 == 0) && ((reinterpret_cast<uintptr_t>(ctab) & 15) == 0);
  float* sx = smem + (kStaged ? stages * buf_floats : 0);
  float* sphi = sx + R * SX;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int nrows = static_cast<int>(
      min(static_cast<long long>(R), static_cast<long long>(rows) - row0));
  if constexpr (kStaged) stage_tree(smem, slots, ctab, 0, LD, LDP, vec);
  // the block's rows of X are R*F contiguous floats
  const float* xb = X + row0 * F;
  for (int i = r; i < R * F; i += R) {
    const int rr = i / F;
    const int f = i - rr * F;
    float x = 0.f;
    if (rr < nrows) {
      x = xb[i];
      if (emask[f] != 0 && x < 0.f) x = __int_as_float(0x7fc00000);
    }
    sx[rr * SX + f] = x;
  }
  for (int i = r; i < R * SP; i += R) sphi[i] = 0.f;
  __syncthreads();
  const SmemRow row{reinterpret_cast<const char*>(sx + r * SX),
                    reinterpret_cast<char*>(sphi + r * SP)};
  float pf = 0.f;  // the bias row
  for (int t = 0; t < T; ++t) {
    if constexpr (kStaged) {
      if (stages > 1 && t + 1 < T) {
        stage_tree(smem + ((t + 1) & 1) * buf_floats, slots, ctab, t + 1, LD,
                   LDP, vec);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* b = smem + (stages > 1 ? (t & 1) * buf_floats : 0);
      tree_pass<D, false>(reinterpret_cast<const int4*>(b), b + 4 * LD, row,
                          L, pf);
    } else {
      tree_pass<D, true>(slots + static_cast<size_t>(t) * LD,
                         ctab + static_cast<size_t>(t) * LDP, row, L, pf);
    }
    pf = pf + __ldg(bias + t);
    if constexpr (kStaged) {
      __syncthreads();  // the buffer is free before it is refilled
      if (stages == 1 && t + 1 < T)
        stage_tree(smem, slots, ctab, t + 1, LD, LDP, vec);
    }
  }
  *row.cell(4 * F) = pf;
  __syncthreads();
  float* ob = out + row0 * (F + 1);
  for (int i = r; i < nrows * (F + 1); i += R) {
    const int rr = i / (F + 1);
    const int f = i - rr * (F + 1);
    ob[i] = sphi[rr * SP + f];
  }
}

// phi in device memory: one thread per row over its column of X^T and of
// the zeroed phi^T.
template <int D>
__global__ void __launch_bounds__(kMaxThreads)
shap_tab_global(const int4* __restrict__ slots, const float* __restrict__ bias,
                const float* __restrict__ ctab, const float* __restrict__ xt,
                const uint8_t* __restrict__ emask,
                float* __restrict__ phi_t,  // [F+1, rows], zeroed
                int T, int L, int F, int rows) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const GmemRow row{xt + r, phi_t + r, static_cast<size_t>(rows), emask};
  const int LD = L * D;
  const size_t LDP = static_cast<size_t>(LD) << D;
  float pf = 0.f;  // the bias row
  for (int t = 0; t < T; ++t) {
    tree_pass<D, true>(slots + static_cast<size_t>(t) * LD, ctab + t * LDP,
                       row, L, pf);
    pf = pf + __ldg(bias + t);
  }
  *row.cell(4 * F) = pf;
}

struct Args {
  const int4* slots;
  const float* bias;
  const float* ctab;
  const float* x;
  const uint8_t* emask;
  float* out;
  int T, L, F, rows, variant, threads, stages, buf_floats, smem_bytes;
  int device;
  cudaStream_t stream;
};

// Lets a kernel take up to the card's opt-in shared memory per block,
// once per kernel (``done``, one flag per device; racing first calls set
// the same value twice).
template <class K>
cudaError_t allow_smem(K kernel, int device, std::atomic<bool>* done) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load()) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  done[device].store(true);
  return cudaSuccess;
}

unsigned grid_for(const Args& a) {
  return static_cast<unsigned>(
      (static_cast<long long>(a.rows) + a.threads - 1) / a.threads);
}

template <int D, bool kStaged>
cudaError_t launch_onchip(const Args& a) {
  static std::atomic<bool> done[kMaxDevices];
  auto kernel = shap_tab_onchip<D, kStaged>;
  cudaError_t err = allow_smem(kernel, a.device, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(a), a.threads, a.smem_bytes, a.stream>>>(
      a.slots, a.bias, a.ctab, a.x, a.emask, a.out, a.T, a.L, a.F, a.rows,
      a.stages, a.buf_floats);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_depth(const Args& a) {
  switch (a.variant) {
    case 0:
      return launch_onchip<D, true>(a);
    case 1:
      return launch_onchip<D, false>(a);
    case 2:
      shap_tab_global<D><<<grid_for(a), a.threads, 0, a.stream>>>(
          a.slots, a.bias, a.ctab, a.x, a.emask, a.out, a.T, a.L, a.F,
          a.rows);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch(int D, const Args& a) {
  switch (D) {
    case 1: return launch_depth<1>(a);
    case 2: return launch_depth<2>(a);
    case 3: return launch_depth<3>(a);
    case 4: return launch_depth<4>(a);
    case 5: return launch_depth<5>(a);
    case 6: return launch_depth<6>(a);
    case 7: return launch_depth<7>(a);
    case 8: return launch_depth<8>(a);
    case 9: return launch_depth<9>(a);
    case 10: return launch_depth<10>(a);
    case 11: return launch_depth<11>(a);
    case 12: return launch_depth<12>(a);
    case 13: return launch_depth<13>(a);
    case 14: return launch_depth<14>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. variant: 0 staged, 1 unstaged, 2 global_phi. x and out
// are X [rows, F] and [rows, F+1] for variants 0/1, and X^T [F, rows] and
// a zeroed phi^T [F+1, rows] for variant 2. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int shap_tab_launch(const void* slots, const void* bias,
                               const void* ctab, const void* x,
                               const void* emask, void* out, int T, int L,
                               int D, int F, int rows, int variant,
                               int threads, int stages, int buf_floats,
                               int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D < 1 || D > kMaxDepth || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || variant < 0 || variant > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const int4*>(slots),
               static_cast<const float*>(bias),
               static_cast<const float*>(ctab),
               static_cast<const float*>(x),
               static_cast<const uint8_t*>(emask),
               static_cast<float*>(out),
               T, L, F, rows, variant, threads, stages, buf_floats,
               smem_bytes, device, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch(D, a));
}
