// Per-level histogram build of the tree learners, for Hopper (sm_90a).
//
// Replaces three TPU kernels of h2o_kubernetes_tpu/ops/histogram.py:
// _hist_fact_kernel (B1, :141, the factorized one-hot matmul used while
// ceil(n_nodes*B/128) <= 256), _hist_kernel (B2, :300, the bin-blocked
// grid of the deeper levels) and _hist_vmappable (B3, :399, K trees'
// histograms against one binned matrix: its vmap rule relabels tree k's
// rows to nodes [k*n_nodes, (k+1)*n_nodes) and re-reads the matrix K
// times). All three compute, for tree k and its live rows (rel[k, r] >=
// 0),
//   hist[k, rel[k, r], f, bins[f, r], c] += vals[k, r, c]   (f32, C chans)
// into hist[K, n_nodes, F, B, C]; B1 and B2 are the K=1 case. The
// one-hot matmul and its bf16 mantissa split are how a TPU scatters
// without atomics; on Hopper the adds are f32 atomics into shared
// memory, so neither is carried over.
//
// What bounds it on an H100. The bytes a level must move are the codes
// (F*rows, uint8; int16 for the 4096-bin AUC), rel (4*K*rows), vals
// (4*K*C*rows) and the output (4*K*n_nodes*F*B*C): 16-160 MB, 5-50 us at
// 3.35 TB/s. What the card spends goes elsewhere: (a) F*C shared-memory
// adds per live (tree, row) -- an f32 atomicAdd into shared memory is a
// compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN), ~0.2 T adds/s over
// the card, slower where a warp's lanes hit one cell (the roots);
// (b) re-reading the (tree, row) stream once per pass over the features
// when a level's histogram does not fit one CTA; (c) the flush of each
// CTA's partial histogram into the output with global atomics. The
// design:
//
// - Streaming (hist_stream), the shallow levels: a CTA holds the whole
//   [K*n_nodes, G, B, C] histogram of a GROUP of up to 8 features in
//   shared memory. A thread takes RPT consecutive rows (4, with 16-byte
//   loads, when rows % 4 == 0; else 1), loads their codes of the G
//   features into registers once, then walks the K trees -- per tree one
//   load of the rows' rel and vals, applied to all G features -- so the
//   (tree, row) stream is read once per group, not per feature. The
//   kernel fits 40 registers, so three CTAs (48 warps) share an SM to
//   hide the compare-and-swap latency; that measured faster than one CTA
//   holding every feature in one pass. Where shared memory is spare, R
//   replicas split the contention (warp w adds into copy w % R).
// - Partitioned (part_count, part_scatter, hist_seg), the deep levels,
//   where one feature's histogram leaves room for one streaming CTA per
//   SM (too few warps to hide the adds, and many passes): the level's
//   live (tree, row) pairs are first sorted, stably, by tree-node (a
//   counting sort: per-warp tile counts, a scan, a scatter
//   that ranks equal keys with __match_any_sync), each pair's codes
//   (row-major) and vals copied into its sorted slot. A CTA of hist_seg
//   then owns a tile of consecutive tree-nodes x a group of features
//   and reads only its tile's pairs, contiguously: every pair is read
//   once per feature group instead of once per node range (XGBoost's
//   gpu_hist keeps its rows partitioned by node for the same reason).
//   Thread-block clusters, whose CTAs add into each other's shared
//   memory, were measured as the alternative and lost: atomics into
//   another CTA's shared memory run several times slower than local ones
//   (tools/cuda_atomics_probe.cu, PERF.md).
// - The grids are sized by the wrapper to the CTAs that fit (threads,
//   registers and shared memory per SM), a few waves deep, and each
//   CTA's flush adds one partial per nonzero output cell.
//
// The launch plan is computed in plain Python (ops/histogram.py
// hist_plan), where it is tested on the CPU. Atomic order varies from run
// to run, so a result is reproducible only where every partial sum is
// exact (dyadic values, DRF's integer counts); elsewhere it agrees with
// the plain version within f32 rounding. The row partition is stable and
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;

// features per group held in registers (must match ops/histogram.py):
// hist_seg holds up to kMaxGroup; hist_stream kStreamGroup, in few enough
// registers for three CTAs per SM (more warps to hide the atomics'
// latency measured faster than more features per pass)
template <typename Code>
constexpr int kMaxGroup = sizeof(Code) == 1 ? 32 : 16;
constexpr int kStreamGroup = 8;

// Adds v[i] into sh[off[i]] for every i with off[i] >= 0. (A
// compare-and-swap loop written out here, to keep several cells in
// flight per thread, measured several times slower than atomicAdd's own
// loop on an H100.)
template <int N>
__device__ __forceinline__ void add_n(float* sh, const int (&off)[N],
                                      const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (off[i] >= 0) atomicAdd(sh + off[i], v[i]);
}

// RPT consecutive rows' codes of one feature, from one load
template <typename Code, int RPT>
struct Codes;

template <>
struct Codes<uint8_t, 4> {
  uint32_t w;
  __device__ void load(const uint8_t* p) {
    w = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ int at(int j) const { return (w >> (8 * j)) & 0xff; }
  __device__ void pin() { asm volatile("" : "+r"(w)); }
};

template <>
struct Codes<int16_t, 4> {
  uint2 w;
  __device__ void load(const int16_t* p) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ int at(int j) const {
    const uint32_t h = j < 2 ? w.x : w.y;
    return static_cast<int16_t>(h >> (16 * (j & 1)));
  }
  __device__ void pin() { asm volatile("" : "+r"(w.x), "+r"(w.y)); }
};

template <typename Code>
struct Codes<Code, 1> {
  int v;
  __device__ void load(const Code* p) { v = static_cast<int>(__ldg(p)); }
  __device__ int at(int) const { return v; }
  __device__ void pin() { asm volatile("" : "+r"(v)); }
};

template <int RPT>
__device__ void load_rel(const int32_t* p, int (&r)[RPT]) {
  if constexpr (RPT == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int N>
__device__ void load_vals(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __ldg(p + i);
  }
}

// Streaming. grid: x = row blocks, y = feature groups, z = node ranges *
// bin chunks. Shared memory: R copies of [node_range, G, bin_chunk, C].
template <typename Code, int RPT, int C>
__global__ void __launch_bounds__(kThreads, 3)
hist_stream(const Code* __restrict__ bins,     // [F, rows]
            const int32_t* __restrict__ rel,   // [K, rows], -1 = dead
            const float* __restrict__ vals,    // [K, rows, C]
            float* __restrict__ out,           // [K, n_nodes, F, B, C], 0
            int K, int n_nodes, int F, int B, long long rows, int G,
            int node_range, int bin_chunk, int bin_chunks, int replicas) {
  constexpr int MAXG = kStreamGroup;
  extern __shared__ float sh[];
  const int f0 = blockIdx.y * G;
  const int gy = min(G, F - f0);
  const int lo = (blockIdx.z / bin_chunks) * node_range;
  const int hi = min(lo + node_range, K * n_nodes);
  const int b0 = (blockIdx.z % bin_chunks) * bin_chunk;
  const int bc = min(bin_chunk, B - b0);
  const int node_cells = G * bin_chunk * C;    // one tree-node, all G
  const int slab = node_range * node_cells;    // one copy
  for (int i = threadIdx.x; i < slab * replicas; i += blockDim.x)
    sh[i] = 0.0f;
  __syncthreads();

  float* mine = sh + (threadIdx.x / 32 % replicas) * slab;
  const long long quads = rows / RPT;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; q < quads; q += stride) {
    const long long r = q * RPT;
    Codes<Code, RPT> cw[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < gy)
        cw[g].load(bins + static_cast<long long>(f0 + g) * rows + r);
    for (int k = 0; k < K; ++k) {
      // keep the G x RPT cell offsets from being hoisted out of the tree
      // loop (they would spill): only the packed codes stay in registers
#pragma unroll
      for (int g = 0; g < MAXG; ++g) cw[g].pin();
      const long long kr = static_cast<long long>(k) * rows + r;
      int rl[RPT];
      load_rel<RPT>(rel + kr, rl);
      int base[RPT];                           // -1: dead or out of range
      bool any = false;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int s = k * n_nodes + rl[j] - lo;
        const bool ok = rl[j] >= 0 && rl[j] < n_nodes && s >= 0 &&
                        s < hi - lo;
        base[j] = ok ? s * node_cells : -1;
        any |= ok;
      }
      if (!any) continue;
      float v[RPT * C];
      load_vals<RPT * C>(vals + kr * C, v);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= gy) break;
        int off[RPT * C];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int code = cw[g].at(j) - b0;
          const bool ok = base[j] >= 0 && code >= 0 && code < bc;
#pragma unroll
          for (int c = 0; c < C; ++c)
            off[j * C + c] = ok ? base[j] + (g * bin_chunk + code) * C + c
                                : -1;
        }
        add_n<RPT * C>(mine, off, v);
      }
    }
  }
  __syncthreads();

  // flush: replicas summed, nonzero cells added into the output (one
  // partial per row block)
  for (int i = threadIdx.x; i < slab; i += blockDim.x) {
    float x = sh[i];
    for (int p = 1; p < replicas; ++p) x += sh[p * slab + i];
    if (x == 0.0f) continue;
    const int c = i % C;
    int t = i / C;
    const int b = t % bin_chunk;
    t /= bin_chunk;
    const int g = t % G;
    const int kn = lo + t / G;
    if (g >= gy || b >= bc || kn >= hi) continue;
    atomicAdd(out + ((static_cast<long long>(kn) * F + f0 + g) * B + b0 + b)
                        * C + c, x);
  }
}

// ---- the row partition: a stable counting sort of the live (tree, row)
// pairs p = k*rows + r by tree-node k*n_nodes + rel[k, r]. Each warp owns
// a tile of `tile` consecutive pairs and a count per tree-node in shared
// memory.

// tree-node of pair p (and its row), or -1 when p >= end or it is dead
__device__ __forceinline__ int pair_bucket(const int32_t* rel, long long p,
                                           long long end, long long rows,
                                           int n_nodes, long long* r_out) {
  if (p >= end) return -1;
  const int node = __ldg(rel + p);
  const long long k = p / rows;
  *r_out = p - k * rows;
  return node >= 0 && node < n_nodes ? static_cast<int>(k) * n_nodes + node
                                     : -1;
}

// cnt[b * tiles + w] = live pairs of tile w in tree-node b
__global__ void part_count(const int32_t* __restrict__ rel,
                           int32_t* __restrict__ cnt, int K, int n_nodes,
                           long long rows, int tile, int tiles) {
  extern __shared__ int32_t cs[];
  const int nb = K * n_nodes;
  const int lane = threadIdx.x & 31;
  int32_t* c = cs + (threadIdx.x / 32) * nb;
  const long long w = static_cast<long long>(blockIdx.x) * (blockDim.x / 32)
                      + threadIdx.x / 32;
  if (w >= tiles) return;                      // uniform over the warp
  for (int b = lane; b < nb; b += 32) c[b] = 0;
  __syncwarp();
  const long long p0 = w * tile;
  const long long p1 = min(p0 + tile, static_cast<long long>(K) * rows);
  for (long long base = p0; base < p1; base += 32) {
    long long r;
    const int b = pair_bucket(rel, base + lane, p1, rows, n_nodes, &r);
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(peers) - 1) c[b] += __popc(peers);
    __syncwarp();
  }
  for (int b = lane; b < nb; b += 32)
    cnt[static_cast<long long>(b) * tiles + w] = c[b];
}

// Each live pair's row of codes (F codes, zero-padded to `stride` bytes)
// and its C vals go to its slot: excl[b * tiles + w] + its rank among the
// tile's earlier pairs of tree-node b.
template <typename Code, int C>
__global__ void part_scatter(const Code* __restrict__ bins,
                             const int32_t* __restrict__ rel,
                             const float* __restrict__ vals,
                             const int32_t* __restrict__ excl,
                             uint8_t* __restrict__ codes_out,
                             float* __restrict__ vals_out, int K,
                             int n_nodes, int F, long long rows, int tile,
                             int tiles, int stride) {
  using U = typename std::conditional<sizeof(Code) == 1, uint8_t,
                                      uint16_t>::type;
  constexpr int kPer = 4 / sizeof(Code);       // codes per 32-bit word
  extern __shared__ int32_t cs[];
  const int nb = K * n_nodes;
  const int lane = threadIdx.x & 31;
  int32_t* next = cs + (threadIdx.x / 32) * nb;
  const long long w = static_cast<long long>(blockIdx.x) * (blockDim.x / 32)
                      + threadIdx.x / 32;
  if (w >= tiles) return;                      // uniform over the warp
  for (int b = lane; b < nb; b += 32)
    next[b] = excl[static_cast<long long>(b) * tiles + w];
  __syncwarp();
  const long long p0 = w * tile;
  const long long p1 = min(p0 + tile, static_cast<long long>(K) * rows);
  for (long long base = p0; base < p1; base += 32) {
    const long long p = base + lane;
    long long r = 0;
    const int b = pair_bucket(rel, p, p1, rows, n_nodes, &r);
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0) {
      const long long pos = next[b] + __popc(peers & ((1u << lane) - 1u));
      uint8_t* dst = codes_out + pos * stride;
      for (int c0 = 0; c0 < stride; c0 += 16) {
        uint32_t word[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t x = 0;
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const int f = (c0 + 4 * q) / static_cast<int>(sizeof(Code)) + e;
            const uint32_t code =
                f < F ? static_cast<U>(__ldg(
                            bins + static_cast<long long>(f) * rows + r))
                      : 0u;
            x |= code << (8 * sizeof(Code) * e);
          }
          word[q] = x;
        }
        *reinterpret_cast<uint4*>(dst + c0) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        vals_out[pos * C + c] = __ldg(vals + p * C + c);
    }
    __syncwarp();
    if (b >= 0 && lane == __ffs(peers) - 1) next[b] += __popc(peers);
    __syncwarp();
  }
}

// Partitioned histogram. grid: x = splits of a tile's pairs, y = feature
// groups, z = tiles of tile_nodes consecutive tree-nodes. Shared memory:
// [tile_nodes, G, B, C] f32, then the tile's tile_nodes + 1 segment
// starts.
template <typename Code, int C>
__global__ void __launch_bounds__(kThreads, 3)
hist_seg(const uint8_t* __restrict__ codes,    // [pairs, stride], sorted
         const float* __restrict__ vals,       // [pairs, C], sorted
         const int32_t* __restrict__ seg,      // [nb + 1] segment starts
         float* __restrict__ out,              // [nb, F, B, C], zeroed
         int nb, int F, int B, int stride, int G, int tile_nodes) {
  constexpr int MAXG = kMaxGroup<Code>;
  constexpr int kWords = MAXG * sizeof(Code) / 16;      // uint4 per group
  constexpr int kPerWord = 16 / sizeof(Code);           // codes per uint4
  constexpr int kPer = 4 / sizeof(Code);                // codes per word
  extern __shared__ float sh[];
  const int f0 = blockIdx.y * G;
  const int gy = min(G, F - f0);
  const int b_lo = blockIdx.z * tile_nodes;
  const int nt = min(tile_nodes, nb - b_lo);
  const int node_cells = G * B * C;
  const int slab = tile_nodes * node_cells;
  int32_t* sseg = reinterpret_cast<int32_t*>(sh + slab);
  for (int i = threadIdx.x; i < slab; i += blockDim.x) sh[i] = 0.0f;
  for (int i = threadIdx.x; i <= nt; i += blockDim.x)
    sseg[i] = seg[b_lo + i];
  __syncthreads();

  const int lo = sseg[0], hi = sseg[nt];
  for (int i = lo + blockIdx.x * blockDim.x + threadIdx.x; i < hi;
       i += gridDim.x * blockDim.x) {
    int a = 0, z = nt;                         // sseg[a] <= i < sseg[z]
    while (z - a > 1) {
      const int m = (a + z) >> 1;
      if (sseg[m] <= i) a = m; else z = m;
    }
    const int base = a * node_cells;
    const uint4* rec = reinterpret_cast<const uint4*>(
        codes + static_cast<long long>(i) * stride + f0 * sizeof(Code));
    uint4 cw[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      if (q * kPerWord < gy) cw[q] = __ldg(rec + q);
    float v4[4 * C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float x = __ldg(vals + static_cast<long long>(i) * C + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) v4[e * C + c] = x;
    }
#pragma unroll
    for (int g4 = 0; g4 < MAXG; g4 += 4) {
      if (g4 >= gy) break;
      int off[4 * C];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = g4 + e;
        const uint4 wv = cw[g / kPerWord];
        const int comp = g % kPerWord / kPer;
        const uint32_t word = comp == 0 ? wv.x : comp == 1 ? wv.y
                              : comp == 2 ? wv.z : wv.w;
        const uint32_t bits = word >> (8 * sizeof(Code) * (g % kPer));
        const int code = sizeof(Code) == 1
            ? static_cast<int>(bits & 0xff)
            : static_cast<int>(static_cast<int16_t>(bits & 0xffff));
        const bool ok = g < gy && code >= 0 && code < B;
#pragma unroll
        for (int c = 0; c < C; ++c)
          off[e * C + c] = ok ? base + (g * B + code) * C + c : -1;
      }
      add_n<4 * C>(sh, off, v4);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < slab; i += blockDim.x) {
    const float x = sh[i];
    if (x == 0.0f) continue;
    const int c = i % C;
    int t = i / C;
    const int b = t % B;
    t /= B;
    const int g = t % G;
    t /= G;
    if (g >= gy || t >= nt) continue;
    atomicAdd(out + ((static_cast<long long>(b_lo + t) * F + f0 + g) * B + b)
                        * C + c, x);
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename Code, int RPT, int C>
int stream_launch(const void* bins, const void* rel, const void* vals,
                  void* out, int K, int n_nodes, int F, int B,
                  long long rows, int G, int node_range, int bin_chunk,
                  int replicas, int row_blocks, cudaStream_t stream) {
  auto kern = hist_stream<Code, RPT, C>;
  const int groups = (F + G - 1) / G;
  const int ranges = (K * n_nodes + node_range - 1) / node_range;
  const int bin_chunks = (B + bin_chunk - 1) / bin_chunk;
  const size_t smem = static_cast<size_t>(replicas) * node_range * G *
                      bin_chunk * C * sizeof(float);
  const int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<dim3(row_blocks, groups, ranges * bin_chunks), kThreads, smem,
         stream>>>(static_cast<const Code*>(bins),
                   static_cast<const int32_t*>(rel),
                   static_cast<const float*>(vals), static_cast<float*>(out),
                   K, n_nodes, F, B, rows, G, node_range, bin_chunk,
                   bin_chunks, replicas);
  return static_cast<int>(cudaGetLastError());
}

template <typename Code, int C>
int scatter_launch(const void* bins, const void* rel, const void* vals,
                   const void* excl, void* codes_out, void* vals_out, int K,
                   int n_nodes, int F, long long rows, int tile, int tiles,
                   int warps, int stride, cudaStream_t stream) {
  auto kern = part_scatter<Code, C>;
  const size_t smem = static_cast<size_t>(warps) * K * n_nodes * 4;
  const int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<(tiles + warps - 1) / warps, 32 * warps, smem, stream>>>(
      static_cast<const Code*>(bins), static_cast<const int32_t*>(rel),
      static_cast<const float*>(vals), static_cast<const int32_t*>(excl),
      static_cast<uint8_t*>(codes_out), static_cast<float*>(vals_out), K,
      n_nodes, F, rows, tile, tiles, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename Code, int C>
int seg_launch(const void* codes, const void* vals, const void* seg,
               void* out, int nb, int F, int B, int stride, int G,
               int tile_nodes, int splits, cudaStream_t stream) {
  auto kern = hist_seg<Code, C>;
  const int groups = (F + G - 1) / G;
  const int tiles = (nb + tile_nodes - 1) / tile_nodes;
  const size_t smem = static_cast<size_t>(tile_nodes) * G * B * C * 4 +
                      (tile_nodes + 1) * 4;
  const int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<dim3(splits, groups, tiles), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(vals),
      static_cast<const int32_t*>(seg), static_cast<float*>(out), nb, F, B,
      stride, G, tile_nodes);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers; stream is a
// cudaStream_t; plan fields come from ops/histogram.py hist_plan. Each
// returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernels do not take.

// The streaming histogram (hist_stream) of one level.
extern "C" int hist_launch(const void* bins, int code_bytes, const void* rel,
                           const void* vals, void* out, int K, int n_nodes,
                           int F, int B, int C, long long rows, int rpt,
                           int group, int node_range, int bin_chunk,
                           int replicas, int row_blocks, int device,
                           void* stream) {
  if ((code_bytes != 1 && code_bytes != 2) || (C != 2 && C != 3) ||
      (rpt != 1 && rpt != 4) || rows % rpt != 0 || group < 1 ||
      group > kStreamGroup || node_range < 1 || bin_chunk < 1 ||
      replicas < 1 || row_blocks < 1)
    return kBad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define H2O_STREAM(T, R, CC)                                                \
  if (sizeof(T) == static_cast<size_t>(code_bytes) && rpt == R && C == CC) \
    return stream_launch<T, R, CC>(bins, rel, vals, out, K, n_nodes, F, B,  \
                                   rows, group, node_range, bin_chunk,      \
                                   replicas, row_blocks, s);
  H2O_STREAM(uint8_t, 4, 2) H2O_STREAM(uint8_t, 4, 3)
  H2O_STREAM(uint8_t, 1, 2) H2O_STREAM(uint8_t, 1, 3)
  H2O_STREAM(int16_t, 4, 2) H2O_STREAM(int16_t, 4, 3)
  H2O_STREAM(int16_t, 1, 2) H2O_STREAM(int16_t, 1, 3)
#undef H2O_STREAM
  return kBad;
}

// The row partition of one level: the counts (part_count into cnt [nb *
// tiles]) when excl is null, else the scatter (part_scatter) with excl,
// the exclusive scan of those counts.
extern "C" int part_launch(const void* bins, int code_bytes, const void* rel,
                           const void* vals, void* cnt, const void* excl,
                           void* codes_out, void* vals_out, int K,
                           int n_nodes, int F, int C, long long rows,
                           int tile, int tiles, int warps, int stride,
                           int device, void* stream) {
  if ((code_bytes != 1 && code_bytes != 2) || (C != 2 && C != 3) ||
      warps < 1 || warps > 32 || tile < 32 || tile % 32 != 0 ||
      tiles < 1 || rows < 1 || stride % 16 != 0 ||
      stride < F * code_bytes ||
      static_cast<long long>(tiles - 1) * tile >=
          static_cast<long long>(K) * rows ||
      static_cast<long long>(tiles) * tile < static_cast<long long>(K) * rows)
    return kBad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (excl == nullptr) {
    const size_t smem = static_cast<size_t>(warps) * K * n_nodes * 4;
    const int e = set_smem(part_count, smem);
    if (e != 0) return e;
    part_count<<<(tiles + warps - 1) / warps, 32 * warps, smem, s>>>(
        static_cast<const int32_t*>(rel), static_cast<int32_t*>(cnt), K,
        n_nodes, rows, tile, tiles);
    return static_cast<int>(cudaGetLastError());
  }
#define H2O_SCATTER(T, CC)                                                  \
  if (sizeof(T) == static_cast<size_t>(code_bytes) && C == CC)             \
    return scatter_launch<T, CC>(bins, rel, vals, excl, codes_out,          \
                                 vals_out, K, n_nodes, F, rows, tile,       \
                                 tiles, warps, stride, s);
  H2O_SCATTER(uint8_t, 2) H2O_SCATTER(uint8_t, 3)
  H2O_SCATTER(int16_t, 2) H2O_SCATTER(int16_t, 3)
#undef H2O_SCATTER
  return kBad;
}

// The partitioned histogram (hist_seg) over the sorted pairs.
extern "C" int seg_hist_launch(const void* codes, int code_bytes,
                               const void* vals, const void* seg, void* out,
                               int nb, int F, int B, int C, int stride,
                               int group, int tile_nodes, int splits,
                               int device, void* stream) {
  const int max_group = code_bytes == 1 ? kMaxGroup<uint8_t>
                                        : kMaxGroup<int16_t>;
  if ((code_bytes != 1 && code_bytes != 2) || (C != 2 && C != 3) ||
      group < 1 || group > max_group || tile_nodes < 1 || splits < 1 ||
      stride % 16 != 0 || stride < F * code_bytes ||
      ((F + group - 1) / group > 1 && group * code_bytes % 16 != 0))
    return kBad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define H2O_SEG(T, CC)                                                      \
  if (sizeof(T) == static_cast<size_t>(code_bytes) && C == CC)             \
    return seg_launch<T, CC>(codes, vals, seg, out, nb, F, B, stride, group, \
                             tile_nodes, splits, s);
  H2O_SEG(uint8_t, 2) H2O_SEG(uint8_t, 3)
  H2O_SEG(int16_t, 2) H2O_SEG(int16_t, 3)
#undef H2O_SEG
  return kBad;
}

// Registers per thread of the streaming (kind 0) or partitioned (kind 1)
// histogram kernel for these fields, or -1: the wrapper's plan counts
// how many CTAs fit an SM with it.
extern "C" int hist_regs(int kind, int code_bytes, int rpt, int C) {
  const void* fn = nullptr;
#define H2O_FN(T, R, CC)                                                    \
  if (sizeof(T) == static_cast<size_t>(code_bytes) && C == CC) {           \
    if (kind == 0 && rpt == R)                                              \
      fn = reinterpret_cast<const void*>(hist_stream<T, R, CC>);            \
    if (kind == 1)                                                          \
      fn = reinterpret_cast<const void*>(hist_seg<T, CC>);                  \
  }
  H2O_FN(uint8_t, 4, 2) H2O_FN(uint8_t, 4, 3)
  H2O_FN(uint8_t, 1, 2) H2O_FN(uint8_t, 1, 3)
  H2O_FN(int16_t, 4, 2) H2O_FN(int16_t, 4, 3)
  H2O_FN(int16_t, 1, 2) H2O_FN(int16_t, 1, 3)
#undef H2O_FN
  cudaFuncAttributes a;
  if (fn == nullptr || cudaFuncGetAttributes(&a, fn) != cudaSuccess)
    return -1;
  return a.numRegs;
}
