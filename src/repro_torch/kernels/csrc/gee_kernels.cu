// Hand-written Hopper (sm_90a) kernels of the GEE main path.
//
// Three kernels, one build, a plain C interface loaded with ctypes
// (repro_torch/kernels/build.py):
//
//   gee_spmm        replaces src/repro/kernels/gee_spmm.py::_gee_spmm_kernel
//                   z[r,k] = sum_d contrib[r,d] * [ylab[r,d] == k]
//   row_norm        replaces src/repro/kernels/row_norm.py::_row_norm_kernel
//                   row L2 normalization with the EPS_NORM clamp
//   gee_spmm_fused  replaces src/repro/kernels/gee_fused.py::_gee_fused_kernel
//                   gee_spmm, then z[r, rowlab_r] += dadd_r, then row_norm
//
// Bound on the H100 (3.35 TB/s): all three move bytes and do a few operations
// per byte.  gee_spmm and gee_spmm_fused read 8 B per ELL slot (int32 label,
// f32 contribution) and write 4*R*K B (the fused kernel also reads 8 B per
// row of rowlab/dadd); row_norm reads and writes 4*N*K B each.  At K = 5 and
// N = 92,482 that is 3.7 MB, about one microsecond of bytes: row_norm is
// bound by the latency of its load-reduce-store chains and by launch cost,
// so its design is about how many chains are in flight (below).
//
// Design.  The TPU kernels walk the degree axis as a sequential grid axis and
// revisit the output block.  Here blocks run unordered, so a row's whole
// degree is reduced inside one block: a group of 1, 2, 4 or 8 warps owns one
// row (more warps for wider rows, so the 65,536-wide hub rows of power-law
// graphs are split over 256 threads while narrow buckets keep one warp a row
// and many rows in flight).  Each thread keeps lane-private sums for a tile
// of KT classes in registers and streams its slots once per class tile with
// coalesced loads; no atomics, no cross-block accumulation, no output
// revisit.  Rows are disjoint within and across buckets.  The design does
// nothing more for the byte bound than read each slot once (for K <= 32) and
// write each output once: the fused kernel saves the [N, K] round trip of
// the staged epilogue by keeping the K-wide row in shared memory until the
// diag term is added and the row normalized.
//
// Sum order (deterministic, the same on every run): thread p of a row group
// of G threads adds slots p, p+G, p+2G, ... in ascending order; each warp
// then combines its lanes with an xor butterfly (every lane ends with the
// same bits); the group's warps are combined in ascending warp order.
//
// row_norm.  For K <= 32 a row is a segment of W lanes, W the power of two
// >= K, so a warp holds 32 / W contiguous rows and loads them as one span;
// each row is reduced by an xor butterfly inside its segment.  A grid of a
// few blocks per SM strides over the row groups and issues the next group's
// load before it reduces the current one, so every warp keeps two load
// chains in flight instead of one chain per wave of one-row warps.  K > 32
// keeps one warp a row (the routine the fused epilogue calls).  The
// segmented butterfly gives the bits of the full-warp one: in the steps it
// skips, the full butterfly adds exact zeros (lanes >= K hold 0).
//
// Numerics: IEEE sqrtf and division, no rsqrtf, no flushed denormals (the
// build passes no --use_fast_math): the EPS_NORM = 1e-30 clamp of
// repro/core/epilogue.py exists for denormal-norm rows.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;
// The fused kernel keeps kBlockWarps rows of K floats in shared memory:
// 8 * 1024 * 4 B = 32 KiB, inside the 48 KiB a block gets without opting in.
constexpr int kMaxClasses = 1024;
// row_norm's grid for K <= 32: at most this many blocks of kBlockThreads an
// SM, so that all are resident at once (8 * 8 = the SM's 64 warps, at <= 32
// registers a thread).
constexpr int kRowNormBlocksPerSm = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The full-warp row norm of the fused epilogue and of row_norm at K > 32:
// norm = sqrt(sum_k z_k^2); rows with norm 0 stay exactly 0, the others are
// divided by max(norm, eps).  One full warp per row.  row_norm_seg_kernel
// computes the same bits for K <= 32 with W lanes a row.
__device__ __forceinline__ void row_l2_normalize_warp(const float* row, float* out,
                                                      int K, float eps, int lane) {
  float ss = 0.f;
  for (int k = lane; k < K; k += kWarp) {
    const float v = row[k];
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float norm = sqrtf(ss);
  const float denom = fmaxf(norm, eps);
  for (int k = lane; k < K; k += kWarp) out[k] = norm > 0.f ? row[k] / denom : 0.f;
}

// Lane-private sums of one class tile [k0, k0 + KT) over the slots this
// thread owns (p, p + stride, ...).  A -1 (padding) slot matches no class.
template <int KT>
__device__ __forceinline__ void contract_tile(const int* __restrict__ ylab,
                                              const float* __restrict__ contrib,
                                              int64_t D, int k0, int p, int stride,
                                              float (&acc)[KT]) {
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = 0.f;
#pragma unroll 4
  for (int64_t d = p; d < D; d += stride) {
    const int y = __ldg(ylab + d) - k0;
    const float c = __ldg(contrib + d);
#pragma unroll
    for (int t = 0; t < KT; ++t) acc[t] += (y == t) ? c : 0.f;
  }
}

// Combine one tile's lane-private sums over the row group and store the
// finished sums at dst[k0 + t] (from the group's first warp, lane t).
// Every thread of the block calls this the same number of times.
template <int KT>
__device__ __forceinline__ void group_reduce(float (&acc)[KT], float (*part)[KT],
                                             int warp, int lane, int first_warp,
                                             int wpr, float* dst, int k0, int K) {
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = warp_sum(acc[t]);
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < KT; ++t) part[warp][t] = acc[t];
  }
  __syncthreads();
  if (dst != nullptr && lane < KT && k0 + lane < K) {
    float s = 0.f;
    for (int j = 0; j < wpr; ++j) s += part[first_warp + j][lane];
    dst[k0 + lane] = s;
  }
  __syncthreads();
}

struct RowGroup {
  int warp, lane, wpr, first_warp, p;
  int64_t r;
  bool leader;  // the group's first warp of a real row
  bool live;    // r < R
};

__device__ __forceinline__ RowGroup row_group(int64_t R, int wpr) {
  RowGroup g;
  g.warp = threadIdx.x / kWarp;
  g.lane = threadIdx.x % kWarp;
  g.wpr = wpr;
  const int group = g.warp / wpr;
  g.first_warp = group * wpr;
  g.p = (g.warp - g.first_warp) * kWarp + g.lane;
  g.r = static_cast<int64_t>(blockIdx.x) * (kBlockWarps / wpr) + group;
  g.live = g.r < R;
  g.leader = g.live && g.warp == g.first_warp;
  return g;
}

template <int KT>
__global__ void __launch_bounds__(kBlockThreads)
gee_spmm_kernel(const int* __restrict__ ylab, const float* __restrict__ contrib,
                float* __restrict__ out, int64_t R, int64_t D, int K, int wpr) {
  __shared__ float part[kBlockWarps][KT];
  const RowGroup g = row_group(R, wpr);
  const int64_t d_end = g.live ? D : 0;  // dead groups still join the syncs
  const int64_t base = g.live ? g.r * D : 0;
  float* dst = g.leader ? out + g.r * K : nullptr;
  for (int k0 = 0; k0 < K; k0 += KT) {
    float acc[KT];
    contract_tile<KT>(ylab + base, contrib + base, d_end, k0, g.p, wpr * kWarp, acc);
    group_reduce<KT>(acc, part, g.warp, g.lane, g.first_warp, wpr, dst, k0, K);
  }
}

template <int KT>
__global__ void __launch_bounds__(kBlockThreads)
gee_spmm_fused_kernel(const int* __restrict__ ylab, const float* __restrict__ contrib,
                      const int* __restrict__ rowlab, const float* __restrict__ dadd,
                      float* __restrict__ out, int64_t R, int64_t D, int K, int wpr,
                      int correlation, float eps) {
  __shared__ float part[kBlockWarps][KT];
  extern __shared__ float rows[];  // [kBlockWarps / wpr][K]
  const RowGroup g = row_group(R, wpr);
  const int64_t d_end = g.live ? D : 0;
  const int64_t base = g.live ? g.r * D : 0;
  float* row = rows + static_cast<int64_t>(g.first_warp / wpr) * K;
  for (int k0 = 0; k0 < K; k0 += KT) {
    float acc[KT];
    contract_tile<KT>(ylab + base, contrib + base, d_end, k0, g.p, wpr * kWarp, acc);
    group_reduce<KT>(acc, part, g.warp, g.lane, g.first_warp, wpr,
                     g.leader ? row : nullptr, k0, K);
  }
  if (!g.leader) return;  // no block-wide sync below this point
  if (rowlab != nullptr && g.lane == 0) {
    const int y = rowlab[g.r];
    if (y >= 0 && y < K) row[y] += dadd[g.r];
  }
  __syncwarp();
  float* orow = out + g.r * K;
  if (correlation) {
    row_l2_normalize_warp(row, orow, K, eps, g.lane);
  } else {
    for (int k = g.lane; k < K; k += kWarp) orow[k] = row[k];
  }
}

// K > 32: one warp a row.
__global__ void __launch_bounds__(kBlockThreads)
row_norm_kernel(const float* __restrict__ z, float* __restrict__ out, int64_t N, int K,
                float eps) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kBlockWarps + warp;
  if (r >= N) return;  // whole warps leave together
  row_l2_normalize_warp(z + r * K, out + r * K, K, eps, lane);
}

// K <= W <= 32: a warp holds kWarp / W rows, W lanes a row; the grid strides
// over groups of kWarp / W rows, one group a warp at a time.
template <int W>
__global__ void __launch_bounds__(kBlockThreads)
row_norm_seg_kernel(const float* __restrict__ z, float* __restrict__ out, int64_t N,
                    int K, float eps) {
  constexpr int kRows = kWarp / W;
  const int lane = threadIdx.x % kWarp;
  const int c = lane % W;
  const int64_t groups = (N + kRows - 1) / kRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlockWarps;
  int64_t g = static_cast<int64_t>(blockIdx.x) * kBlockWarps + threadIdx.x / kWarp;
  // the element this lane owns in group gg: its offset, or -1 past the data
  auto slot = [&](int64_t gg) -> int64_t {
    const int64_t r = gg * kRows + lane / W;
    return gg < groups && r < N && c < K ? r * K + c : -1;
  };
  int64_t at = slot(g);
  float v = at >= 0 ? __ldg(z + at) : 0.f;
  for (; g < groups; g += stride) {  // g is the same on every lane of a warp
    const int64_t at_next = slot(g + stride);
    const float v_next = at_next >= 0 ? __ldg(z + at_next) : 0.f;
    float ss = fmaf(v, v, 0.f);
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(kFullMask, ss, o, W);
    const float norm = sqrtf(ss);
    const float denom = fmaxf(norm, eps);
    if (at >= 0) out[at] = norm > 0.f ? v / denom : 0.f;
    at = at_next;
    v = v_next;
  }
}

// Warps per row: one below 2,048 slots, then doubling with the width up to
// a whole block (8 warps) from 8,192 slots, so a thread walks >= 64 slots.
int warps_per_row(int64_t D) {
  int wpr = 1;
  while (wpr < kBlockWarps && D >= 2048LL * wpr) wpr *= 2;
  return wpr;
}

// The class tile: the smallest of 4, 8, 16, 32 that covers K (32 beyond).
int class_tile(int K) {
  if (K <= 4) return 4;
  if (K <= 8) return 8;
  if (K <= 16) return 16;
  return 32;
}

bool grid_for(int64_t R, int rows_per_block, unsigned* blocks) {
  const int64_t b = (R + rows_per_block - 1) / rows_per_block;
  if (b <= 0 || b > INT_MAX) return false;
  *blocks = static_cast<unsigned>(b);
  return true;
}

template <int KT>
void launch_spmm(const int* ylab, const float* contrib, float* out, int64_t R,
                 int64_t D, int K, int wpr, unsigned blocks, cudaStream_t s) {
  gee_spmm_kernel<KT><<<blocks, kBlockThreads, 0, s>>>(ylab, contrib, out, R, D, K, wpr);
}

template <int KT>
void launch_fused(const int* ylab, const float* contrib, const int* rowlab,
                  const float* dadd, float* out, int64_t R, int64_t D, int K, int wpr,
                  int correlation, float eps, unsigned blocks, size_t smem,
                  cudaStream_t s) {
  gee_spmm_fused_kernel<KT><<<blocks, kBlockThreads, smem, s>>>(
      ylab, contrib, rowlab, dadd, out, R, D, K, wpr, correlation, eps);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface.  Every launcher returns cudaGetLastError() right after the
// launch (0 = launched); it launches on the given stream and never syncs.
// ---------------------------------------------------------------------------

extern "C" {

int gee_kernels_max_classes() { return kMaxClasses; }

const char* gee_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gee_spmm_launch(const void* ylab, const void* contrib, void* out, int64_t R,
                    int64_t D, int K, void* stream) {
  if (K < 1 || D < 0) return cudaErrorInvalidValue;
  const int wpr = warps_per_row(D);
  unsigned blocks;
  if (!grid_for(R, kBlockWarps / wpr, &blocks)) return cudaErrorInvalidConfiguration;
  const int* y = static_cast<const int*>(ylab);
  const float* c = static_cast<const float*>(contrib);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (class_tile(K)) {
    case 4: launch_spmm<4>(y, c, o, R, D, K, wpr, blocks, s); break;
    case 8: launch_spmm<8>(y, c, o, R, D, K, wpr, blocks, s); break;
    case 16: launch_spmm<16>(y, c, o, R, D, K, wpr, blocks, s); break;
    default: launch_spmm<32>(y, c, o, R, D, K, wpr, blocks, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int gee_spmm_fused_launch(const void* ylab, const void* contrib, const void* rowlab,
                          const void* dadd, void* out, int64_t R, int64_t D, int K,
                          int correlation, float eps, void* stream) {
  if (K < 1 || K > kMaxClasses || D < 0) return cudaErrorInvalidValue;
  if ((rowlab == nullptr) != (dadd == nullptr)) return cudaErrorInvalidValue;
  const int wpr = warps_per_row(D);
  unsigned blocks;
  if (!grid_for(R, kBlockWarps / wpr, &blocks)) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * static_cast<size_t>(kBlockWarps / wpr) * K;
  const int* y = static_cast<const int*>(ylab);
  const float* c = static_cast<const float*>(contrib);
  const int* rl = static_cast<const int*>(rowlab);
  const float* da = static_cast<const float*>(dadd);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (class_tile(K)) {
    case 4: launch_fused<4>(y, c, rl, da, o, R, D, K, wpr, correlation, eps, blocks, smem, s); break;
    case 8: launch_fused<8>(y, c, rl, da, o, R, D, K, wpr, correlation, eps, blocks, smem, s); break;
    case 16: launch_fused<16>(y, c, rl, da, o, R, D, K, wpr, correlation, eps, blocks, smem, s); break;
    default: launch_fused<32>(y, c, rl, da, o, R, D, K, wpr, correlation, eps, blocks, smem, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int row_norm_launch(const void* z, void* out, int64_t N, int K, float eps, void* stream) {
  if (K < 1) return cudaErrorInvalidValue;
  const float* zf = static_cast<const float*>(z);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > kWarp) {
    unsigned blocks;
    if (!grid_for(N, kBlockWarps, &blocks)) return cudaErrorInvalidConfiguration;
    row_norm_kernel<<<blocks, kBlockThreads, 0, s>>>(zf, o, N, K, eps);
    return static_cast<int>(cudaGetLastError());
  }
  int w = 1;
  while (w < K) w *= 2;
  const int64_t groups = (N + kWarp / w - 1) / (kWarp / w);
  unsigned blocks;
  if (!grid_for(groups, kBlockWarps, &blocks)) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // no more blocks than are resident at once: past that, warps stride
  const unsigned most = static_cast<unsigned>(sms) * kRowNormBlocksPerSm;
  if (blocks > most) blocks = most;
  switch (w) {
    case 1: row_norm_seg_kernel<1><<<blocks, kBlockThreads, 0, s>>>(zf, o, N, K, eps); break;
    case 2: row_norm_seg_kernel<2><<<blocks, kBlockThreads, 0, s>>>(zf, o, N, K, eps); break;
    case 4: row_norm_seg_kernel<4><<<blocks, kBlockThreads, 0, s>>>(zf, o, N, K, eps); break;
    case 8: row_norm_seg_kernel<8><<<blocks, kBlockThreads, 0, s>>>(zf, o, N, K, eps); break;
    case 16: row_norm_seg_kernel<16><<<blocks, kBlockThreads, 0, s>>>(zf, o, N, K, eps); break;
    default: row_norm_seg_kernel<32><<<blocks, kBlockThreads, 0, s>>>(zf, o, N, K, eps); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
