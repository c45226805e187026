// Hand-written Hopper (sm_90a) kernels of the GEE main path.
//
// Three functions, one build, a plain C interface loaded with ctypes
// (repro_torch/kernels/build.py):
//
//   gee_spmm        replaces src/repro/kernels/gee_spmm.py::_gee_spmm_kernel
//                   z[r,k] = sum_d contrib[r,d] * [ylab[r,d] == k]
//   gee_spmm_fused  replaces src/repro/kernels/gee_fused.py::_gee_fused_kernel
//                   gee_spmm, then z[r, rowlab_r] += dadd_r, then row_norm
//   row_norm        replaces src/repro/kernels/row_norm.py::_row_norm_kernel
//                   row L2 normalization with the EPS_NORM clamp
//
// and a second source for the contraction's kernels, gee_gathered: the same
// launch (either epilogue) from a degree bucket's packing as it is (cols,
// vals) and the fit's per-vertex records (label and d^-1/2 in 8 bytes) and
// 1 / n_k, each slot's label, class weight and Laplacian scale gathered in
// registers, each finished row written in place to its row of the fit's
// [N, K] output.  It is what ell_planes, laplacian_vals and the diag addend
// would write into the planes, with the same bits (struct Gathered), so a
// fit's buckets need no [R, D] pass of their own.  It reads the 8 B a slot
// the planes cost, plus one 8-byte gather a slot from the [N] records, which
// sit in L2; at K = 5 on cl-100k-1d8-l5 those gathers, not HBM, bound it.
//
// Bound on the H100 (3.35 TB/s): bytes.  The contraction reads 8 B per ELL
// slot (int32 label, f32 contribution) once and writes 4*R*K B (the fused
// kernel also reads 8 B a row of rowlab/dadd); a slot costs K compare-selects,
// far below the card's instruction rate.  row_norm reads and writes 4*N*K B
// each; at K = 5 and N = 92,482 that is 3.7 MB, about one microsecond of
// bytes, so it is bound by the latency of its load-reduce-store chains and by
// launch cost (below).
//
// The contraction.  gee_spmm and gee_spmm_fused are the same two kernels: the
// staged call is the fused one with no diag term and no norm.  The degree
// buckets of a power-law graph run from tens of thousands of 128-slot rows to
// a single 65,536-slot hub row, so the work is cut by slots, not by rows, and
// the wrapper picks the geometry (repro_torch/kernels/gee_spmm.py::
// launch_geometry; checked here):
//
//  * 16-byte loads.  ylab is read as int4 and contrib as float4 when D % 4 == 0
//    and both bases are 16-byte aligned (every bucket); otherwise one slot a
//    load (a flat plane of any width, a sliced view).  A lane issues kVec
//    loads of each plane before it uses the first, so it keeps 2 * kVec loads
//    of 16 B in flight.
//  * Narrow rows (at most 32 * seg_loads loads, 2,048 slots; the instruction
//    count is what costs there): gee_seg_kernel gives a row a segment of L
//    lanes, L the power of two that leaves each lane about lane_loads loads
//    (up to a warp), so a warp holds 32 / L rows.  A segment reduces its row with a segmented xor
//    butterfly (log2 L shuffles a class): no shared memory, no block barrier.
//  * Wide rows (latency is what costs there): gee_span_kernel gives a block of
//    T <= 256 threads a span of S slots of one row.  A row wider than S is
//    split into ceil(D / S) spans on as many blocks, so the 65,536-slot hub row
//    runs on 16 SMs at S = 4,096, not on one, with every load of a thread in
//    flight at once.  A split span writes its K partial sums to a workspace;
//    the last of the row's blocks to arrive (a per-row ticket: __threadfence,
//    then atomicAdd) adds the partials in span order, so the bits never depend
//    on which block came last, and resets the ticket for the next launch on
//    the stream; it loads kCombineLoads partials at once, so the 16 spans of
//    the hub row cost one round trip to L2.  A row that fits one span is
//    finished by its own block, with no workspace.  Each block loads its
//    row's rowlab and dadd before its planes, off the critical path.
//  * Exact K.  K <= 8 is a template constant, so K = 5 makes 5 compare-selects
//    a slot; K > 8 walks class tiles of 16 or 32 (one read of the row a tile).
//
// Sum order (deterministic, the same on every run): a lane adds its slots in
// ascending order; a segment or warp combines its lanes with an xor butterfly
// (every lane ends with the same bits); a block combines its warps in
// ascending warp order; a split row's spans are added in ascending span order.
//
// The fused epilogue adds dadd at rowlab and normalizes with row_norm's
// arithmetic: row_l2_normalize_warp from shared memory, or, for K <= 8 in a
// segment, the same butterfly over the squares computed as a tree in
// registers, so the fused rows carry row_norm's bits.
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
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;
// The fused kernel keeps up to kBlockWarps rows of K floats in shared memory
// (class tiles): 8 * 1024 * 4 B = 32 KiB, inside the 48 KiB a block gets
// without opting in.
constexpr int kMaxClasses = 1024;
// row_norm's grid for K <= 32: at most this many blocks of kBlockThreads an
// SM, so that all are resident at once (8 * 8 = the SM's 64 warps, at <= 32
// registers a thread).
constexpr int kRowNormBlocksPerSm = 8;
// Loads of each plane a lane issues before it uses the first.
constexpr int kVec = 4;
// K up to this is a template constant; past it, class tiles of 16 or 32.
constexpr int kRegClasses = 8;
// Partial sums of a split row the finishing block loads at once, a class.
constexpr int kCombineLoads = 16;

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

__host__ __device__ constexpr int pow2_at_least(int k) {
  int w = 1;
  while (w < k) w *= 2;
  return w;
}

// One slot into the sums of a class tile (y already relative to the tile's
// first class): a -1 (padding) slot, or a class outside the tile, adds 0.
template <int KT>
__device__ __forceinline__ void add_slot(float (&acc)[KT], int y, float c) {
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] += (y == t) ? c : 0.f;
}

// One load of both planes at load index e of a row: U = 4 slots (int4 and
// float4) or U = 1 slot.
template <int U>
struct Load;

template <>
struct Load<4> {
  int4 y;
  float4 c;
  __device__ __forceinline__ void get(const int* yr, const float* cr, int64_t e) {
    y = __ldg(reinterpret_cast<const int4*>(yr) + e);
    c = __ldg(reinterpret_cast<const float4*>(cr) + e);
  }
  // slot u of the load (u a constant once unrolled), for the gathered source
  __device__ __forceinline__ int ys(int u) const {
    return u == 0 ? y.x : u == 1 ? y.y : u == 2 ? y.z : y.w;
  }
  __device__ __forceinline__ float cs(int u) const {
    return u == 0 ? c.x : u == 1 ? c.y : u == 2 ? c.z : c.w;
  }
  __device__ __forceinline__ void set(int u, int yv, float cv) {
    (u == 0 ? y.x : u == 1 ? y.y : u == 2 ? y.z : y.w) = yv;
    (u == 0 ? c.x : u == 1 ? c.y : u == 2 ? c.z : c.w) = cv;
  }
  template <int KT>
  __device__ __forceinline__ void add(float (&acc)[KT], int k0) const {
    add_slot<KT>(acc, y.x - k0, c.x);
    add_slot<KT>(acc, y.y - k0, c.y);
    add_slot<KT>(acc, y.z - k0, c.z);
    add_slot<KT>(acc, y.w - k0, c.w);
  }
};

template <>
struct Load<1> {
  int y;
  float c;
  __device__ __forceinline__ void get(const int* yr, const float* cr, int64_t e) {
    y = __ldg(yr + e);
    c = __ldg(cr + e);
  }
  template <int KT>
  __device__ __forceinline__ void add(float (&acc)[KT], int k0) const {
    add_slot<KT>(acc, y - k0, c);
  }
};

// ---------------------------------------------------------------------------
// Where a launch's slots come from.  Each source has a row view, RowOf, that a
// kernel opens once a row: the row's two slot streams, the row of `out` it
// writes, its diag term (class y, -1 for none, and addend a; loaded only where
// `lead`), and two per-load steps, `gather` (loads that depend on the streams)
// and `finish` (turns a load into (class, contribution) slots: -1 and 0 for a
// slot that does not count).
// ---------------------------------------------------------------------------

// The planes as ell_planes writes them: slot (ylab, contrib), the row's diag
// term (rowlab, dadd; none when rowlab is null); row r of the launch is row r
// of out.
struct Planes {
  static constexpr bool kScalarLoads = true;  // built for D % 4 != 0 too
  const int* ylab;
  const float* contrib;
  const int* rowlab;
  const float* dadd;
  __host__ __device__ bool diag_on() const { return rowlab != nullptr; }
  bool aligned16() const;
};

// A bucket's packing as it is (slot (cols, vals)) and the fit's per-vertex
// records: verts [N], each vertex's label and the bits of its d^-1/2 in one
// 8-byte record, so a slot's gather is one load; winv [K] (1 / n_k).  Row r
// of the launch is row row_ids[r] of out ([N, K]); a row whose id lies
// outside [0, N) (a padding row's dump row N) writes nothing.  Per slot, with
// c = clamp(col, 0, N - 1): lv = (v * dinv[row]) * dinv[c] with the
// Laplacian, else v, and y = label[c]; the slot counts iff lv != 0 and
// 0 <= y < K, adding lv * winv[y] to class y.  With `diag`, the row's term is
// y_r = label[row] and a = (dinv[row] * dinv[row]) * winv[y_r] (winv[y_r]
// without the Laplacian).  These are laplacian_vals, ell_planes and the fused
// driver's diag addend, product by product in the same order; every product
// is __fmul_rn, so none is contracted into an add, and the slots are the
// planes' bits.  Built for 16-byte loads only (D % 4 == 0, as every width of
// the bucket ladder is); the wrapper takes the planes for any other width.
struct Gathered {
  static constexpr bool kScalarLoads = false;
  const int* cols;
  const float* vals;
  const int* row_ids;
  const int2* verts;
  const float* winv;
  int64_t N;
  int laplacian;
  int diag;
  __host__ __device__ bool diag_on() const { return diag != 0; }
  bool aligned16() const;
};

template <int KC, class Src>
struct RowOf;

template <int KC>
struct RowOf<KC, Planes> {
  const int* yr;
  const float* cr;
  int64_t orow;
  bool live;    // the row's slots are read
  bool writes;  // the row is written to out
  int y;
  float a;
  template <int U>
  struct Extra {};
  // in_grid: the row exists (a segment past the last row reads nothing)
  __device__ __forceinline__ RowOf(const Planes& s, int64_t r, bool in_grid, int64_t D, int,
                                   bool lead) {
    live = writes = in_grid;
    orow = r;
    const int64_t base = live ? r * D : 0;
    yr = s.ylab + base;
    cr = s.contrib + base;
    const bool diag = live && lead && s.rowlab != nullptr;
    y = diag ? __ldg(s.rowlab + r) : -1;
    a = diag ? __ldg(s.dadd + r) : 0.f;
  }
  template <int U>
  __device__ __forceinline__ void get(Load<U>& ld, int64_t e) const {
    ld.get(yr, cr, e);
  }
  template <int U>
  __device__ __forceinline__ void gather(const Load<U>&, Extra<U>&) const {}
  template <int U>
  __device__ __forceinline__ void finish(Load<U>&, const Extra<U>&) const {}
};

template <int KC>
struct RowOf<KC, Gathered> {
  // K <= kRegClasses: winv in registers, read by a select a slot; class
  // tiles read it through L1 (the row is read again a tile anyway)
  static constexpr int kW = KC <= kRegClasses ? KC : 1;
  const int* cr;
  const float* vr;
  const int2* verts;
  const float* winv;
  int64_t last;  // N - 1
  int K;
  bool lap;
  float drow;
  float w[kW];
  int64_t orow;
  bool live;
  bool writes;
  int y;
  float a;
  template <int U>
  struct Extra {
    int2 v[U];  // the slots' vertex records
  };
  // The slot streams do not wait on row_ids: a row past the ids' range
  // reads its own (padding) slots and only its writes are skipped.
  __device__ __forceinline__ RowOf(const Gathered& s, int64_t r, bool in_grid, int64_t D, int K_,
                                   bool lead)
      : verts(s.verts), winv(s.winv), last(s.N - 1), K(K_), lap(s.laplacian != 0) {
    orow = in_grid ? __ldg(s.row_ids + r) : -1;
    live = in_grid;
    const int64_t base = live ? r * D : 0;
    cr = s.cols + base;
    vr = s.vals + base;
    writes = live && orow >= 0 && orow < s.N;
    if constexpr (KC <= kRegClasses) {
#pragma unroll
      for (int t = 0; t < KC; ++t) w[t] = __ldg(winv + t);
    }
    const bool diag = lead && s.diag;
    const int2 me = writes && (lap || diag) ? __ldg(verts + orow) : make_int2(-1, 0);
    drow = __int_as_float(me.y);
    const int yl = diag ? me.x : -1;
    const bool ok = yl >= 0 && yl < K;
    y = ok ? yl : -1;
    const float wy = ok ? weight(yl) : 0.f;
    a = lap ? __fmul_rn(__fmul_rn(drow, drow), wy) : wy;
  }
  // winv[c] for 0 <= c < K
  __device__ __forceinline__ float weight(int c) const {
    if constexpr (KC <= kRegClasses) {
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < KC; ++t) v = c == t ? w[t] : v;
      return v;
    } else {
      return __ldg(winv + c);
    }
  }
  template <int U>
  __device__ __forceinline__ void get(Load<U>& ld, int64_t e) const {
    ld.get(cr, vr, e);  // the load's y holds cols, its c vals
  }
  template <int U>
  __device__ __forceinline__ void gather(const Load<U>& ld, Extra<U>& ex) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int64_t c = ld.ys(u);
      c = c < 0 ? 0 : (c > last ? last : c);
      ex.v[u] = __ldg(verts + c);
    }
  }
  template <int U>
  __device__ __forceinline__ void finish(Load<U>& ld, const Extra<U>& ex) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float v = ld.cs(u);
      const float lv = lap ? __fmul_rn(__fmul_rn(v, drow), __int_as_float(ex.v[u].y)) : v;
      const int yv = ex.v[u].x;
      const bool ok = lv != 0.f && yv >= 0 && yv < K;
      ld.set(u, ok ? yv : -1, ok ? __fmul_rn(lv, weight(ok ? yv : 0)) : 0.f);
    }
  }
};

// Lane-private sums of the class tile [k0, k0 + KT) over the loads first,
// first + stride, ... < end of one row (load e holds slots [e*U, e*U + U)).
// kVec loads of each stream are issued before the first is used; a gathered
// row then issues all their gathers before it finishes the first slot.
template <int KT, int U, class Row>
__device__ __forceinline__ void lane_sums(const Row& rw, int64_t first, int64_t end, int stride,
                                          int k0, float (&acc)[KT]) {
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = 0.f;
  const int64_t step = static_cast<int64_t>(kVec) * stride;
  for (int64_t e0 = first; e0 < end; e0 += step) {
    Load<U> ld[kVec];
    typename Row::template Extra<U> ex[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (e0 + static_cast<int64_t>(v) * stride < end) rw.get(ld[v], e0 + v * stride);
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (e0 + static_cast<int64_t>(v) * stride < end) rw.gather(ld[v], ex[v]);
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (e0 + static_cast<int64_t>(v) * stride < end) {
        rw.finish(ld[v], ex[v]);
        ld[v].template add<KT>(acc, k0);
      }
    }
  }
}

// The fused epilogue on a row that every lane of its segment holds in
// registers (K = KC <= 8): the diag term, then row_l2_normalize_warp's
// arithmetic.  Its butterfly over the squares is computed as the same tree in
// registers (the full warp's butterfly adds exact zeros in the steps past
// pow2_at_least(KC)), so the bits are row_norm's.
template <int KC>
__device__ __forceinline__ void epilogue_regs(float (&z)[KC], int y, float a, int correlation,
                                              float eps) {
#pragma unroll
  for (int t = 0; t < KC; ++t) {
    if (t == y) z[t] += a;
  }
  if (!correlation) return;
  constexpr int W = pow2_at_least(KC);
  float sq[W];
#pragma unroll
  for (int t = 0; t < W; ++t) sq[t] = t < KC ? fmaf(z[t], z[t], 0.f) : 0.f;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int t = 0; t < o; ++t) sq[t] += sq[t + o];
  }
  const float norm = sqrtf(sq[0]);
  const float denom = fmaxf(norm, eps);
#pragma unroll
  for (int t = 0; t < KC; ++t) z[t] = norm > 0.f ? z[t] / denom : 0.f;
}

// The fused epilogue on a row in shared memory, by one warp: the diag term a
// at class y (lane 0's; none at y = -1), then row_l2_normalize_warp (without
// correlation, a copy).
__device__ __forceinline__ void epilogue_warp(float* row, float* orow, int K, int y, float a,
                                              int correlation, float eps, int lane) {
  if (lane == 0 && y >= 0 && y < K) row[y] += a;
  __syncwarp();
  if (correlation) {
    row_l2_normalize_warp(row, orow, K, eps, lane);
  } else {
    for (int k = lane; k < K; k += kWarp) orow[k] = row[k];
  }
}

// Rows of at most 32 * seg_loads loads: a segment of L lanes a row (L a power
// of two <= 32; L = 32 for class tiles), so kBlockThreads / L rows a block.
// KC <= 8: K == KC, the row in registers; KC = 16 or 32: class tiles of KC,
// one warp a row, the row in shared memory when the epilogue runs.
template <int KC, int U, class Src>
__global__ void __launch_bounds__(kBlockThreads)
gee_seg_kernel(const Src src, float* __restrict__ out, int64_t R, int64_t D, int K, int L,
               int correlation, float eps) {
  extern __shared__ float rows[];  // class tiles with an epilogue: [kBlockWarps][K]
  const int lane = threadIdx.x % kWarp;
  const int j = lane & (L - 1);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kBlockThreads / L) + threadIdx.x / L;
  // the row's diag term, loaded ahead of the slots
  const RowOf<KC, Src> rw(src, r, r < R, D, K, true);
  const int64_t loads = rw.live ? D / U : 0;  // dead segments still join the shuffles
  const bool epi = src.diag_on() || correlation;
  if constexpr (KC <= kRegClasses) {
    float z[KC];
    lane_sums<KC, U>(rw, j, loads, L, 0, z);
    for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int t = 0; t < KC; ++t) z[t] += __shfl_xor_sync(kFullMask, z[t], o, L);
    }
    if (!rw.writes) return;  // after the last shuffle
    if (epi) epilogue_regs<KC>(z, rw.y, rw.a, correlation, eps);
    float* orow = out + rw.orow * K;
#pragma unroll
    for (int t = 0; t < KC; ++t) {
      if ((t & (L - 1)) == j) orow[t] = z[t];
    }
  } else {
    float* row = rows + (threadIdx.x / kWarp) * K;
    float* dst = epi ? row : out + rw.orow * K;
    for (int k0 = 0; k0 < K; k0 += KC) {
      float z[KC];
      lane_sums<KC, U>(rw, lane, loads, kWarp, k0, z);
      float mine = 0.f;
#pragma unroll
      for (int t = 0; t < KC; ++t) {
        const float s = warp_sum(z[t]);
        if (t == lane) mine = s;
      }
      if (rw.writes && lane < KC && k0 + lane < K) dst[k0 + lane] = mine;
    }
    if (!rw.writes || !epi) return;  // whole warps: L == 32
    __syncwarp();
    epilogue_warp(row, out + rw.orow * K, K, rw.y, rw.a, correlation, eps, lane);
  }
}

// Rows of more than 32 * seg_loads loads: a block of T = blockDim.x threads
// (64, 128 or 256) takes a span of S slots of one row; block b is span
// b % nspans of row b / nspans.  With nspans > 1, each span's sums go to
// ws[b][K] and the row's last block to arrive finishes the row.
template <int KC, int U, class Src>
__global__ void __launch_bounds__(kBlockThreads)
gee_span_kernel(const Src src, float* __restrict__ out, float* __restrict__ ws,
                int* __restrict__ tickets, int64_t D, int K, int64_t S, int nspans,
                int correlation, float eps) {
  __shared__ float part[kBlockWarps][KC];
  __shared__ int last;
  extern __shared__ float row[];  // [K] when the epilogue runs
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int64_t b = blockIdx.x;
  const int64_t r = b / nspans;
  // the row's diag term, loaded ahead of the slots (used by thread 0)
  const RowOf<KC, Src> rw(src, r, true, D, K, tid == 0);
  if (!rw.writes) return;  // every block of a skipped row leaves: no ticket
  const int64_t span_loads = S / U;
  const int64_t first = (b - r * nspans) * span_loads;
  const int64_t end = first + span_loads < D / U ? first + span_loads : D / U;
  const bool epi = src.diag_on() || correlation;
  const bool split = nspans > 1;
  float* dst = split ? ws + b * K : (epi ? row : out + rw.orow * K);
  for (int k0 = 0; k0 < K; k0 += KC) {
    float z[KC];
    lane_sums<KC, U>(rw, first + tid, end, T, k0, z);
#pragma unroll
    for (int t = 0; t < KC; ++t) z[t] = warp_sum(z[t]);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < KC; ++t) part[warp][t] = z[t];
    }
    __syncthreads();
    if (tid < KC && k0 + tid < K) {
      float v = part[0][tid];
      for (int w = 1; w < T / kWarp; ++w) v += part[w][tid];
      dst[k0 + tid] = v;
    }
    __syncthreads();
  }
  if (split) {
    // The ticket: the last of the row's blocks to arrive adds the spans'
    // partial sums, in span order.
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + r, 1) == nspans - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* p = ws + r * nspans * K;
    float* to = epi ? row : out + rw.orow * K;
    for (int k = tid; k < K; k += T) {
      // kCombineLoads partials in flight at once, added in span order
      float v = 0.f;
      for (int i0 = 0; i0 < nspans; i0 += kCombineLoads) {
        float q[kCombineLoads];
#pragma unroll
        for (int u = 0; u < kCombineLoads; ++u) {
          q[u] = i0 + u < nspans ? __ldcg(p + static_cast<int64_t>(i0 + u) * K + k) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kCombineLoads; ++u) {
          if (i0 + u < nspans) v += q[u];
        }
      }
      to[k] = v;
    }
    if (tid == 0) tickets[r] = 0;  // ready for the next launch on this stream
    __syncthreads();
  }
  if (epi && warp == 0) {
    epilogue_warp(row, out + rw.orow * K, K, rw.y, rw.a, correlation, eps, lane);
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

bool grid_for(int64_t R, int rows_per_block, unsigned* blocks) {
  const int64_t b = (R + rows_per_block - 1) / rows_per_block;
  if (b <= 0 || b > INT_MAX) return false;
  *blocks = static_cast<unsigned>(b);
  return true;
}

// K <= kRegClasses: f(K) as a constant; past it, the class tile 16 or 32.
template <typename F>
void with_tile(int K, F&& f) {
  static_assert(kRegClasses == 8, "one case a K up to kRegClasses");
  switch (K) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 7: f(std::integral_constant<int, 7>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    default:
      if (K <= 16) {
        f(std::integral_constant<int, 16>{});
      } else {
        f(std::integral_constant<int, 32>{});
      }
      break;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool Planes::aligned16() const {
  return ::aligned16(ylab) && ::aligned16(contrib);
}

bool Gathered::aligned16() const {
  return ::aligned16(cols) && ::aligned16(vals);
}

// The contraction with an optional epilogue (the source's diag term,
// correlation), at the geometry the wrapper chose: lanes <= 32 takes
// gee_seg_kernel with `lanes` lanes a row; lanes in {64, 128, 256} takes
// gee_span_kernel with blocks of `lanes` threads over spans of `span` slots.
// vec: 16-byte loads of the source's two slot streams, which a source
// without kScalarLoads requires (its kernels are built for them alone).
template <class Src>
int contraction_launch(const Src& src, void* out, void* ws, void* tickets, int64_t R, int64_t D,
                       int K, int correlation, float eps, int vec, int lanes, int64_t span,
                       void* stream) {
  if (R < 0 || D < 0 || K < 1) return cudaErrorInvalidValue;
  const bool epi = src.diag_on() || correlation;
  if (epi && K > kMaxClasses) return cudaErrorInvalidValue;
  if (lanes < 1 || lanes > kBlockThreads || (lanes & (lanes - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  if (vec && (D % 4 != 0 || !src.aligned16())) return cudaErrorInvalidValue;
  if (!vec && !Src::kScalarLoads) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= kWarp) {
    if (K > kRegClasses && lanes != kWarp) return cudaErrorInvalidValue;
    unsigned blocks;
    if (!grid_for(R, kBlockThreads / lanes, &blocks)) return cudaErrorInvalidConfiguration;
    const size_t smem = epi && K > kRegClasses ? sizeof(float) * kBlockWarps * K : 0;
    with_tile(K, [&](auto kc) {
      constexpr int KC = decltype(kc)::value;
      if (vec) {
        gee_seg_kernel<KC, 4, Src><<<blocks, kBlockThreads, smem, s>>>(src, o, R, D, K, lanes,
                                                                       correlation, eps);
      } else if constexpr (Src::kScalarLoads) {
        gee_seg_kernel<KC, 1, Src><<<blocks, kBlockThreads, smem, s>>>(src, o, R, D, K, lanes,
                                                                       correlation, eps);
      }
    });
    return static_cast<int>(cudaGetLastError());
  }
  if (lanes < 2 * kWarp || span < 1 || (vec && span % 4 != 0)) return cudaErrorInvalidValue;
  const int64_t nspans = D > span ? (D + span - 1) / span : 1;
  if (nspans > INT_MAX / 2 || R > INT_MAX / nspans) return cudaErrorInvalidConfiguration;
  if (nspans > 1 && (ws == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(R * nspans);
  const size_t smem = epi ? sizeof(float) * K : 0;
  float* w = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  const int ns = static_cast<int>(nspans);
  with_tile(K, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (vec) {
      gee_span_kernel<KC, 4, Src><<<blocks, lanes, smem, s>>>(src, o, w, tk, D, K, span, ns,
                                                              correlation, eps);
    } else if constexpr (Src::kScalarLoads) {
      gee_span_kernel<KC, 1, Src><<<blocks, lanes, smem, s>>>(src, o, w, tk, D, K, span, ns,
                                                              correlation, eps);
    }
  });
  return static_cast<int>(cudaGetLastError());
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

// ws: [R, nspans, K] f32 and tickets: [>= R] int32, all zero, when a row is
// split (lanes > 32 and D > span); otherwise either may be null.
int gee_spmm_launch(const void* ylab, const void* contrib, void* out, void* ws, void* tickets,
                    int64_t R, int64_t D, int K, int vec, int lanes, int64_t span,
                    void* stream) {
  const Planes src{static_cast<const int*>(ylab), static_cast<const float*>(contrib), nullptr,
                   nullptr};
  return contraction_launch(src, out, ws, tickets, R, D, K, 0, 0.f, vec, lanes, span, stream);
}

int gee_spmm_fused_launch(const void* ylab, const void* contrib, const void* rowlab,
                          const void* dadd, void* out, void* ws, void* tickets, int64_t R,
                          int64_t D, int K, int correlation, float eps, int vec, int lanes,
                          int64_t span, void* stream) {
  if (K > kMaxClasses) return cudaErrorInvalidValue;
  if ((rowlab == nullptr) != (dadd == nullptr)) return cudaErrorInvalidValue;
  const Planes src{static_cast<const int*>(ylab), static_cast<const float*>(contrib),
                   static_cast<const int*>(rowlab), static_cast<const float*>(dadd)};
  return contraction_launch(src, out, ws, tickets, R, D, K, correlation, eps, vec, lanes, span,
                            stream);
}

// The gathered source (see Gathered): cols/vals [R, D], row_ids [R], verts
// [N] 8-byte records (label, d^-1/2 bits; 8-byte aligned), winv [K], out
// [N, K] (rows not named by row_ids are left as they are); laplacian: scale
// by d^-1/2; diag: the diag term; ws and tickets as above; vec must be 1.
int gee_gathered_launch(const void* cols, const void* vals, const void* row_ids,
                        const void* verts, const void* winv, void* out, void* ws, void* tickets,
                        int64_t R, int64_t D, int64_t N, int K, int laplacian, int diag,
                        int correlation, float eps, int vec, int lanes, int64_t span,
                        void* stream) {
  if (R > 0 && (N < 1 || cols == nullptr || vals == nullptr || row_ids == nullptr ||
                verts == nullptr || winv == nullptr || out == nullptr ||
                reinterpret_cast<uintptr_t>(verts) % 8 != 0)) {
    return cudaErrorInvalidValue;
  }
  const Gathered src{static_cast<const int*>(cols),   static_cast<const float*>(vals),
                     static_cast<const int*>(row_ids), static_cast<const int2*>(verts),
                     static_cast<const float*>(winv), N,
                     laplacian ? 1 : 0,                diag ? 1 : 0};
  return contraction_launch(src, out, ws, tickets, R, D, K, correlation, eps, vec, lanes, span,
                            stream);
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
