// Hand-written Hopper (sm_90a) kernels of vertex-similarity retrieval.
//
// Four kernels, built with gee_kernels.cu into the one ctypes library
// (repro_torch/kernels/build.py):
//
//   pairwise_scores       replaces src/repro/kernels/topk_score.py::_pairwise_kernel
//                         masked [Q, M] scores of queries against a shared database
//   gathered_scores       replaces src/repro/kernels/topk_score.py::_gathered_kernel
//                         the same scores against per-query candidates [Q, M, K]
//   scored_topk           replaces src/repro/kernels/topk_score.py::_pairwise_topk_kernel
//                         pairwise_scores with a top-k; the [Q, M] scores never
//                         reach device memory
//   scored_topk_gathered  replaces src/repro/kernels/topk_score.py::_gathered_topk_kernel
//                         gathered_scores with a top-k that reports each
//                         candidate's database id
//
// Scores: l2 is (2·dot − ‖q‖²) − ‖x‖² = −‖q − x‖²; cosine is dot / (‖q‖‖x‖),
// 0 when sqrt(‖q‖²)·sqrt(‖x‖²) is 0 (clamped at 1e-30).  A masked slot
// (valid/mask == 0) scores NEG_INF = −FLT_MAX.  dot, ‖q‖² and ‖x‖² are summed
// in one loop over k, ascending, in f32; IEEE sqrtf and division (the build
// has no --use_fast_math).
//
// K is 3–9 classes, so each score is a few multiply-adds on 4·K bytes (each
// kernel's bound on the H100 is named below); a tensor core or a TPU-style
// 128-lane K padding would only add bytes.  K is not padded.
//
// Design.
//   * gathered_scores runs one thread per output (q, m), with a warp on
//     neighbouring m: the output and the gathered candidates are read and
//     written as contiguous spans.  A masked slot reads no candidate.
//   * pairwise_scores has three shapes on the main path: the index build
//     (92,482 vertices against <= 10 centroids), a flush's probe (64 queries
//     against the same centroids) and the staged brute force (64 queries
//     against all 92,482 rows).  The first two write a few hundred KB or
//     less: what bounds them is the launch and one load latency, not bytes.
//     So with few database rows (M <= kSmallM) a thread takes one output,
//     with K a template constant and 32-bit indices, and issues all its
//     loads at once; on the H100 (80GB HBM3, 700 W) that beat a block that
//     stages the centroids, their norms and valid in shared memory at both
//     shapes (tools/topk_variants.py).  With many rows (the staged brute
//     force: a 23.7 MB output, bound by bytes) a thread takes a database
//     row, neighbouring threads neighbouring m, loads it and its ‖x‖² once
//     and scores it against kColQueries query rows held in shared memory,
//     so each store instruction writes a contiguous span.  valid is read
//     as it comes: bytes (bool/uint8, nonzero = live) or f32 (> 0 = live),
//     so the index's bool mask needs no cast kernel a call.
//   * The top-k kernels.  The TPU carries a running top-k across a
//     sequential grid axis; Hopper blocks run in no order.  So every
//     candidate is ranked by one total order -- score descending, then
//     candidate position m ascending -- under which the top-k is unique and
//     any merge order gives the reference's stable order (equal scores in
//     ascending m; for the gathered kernel m is the position in the row, not
//     the database id, as in the reference's concatenate-then-top_k).  A
//     batch has Q = 64 queries, too few blocks for 132 SMs, so M is split
//     into chunks (the wrapper picks the count): pass 1 ranks one chunk of
//     one query (or of a tile of queries) a block, and pass 2, a warp a
//     query, merges the chunks' sorted lists whole (warp_merge: a bitonic
//     merge across lanes, about the cost of one insertion a list).  With one
//     chunk, pass 1 writes the result itself.  The last pass applies the
//     reference's _finalize_topk: id -1 where the score is <= NEG_INF / 2,
//     padding (-1, NEG_INF) from kk = min(k, M) up to k.  kk is at most
//     kMaxTopK (topk_score.MAX_TOPK) = 32.
//   * scored_topk (the brute-force path, and the recall oracle): the
//     database [M, K] is shared by every query, so a pass-1 block takes a
//     tile of kQueryTile queries and one chunk of M.  Each warp keeps one
//     warp-held list (below) a query of the tile, all in registers, and the
//     query rows in registers too (K <= kRegClasses); each lane loads its
//     kTopkUnroll candidate rows a round ahead, computes their ‖x‖² once,
//     scores each against the tile's queries and offers each score to its
//     query's list (warp_offer, one list after the other).  The block's
//     warps then merge query i's lists into warp i (warp_merge).
//     What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): not bytes
//     (the database is 1.85 MB at cl-100k-1d8-l5, read from L2 by every
//     tile) and not the 6·K + 4 operations a pair at the f32 peak, but the
//     instructions issued around them (compare, ballot, selects, address
//     and valid checks: tens a pair in the compiled loop), then the
//     insertions, about kk·(1 + ln(n / kk)) for a list that sees n
//     candidates, and a fixed ~10 µs of launches, prologue and merges.  So
//     the tile is small (2: a tile of 4 made more lists and more
//     insertions, and was slower at every k), loads run one round ahead (1-4
//     % faster than loading a round's rows at its top at k <= 10; two or
//     three rounds ahead changed nothing), and the chunk policy fills the
//     card with exactly one wave of pass-1 blocks (kTopkBlocksPerSm an SM,
//     pinned by the launch bounds), whose lists see as many candidates as
//     that allows.
//   * scored_topk_gathered (every IVF flush): a warp-held list.  Lane j of
//     a warp holds the warp's j-th best (score, m) in registers.  Each
//     round, every lane scores kUnroll candidates 32 apart, so the warp
//     reads neighbouring m; a ballot marks the lanes whose candidate beats
//     the warp's kk-th entry, and only those are inserted, one at a time, by
//     a compare and a shuffle up; once the list is full most rounds insert
//     nothing.  The block's warps then store their lists in dynamic shared
//     memory (warps * kk entries, at most 2 KiB) and warp 0 offers them to
//     its own list the same way; pass 2 is the shared one above.  Nothing
//     but the lists leaves registers.
//     What bounds it: the bytes of the candidate block, once the insertions
//     are few -- but each warp walks its rounds one after another, so the
//     time is that of the rounds' memory latencies unless loads are in
//     flight ahead of them.  For K up to kRegClasses a round's candidate
//     rows are loaded into registers one round ahead (their masks two ahead,
//     so a masked slot reads no candidate), and the wrapper picks no more
//     chunks than fit on the card at once, so no block waits for a second
//     wave.  Wider K scores straight from memory.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>
#include <limits>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScoreThreads = 256;
constexpr int kScoreMaxBlocks = 4096;   // grid-stride beyond
constexpr int kMaxTopK = 32;
// pairwise_scores: with at most kSmallM database rows, one thread an
// output; otherwise blocks of kColThreads take a database row a thread,
// each scored against kColQueries query rows.
constexpr int kSmallM = 32;
constexpr int kColThreads = 256;
constexpr int kColQueries = 8;
// scored_topk: warps of a pass-1 block (its dynamic shared memory is
// 8 B * kQueryTile * kTopkWarps * kk), the queries a warp scores each
// candidate against, and the resident pass-1 blocks an SM (<= 128 registers).
constexpr int kTopkWarps = 8;
constexpr int kQueryTile = 2;
constexpr int kTopkBlocksPerSm = 2;
constexpr int kTopkUnroll = 2;  // candidates a lane takes in one round (K <= kRegClasses)
// scored_topk_gathered: warps of a pass-1 block (its dynamic shared memory
// is 8 B * kGatherWarps * kk), queries (one warp each) of a pass-2 block
// (both top-k kernels), the widest K whose candidate rows are prefetched
// into registers (both), and the candidates a lane takes in one round.
constexpr int kGatherWarps = 8;
constexpr int kGatherBlocksPerSm = 4;  // resident pass-1 blocks: <= 64 registers
constexpr int kMergeWarps = 4;
constexpr int kRegClasses = 8;
constexpr int kUnroll = 2;
constexpr float kNegInf = -FLT_MAX;
constexpr float kCosEps = 1e-30f;
constexpr int kL2 = 0;
constexpr int kCosine = 1;
// The empty slot of a list: below every real candidate, NEG_INF and
// -inf scores included (-inf ties with it and wins on m).
constexpr float kEmptyScore = -std::numeric_limits<float>::infinity();
constexpr int kEmptyPos = INT_MAX;

// rq, rx: sqrtf(qn2), sqrtf(xn2), which a caller may compute once a row.
__device__ __forceinline__ float finish_score(float dot, float qn2, float xn2, float rq, float rx,
                                              int metric) {
  if (metric == kL2) return (2.f * dot - qn2) - xn2;
  const float denom = rq * rx;
  return denom > 0.f ? dot / fmaxf(denom, kCosEps) : 0.f;
}

__device__ __forceinline__ float finish_score(float dot, float qn2, float xn2, int metric) {
  return finish_score(dot, qn2, xn2, sqrtf(qn2), sqrtf(xn2), metric);
}

// A valid operand as the caller holds it: none (all live), bytes (bool or
// uint8, nonzero = live) or f32 (> 0 = live).
struct Valid {
  const void* p;
  int bytes;  // 1 or 4
  __device__ __forceinline__ bool live(int m) const {
    if (p == nullptr) return true;
    return bytes == 1 ? __ldg(static_cast<const unsigned char*>(p) + m) != 0
                      : __ldg(static_cast<const float*>(p) + m) > 0.f;
  }
};

__device__ __forceinline__ float score_of(const float* __restrict__ q,
                                          const float* __restrict__ x, int K,
                                          int metric) {
  float dot = 0.f, qn2 = 0.f, xn2 = 0.f;
  for (int k = 0; k < K; ++k) {
    const float a = __ldg(q + k);
    const float b = __ldg(x + k);
    dot = fmaf(a, b, dot);
    qn2 = fmaf(a, a, qn2);
    xn2 = fmaf(b, b, xn2);
  }
  return finish_score(dot, qn2, xn2, metric);
}

// The total order of the top-k: higher score first, then lower m.
__device__ __forceinline__ bool better(float s1, int m1, float s2, int m2) {
  return s1 > s2 || (s1 == s2 && m1 < m2);
}

// A warp's running top list: lane j holds the warp's j-th best (s, m) under
// `better`, all 32 lanes sorted; the list that counts is its first kk
// entries, and entry kk - 1 is the bar a candidate must beat (held on
// every lane).
struct WarpTopk {
  float s;
  int m;
  float bar_s;
  int bar_m;
};

__device__ __forceinline__ WarpTopk warp_list_empty() {
  return WarpTopk{kEmptyScore, kEmptyPos, kEmptyScore, kEmptyPos};
}

// Insert (ns, nm), the same on every lane, into the sorted list: the lanes
// from the insertion point on take their upper neighbour's entry (lane 31's
// falls off), and the first of them takes the new one.
__device__ __forceinline__ void warp_insert(WarpTopk& t, float ns, int nm, int lane) {
  const bool gt = better(ns, nm, t.s, t.m);  // false ... false, true ... true
  const unsigned gts = __ballot_sync(kFullMask, gt);
  const float up_s = __shfl_up_sync(kFullMask, t.s, 1);
  const int up_m = __shfl_up_sync(kFullMask, t.m, 1);
  const bool shift = ((gts << 1) >> lane) & 1u;  // the lane below also moves
  if (gt) {
    t.s = shift ? up_s : ns;
    t.m = shift ? up_m : nm;
  }
}

// Merge another warp list (os, om) -- sorted best first over the 32 lanes,
// as every warp list is -- into t: the other list reversed is taken lane by
// lane where better than t's entry, which leaves the best 32 of both as a
// bitonic sequence, and a bitonic merge (5 compare-exchange steps across
// lanes) sorts it.  t's first kk entries end as offering the other list's
// entries one by one leaves them, at the cost of about one insertion.
__device__ __forceinline__ void warp_merge(WarpTopk& t, float os, int om, int kk, int lane) {
  const float rs = __shfl_sync(kFullMask, os, kWarp - 1 - lane);
  const int rm = __shfl_sync(kFullMask, om, kWarp - 1 - lane);
  if (better(rs, rm, t.s, t.m)) {
    t.s = rs;
    t.m = rm;
  }
#pragma unroll
  for (int stride = kWarp / 2; stride > 0; stride >>= 1) {
    const float xs = __shfl_xor_sync(kFullMask, t.s, stride);
    const int xm = __shfl_xor_sync(kFullMask, t.m, stride);
    // the lower lane of each pair keeps the better entry
    if ((lane & stride) == 0 ? better(xs, xm, t.s, t.m) : better(t.s, t.m, xs, xm)) {
      t.s = xs;
      t.m = xm;
    }
  }
  t.bar_s = __shfl_sync(kFullMask, t.s, kk - 1);
  t.bar_m = __shfl_sync(kFullMask, t.m, kk - 1);
}

// Offer every lane's candidate (s, m) to the warp's list.  The lanes whose
// candidate beats the bar are inserted one at a time, lowest lane first, and
// the bar is read again after each insertion.  The result does not depend on
// the order: every candidate of the final top-kk is inserted, and the order
// is total.  A NaN score beats nothing and is never inserted.
__device__ __forceinline__ void warp_offer(WarpTopk& t, float s, int m, int kk, int lane) {
  unsigned pending = __ballot_sync(kFullMask, better(s, m, t.bar_s, t.bar_m));
  while (pending != 0u) {
    const int src = __ffs(pending) - 1;
    warp_insert(t, __shfl_sync(kFullMask, s, src), __shfl_sync(kFullMask, m, src), lane);
    t.bar_s = __shfl_sync(kFullMask, t.s, kk - 1);
    t.bar_m = __shfl_sync(kFullMask, t.m, kk - 1);
    pending &= ~(1u << src) & __ballot_sync(kFullMask, better(s, m, t.bar_s, t.bar_m));
  }
}

// Write query qi's list in the reference's _finalize_topk convention: lane
// j < kk writes its own entry.  ids == nullptr: the id is the position m.
__device__ __forceinline__ void warp_finalize(const WarpTopk& t, const int* __restrict__ ids,
                                              int64_t qi, int64_t M, int kk, int k,
                                              float* __restrict__ out_s,
                                              int* __restrict__ out_ids, int lane) {
  for (int j = lane; j < k; j += kWarp) {
    float s = kNegInf;
    int id = -1;
    if (j < kk) {  // j == lane
      s = t.s;
      // (an empty entry reaches here only past a NaN score: it keeps id -1)
      if (s > kNegInf * 0.5f && t.m != kEmptyPos) id = ids == nullptr ? t.m : ids[qi * M + t.m];
    }
    out_s[qi * k + j] = s;
    out_ids[qi * k + j] = id;
  }
}

// pairwise_scores with few database rows (M <= kSmallM): one thread an
// output (q, m) = (i / M, i % M) in 32-bit arithmetic; K == KC <=
// kRegClasses is a template constant, so all of a thread's loads (its two
// rows and valid) issue together.  ‖q‖² and ‖x‖² are summed again for each
// output: K multiply-adds, where the time is the launch and one load
// latency.  KC == 0: any K, score_of's loop.  The sums are score_of's, term
// for term.
template <int KC>
__global__ void __launch_bounds__(kScoreThreads)
pairwise_few_kernel(const float* __restrict__ q, const float* __restrict__ x, Valid valid,
                    float* __restrict__ out, int Q, int M, int K, int metric) {
  const int i = blockIdx.x * kScoreThreads + threadIdx.x;
  if (i >= Q * M) return;
  const int qi = i / M, m = i - qi * M;
  const bool live = valid.live(m);
  float s;
  if constexpr (KC > 0) {
    float a[KC], b[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      a[j] = __ldg(q + static_cast<int64_t>(qi) * KC + j);
      b[j] = __ldg(x + m * KC + j);
    }
    float dot = 0.f, qn2 = 0.f, xn2 = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      dot = fmaf(a[j], b[j], dot);
      qn2 = fmaf(a[j], a[j], qn2);
      xn2 = fmaf(b[j], b[j], xn2);
    }
    s = finish_score(dot, qn2, xn2, metric);
  } else {
    s = score_of(q + static_cast<int64_t>(qi) * K, x + static_cast<int64_t>(m) * K, K, metric);
  }
  out[i] = live ? s : kNegInf;
}

// pairwise_scores with many database rows: block b takes query tile
// b / mblocks (kColQueries rows, their ‖q‖² and √‖q‖² in shared memory) and
// database rows kColThreads * (b % mblocks) on, one a thread; each thread
// loads its row (into registers for KC > 0, issued before the barrier that
// waits for the tile) and computes its ‖x‖² once, then writes its column of
// the tile's outputs, so neighbouring threads store neighbouring m.
template <int KC>
__global__ void __launch_bounds__(kColThreads)
pairwise_cols_kernel(const float* __restrict__ q, const float* __restrict__ x, Valid valid,
                     float* __restrict__ out, int Q, int M, int K, int mblocks, int metric) {
  __shared__ float sh_q[kColQueries * (KC > 0 ? KC : 1)];
  __shared__ float sh_qn2[kColQueries];
  __shared__ float sh_rq[kColQueries];
  const int t = threadIdx.x;
  const int q0 = (blockIdx.x / mblocks) * kColQueries;
  const int m = (blockIdx.x % mblocks) * kColThreads + t;
  const int nq = Q - q0 < kColQueries ? Q - q0 : kColQueries;
  const float* qtile = q + static_cast<int64_t>(q0) * K;
  const float* xrow = x + static_cast<int64_t>(m) * K;
  const bool in = m < M;
  const bool live = in && valid.live(m);
  float xr[KC > 0 ? KC : 1];
  if constexpr (KC > 0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) xr[j] = in ? __ldg(xrow + j) : 0.f;
    if (t < nq * KC) sh_q[t] = __ldg(qtile + t);
  }
  if (t < nq) {
    float qn2 = 0.f;
    for (int j = 0; j < K; ++j) {
      const float a = __ldg(qtile + t * K + j);
      qn2 = fmaf(a, a, qn2);
    }
    sh_qn2[t] = qn2;
    sh_rq[t] = sqrtf(qn2);
  }
  __syncthreads();
  if (!in) return;
  float xn2 = 0.f;
  if constexpr (KC > 0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) xn2 = fmaf(xr[j], xr[j], xn2);
  } else {
    for (int j = 0; j < K; ++j) {
      const float b = __ldg(xrow + j);
      xn2 = fmaf(b, b, xn2);
    }
  }
  const float rx = metric == kCosine ? sqrtf(xn2) : 0.f;  // l2 reads no root
  for (int i = 0; i < nq; ++i) {
    float s = kNegInf;
    if (live) {
      float dot = 0.f;
      if constexpr (KC > 0) {
#pragma unroll
        for (int j = 0; j < KC; ++j) dot = fmaf(sh_q[i * KC + j], xr[j], dot);
      } else {
        for (int j = 0; j < K; ++j) dot = fmaf(__ldg(qtile + i * K + j), __ldg(xrow + j), dot);
      }
      s = finish_score(dot, sh_qn2[i], xn2, sh_rq[i], rx, metric);
    }
    out[static_cast<int64_t>(q0 + i) * M + m] = s;
  }
}

__global__ void __launch_bounds__(kScoreThreads)
gathered_scores_kernel(const float* __restrict__ cand, const float* __restrict__ q,
                       const float* __restrict__ mask, float* __restrict__ out, int64_t Q,
                       int64_t M, int K, int metric) {
  const int64_t total = Q * M;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int64_t qi = i / M;
    out[i] = mask[i] > 0.f ? score_of(q + qi * K, cand + i * K, K, metric) : kNegInf;
  }
}

// Pass 1 of scored_topk: block (query tile, chunk) over the database x
// [M, K] and valid [M] (nullable).  kTopkWarps warps stride over the chunk
// and each warp keeps one warp-held list for each of the tile's nq <=
// kQueryTile queries; a candidate's row and ‖x‖² are loaded and computed
// once and scored against all nq queries, and each score goes to its
// query's list (warp_offer).  Then warp i merges query i's lists of all
// warps.  KC > 0 (K == KC <= kRegClasses): the query rows and candidate
// rows live in registers, each lane takes kTopkUnroll candidates a round,
// 32 apart, and a round's rows (and valid) are loaded one round ahead;
// KC == 0 (any K): one candidate a lane and round, scored straight from
// memory.  The sums are score_of's, term for term.
template <int KC>
__global__ void __launch_bounds__(kTopkWarps * kWarp, kTopkBlocksPerSm)
topk_pass1_kernel(const float* __restrict__ q, const float* __restrict__ x, Valid valid,
                  float* __restrict__ part_s, int* __restrict__ part_m,
                  float* __restrict__ out_s, int* __restrict__ out_ids, int Q, int M, int K,
                  int metric, int kk, int k, int chunks, int chunk_len) {
  extern __shared__ float sh_s[];  // [kQueryTile][kTopkWarps][kk] scores, then positions
  int* sh_m = reinterpret_cast<int*>(sh_s + kQueryTile * kTopkWarps * kk);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int c = blockIdx.x % chunks;
  const int q0 = (blockIdx.x / chunks) * kQueryTile;
  const int nq = Q - q0 < kQueryTile ? Q - q0 : kQueryTile;
  const int m0 = c * chunk_len;
  const int m1 = M - m0 < chunk_len ? M : m0 + chunk_len;
  const float* qtile = q + static_cast<int64_t>(q0) * K;
  float qn2[kQueryTile], rq[kQueryTile];
  WarpTopk t[kQueryTile];
  float qr[kQueryTile][KC > 0 ? KC : 1];
#pragma unroll
  for (int i = 0; i < kQueryTile; ++i) {
    qn2[i] = 0.f;
    if constexpr (KC > 0) {
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        qr[i][j] = i < nq ? __ldg(qtile + i * KC + j) : 0.f;
        qn2[i] = fmaf(qr[i][j], qr[i][j], qn2[i]);
      }
    } else {
      for (int j = 0; i < nq && j < K; ++j) {
        const float a = __ldg(qtile + i * K + j);
        qn2[i] = fmaf(a, a, qn2[i]);
      }
    }
    rq[i] = sqrtf(qn2[i]);
    t[i] = warp_list_empty();
  }
  // offer candidate m, scored s[i] if live, to the tile's lists
  auto offer = [&](int m, bool live, float (&s)[kQueryTile]) {
    const bool in = m < m1;
#pragma unroll
    for (int i = 0; i < kQueryTile; ++i) {
      if (i < nq) {  // block-uniform
        warp_offer(t[i], in ? (live ? s[i] : kNegInf) : kEmptyScore, in ? m : kEmptyPos, kk, lane);
      }
    }
  };
  if constexpr (KC > 0) {
    constexpr int kSpan = kTopkUnroll * kWarp;  // a warp's m in a round
    constexpr int kStep = kTopkWarps * kSpan;   // the block's
    // the row of candidate m (zeros past the chunk) and whether it is live
    auto load = [&](float (&xr)[KC], bool& live, int m) {
      const bool in = m < m1;
#pragma unroll
      for (int j = 0; j < KC; ++j) xr[j] = in ? __ldg(x + static_cast<int64_t>(m) * KC + j) : 0.f;
      live = in && valid.live(m);
    };
    float xr[kTopkUnroll][KC];
    bool live[kTopkUnroll];
#pragma unroll
    for (int u = 0; u < kTopkUnroll; ++u) load(xr[u], live[u], m0 + warp * kSpan + u * kWarp + lane);
    for (int base = m0 + warp * kSpan; base < m1; base += kStep) {  // warp-uniform
      float xn[kTopkUnroll][KC];  // the next round's rows, loaded now
      bool live_next[kTopkUnroll];
#pragma unroll
      for (int u = 0; u < kTopkUnroll; ++u) {
        load(xn[u], live_next[u], base + kStep + u * kWarp + lane);
      }
#pragma unroll
      for (int u = 0; u < kTopkUnroll; ++u) {
        float xn2 = 0.f;
#pragma unroll
        for (int j = 0; j < KC; ++j) xn2 = fmaf(xr[u][j], xr[u][j], xn2);
        const float rx = metric == kCosine ? sqrtf(xn2) : 0.f;  // l2 reads no root
        float s[kQueryTile];
#pragma unroll
        for (int i = 0; i < kQueryTile; ++i) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < KC; ++j) dot = fmaf(qr[i][j], xr[u][j], dot);
          s[i] = finish_score(dot, qn2[i], xn2, rq[i], rx, metric);
        }
        offer(base + u * kWarp + lane, live[u], s);
      }
#pragma unroll
      for (int u = 0; u < kTopkUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < KC; ++j) xr[u][j] = xn[u][j];
        live[u] = live_next[u];
      }
    }
  } else {
    constexpr int kStep = kTopkWarps * kWarp;
    for (int base = m0 + warp * kWarp; base < m1; base += kStep) {  // warp-uniform
      const int m = base + lane;
      const bool live = m < m1 && valid.live(m);
      const float* xrow = x + static_cast<int64_t>(m) * K;
      float s[kQueryTile] = {};
      if (live) {
        float xn2 = 0.f;
        for (int j = 0; j < K; ++j) {
          const float b = __ldg(xrow + j);
          xn2 = fmaf(b, b, xn2);
        }
        const float rx = metric == kCosine ? sqrtf(xn2) : 0.f;  // l2 reads no root
#pragma unroll
        for (int i = 0; i < kQueryTile; ++i) {
          float dot = 0.f;
          for (int j = 0; i < nq && j < K; ++j) {
            dot = fmaf(__ldg(qtile + i * K + j), __ldg(xrow + j), dot);
          }
          s[i] = finish_score(dot, qn2[i], xn2, rq[i], rx, metric);
        }
      }
      offer(m, live, s);
    }
  }
  // warp i takes query i's lists of the other warps through shared memory
#pragma unroll
  for (int i = 0; i < kQueryTile; ++i) {
    if (i < nq && lane < kk) {
      sh_s[(i * kTopkWarps + warp) * kk + lane] = t[i].s;
      sh_m[(i * kTopkWarps + warp) * kk + lane] = t[i].m;
    }
  }
  __syncthreads();
  if (warp >= nq) return;  // whole warps leave together
  WarpTopk mine = t[0];
#pragma unroll
  for (int i = 1; i < kQueryTile; ++i) {
    if (warp == i) mine = t[i];  // a register select, not a dynamic index
  }
  for (int w = 0; w < kTopkWarps; ++w) {
    if (w == warp) continue;
    const bool in = lane < kk;
    const int at = (warp * kTopkWarps + w) * kk + lane;
    warp_merge(mine, in ? sh_s[at] : kEmptyScore, in ? sh_m[at] : kEmptyPos, kk, lane);
  }
  const int qi = q0 + warp;
  if (chunks == 1) {
    warp_finalize(mine, nullptr, qi, M, kk, k, out_s, out_ids, lane);
    return;
  }
  if (lane < kk) {
    const int64_t at = (static_cast<int64_t>(qi) * chunks + c) * kk + lane;
    part_s[at] = mine.s;
    part_m[at] = mine.m;
  }
}

// Pass 1 of scored_topk_gathered: block (q, chunk), kGatherWarps warps each
// keeping a warp-held list of the candidates it strides over, then merged
// into warp 0's.  KC > 0 (K == KC <= kRegClasses): each lane takes
// kUnroll candidates a round, 32 apart; the query and the candidates' rows
// live in registers, and a round's row loads are issued one round ahead
// (its masks two rounds ahead, so a masked slot still reads no candidate).
// KC == 0 (any K): one candidate a lane and round, scored straight from
// memory.  The sums are score_of's, term for term.
template <int KC>
__global__ void __launch_bounds__(kGatherWarps * kWarp, kGatherBlocksPerSm)
gathered_topk_pass1_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                           const float* __restrict__ mask, const int* __restrict__ ids,
                           float* __restrict__ part_s, int* __restrict__ part_m,
                           float* __restrict__ out_s, int* __restrict__ out_ids, int64_t M,
                           int K, int metric, int kk, int k, int chunks, int64_t chunk_len) {
  extern __shared__ float sh_s[];  // [kGatherWarps][kk] scores, then positions
  int* sh_m = reinterpret_cast<int*>(sh_s + kGatherWarps * kk);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t qi = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const int64_t m0 = c * chunk_len;
  const int64_t m1 = m0 + chunk_len < M ? m0 + chunk_len : M;
  const float* qrow = q + qi * K;
  const float* mrow = mask + qi * M;
  const float* crow = cand + qi * M * K;
  WarpTopk t = warp_list_empty();
  if constexpr (KC > 0) {
    constexpr int64_t kSpan = kUnroll * kWarp;       // a warp's m in a round
    constexpr int64_t kStep = kGatherWarps * kSpan;  // the block's
    float qr[KC];
    float qn2 = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      qr[j] = __ldg(qrow + j);
      qn2 = fmaf(qr[j], qr[j], qn2);
    }
    // mask of candidate m (0 past the chunk), and its row if live
    auto mask_at = [&](int64_t m) { return m < m1 ? __ldg(mrow + m) : 0.f; };
    auto load_row = [&](float (&x)[KC], float live, int64_t m) {
#pragma unroll
      for (int j = 0; j < KC; ++j) x[j] = live > 0.f ? __ldg(crow + m * KC + j) : 0.f;
    };
    // this round's masks and rows, and the next round's masks
    const int64_t first = m0 + warp * kSpan + lane;
    float live[kUnroll], live_next[kUnroll], x[kUnroll][KC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      live[u] = mask_at(first + u * kWarp);
      live_next[u] = mask_at(first + kStep + u * kWarp);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_row(x[u], live[u], first + u * kWarp);
    for (int64_t base = m0 + warp * kSpan; base < m1; base += kStep) {  // warp-uniform
      const int64_t m = base + lane;
      float x_next[kUnroll][KC], live_after[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load_row(x_next[u], live_next[u], m + kStep + u * kWarp);
        live_after[u] = mask_at(m + 2 * kStep + u * kWarp);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t mu = m + u * kWarp;
        float s = kEmptyScore;
        int pos = kEmptyPos;
        if (mu < m1) {
          pos = static_cast<int>(mu);
          s = kNegInf;
          if (live[u] > 0.f) {
            float dot = 0.f, xn2 = 0.f;
#pragma unroll
            for (int j = 0; j < KC; ++j) {
              dot = fmaf(qr[j], x[u][j], dot);
              xn2 = fmaf(x[u][j], x[u][j], xn2);
            }
            s = finish_score(dot, qn2, xn2, metric);
          }
        }
        warp_offer(t, s, pos, kk, lane);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < KC; ++j) x[u][j] = x_next[u][j];
        live[u] = live_next[u];
        live_next[u] = live_after[u];
      }
    }
  } else {
    constexpr int64_t kStep = kGatherWarps * kWarp;
    for (int64_t base = m0 + warp * kWarp; base < m1; base += kStep) {  // warp-uniform
      const int64_t m = base + lane;
      float s = kEmptyScore;
      int pos = kEmptyPos;
      if (m < m1) {
        pos = static_cast<int>(m);
        s = mrow[m] > 0.f ? score_of(qrow, crow + m * K, K, metric) : kNegInf;
      }
      warp_offer(t, s, pos, kk, lane);
    }
  }
  if (lane < kk) {
    sh_s[warp * kk + lane] = t.s;
    sh_m[warp * kk + lane] = t.m;
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kGatherWarps; ++w) {
    const bool in = lane < kk;
    warp_offer(t, in ? sh_s[w * kk + lane] : kEmptyScore, in ? sh_m[w * kk + lane] : kEmptyPos,
               kk, lane);
  }
  if (chunks == 1) {
    warp_finalize(t, ids, qi, M, kk, k, out_s, out_ids, lane);
    return;
  }
  if (lane < kk) {
    const int64_t at = (qi * chunks + c) * kk + lane;
    part_s[at] = t.s;
    part_m[at] = t.m;
  }
}

// Pass 2 of both top-k kernels: one warp a query merges its chunks' lists;
// ids == nullptr (scored_topk): the id is the position.
__global__ void __launch_bounds__(kMergeWarps * kWarp)
topk_pass2_kernel(const float* __restrict__ part_s, const int* __restrict__ part_m,
                  const int* __restrict__ ids, float* __restrict__ out_s,
                  int* __restrict__ out_ids, int64_t Q, int64_t M, int kk, int k, int chunks) {
  const int lane = threadIdx.x % kWarp;
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * kMergeWarps + threadIdx.x / kWarp;
  if (qi >= Q) return;  // whole warps leave together
  const float* ps = part_s + qi * chunks * kk;
  const int* pm = part_m + qi * chunks * kk;
  WarpTopk t = warp_list_empty();
#pragma unroll 4
  for (int c = 0; c < chunks; ++c) {  // each chunk's list is sorted: merge it whole
    const bool in = lane < kk;
    warp_merge(t, in ? ps[c * kk + lane] : kEmptyScore, in ? pm[c * kk + lane] : kEmptyPos, kk,
               lane);
  }
  warp_finalize(t, ids, qi, M, kk, k, out_s, out_ids, lane);
}

unsigned score_blocks(int64_t total) {
  const int64_t b = (total + kScoreThreads - 1) / kScoreThreads;
  return static_cast<unsigned>(b < kScoreMaxBlocks ? b : kScoreMaxBlocks);
}

// The checks both top-k launchers share; on success *kk = min(k, M).
int check_topk(int64_t Q, int64_t M, int K, int metric, int k, int chunks,
               const void* part_s, const void* part_m, int* kk) {
  if (Q < 1 || M < 1 || M >= INT_MAX || K < 1 || k < 1 || chunks < 1) {
    return cudaErrorInvalidValue;
  }
  if (metric != kL2 && metric != kCosine) return cudaErrorInvalidValue;
  *kk = static_cast<int>(k < M ? k : M);
  if (*kk > kMaxTopK) return cudaErrorInvalidValue;
  if (chunks > 1 && (part_s == nullptr || part_m == nullptr)) return cudaErrorInvalidValue;
  if (Q * chunks > INT_MAX) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// Call f(std::integral_constant<int, KC>{}) with KC = K for K <= kRegClasses
// (one instantiation a K) and KC = 0 (any K) past it.
template <typename F>
void with_classes(int K, F&& f) {
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
    default: f(std::integral_constant<int, 0>{}); break;
  }
}

bool bad_valid(const void* valid, int valid_bytes) {
  return valid != nullptr && valid_bytes != 1 && valid_bytes != 4;
}

// Pass 2 of a top-k launch in `chunks` chunks (none at one chunk).
int launch_merge(const float* ps, const int* pm, const int* ids, float* os, int* oi, int64_t Q,
                 int64_t M, int kk, int k, int chunks, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const unsigned merge_blocks = static_cast<unsigned>((Q + kMergeWarps - 1) / kMergeWarps);
  topk_pass2_kernel<<<merge_blocks, kMergeWarps * kWarp, 0, s>>>(ps, pm, ids, os, oi, Q, M, kk,
                                                                 k, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface.  Every launcher returns cudaGetLastError() right after its
// launches (0 = launched); it launches on the given stream and never syncs.
// metric: 0 = l2, 1 = cosine.  valid_bytes: 1 (bool/uint8) or 4 (f32), read
// only when valid is not null.
// ---------------------------------------------------------------------------

extern "C" {

int topk_kernels_max_topk() { return kMaxTopK; }

int pairwise_scores_launch(const void* q, const void* x, const void* valid, int valid_bytes,
                           void* out, int64_t Q, int64_t M, int K, int metric, void* stream) {
  if (Q < 0 || M < 0 || Q >= INT_MAX || M >= INT_MAX || K < 1 ||
      (metric != kL2 && metric != kCosine) || bad_valid(valid, valid_bytes)) {
    return cudaErrorInvalidValue;
  }
  if (Q == 0 || M == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const Valid v{valid, valid_bytes};
  const int nq = static_cast<int>(Q), nm = static_cast<int>(M);
  if (M <= kSmallM && Q * M < INT_MAX - kScoreThreads) {  // i and Q * M fit an int
    const unsigned blocks = static_cast<unsigned>((Q * M + kScoreThreads - 1) / kScoreThreads);
    with_classes(K, [&](auto kc) {
      pairwise_few_kernel<decltype(kc)::value><<<blocks, kScoreThreads, 0, s>>>(qf, xf, v, of, nq,
                                                                              nm, K, metric);
    });
  } else {
    const int64_t mblocks = (M + kColThreads - 1) / kColThreads;
    const int64_t blocks = (Q + kColQueries - 1) / kColQueries * mblocks;
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    with_classes(K, [&](auto kc) {
      pairwise_cols_kernel<decltype(kc)::value>
          <<<static_cast<unsigned>(blocks), kColThreads, 0, s>>>(
              qf, xf, v, of, nq, nm, K, static_cast<int>(mblocks), metric);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

int gathered_scores_launch(const void* cand, const void* q, const void* mask, void* out,
                           int64_t Q, int64_t M, int K, int metric, void* stream) {
  if (Q < 0 || M < 0 || K < 1 || (metric != kL2 && metric != kCosine)) {
    return cudaErrorInvalidValue;
  }
  if (Q == 0 || M == 0) return cudaSuccess;
  gathered_scores_kernel<<<score_blocks(Q * M), kScoreThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const float*>(q),
      static_cast<const float*>(mask), static_cast<float*>(out), Q, M, K, metric);
  return static_cast<int>(cudaGetLastError());
}

int scored_topk_launch(const void* q, const void* x, const void* valid, int valid_bytes,
                       void* part_s, void* part_m, void* out_s, void* out_ids, int64_t Q,
                       int64_t M, int K, int metric, int k, int chunks, void* stream) {
  int kk;
  const int bad = check_topk(Q, M, K, metric, k, chunks, part_s, part_m, &kk);
  if (bad != cudaSuccess) return bad;
  // a lane's next row, a round ahead, still has an int position
  if (bad_valid(valid, valid_bytes) || M > INT_MAX - 2 * kTopkWarps * kTopkUnroll * kWarp) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = (Q + kQueryTile - 1) / kQueryTile * chunks;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk_len = static_cast<int>((M + chunks - 1) / chunks);
  const size_t smem = (sizeof(float) + sizeof(int)) * kQueryTile * kTopkWarps * kk;
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  const Valid v{valid, valid_bytes};
  float* ps = static_cast<float*>(part_s);
  int* pm = static_cast<int*>(part_m);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_ids);
  with_classes(K, [&](auto kc) {
    topk_pass1_kernel<decltype(kc)::value>
        <<<static_cast<unsigned>(blocks), kTopkWarps * kWarp, smem, s>>>(
            qf, xf, v, ps, pm, os, oi, static_cast<int>(Q), static_cast<int>(M), K, metric, kk,
            k, chunks, chunk_len);
  });
  return launch_merge(ps, pm, nullptr, os, oi, Q, M, kk, k, chunks, s);
}

int scored_topk_gathered_launch(const void* cand, const void* q, const void* mask,
                                const void* ids, void* part_s, void* part_m, void* out_s,
                                void* out_ids, int64_t Q, int64_t M, int K, int metric,
                                int k, int chunks, void* stream) {
  if (mask == nullptr || ids == nullptr) return cudaErrorInvalidValue;
  int kk;
  const int bad = check_topk(Q, M, K, metric, k, chunks, part_s, part_m, &kk);
  if (bad != cudaSuccess) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t chunk_len = (M + chunks - 1) / chunks;
  const unsigned blocks = static_cast<unsigned>(Q * chunks);
  const size_t smem = (sizeof(float) + sizeof(int)) * kGatherWarps * kk;
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(cand);
  const float* mf = static_cast<const float*>(mask);
  const int* idp = static_cast<const int*>(ids);
  float* ps = static_cast<float*>(part_s);
  int* pm = static_cast<int*>(part_m);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_ids);
  with_classes(K, [&](auto kc) {
    gathered_topk_pass1_kernel<decltype(kc)::value><<<blocks, kGatherWarps * kWarp, smem, s>>>(
        qf, cf, mf, idp, ps, pm, os, oi, M, K, metric, kk, k, chunks, chunk_len);
  });
  return launch_merge(ps, pm, idp, os, oi, Q, M, kk, k, chunks, s);
}

}  // extern "C"
