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
// Bound on the H100 (3.35 TB/s): bytes.  K is 3–9 classes, so each score is
// a few multiply-adds on 4·K bytes; a tensor core or a TPU-style 128-lane K
// padding would only add bytes.  K is not padded.
//
// Design.
//   * The score kernels run one thread per output (q, m), with a warp on
//     neighbouring m: the output and the gathered candidates are read and
//     written as contiguous spans.  A masked slot reads no candidate.
//   * The top-k kernels.  The TPU carries a running top-k across a
//     sequential grid axis; Hopper blocks run in no order.  So every
//     candidate is ranked by one total order -- score descending, then
//     candidate position m ascending -- under which the top-k is unique and
//     any merge order gives the reference's stable order (equal scores in
//     ascending m; for the gathered kernel m is the position in the row, not
//     the database id, as in the reference's concatenate-then-top_k).  A
//     flush has Q = 64 queries, too few blocks for 132 SMs, so M is split
//     into chunks (the wrapper picks the count): pass 1 ranks one chunk of
//     one query a block, and pass 2 merges the chunks' lists of each query
//     from scratch.  With one chunk, pass 1 writes the result itself.  The
//     last pass applies the reference's _finalize_topk: id -1 where the
//     score is <= NEG_INF / 2, padding (-1, NEG_INF) from kk = min(k, M)
//     up to k.  kk is at most kMaxTopK (topk_score.MAX_TOPK) = 32.
//   * scored_topk (the brute-force path): each of a block's 128 threads
//     keeps a private sorted top-kk of the m it strides over, in local
//     memory; the block merges the threads' lists by a tree of two-list
//     merges in 32 KiB of static shared memory, and pass 2 (a block a
//     query) does the same over the chunks' lists.  Bound by that
//     bookkeeping, not by bytes: most candidates enter a private list.
//   * scored_topk_gathered (every IVF flush): a warp-held list.  Lane j of
//     a warp holds the warp's j-th best (score, m) in registers.  Each
//     round, every lane scores kUnroll candidates 32 apart, so the warp
//     reads neighbouring m; a ballot marks the lanes whose candidate beats
//     the warp's kk-th entry, and only those are inserted, one at a time, by
//     a compare and a shuffle up; once the list is full most rounds insert
//     nothing.  The block's warps then store their lists in dynamic shared
//     memory (warps * kk entries, at most 2 KiB) and warp 0 offers them to
//     its own list the same way; pass 2 is one warp a query over the
//     chunks' lists.  Nothing but the lists leaves registers.
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

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScoreThreads = 256;
constexpr int kScoreMaxBlocks = 4096;   // grid-stride beyond
constexpr int kTopkThreads = 128;
constexpr int kMaxTopK = 32;
// scored_topk_gathered: warps of a pass-1 block (its dynamic shared memory
// is 8 B * kGatherWarps * kk), queries (one warp each) of a pass-2 block,
// the widest K whose candidate rows are prefetched into registers, and the
// candidates a lane takes in one round.
constexpr int kGatherWarps = 8;
constexpr int kGatherBlocksPerSm = 4;  // resident pass-1 blocks: <= 64 registers
constexpr int kMergeWarps = 4;
constexpr int kRegClasses = 8;
constexpr int kUnroll = 2;
constexpr float kNegInf = -FLT_MAX;
constexpr float kCosEps = 1e-30f;
constexpr int kL2 = 0;
constexpr int kCosine = 1;
// The empty slot of a private list: below every real candidate, NEG_INF and
// -inf scores included (-inf ties with it and wins on m).
constexpr float kEmptyScore = -std::numeric_limits<float>::infinity();
constexpr int kEmptyPos = INT_MAX;

__device__ __forceinline__ float finish_score(float dot, float qn2, float xn2, int metric) {
  if (metric == kL2) return (2.f * dot - qn2) - xn2;
  const float denom = sqrtf(qn2) * sqrtf(xn2);
  return denom > 0.f ? dot / fmaxf(denom, kCosEps) : 0.f;
}

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

// Insert (s, m) into a sorted private list of kk entries if it belongs.
__device__ __forceinline__ void push(float s, int m, float* ls, int* lm, int kk) {
  if (!better(s, m, ls[kk - 1], lm[kk - 1])) return;
  int j = kk - 1;
  while (j > 0 && better(s, m, ls[j - 1], lm[j - 1])) {
    ls[j] = ls[j - 1];
    lm[j] = lm[j - 1];
    --j;
  }
  ls[j] = s;
  lm[j] = m;
}

__device__ __forceinline__ void clear_list(float* ls, int* lm, int kk) {
  for (int j = 0; j < kk; ++j) {
    ls[j] = kEmptyScore;
    lm[j] = kEmptyPos;
  }
}

// Store every thread's private list into the block's shared lists and merge
// them into list 0 by a tree of two-list merges (each keeps the top kk).
// Every thread of the block calls this.
__device__ void block_merge(const float* ls, const int* lm, float* sh_s, int* sh_m,
                            int kk) {
  const int t = threadIdx.x;
  for (int j = 0; j < kk; ++j) {
    sh_s[t * kMaxTopK + j] = ls[j];
    sh_m[t * kMaxTopK + j] = lm[j];
  }
  for (int stride = 1; stride < kTopkThreads; stride <<= 1) {
    __syncthreads();
    if (t % (2 * stride) == 0) {
      float* as = sh_s + t * kMaxTopK;
      int* am = sh_m + t * kMaxTopK;
      const float* bs = sh_s + (t + stride) * kMaxTopK;
      const int* bm = sh_m + (t + stride) * kMaxTopK;
      float os[kMaxTopK];
      int om[kMaxTopK];
      int i = 0, j = 0;  // i + j == o < kk, so neither runs past its list
      for (int o = 0; o < kk; ++o) {
        if (better(as[i], am[i], bs[j], bm[j])) {
          os[o] = as[i];
          om[o] = am[i];
          ++i;
        } else {
          os[o] = bs[j];
          om[o] = bm[j];
          ++j;
        }
      }
      for (int o = 0; o < kk; ++o) {
        as[o] = os[o];
        am[o] = om[o];
      }
    }
  }
  __syncthreads();
}

// Write query qi's merged list (shared list 0) in the reference's
// _finalize_topk convention.  ids == nullptr: the id is the position m.
__device__ void finalize(const float* sh_s, const int* sh_m, const int* __restrict__ ids,
                         int64_t qi, int64_t M, int kk, int k, float* __restrict__ out_s,
                         int* __restrict__ out_ids) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = kNegInf;
    int id = -1;
    if (j < kk) {
      s = sh_s[j];
      // (an empty slot reaches here only past a NaN score: it keeps id -1)
      if (s > kNegInf * 0.5f && sh_m[j] != kEmptyPos) {
        id = ids == nullptr ? sh_m[j] : ids[qi * M + sh_m[j]];
      }
    }
    out_s[qi * k + j] = s;
    out_ids[qi * k + j] = id;
  }
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

// finalize for a warp-held list: lane j < kk writes its own entry.
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
      if (s > kNegInf * 0.5f && t.m != kEmptyPos) id = ids[qi * M + t.m];
    }
    out_s[qi * k + j] = s;
    out_ids[qi * k + j] = id;
  }
}

__global__ void __launch_bounds__(kScoreThreads)
pairwise_scores_kernel(const float* __restrict__ q, const float* __restrict__ x,
                       const float* __restrict__ valid, float* __restrict__ out,
                       int64_t Q, int64_t M, int K, int metric) {
  const int64_t total = Q * M;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int64_t qi = i / M, m = i - qi * M;
    const bool live = valid == nullptr || valid[m] > 0.f;
    out[i] = live ? score_of(q + qi * K, x + m * K, K, metric) : kNegInf;
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

// Pass 1 of scored_topk: x is the database [M, K] and valid [M] (nullable).
__global__ void __launch_bounds__(kTopkThreads)
topk_pass1_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ valid, float* __restrict__ part_s,
                  int* __restrict__ part_m, float* __restrict__ out_s,
                  int* __restrict__ out_ids, int64_t M, int K, int metric, int kk, int k,
                  int chunks, int64_t chunk_len) {
  __shared__ float sh_s[kTopkThreads * kMaxTopK];
  __shared__ int sh_m[kTopkThreads * kMaxTopK];
  const int64_t qi = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const int64_t m0 = c * chunk_len;
  const int64_t m1 = m0 + chunk_len < M ? m0 + chunk_len : M;
  const float* qrow = q + qi * K;
  float ls[kMaxTopK];
  int lm[kMaxTopK];
  clear_list(ls, lm, kk);
  for (int64_t m = m0 + threadIdx.x; m < m1; m += kTopkThreads) {
    const bool live = valid == nullptr || valid[m] > 0.f;
    const float s = live ? score_of(qrow, x + m * K, K, metric) : kNegInf;
    push(s, static_cast<int>(m), ls, lm, kk);
  }
  block_merge(ls, lm, sh_s, sh_m, kk);
  if (chunks == 1) {
    finalize(sh_s, sh_m, nullptr, qi, M, kk, k, out_s, out_ids);
    return;
  }
  const int64_t base = (qi * chunks + c) * kk;
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    part_s[base + j] = sh_s[j];
    part_m[base + j] = sh_m[j];
  }
}

// Pass 2 of scored_topk: one block per query merges its chunks' lists.
__global__ void __launch_bounds__(kTopkThreads)
topk_pass2_kernel(const float* __restrict__ part_s, const int* __restrict__ part_m,
                  const int* __restrict__ ids, float* __restrict__ out_s,
                  int* __restrict__ out_ids, int64_t M, int kk, int k, int chunks) {
  __shared__ float sh_s[kTopkThreads * kMaxTopK];
  __shared__ int sh_m[kTopkThreads * kMaxTopK];
  const int64_t qi = blockIdx.x;
  const int64_t n = static_cast<int64_t>(chunks) * kk;
  const float* ps = part_s + qi * n;
  const int* pm = part_m + qi * n;
  float ls[kMaxTopK];
  int lm[kMaxTopK];
  clear_list(ls, lm, kk);
  for (int64_t e = threadIdx.x; e < n; e += kTopkThreads) push(ps[e], pm[e], ls, lm, kk);
  block_merge(ls, lm, sh_s, sh_m, kk);
  finalize(sh_s, sh_m, ids, qi, M, kk, k, out_s, out_ids);
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

// Pass 2 of scored_topk_gathered: one warp a query merges its chunks' lists.
__global__ void __launch_bounds__(kMergeWarps * kWarp)
gathered_topk_pass2_kernel(const float* __restrict__ part_s, const int* __restrict__ part_m,
                           const int* __restrict__ ids, float* __restrict__ out_s,
                           int* __restrict__ out_ids, int64_t Q, int64_t M, int kk, int k,
                           int chunks) {
  const int lane = threadIdx.x % kWarp;
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * kMergeWarps + threadIdx.x / kWarp;
  if (qi >= Q) return;  // whole warps leave together
  const int64_t n = static_cast<int64_t>(chunks) * kk;
  const float* ps = part_s + qi * n;
  const int* pm = part_m + qi * n;
  WarpTopk t = warp_list_empty();
  for (int64_t e0 = 0; e0 < n; e0 += kWarp) {
    const int64_t e = e0 + lane;
    warp_offer(t, e < n ? ps[e] : kEmptyScore, e < n ? pm[e] : kEmptyPos, kk, lane);
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

}  // namespace

// ---------------------------------------------------------------------------
// C interface.  Every launcher returns cudaGetLastError() right after its
// launches (0 = launched); it launches on the given stream and never syncs.
// metric: 0 = l2, 1 = cosine.
// ---------------------------------------------------------------------------

extern "C" {

int topk_kernels_max_topk() { return kMaxTopK; }

int pairwise_scores_launch(const void* q, const void* x, const void* valid, void* out,
                           int64_t Q, int64_t M, int K, int metric, void* stream) {
  if (Q < 0 || M < 0 || K < 1 || (metric != kL2 && metric != kCosine)) {
    return cudaErrorInvalidValue;
  }
  if (Q == 0 || M == 0) return cudaSuccess;
  pairwise_scores_kernel<<<score_blocks(Q * M), kScoreThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const float*>(valid), static_cast<float*>(out), Q, M, K, metric);
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

int scored_topk_launch(const void* q, const void* x, const void* valid, void* part_s,
                       void* part_m, void* out_s, void* out_ids, int64_t Q, int64_t M,
                       int K, int metric, int k, int chunks, void* stream) {
  int kk;
  const int bad = check_topk(Q, M, K, metric, k, chunks, part_s, part_m, &kk);
  if (bad != cudaSuccess) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t chunk_len = (M + chunks - 1) / chunks;
  topk_pass1_kernel<<<static_cast<unsigned>(Q * chunks), kTopkThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const float*>(valid), static_cast<float*>(part_s),
      static_cast<int*>(part_m), static_cast<float*>(out_s), static_cast<int*>(out_ids), M,
      K, metric, kk, k, chunks, chunk_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  topk_pass2_kernel<<<static_cast<unsigned>(Q), kTopkThreads, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_m), nullptr,
      static_cast<float*>(out_s), static_cast<int*>(out_ids), M, kk, k, chunks);
  return static_cast<int>(cudaGetLastError());
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
#define PASS1(KC)                                                          \
  gathered_topk_pass1_kernel<KC><<<blocks, kGatherWarps * kWarp, smem, s>>>( \
      qf, cf, mf, idp, ps, pm, os, oi, M, K, metric, kk, k, chunks, chunk_len)
  switch (K) {  // one instantiation a K up to kRegClasses
    case 1: PASS1(1); break;
    case 2: PASS1(2); break;
    case 3: PASS1(3); break;
    case 4: PASS1(4); break;
    case 5: PASS1(5); break;
    case 6: PASS1(6); break;
    case 7: PASS1(7); break;
    case 8: PASS1(8); break;
    default: PASS1(0); break;
  }
#undef PASS1
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const unsigned merge_blocks = static_cast<unsigned>((Q + kMergeWarps - 1) / kMergeWarps);
  gathered_topk_pass2_kernel<<<merge_blocks, kMergeWarps * kWarp, 0, s>>>(
      ps, pm, idp, os, oi, Q, M, kk, k, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
