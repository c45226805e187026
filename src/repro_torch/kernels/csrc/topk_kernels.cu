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
//     the database id, as in the reference's concatenate-then-top_k).
//     Pass 1: block (q, chunk) walks its chunk of m, each thread keeping a
//     private sorted top-kk of the m it strides over; the block then merges
//     the threads' lists in shared memory by a tree of two-list merges.  A
//     flush has Q = 64 queries, too few blocks for 132 SMs, so M is split
//     into chunks (the wrapper picks the count) and pass 2 (one block per q)
//     merges the chunks' lists from scratch the same way.  With one chunk,
//     pass 1 writes the result itself.  The last pass applies the
//     reference's _finalize_topk: id −1 where the score is <= NEG_INF / 2,
//     padding (−1, NEG_INF) from kk = min(k, M) up to k.
//   * kk is at most kMaxTopK (topk_score.MAX_TOPK): the private lists live
//     in local memory and the block's lists in 32 KiB of shared memory.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>
#include <limits>

namespace {

constexpr int kScoreThreads = 256;
constexpr int kScoreMaxBlocks = 4096;   // grid-stride beyond
constexpr int kTopkThreads = 128;
constexpr int kMaxTopK = 32;
constexpr float kNegInf = -FLT_MAX;
constexpr float kCosEps = 1e-30f;
constexpr int kL2 = 0;
constexpr int kCosine = 1;
// The empty slot of a private list: below every real candidate, NEG_INF and
// -inf scores included (-inf ties with it and wins on m).
constexpr float kEmptyScore = -std::numeric_limits<float>::infinity();
constexpr int kEmptyPos = INT_MAX;

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
  if (metric == kL2) return (2.f * dot - qn2) - xn2;
  const float denom = sqrtf(qn2) * sqrtf(xn2);
  return denom > 0.f ? dot / fmaxf(denom, kCosEps) : 0.f;
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

// Pass 1 of both top-k kernels.  kGathered: x is cand [Q, M, K] and valid
// the mask [Q, M]; else x is the database [M, K] and valid [M] (nullable).
template <bool kGathered>
__global__ void __launch_bounds__(kTopkThreads)
topk_pass1_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ valid, const int* __restrict__ ids,
                  float* __restrict__ part_s, int* __restrict__ part_m,
                  float* __restrict__ out_s, int* __restrict__ out_ids, int64_t M, int K,
                  int metric, int kk, int k, int chunks, int64_t chunk_len) {
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
    float s;
    if (kGathered) {
      const int64_t i = qi * M + m;
      s = valid[i] > 0.f ? score_of(qrow, x + i * K, K, metric) : kNegInf;
    } else {
      const bool live = valid == nullptr || valid[m] > 0.f;
      s = live ? score_of(qrow, x + m * K, K, metric) : kNegInf;
    }
    push(s, static_cast<int>(m), ls, lm, kk);
  }
  block_merge(ls, lm, sh_s, sh_m, kk);
  if (chunks == 1) {
    finalize(sh_s, sh_m, kGathered ? ids : nullptr, qi, M, kk, k, out_s, out_ids);
    return;
  }
  const int64_t base = (qi * chunks + c) * kk;
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    part_s[base + j] = sh_s[j];
    part_m[base + j] = sh_m[j];
  }
}

// Pass 2: one block per query merges its chunks' lists.
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

unsigned score_blocks(int64_t total) {
  const int64_t b = (total + kScoreThreads - 1) / kScoreThreads;
  return static_cast<unsigned>(b < kScoreMaxBlocks ? b : kScoreMaxBlocks);
}

// Shared checks and both passes of the two top-k launchers.
template <bool kGathered>
int launch_topk(const float* q, const float* x, const float* valid, const int* ids,
                float* part_s, int* part_m, float* out_s, int* out_ids, int64_t Q,
                int64_t M, int K, int metric, int k, int chunks, cudaStream_t s) {
  if (Q < 1 || M < 1 || M >= INT_MAX || K < 1 || k < 1 || chunks < 1) {
    return cudaErrorInvalidValue;
  }
  if (metric != kL2 && metric != kCosine) return cudaErrorInvalidValue;
  const int kk = static_cast<int>(k < M ? k : M);
  if (kk > kMaxTopK) return cudaErrorInvalidValue;
  if (chunks > 1 && (part_s == nullptr || part_m == nullptr)) return cudaErrorInvalidValue;
  const int64_t blocks = Q * chunks;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int64_t chunk_len = (M + chunks - 1) / chunks;
  topk_pass1_kernel<kGathered><<<static_cast<unsigned>(blocks), kTopkThreads, 0, s>>>(
      q, x, valid, ids, part_s, part_m, out_s, out_ids, M, K, metric, kk, k, chunks,
      chunk_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  topk_pass2_kernel<<<static_cast<unsigned>(Q), kTopkThreads, 0, s>>>(
      part_s, part_m, kGathered ? ids : nullptr, out_s, out_ids, M, kk, k, chunks);
  return static_cast<int>(cudaGetLastError());
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
  return launch_topk<false>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const float*>(valid), nullptr, static_cast<float*>(part_s),
      static_cast<int*>(part_m), static_cast<float*>(out_s), static_cast<int*>(out_ids), Q,
      M, K, metric, k, chunks, static_cast<cudaStream_t>(stream));
}

int scored_topk_gathered_launch(const void* cand, const void* q, const void* mask,
                                const void* ids, void* part_s, void* part_m, void* out_s,
                                void* out_ids, int64_t Q, int64_t M, int K, int metric,
                                int k, int chunks, void* stream) {
  if (mask == nullptr || ids == nullptr) return cudaErrorInvalidValue;
  return launch_topk<true>(
      static_cast<const float*>(q), static_cast<const float*>(cand),
      static_cast<const float*>(mask), static_cast<const int*>(ids),
      static_cast<float*>(part_s), static_cast<int*>(part_m), static_cast<float*>(out_s),
      static_cast<int*>(out_ids), Q, M, K, metric, k, chunks,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
