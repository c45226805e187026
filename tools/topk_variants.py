#!/usr/bin/env python3
"""Time the retrieval kernels of ``topk_kernels.cu`` against other designs of
the same functions, on one GPU.

    python3 tools/topk_variants.py

Each variant is the source in ``src/repro_torch/kernels/csrc/topk_kernels.cu``
with one part swapped, compiled with the build's own nvcc flags into
``build/topk_variants/`` and loaded with ``ctypes``:

* ``as_built``: the source as it is;
* ``no_prefetch``: ``scored_topk``'s pass 1 loads each round's candidate rows
  at the top of that round instead of one round ahead;
* ``lockstep``: ``scored_topk``'s pass 1 offers a candidate's scores to the
  tile's lists in lockstep (``warp_offer_n``), not one list after the other;
* ``offer_n1``: ``warp_offer`` as ``warp_offer_n`` over one list, not a loop
  of its own (timed in ``scored_topk_gathered``, whose pass 1 uses it).

Every variant also carries ``pairwise_scores`` four ways, launched directly:
``thread_i64`` (one thread an output with an int64 division and a runtime-K
loop, reading ``valid`` as bytes: the first port's kernel without its cast),
``few`` (the source's few-row path: one thread an output, K a template
constant, 32-bit indices), ``rows`` (a block a tile of query rows with the
centroids, their norms and valid staged in shared memory) and ``cols`` (the
source's many-row path), at the shapes of the index build, a flush's probe
and the staged brute force.

Every variant and path is held bit for bit against the plain version on
integer-valued inputs before it is timed.  Times are device times by CUDA
events (median of 20 launches, 3 rounds, the variants taken in turn each
round; the median of the rounds is reported).  Writes
``chiprun_out/topk_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src/repro_torch/kernels/csrc/topk_kernels.cu")
OUT = os.path.join(ROOT, "build", "topk_variants")

# scored_topk pass 1: load the round's rows at its top, not a round ahead
NO_PREFETCH = [
    ("load(xn[u], live_next[u], base + kStep + u * kWarp + lane);",
     "load(xr[u], live[u], base + u * kWarp + lane);"),
    ("#pragma unroll\n"
     "      for (int u = 0; u < kTopkUnroll; ++u) {\n"
     "#pragma unroll\n"
     "        for (int j = 0; j < KC; ++j) xr[u][j] = xn[u][j];\n"
     "        live[u] = live_next[u];\n"
     "      }\n", ""),
]
# warp_offer_n: offer candidate (s[i], m) to list i of N lists in lockstep,
# so that the lists' chains of dependent shuffles can overlap
WARP_OFFER_N = """
template <int N>
__device__ __forceinline__ void warp_offer_n(WarpTopk (&t)[N], const float (&s)[N], int m, int n,
                                             int kk, int lane) {
  unsigned pending[N];
  bool any = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    pending[i] = __ballot_sync(kFullMask, i < n && better(s[i], m, t[i].bar_s, t[i].bar_m));
    any |= pending[i] != 0u;
  }
  while (any) {  // warp-uniform
    any = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool ins = pending[i] != 0u;
      const int src = ins ? __ffs(pending[i]) - 1 : 0;
      const float ns = __shfl_sync(kFullMask, s[i], src);
      const int nm = __shfl_sync(kFullMask, m, src);
      warp_insert(t[i], ins ? ns : kEmptyScore, ins ? nm : kEmptyPos, lane);
      t[i].bar_s = __shfl_sync(kFullMask, t[i].s, kk - 1);
      t[i].bar_m = __shfl_sync(kFullMask, t[i].m, kk - 1);
      pending[i] &= ~(1u << src) & __ballot_sync(kFullMask, better(s[i], m, t[i].bar_s, t[i].bar_m));
      any |= pending[i] != 0u;
    }
  }
}

"""
_OFFER = "// Offer every lane's candidate (s, m) to the warp's list."
LOCKSTEP = [
    (_OFFER, WARP_OFFER_N + _OFFER),
    ("    for (int i = 0; i < kQueryTile; ++i) {\n"
     "      if (i < nq) {  // block-uniform\n"
     "        warp_offer(t[i], in ? (live ? s[i] : kNegInf) : kEmptyScore, "
     "in ? m : kEmptyPos, kk, lane);\n"
     "      }\n"
     "    }\n",
     "    for (int i = 0; i < kQueryTile; ++i) s[i] = in ? (live ? s[i] : "
     "kNegInf) : kEmptyScore;\n"
     "    warp_offer_n(t, s, in ? m : kEmptyPos, nq, kk, lane);\n"),
]
OFFER_N1 = [
    (_OFFER, WARP_OFFER_N + _OFFER),
    ("  unsigned pending = __ballot_sync(kFullMask, better(s, m, t.bar_s, "
     "t.bar_m));\n"
     "  while (pending != 0u) {\n"
     "    const int src = __ffs(pending) - 1;\n"
     "    warp_insert(t, __shfl_sync(kFullMask, s, src), "
     "__shfl_sync(kFullMask, m, src), lane);\n"
     "    t.bar_s = __shfl_sync(kFullMask, t.s, kk - 1);\n"
     "    t.bar_m = __shfl_sync(kFullMask, t.m, kk - 1);\n"
     "    pending &= ~(1u << src) & __ballot_sync(kFullMask, "
     "better(s, m, t.bar_s, t.bar_m));\n"
     "  }\n",
     "  WarpTopk ts[1] = {t};\n"
     "  const float ss[1] = {s};\n"
     "  warp_offer_n(ts, ss, m, 1, kk, lane);\n"
     "  t = ts[0];\n"),
]
VARIANTS = {"as_built": [], "no_prefetch": NO_PREFETCH, "lockstep": LOCKSTEP,
            "offer_n1": OFFER_N1}

# pairwise_scores four ways: mode 0 thread_i64, 1 few, 2 rows, 3 cols
PAIRWISE = r"""
namespace {
__global__ void __launch_bounds__(kScoreThreads)
pairwise_thread_i64_kernel(const float* __restrict__ q, const float* __restrict__ x,
                           Valid valid, float* __restrict__ out, int64_t Q, int64_t M, int K,
                           int metric) {
  const int64_t total = Q * M;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int64_t qi = i / M, m = i - qi * M;
    out[i] = valid.live(static_cast<int>(m)) ? score_of(q + qi * K, x + m * K, K, metric)
                                             : kNegInf;
  }
}

constexpr int kRowThreads = 128;

// rows: with M <= kSmallM and M * K <= 2,048, the block holds the database, its ‖x‖², √‖x‖² and valid in
// shared memory, each thread scores one query row against all M of them
// into the block's staged output, and the block stores its rows' outputs as
// one contiguous span.  Every global load (the query row, the database,
// valid) is issued before the first barrier, so a block waits for one
// memory latency, not a chain of them.  KC > 0 (K == KC <= kRegClasses):
// the query row lives in registers; KC == 0: any K, read from memory.  The
// sums are score_of's, term for term.
template <int KC>
__global__ void __launch_bounds__(kRowThreads)
pairwise_rows_kernel(const float* __restrict__ q, const float* __restrict__ x, Valid valid,
                     float* __restrict__ out, int Q, int M, int K, int metric) {
  extern __shared__ float sh[];
  const int kd = KC > 0 ? KC : K;
  float* sh_x = sh;                 // [M][kd]
  float* sh_xn2 = sh_x + M * kd;    // [M]
  float* sh_rx = sh_xn2 + M;        // [M]
  float* sh_live = sh_rx + M;       // [M], 1 = live
  float* sh_out = sh_live + M;      // [kRowThreads][M]
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kRowThreads;
  const int rows = Q - q0 < kRowThreads ? Q - q0 : kRowThreads;
  const float* qrow = q + static_cast<int64_t>(q0 + t) * kd;
  float qr[KC > 0 ? KC : 1];
  if constexpr (KC > 0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) qr[j] = t < rows ? __ldg(qrow + j) : 0.f;
  }
  for (int i = t; i < M * kd; i += kRowThreads) sh_x[i] = __ldg(x + i);
  for (int m = t; m < M; m += kRowThreads) sh_live[m] = valid.live(m) ? 1.f : 0.f;
  __syncthreads();
  for (int m = t; m < M; m += kRowThreads) {
    float xn2 = 0.f;
    for (int j = 0; j < kd; ++j) xn2 = fmaf(sh_x[m * kd + j], sh_x[m * kd + j], xn2);
    sh_xn2[m] = xn2;
    sh_rx[m] = sqrtf(xn2);
  }
  __syncthreads();
  if (t < rows) {
    float qn2 = 0.f;
    if constexpr (KC > 0) {
#pragma unroll
      for (int j = 0; j < KC; ++j) qn2 = fmaf(qr[j], qr[j], qn2);
    } else {
      for (int j = 0; j < K; ++j) {
        const float a = __ldg(qrow + j);
        qn2 = fmaf(a, a, qn2);
      }
    }
    const float rq = sqrtf(qn2);
    for (int m = 0; m < M; ++m) {
      float dot = 0.f;
      if constexpr (KC > 0) {
#pragma unroll
        for (int j = 0; j < KC; ++j) dot = fmaf(qr[j], sh_x[m * KC + j], dot);
      } else {
        for (int j = 0; j < K; ++j) dot = fmaf(__ldg(qrow + j), sh_x[m * K + j], dot);
      }
      sh_out[t * M + m] =
          sh_live[m] > 0.f ? finish_score(dot, qn2, sh_xn2[m], rq, sh_rx[m], metric) : kNegInf;
    }
  }
  __syncthreads();
  float* o = out + static_cast<int64_t>(q0) * M;
  for (int i = t; i < rows * M; i += kRowThreads) o[i] = sh_out[i];
}

}  // namespace

extern "C" int variant_pairwise_launch(int mode, const void* q, const void* x, const void* valid,
                                       int valid_bytes, void* out, int64_t Q, int64_t M, int K,
                                       int metric, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const Valid v{valid, valid_bytes};
  const int nq = static_cast<int>(Q), nm = static_cast<int>(M);
  if (mode == 0) {
    pairwise_thread_i64_kernel<<<score_blocks(Q * M), kScoreThreads, 0, s>>>(qf, xf, v, of, Q,
                                                                            M, K, metric);
  } else if (mode == 1) {
    if (M > kSmallM) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((Q * M + kScoreThreads - 1) / kScoreThreads);
    with_classes(K, [&](auto kc) {
      pairwise_few_kernel<decltype(kc)::value><<<blocks, kScoreThreads, 0, s>>>(qf, xf, v, of, nq,
                                                                              nm, K, metric);
    });
  } else if (mode == 2) {
    if (M > kSmallM || M * K > 2048) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((Q + kRowThreads - 1) / kRowThreads);
    const size_t smem = sizeof(float) * (M * K + 3 * M + kRowThreads * M);
    with_classes(K, [&](auto kc) {
      pairwise_rows_kernel<decltype(kc)::value><<<blocks, kRowThreads, smem, s>>>(
          qf, xf, v, of, nq, nm, K, metric);
    });
  } else {
    const int64_t mblocks = (M + kColThreads - 1) / kColThreads;
    const int64_t blocks = (Q + kColQueries - 1) / kColQueries * mblocks;
    with_classes(K, [&](auto kc) {
      pairwise_cols_kernel<decltype(kc)::value>
          <<<static_cast<unsigned>(blocks), kColThreads, 0, s>>>(
              qf, xf, v, of, nq, nm, K, static_cast<int>(mblocks), metric);
    });
  }
  return static_cast<int>(cudaGetLastError());
}
"""
_P = ctypes.c_void_p
_I64, _INT = ctypes.c_int64, ctypes.c_int


def variant_source(subs) -> str:
    text = open(SRC).read()
    for old, new in subs:
        if text.count(old) != 1:
            raise AssertionError(f"the source holds {text.count(old)} "
                                 f"copies of {old[:60]!r}, not one")
        text = text.replace(old, new)
    return text + PAIRWISE


def compile_all(build) -> tuple[dict, dict]:
    """Compile every variant at once; returns its library and its pass-1
    registers and spills by K, from ``-Xptxas -v``."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(subs))
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        regs[name] = {}
        for i, line in enumerate(lines):
            hit = re.search(r"Compiling entry function '(_Z\w*?(topk_pass1_kernel|"
                            r"gathered_topk_pass1_kernel)ILi(\d+)\w*)'", line)
            if hit:
                blob = " ".join(lines[i + 1:i + 4])
                r = re.search(r"Used (\d+) registers", blob)
                sp = re.search(r"(\d+) bytes spill stores", blob)
                regs[name][f"{hit.group(2)}<{hit.group(3)}>"] = (
                    f"{r.group(1) if r else '?'} registers, "
                    f"{sp.group(1) if sp else '?'} B spilled")
        lib = ctypes.CDLL(so)
        for fn, (args, res) in build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
        lib.variant_pairwise_launch.argtypes = [_INT, _P, _P, _P, _INT, _P,
                                                _I64, _I64, _INT, _INT, _P]
        lib.variant_pairwise_launch.restype = _INT
        libs[name] = lib
    return libs, regs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import topk_score as ts

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs, regs = compile_all(build)
    print("pass-1 registers:", json.dumps(regs), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def ok(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")

    def pairwise(lib, mode, q, x, valid):
        out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32,
                          device=dev)
        ok(lib.variant_pairwise_launch(
            mode, q.data_ptr(), x.data_ptr(),
            None if valid is None else valid.data_ptr(),
            0 if valid is None else valid.element_size(), out.data_ptr(),
            q.shape[0], x.shape[0], q.shape[1], 0, stream))
        return out

    def scored(lib, q, x, valid, k, metric=0):
        nq, m = q.shape[0], x.shape[0]
        chunks = ts._num_chunks(dev, nq, m)
        kk = min(k, m)
        out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
        ps = torch.empty((nq, chunks, kk), dtype=torch.float32, device=dev)
        pm = torch.empty((nq, chunks, kk), dtype=torch.int32, device=dev)
        ok(lib.scored_topk_launch(
            q.data_ptr(), x.data_ptr(),
            None if valid is None else valid.data_ptr(),
            0 if valid is None else valid.element_size(), ps.data_ptr(),
            pm.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), nq, m,
            q.shape[1], metric, k, chunks, stream))
        return out_i, out_s

    def gathered(lib, q, cand, mask, ids, k, metric=0):
        nq, m = cand.shape[0], cand.shape[1]
        chunks = ts._gathered_chunks(dev, nq, m)
        kk = min(k, m)
        out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
        ps = torch.empty((nq, chunks, kk), dtype=torch.float32, device=dev)
        pm = torch.empty((nq, chunks, kk), dtype=torch.int32, device=dev)
        ok(lib.scored_topk_gathered_launch(
            cand.data_ptr(), q.data_ptr(), mask.data_ptr(), ids.data_ptr(),
            ps.data_ptr(), pm.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            nq, m, q.shape[1], metric, k, chunks, stream))
        return out_i, out_s

    def gpu_ms(fn, reps=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def race(fns: dict, rounds=3) -> dict:
        got = {n: [] for n in fns}
        for _ in range(rounds):
            for n, fn in fns.items():
                got[n].append(gpu_ms(fn))
        return {n: round(float(np.median(t)), 5) for n, t in got.items()}

    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def ints(*shape):
        return t(rng.integers(-2, 3, shape).astype(np.float32))

    def normal(*shape):
        return t(rng.standard_normal(shape).astype(np.float32))

    result = {"card": card, "registers": regs}

    # -- pairwise_scores four ways -------------------------------------------
    lib = libs["as_built"]
    modes = {"thread_i64": 0, "few": 1, "rows": 2, "cols": 3}

    def fits(mode, mn):  # few and rows take M <= kSmallM only
        return mode in (0, 3) or mn <= 32

    for qn, mn, kd in ((64, 5, 5), (92482, 5, 5), (64, 92482, 5),
                       (129, 7, 3), (65, 1000, 9)):
        q, x = ints(qn, kd), ints(mn, kd)
        valid = t(rng.random(mn) < 0.7, torch.bool)
        want = ref.pairwise_scores_ref(q, x, valid, "l2")
        for name, mode in modes.items():
            if not fits(mode, mn):
                continue
            if not torch.equal(pairwise(lib, mode, q, x, valid), want):
                raise AssertionError(f"pairwise {name} {qn}x{mn}x{kd}")
    shapes = {  # (Q, M, K, valid): the main path's three shapes, both graphs
        "cl build": (92482, 5, 5, True), "cl probe": (64, 5, 5, True),
        "cl staged": (64, 92482, 5, False),
        "sbm build": (10000, 3, 3, True), "sbm probe": (64, 3, 3, True),
        "sbm staged": (64, 10000, 3, False)}
    pw = {}
    for sname, (qn, mn, kd, has_valid) in shapes.items():
        q, x = normal(qn, kd), normal(mn, kd)
        valid = torch.ones(mn, dtype=torch.bool, device=dev) if has_valid \
            else None
        fns = {name: (lambda mode=mode: pairwise(lib, mode, q, x, valid))
               for name, mode in modes.items() if fits(mode, mn)}
        outs = [fn() for fn in fns.values()]
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"pairwise paths differ at {sname}")
        pw[sname] = race(fns)
        pw[sname]["wrapper"] = round(gpu_ms(
            lambda: ts.pairwise_scores(q, x, valid)), 5)
        print(f"pairwise_scores {sname} {qn}x{mn}x{kd} ms:",
              json.dumps(pw[sname]), flush=True)
    pw["empty_launch"] = round(gpu_ms(lambda: torch.cuda._sleep(0)), 5)
    result["pairwise_scores"] = pw

    # -- scored_topk: the round-ahead prefetch, lists one after the other ----
    trio = {n: libs[n] for n in ("as_built", "no_prefetch", "lockstep")}
    for qn, mn, kd in ((65, 30001, 5), (3, 5000, 8), (64, 10000, 3)):
        q, x = ints(qn, kd), ints(mn, kd)
        valid = t(rng.random(mn) < 0.8, torch.bool)
        for k in (1, 10, 32):
            want = ref.scored_topk_ref(q, x, valid, k)
            for n, vlib in trio.items():
                got = scored(vlib, q, x, valid, k)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"scored_topk {n} {qn}x{mn}x{kd} "
                                         f"k={k}")
    st = {}
    for sname, (mn, kd) in {"cl": (92482, 5), "sbm": (10000, 3)}.items():
        q, x = normal(64, kd), normal(mn, kd)
        for k in (1, 10, 32):
            st[f"{sname} k={k}"] = race(
                {n: (lambda vlib=vlib: scored(vlib, q, x, None, k))
                 for n, vlib in trio.items()})
            print(f"scored_topk {sname} 64x{mn}x{kd} k={k} ms:",
                  json.dumps(st[f'{sname} k={k}']), flush=True)
    result["scored_topk"] = st

    # -- scored_topk_gathered: warp_offer's own loop or warp_offer_n<1> ------
    pair = {n: libs[n] for n in ("as_built", "offer_n1")}
    q, cand = ints(5, 3), ints(5, 9000, 3)
    mask = t(rng.random((5, 9000)) < 0.8)
    ids = t(rng.permutation(5 * 9000).reshape(5, 9000), torch.int32)
    for k in (1, 10, 32):
        want = ref.scored_topk_gathered_ref(q, cand, mask, ids, k)
        for n, vlib in pair.items():
            got = gathered(vlib, q, cand, mask, ids, k)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"scored_topk_gathered {n} k={k}")
    gt = {}
    for sname, (mn, kd) in {"cl": (58752, 5), "sbm": (10240, 3)}.items():
        q, cand = normal(64, kd), normal(64, mn, kd)
        mask = t(rng.random((64, mn)) < 0.9)
        ids = t(np.tile(np.arange(mn), (64, 1)), torch.int32)
        for k in (10, 32):
            gt[f"{sname} k={k}"] = race(
                {n: (lambda vlib=vlib: gathered(vlib, q, cand, mask, ids, k))
                 for n, vlib in pair.items()})
            print(f"scored_topk_gathered {sname} 64x{mn}x{kd} k={k} ms:",
                  json.dumps(gt[f'{sname} k={k}']), flush=True)
    result["scored_topk_gathered"] = gt

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "topk_variants.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
