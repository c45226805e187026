#!/usr/bin/env python3
"""Time the contraction kernels (``gee_spmm``, ``gee_spmm_fused``) per degree
bucket, against other trees and other designs, on one GPU.

    python3 tools/gee_variants.py                          # sweep this tree
    python3 tools/gee_variants.py --trees OTHER . --rounds 1

Both modes fit sbm-10k (``sample_sbm(10_000, seed=0)``) and cl-100k-1d8-l5
(``synth_like``, seed 0) with the default options, fused and staged, and
keep every contraction launch of the two fits (one a degree bucket).  Each
launch is timed alone with the L2 flushed before each rep (a 128 MB buffer
written and then read outside the timed window; median of 10 reps, CUDA
events behind a sleep kernel: ``chip_smoke.py``'s ``gpu_ms_cold``), and each
fit's launches in sequence, warm (``gpu_ms``, as its phase 6) and with the L2
flushed before each rep.

``--trees``: a fresh process for each tree (a checkout of this repo; ``.``
is this one), in the order A B B A, ``--rounds`` times, imports that tree's
``repro_torch``, builds its kernels and times its own fits' launches: a tree
that launches a bucket's padding rows is timed with them.  Prints each
bucket's median over the processes of a tree beside the other's.

Sweep (no ``--trees``): this tree's launch geometry at other settings of
``launch_geometry``'s knobs (``lane_loads``, ``seg_loads``, ``span``), and
variants of ``csrc/gee_kernels.cu`` made by exact text swaps and compiled
with the build's own flags into ``build/gee_variants/``: ``kvec2`` and
``kvec8`` (loads of each plane a lane issues before it uses the first) and
``second_pass`` (a split row's partial sums added by a second launch, one
warp a row, instead of the last block to take a ticket).  Every setting and
variant is first held bit for bit against the plain version on
integer-valued planes (exact sums), then against the source's kernel on the
captured planes with ``chip_smoke.py``'s tolerance.

Writes ``chiprun_out/gee_variants.json`` (``gee_variants_trees.json`` with
``--trees``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src/repro_torch/kernels/csrc/gee_kernels.cu")
OUT = os.path.join(ROOT, "build", "gee_variants")

# a split row's partial sums added by a second launch: the span kernel
# returns after it writes its span's sums, a warp a row adds them
SECOND_PASS = [
    ("  if (split) {\n    // The ticket:",
     "  if (split && tickets == nullptr) return;  // added by a second launch\n"
     "  if (split) {\n    // The ticket:"),
    ("if (nspans > 1 && (ws == nullptr || tickets == nullptr)) "
     "return cudaErrorInvalidValue;",
     "if (nspans > 1 && ws == nullptr) return cudaErrorInvalidValue;"),
]
SECOND_PASS_KERNEL = r"""
namespace {
__global__ void __launch_bounds__(kWarp)
variant_combine_kernel(const float* __restrict__ ws, const int* __restrict__ rowlab,
                       const float* __restrict__ dadd, float* __restrict__ out, int K,
                       int nspans, int correlation, float eps) {
  extern __shared__ float row[];
  const int lane = threadIdx.x;
  const int64_t r = blockIdx.x;
  const bool diag = rowlab != nullptr;
  const int y = diag ? __ldg(rowlab + r) : -1;
  const float a = diag ? __ldg(dadd + r) : 0.f;
  const bool epi = diag || correlation;
  const float* p = ws + r * nspans * K;
  float* to = epi ? row : out + r * K;
  for (int k = lane; k < K; k += kWarp) {
    float v = 0.f;
    for (int i0 = 0; i0 < nspans; i0 += kCombineLoads) {
      float q[kCombineLoads];
#pragma unroll
      for (int u = 0; u < kCombineLoads; ++u) {
        q[u] = i0 + u < nspans ? __ldg(p + static_cast<int64_t>(i0 + u) * K + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kCombineLoads; ++u) {
        if (i0 + u < nspans) v += q[u];
      }
    }
    to[k] = v;
  }
  __syncwarp();
  if (epi) epilogue_warp(row, out + r * K, K, y, a, correlation, eps, lane);
}
}  // namespace

extern "C" int variant_combine_launch(const void* ws, const void* rowlab, const void* dadd,
                                      void* out, int64_t R, int K, int nspans,
                                      int correlation, float eps, void* stream) {
  const bool epi = rowlab != nullptr || correlation;
  variant_combine_kernel<<<static_cast<unsigned>(R), kWarp, epi ? sizeof(float) * K : 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const int*>(rowlab),
      static_cast<const float*>(dadd), static_cast<float*>(out), K, nspans, correlation, eps);
  return static_cast<int>(cudaGetLastError());
}
"""
VARIANTS = {
    "kvec2": [("constexpr int kVec = 4;", "constexpr int kVec = 2;")],
    "kvec8": [("constexpr int kVec = 4;", "constexpr int kVec = 8;")],
    "second_pass": SECOND_PASS,
}
# launch_geometry's knobs: (lane_loads, seg_loads, span)
SWEEP = [(ll, sl, sp) for ll in (2, 4, 8) for sl in (8, 16, 32)
         for sp in (2048, 4096, 8192, 16384) if ll <= sl]


def variant_source(name: str) -> str:
    text = open(SRC).read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise AssertionError(f"the source holds {text.count(old)} "
                                 f"copies of {old[:60]!r}, not one")
        text = text.replace(old, new)
    return text + (SECOND_PASS_KERNEL if name == "second_pass" else "")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def captured_fits(torch, cs, tree_src: str) -> tuple[dict, dict]:
    """{graph: {kernel: [(args, kwargs)]}} of a default fused fit and a
    default staged fit of both graphs (``chip_smoke.Recorder``), and the
    kernel wrappers by name.  A tree whose drivers make gathered launches
    (``gee_spmm_gathered``) gives the plane calls they stand for
    (``chip_smoke.planes_of``)."""
    sys.path.insert(0, tree_src)
    from repro_torch.core.api import GEEEmbedder
    from repro_torch.core.plan import PreparedGraph
    from repro_torch.graph.datasets import TABLE2, synth_like
    from repro_torch.graph.sbm import sample_sbm
    from repro_torch.kernels import gee_fused, ops
    from repro_torch.kernels.build import load_library

    load_library()
    sbm = sample_sbm(10_000, seed=0)
    cl = synth_like(TABLE2["cl-100k-1d8-l5"], seed=0)
    graphs = {"sbm-10k": (sbm.edges, sbm.labels, sbm.num_classes),
              "cl-100k-1d8-l5": (cl.edges, cl.labels, cl.spec.num_classes)}
    out = {}
    for g, (edges, labels, k) in graphs.items():
        prep = PreparedGraph(edges)
        calls = {}
        gathered = hasattr(gee_fused, "gee_spmm_gathered")
        for name, module, flag in (("gee_spmm_fused", gee_fused, "1"),
                                   ("gee_spmm", ops, "0")):
            os.environ[gee_fused.ENV_FUSED] = flag
            try:
                with cs.Recorder(module, "gee_spmm_gathered" if gathered
                                 else name) as keep:
                    GEEEmbedder(num_classes=k, backend="cuda").fit_transform(
                        prep, labels)
            finally:
                del os.environ[gee_fused.ENV_FUSED]
            calls[name] = [cs.planes_of(torch, a, kw, flag == "1")
                           for a, kw in keep.calls] if gathered \
                else keep.calls
        out[g] = calls
    torch.cuda.synchronize()
    return out, {"gee_spmm_fused": gee_fused.gee_spmm_fused,
                 "gee_spmm": ops.gee_spmm}


def time_fits(torch, cs, caps, fns, flush) -> dict:
    """Each launch alone (L2 flushed) and each fit's launches in sequence."""
    res = {}
    for g, by_name in caps.items():
        for name, calls in by_name.items():
            fn = fns[name]

            def fit():
                return [fn(*a, **kw) for a, kw in calls]

            res[f"{g} {name}"] = {
                "shapes": [list(a[0].shape) for a, _ in calls],
                "bucket_ms": [cs.gpu_ms_cold(torch, lambda: fn(*a, **kw),
                                             flush) for a, kw in calls],
                "fit_ms": cs.gpu_ms(torch, fit),
                "fit_ms_flushed": cs.gpu_ms_cold(torch, fit, flush, reps=20)}
    return res


def worker(tree: str) -> dict:
    import torch

    import chip_smoke as cs

    tree = os.path.abspath(tree)
    caps, fns = captured_fits(torch, cs, os.path.join(tree, "src"))
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    return {"tree": tree, "card": card(),
            "timing": time_fits(torch, cs, caps, fns, flush)}


def compare_trees(trees: list[str], rounds: int) -> dict:
    order = []
    for _ in range(rounds):
        order += trees + trees[::-1]
    runs = {t: [] for t in trees}
    for t in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", t], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"worker for {t} failed:\n{proc.stderr[-4000:]}")
        runs[t].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"ran {t}", flush=True)
    summary = {}
    for key in runs[trees[0]][0]["timing"]:
        row = {}
        for t in trees:
            tim = [r["timing"][key] for r in runs[t]]
            row[t] = {
                "shapes": tim[0]["shapes"],
                "bucket_ms": np.median([x["bucket_ms"] for x in tim],
                                       axis=0).round(5).tolist(),
                "fit_ms": round(float(np.median([x["fit_ms"] for x in tim])),
                                5),
                "fit_ms_flushed": round(float(np.median(
                    [x["fit_ms_flushed"] for x in tim])), 5)}
        summary[key] = row
        a, b = (row[t] for t in trees)
        print(f"{key}: fit {a['fit_ms']} / {b['fit_ms']} ms, flushed "
              f"{a['fit_ms_flushed']} / {b['fit_ms_flushed']}; buckets "
              + " ".join(f"{sa[1]}:{x}/{y}" for sa, x, y in
                         zip(a["shapes"], a["bucket_ms"], b["bucket_ms"])),
              flush=True)
    return {"trees": trees, "order": order, "card": runs[trees[0]][0]["card"],
            "summary": summary, "runs": runs}


# ---------------------------------------------------------------------------
# the sweep of this tree
# ---------------------------------------------------------------------------

def compile_variants(build) -> dict:
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn, (args, res) in build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
        libs[name] = lib
    P = ctypes.c_void_p
    libs["second_pass"].variant_combine_launch.argtypes = [
        P, P, P, P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, P]
    libs["second_pass"].variant_combine_launch.restype = ctypes.c_int
    return libs


def sweep() -> dict:
    import torch

    import chip_smoke as cs

    caps, _ = captured_fits(torch, cs, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import gee_spmm as gs
    from repro_torch.kernels.build import stream_of

    libs = compile_variants(build)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    dev = torch.device("cuda")
    as_built, geometry = gs.load_library, gs.launch_geometry

    def run(a, kw, name, knobs=(), lib=None):
        """One launch of ``name`` on captured args ``a`` through
        ``launch_contraction``, its geometry at ``knobs`` (lane_loads,
        seg_loads, span) and on ``lib`` instead of the built library."""
        if lib is not None:
            gs.load_library = lambda: lib
        g = None
        if knobs:
            d, k = a[0].shape[1], (a[2] if name == "gee_spmm" else a[4])
            g = geometry(d, k, gs._vec(a[0], a[1]), *knobs)
        try:
            if name == "gee_spmm":
                return gs.launch_contraction(a[0], a[1], None, None, a[2],
                                             geometry=g)
            return gs.launch_contraction(
                a[0], a[1], a[2], a[3], a[4],
                correlation=kw.get("correlation", True), eps=1e-30,
                geometry=g)
        finally:
            gs.load_library = as_built

    def second_pass(a, kw, name):
        """The split rows' sums added by a second launch."""
        lib = libs["second_pass"]
        y, c = a[0], a[1]
        r, d = y.shape
        k = a[2] if name == "gee_spmm" else a[4]
        lanes, span, spans = gs.launch_geometry(d, k, True)
        if spans == 1:
            return run(a, kw, name, lib=lib)
        out = torch.empty((r, k), dtype=torch.float32, device=dev)
        ws = torch.empty(r * spans * k, dtype=torch.float32, device=dev)
        s = stream_of(y)
        if name == "gee_spmm":
            rc = lib.gee_spmm_launch(y.data_ptr(), c.data_ptr(), out.data_ptr(),
                                     ws.data_ptr(), None, r, d, k, 1, lanes,
                                     span, s)
            rl = da = None
            cor = 0
        else:
            rl, da = a[2].data_ptr(), a[3].data_ptr()
            cor = int(kw.get("correlation", True))
            rc = lib.gee_spmm_fused_launch(
                y.data_ptr(), c.data_ptr(), rl, da, out.data_ptr(),
                ws.data_ptr(), None, r, d, k, cor, 1e-30, 1, lanes, span, s)
        if rc != 0:
            raise RuntimeError(f"second_pass launch: {rc}")
        rc = lib.variant_combine_launch(ws.data_ptr(), rl, da, out.data_ptr(),
                                        r, k, spans, cor, 1e-30, s)
        if rc != 0:
            raise RuntimeError(f"second_pass combine: {rc}")
        return out

    # exactness first: integer-valued planes at every geometry and variant
    rng = np.random.default_rng(0)
    for r, d, k in ((37, 128, 5), (9, 2048, 3), (5, 8192, 5), (2, 65536, 5),
                    (3, 20000, 9)):
        ylab = rng.integers(-1, k, (r, d)).astype(np.int32)
        contrib = np.where(ylab >= 0, rng.integers(1, 4, (r, d)), 0)
        y = torch.from_numpy(ylab).to(dev)
        c = torch.from_numpy(contrib.astype(np.float32)).to(dev)
        want = ref.gee_spmm_ref(y, c, k)
        empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
        empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
        for knobs in SWEEP:
            for got in (run((y, c, k), {}, "gee_spmm", knobs),
                        run((y, c, empty_i, empty_f, k), {"correlation": False},
                            "gee_spmm_fused", knobs)):
                if not torch.equal(got, want):
                    raise AssertionError(f"knobs {knobs} [{r}, {d}] K={k}")
        for v, lib in libs.items():
            for name, a, kw in (("gee_spmm", (y, c, k), {}),
                                ("gee_spmm_fused", (y, c, empty_i, empty_f, k),
                                 {"correlation": False})):
                got = (second_pass(a, kw, name) if v == "second_pass"
                       else run(a, kw, name, lib=lib))
                if not torch.equal(got, want):
                    raise AssertionError(f"variant {v} {name} [{r}, {d}]")
    print("every setting and variant exact on integer planes", flush=True)

    result = {"card": card(), "knobs": {"default": [gs.LANE_LOADS,
                                                    gs.SEG_LOADS, gs.SPAN]},
              "buckets": {}}
    for g, by_name in caps.items():
        for name, calls in by_name.items():
            for a, kw in calls:
                want = run(a, kw, name)
                fns = {",".join(map(str, kn)): (lambda a=a, kw=kw, kn=kn: run(
                    a, kw, name, kn)) for kn in SWEEP}
                fns.update({v: (lambda a=a, kw=kw, lib=lib: run(
                    a, kw, name, lib=lib)) for v, lib in libs.items()
                    if v != "second_pass"})
                fns["second_pass"] = lambda a=a, kw=kw: second_pass(a, kw,
                                                                    name)
                times = {}
                for key, fn in fns.items():
                    cs.max_err(torch, fn(), want)
                    times[key] = round(cs.gpu_ms_cold(torch, fn, flush), 5)
                r, d = a[0].shape
                best = min(times, key=times.get)
                default = times[f"{gs.LANE_LOADS},{gs.SEG_LOADS},{gs.SPAN}"]
                result["buckets"][f"{g} {name} [{r}, {d}]"] = times
                print(f"{g} {name} [{r}, {d}]: default {default} ms, best "
                      f"{best} {times[best]}, kvec2 {times['kvec2']}, kvec8 "
                      f"{times['kvec8']}, second_pass {times['second_pass']}",
                      flush=True)
    # each setting summed over the buckets of a fit
    totals = {}
    for key in result["buckets"][next(iter(result["buckets"]))]:
        for fit in ("sbm-10k gee_spmm_fused", "sbm-10k gee_spmm",
                    "cl-100k-1d8-l5 gee_spmm_fused", "cl-100k-1d8-l5 gee_spmm"):
            totals.setdefault(key, {})[fit] = round(sum(
                t[key] for b, t in result["buckets"].items()
                if b.startswith(fit + " [")), 5)
    result["fit_sums"] = totals
    ranked = sorted(totals, key=lambda k: sum(totals[k].values()))
    print("settings by the sum of all four fits' buckets (ms): " + "; ".join(
        f"{k} {round(sum(totals[k].values()), 5)}" for k in ranked[:8]),
        flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="checkouts to compare")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)             # chip_smoke's timing helpers
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    print(card(), flush=True)
    result = compare_trees(args.trees, args.rounds) if args.trees else sweep()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "gee_variants_trees.json" if args.trees else "gee_variants.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
