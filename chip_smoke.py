#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc/``
with nvcc for sm_90a (one compile per source, in parallel), holds each kernel
against its plain PyTorch version on the card, and drives the port's two
paths on the paper's 10k-node SBM and on the ``cl-100k-1d8-l5`` stand-in
(20 M directed edges):

* the embedding (``GEEEmbedder.fit_transform`` with the ``cuda`` backend,
  fused and staged; all 8 option settings on the SBM), held against the
  port's ``sparse_torch`` reference and the default setting against SciPy
  on the host;
* vertex-similarity retrieval (``build_index``, then 4,096 vertex-id queries
  through ``GEEQueryService`` in flushes of 64, fused and staged, at the
  default nprobe and at full probe, and brute force; l2 and cosine), with
  full probe held equal to brute force and fused to staged;
* out-of-core streaming (phase 10): ``synth_to_disk`` writes
  ``cl-100k-1d8-l5`` (10 M undirected entries) and a scale file (2 M nodes,
  50 M entries) as ``.geeb``; ``fit_transform_file`` streams them through
  the pinned-staging prefetch and the window fold, held against the
  in-memory ``cuda`` fit of ``load_file`` under all 8 settings (and SciPy),
  prefetch depth 0 against depth 2, the scale file against the in-memory
  ``sparse_torch`` fit, with its time, edges per second, the device's busy
  share, the fold's time per window and the peak device memory under a
  stated bound; retrieval over the streamed embedding; and the
  ``gee_run`` / ``gee_search --edge-file`` entry points in processes of
  their own.

Each path runs with every kernel's launch count set to 0 just before it and
read just after.  Every kernel is timed with CUDA events beside its bound;
the two contraction kernels also per degree bucket with the L2 flushed,
with the device work one bucket launch enqueues, and a warm fit's device
time split by prep pass; ``pairwise_scores`` at its three shapes (index
build, a flush's probe, the staged brute force) with the kernels one call
launches, both top-k kernels at other chunk counts and widths of top-k, and
the device time of a fused flush.
The line before the last lists the seven kernels; the last line of standard
output is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before those lines.  Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
# f32 sums in another order, up to 65,536 terms.  ATOL is scaled to each
# row (below): a Laplacian-scaled row of a hub holds values near 1e-6, so a
# fixed 1e-5 would pass a row that lost most of its terms.
RTOL = ATOL = 1e-5
# The retrieval scores are held to the f32 round-off of the terms they are
# computed from (``term_scale``), not to their own size: 1e-6 of the terms,
# about 8 units of f32 round-off.
TERM_ATOL = 1e-6
DEVICE = "cuda"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/gee_kernels.cu"
TOPK_SOURCE = "src/repro_torch/kernels/csrc/topk_kernels.cu"
REPLACES = {
    "gee_spmm": "src/repro/kernels/gee_spmm.py:208",
    "row_norm": "src/repro/kernels/row_norm.py:26",
    "gee_spmm_fused": "src/repro/kernels/gee_fused.py:122",
    "pairwise_scores": "src/repro/kernels/topk_score.py:171",
    "gathered_scores": "src/repro/kernels/topk_score.py:184",
    "scored_topk": "src/repro/kernels/topk_score.py:379",
    "scored_topk_gathered": "src/repro/kernels/topk_score.py:407",
}
# the one PyTorch call timed beside a kernel as its yardstick (phase 6)
LIBRARY = {"row_norm": "F.normalize", "gee_spmm": "torch.sparse.mm"}
# the streaming path (phase 10): a file of 2 M nodes, 50 M undirected
# entries and 5 classes (48 windows of the default 1,048,576 entries)
SCALE_SPEC = ("scale-2m-50m", 2_000_000, 50_000_000, 5)
# the retrieval path (phase 8): vertex-id queries, flushes of 64, top 10
N_QUERIES = 4096
FLUSH = 64
TOP_K = 10


def say(line: str) -> None:
    print(line, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for a kernel wrapper in its caller's module and keeps the
    arguments of every call, so the main path's exact kernel inputs can be
    compared and timed.  It calls the wrapper itself, which keeps counting
    its own launches."""

    # While it stands in, the wrapper's own ``launches += 1`` finds the
    # recorder under the wrapper's name; those capture launches are not
    # main-path launches, so they land here and are dropped.
    launches = 0

    def __init__(self, module, name, keep=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []
        self.keep = keep                 # keep the first ``keep`` calls

    def __call__(self, *args, **kwargs):
        if self.keep is None or len(self.calls) < self.keep:
            self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def gpu_ms(torch, fn, reps: int = 20, warmup: int = 2,
           sleep_cycles: int = 1_000_000) -> float:
    """Median device time (ms) of ``fn``'s launches, by CUDA events.  A
    sleep kernel queued ahead of the start event lets the host enqueue all
    of ``fn``'s launches before the device reaches them, so host launch
    overhead does not show as device time (as long as the host finishes
    within the sleep and ``fn`` never waits for the device)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


FLUSH_BYTES = 128 * 2**20       # more than twice the H100's 50 MB L2


def gpu_ms_cold(torch, fn, flush, reps: int = 10, warmup: int = 2) -> float:
    """``gpu_ms`` with the L2 flushed before each rep: outside the timed
    window, ``flush`` (a ``FLUSH_BYTES`` buffer) is written and then read,
    so L2 holds none of ``fn``'s inputs and no dirty line that would be
    written back inside the window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(torch, fn, reps: int) -> float:
    """Median wall time (ms) of ``fn`` ending in a device synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def max_err(torch, got, want, scale=None) -> tuple:
    """Hold ``got`` against ``want`` row by row: each entry within
    ``RTOL * |want| + ATOL * min(1, max |want row|)``, so every row is held
    to its own scale and never more loosely than rtol = atol = 1e-5; a row
    that should be all zeros must be exactly zero.  A retrieval score's row
    passes ``scale`` [rows, 1], its ``term_scale``: each entry is then held
    within ``RTOL * |want| + TERM_ATOL * scale``.  Returns the max-abs error
    and the max over rows of max |got - want| / the row's scale."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0, 0.0
    g = got.detach().double().reshape(got.shape[0], -1)
    w = want.detach().to(g.device).double().reshape(want.shape[0], -1)
    if scale is None:
        scale = w.abs().amax(dim=1, keepdim=True)
        atol = ATOL * scale.clamp(max=1.0)
    else:
        scale = torch.as_tensor(scale).to(g.device).double().reshape(-1, 1)
        atol = TERM_ATOL * scale
    diff = (g - w).abs()
    bad = ~(diff <= RTOL * w.abs() + atol)                       # NaN: bad
    row_err = diff.amax(dim=1, keepdim=True)
    rel = torch.where(scale > 0, row_err / scale,
                      torch.where(row_err > 0, float("inf"), 0.0))
    if bool(bad.any()):
        r = int(bad.any(dim=1).nonzero()[0])
        raise AssertionError(
            f"{int(bad.sum())} of {bad.numel()} entries off; first in row "
            f"{r}: got {g[r, :8].tolist()} want {w[r, :8].tolist()}")
    return float(diff.max()), float(rel.max())


def worst(pairs) -> tuple:
    """The largest max-abs and the largest relative error of ``max_err``
    results."""
    pairs = list(pairs)
    return max(a for a, _ in pairs), max(r for _, r in pairs)


def fmt_err(pairs) -> str:
    a, r = worst(pairs)
    return f"max_abs_err={a:.3g} max_rel_err={r:.3g}"


def rand_planes(rng, r, d, k, pad_frac=0.3):
    ylab = rng.integers(0, k, (r, d)).astype(np.int32)
    contrib = rng.uniform(0.1, 1.0, (r, d)).astype(np.float32)
    pad = rng.random((r, d)) < pad_frac
    ylab[pad] = -1
    contrib[pad] = 0.0
    ylab[0] = -1                       # an all-padding row
    contrib[0] = 0.0
    return ylab, contrib


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def edge_cases(torch, kernels, refs, errs):
    """Kernel vs plain on small shapes that stress the edges: K=1, K past
    one class tile, all -1 rows, row counts off the block, widths 8 and
    65,536, empty rowlab, correlation on and off; then ``row_norm``'s own
    cases (``row_norm_edge_cases``)."""
    gee_spmm, row_norm, gee_spmm_fused = kernels
    gee_spmm_ref, row_norm_ref, gee_spmm_fused_ref = refs
    rng = np.random.default_rng(0)
    dev = DEVICE
    shapes = [(13, 8, 1), (13, 8, 3), (300, 8, 7), (37, 100, 40),
              (16, 2048, 64), (5, 65536, 5), (1, 65536, 1), (9, 8192, 9)]
    n_cases = 0
    for r, d, k in shapes:
        y_np, c_np = rand_planes(rng, r, d, k)
        y, c = torch.from_numpy(y_np).to(dev), torch.from_numpy(c_np).to(dev)
        errs["gee_spmm"].append(max_err(torch, gee_spmm(y, c, k),
                                        gee_spmm_ref(y, c, k)))
        rowlab = torch.from_numpy(
            rng.integers(-1, k, r).astype(np.int32)).to(dev)
        dadd = torch.from_numpy(
            rng.uniform(0.1, 1.0, r).astype(np.float32)).to(dev)
        empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
        empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
        for rl, da in ((rowlab, dadd), (empty_i, empty_f)):
            for cor in (True, False):
                errs["gee_spmm_fused"].append(max_err(
                    torch, gee_spmm_fused(y, c, rl, da, k, correlation=cor),
                    gee_spmm_fused_ref(y, c, rl, da, k, correlation=cor)))
                n_cases += 1
        n_cases += 1
    n_cases += row_norm_edge_cases(torch, row_norm, row_norm_ref,
                                   gee_spmm_fused, rng, errs)
    return n_cases


def contraction_edge_cases(torch, gee_spmm, gee_spmm_fused, refs, errs,
                           span: int) -> int:
    """Both contraction kernels against their plain versions at the edges
    of the launch geometry: widths 1, 3, 4, 5 (one slot a load past the
    first), the largest segment row and the first span row (512, 516 at
    16-byte loads), S - 1, S, S + 1 and 2S + 3 for the span S (one row split
    into 1-3 blocks), the 65,536-slot hub width and a 262,144-slot row; K 1,
    5, 8, 9, 32 and 33 (exact K, then class tiles), K = 1,024 (fused) and
    1,500 (staged); diag and correlation on and off, ``rowlab = -1`` rows,
    all-padding rows and an all-padding plane, R = 0, and a ``contrib`` whose
    base is not 16-byte aligned (a contiguous view at an offset of one element).
    Every launch is made twice and must give the same bits; integer-valued
    planes, whose sums are exact, must give the plain version's bits."""
    gee_spmm_ref, gee_spmm_fused_ref = refs
    rng = np.random.default_rng(1)
    dev = DEVICE
    empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
    empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
    widths = (1, 3, 4, 5, 128, 512, 516, span - 1, span, span + 1,
              2 * span + 3)
    cases = [(37, d, k, False) for k in (1, 5, 8, 9, 32, 33) for d in widths]
    cases += [(2, 65536, k, False) for k in (1, 5, 9)]
    cases += [(2, 262144, k, False) for k in (1, 5, 9)]
    cases += [(9, d, 1024, False) for d in (5, 516, 2 * span + 3)]
    cases += [(9, d, 1500, False) for d in (5, 516, 2 * span + 3)]
    cases += [(0, 4, 5, False), (0, 2 * span + 3, 5, False)]
    cases += [(37, d, k, True) for d in (128, 516, 2048, 2 * span + 4)
              for k in (5, 33)]

    def twice(fn, *a, **kw):
        got = fn(*a, **kw)
        if not torch.equal(got, fn(*a, **kw)):
            raise AssertionError(f"{fn.__name__}: two launches on the same "
                                 f"input differ")
        return got

    def offset_view(t):
        """A contiguous copy of ``t`` one element into a fresh buffer."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    n_cases = 0
    for r, d, k, misaligned in cases:
        y_np, c_np = rand_planes(rng, max(r, 1), d, k)
        if d == 65536:
            y_np[:] = -1                     # an all-padding plane
            c_np[:] = 0.0
        y_np, c_np = y_np[:r], c_np[:r]
        planes = [(torch.from_numpy(y_np).to(dev),
                   torch.from_numpy(c_np).to(dev))]
        ints = np.where(y_np >= 0, rng.integers(1, 4, y_np.shape), 0)
        planes.append((planes[0][0], torch.from_numpy(
            ints.astype(np.float32)).to(dev)))
        if misaligned:
            planes = [(y, offset_view(c)) for y, c in planes]
            if planes[0][1].data_ptr() % 16 == 0:
                raise AssertionError("offset view is 16-byte aligned")
        for i, (y, c) in enumerate(planes):
            got = twice(gee_spmm, y, c, k)
            want = gee_spmm_ref(y, c, k)
            errs["gee_spmm"].append(max_err(torch, got, want))
            if i == 1 and not torch.equal(got, want):
                raise AssertionError(f"gee_spmm R={r} D={d} K={k}: integer "
                                     f"planes differ from plain")
            n_cases += 1
            if k > 1024:
                continue
            rowlab = torch.from_numpy(
                rng.integers(-1, k, r).astype(np.int32)).to(dev)
            dadd = torch.from_numpy(
                rng.uniform(0.1, 1.0, r).astype(np.float32)).to(dev)
            for rl, da in ((rowlab, dadd), (empty_i, empty_f)):
                for cor in (True, False):
                    got = twice(gee_spmm_fused, y, c, rl, da, k,
                                correlation=cor)
                    want = gee_spmm_fused_ref(y, c, rl, da, k,
                                              correlation=cor)
                    errs["gee_spmm_fused"].append(max_err(torch, got, want))
                    if i == 1 and not cor and not rl.numel() \
                            and not torch.equal(got, want):
                        raise AssertionError(
                            f"gee_spmm_fused R={r} D={d} K={k}: integer "
                            f"planes differ from plain")
                    n_cases += 1
    return n_cases


def row_norm_edge_cases(torch, row_norm, row_norm_ref, gee_spmm_fused, rng,
                        errs) -> int:
    """``row_norm`` against its plain version: K on both sides of every
    lane-segment width (1 to 32 lanes a row) and past one warp (33, 200,
    1,025); row counts off every rows-per-warp and block multiple, and
    large enough that the grid strides; zero rows; a row whose squares are
    denormal (no flushed denormals); integer-valued rows, whose sums are
    exact, bit for bit.  Where the fused kernel takes K (<= 1,024), its
    full-warp epilogue run on the same rows (planes of one slot per class,
    so its contraction is exact) must give the same bits."""
    dev = DEVICE
    big = {1: 300_007, 5: 100_003, 32: 20_001}
    n_cases = 0
    for k in (1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 31, 32, 33, 200, 1025):
        for n in (13, 1001, big.get(k)):
            if n is None:
                continue
            for integer in (False, True):
                if integer:
                    z = rng.integers(-3, 4, (n, k)).astype(np.float32)
                else:
                    z = rng.standard_normal((n, k)).astype(np.float32)
                z[rng.random(n) < 0.2] = 0.0           # zero rows stay zero
                if not integer:
                    z[1] = 1e-21           # its squares are denormal floats
                zt = torch.from_numpy(z).to(dev)
                got, want = row_norm(zt), row_norm_ref(zt)
                errs["row_norm"].append(max_err(torch, got, want))
                if integer and not torch.equal(got, want):
                    raise AssertionError(f"row_norm N={n} K={k}: integer-"
                                         f"valued rows differ from plain")
                if not integer:
                    # flushed, the denormal row's norm would read 0
                    torch.testing.assert_close(got[1], want[1], rtol=RTOL,
                                               atol=0.0)
                    if not bool((got[1] != 0).all()):
                        raise AssertionError("row_norm flushed a "
                                             "denormal-norm row")
                if k <= 1024:
                    ylab = torch.arange(k, dtype=torch.int32, device=dev
                                        ).expand(n, k).contiguous()
                    empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
                    empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
                    fused = gee_spmm_fused(ylab, zt, empty_i, empty_f, k,
                                           correlation=True)
                    if not torch.equal(got, fused):
                        raise AssertionError(f"row_norm N={n} K={k}: not the "
                                             f"fused epilogue's bits")
                n_cases += 1
    return n_cases


def bucket_table(torch, fn, calls, bell, flush) -> dict:
    """One contraction kernel on each bucket launch of a fit (``calls``, in
    bucket order): real and padded rows (``bell``'s packing), width, bytes
    (8 B a launched slot, 4 B an output, 8 B a row of rowlab/dadd), the
    bytes bound and the time alone with L2 flushed before each rep.  Also
    the device work one launch enqueues (``graph_nodes``) at the narrowest
    and the widest bucket (a split row: ticket and workspace included):
    anything but one kernel fails the run."""
    rows = []
    for (a, kw), b in zip(calls, bell.buckets):
        r, d = a[0].shape
        k = a[4] if len(a) > 4 else a[2]
        if r != b.num_rows or d != b.width:
            raise AssertionError(f"launch [{r}, {d}] is not bucket "
                                 f"[{b.num_rows} real rows, {b.width}]")
        nbytes = 8 * r * d + 4 * r * k + (8 * r if len(a) > 4 else 0)
        rows.append({"R": r, "R_pad": int(b.row_ids.shape[0]), "D": d,
                     "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "ms": gpu_ms_cold(torch, lambda: fn(*a, **kw), flush)})
    per_launch = {}
    for i in (0, len(calls) - 1):
        a, kw = calls[i]
        nodes = graph_nodes(torch, lambda: fn(*a, **kw))
        if nodes != {"kernel": 1}:
            raise AssertionError(f"{fn.__name__} on [{rows[i]['R']}, "
                                 f"{rows[i]['D']}] enqueued {nodes}, not one "
                                 f"kernel")
        per_launch[rows[i]["D"]] = sum(nodes.values())
    # the floor of a launch timed this way: an empty kernel, L2 flushed
    return {"rows": rows, "kernels_per_launch": per_launch,
            "empty_launch_ms": gpu_ms_cold(torch, lambda: torch.cuda._sleep(0),
                                           flush)}


# The functions the fused driver calls, whose device time a warm fit splits
# into: the class weights, the degrees and the Laplacian scale, the planes,
# the diag addend, the kernel and the residual fixup of degree-0 rows.
PREP_PASSES = ("class_weight_inv", "bucketed_degrees", "inv_sqrt_degrees",
               "laplacian_vals", "ell_planes", "_diag_addend",
               "gee_spmm_fused", "apply_epilogue")


def prep_passes(torch, module, fit) -> dict:
    """A warm default fit's device time (ms) by pass: one fit runs with
    each function of ``PREP_PASSES`` in the fused driver's ``module``
    keeping its calls' arguments, then each pass's calls are replayed in
    sequence and timed by ``gpu_ms`` behind a long sleep kernel, so no host
    time shows (CUDA events around each pass inside the fit read the
    kernel pass at 0.68 ms on cl-100k-1d8-l5, where its launches take 0.13:
    host gaps).  What the passes leave of the fit's device time is the
    scatter ``z[rows] = out``, the covered mask, the final ``where`` and
    gaps."""
    calls = {n: [] for n in PREP_PASSES}
    originals = {n: getattr(module, n) for n in PREP_PASSES}

    def keep(name, fn):
        def call(*a, **kw):
            calls[name].append((a, kw))
            return fn(*a, **kw)
        call.launches = 0        # the kernel wrapper counts into its name
        return call

    try:
        for n in PREP_PASSES:
            setattr(module, n, keep(n, originals[n]))
        fit()
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)
    torch.cuda.synchronize()
    return {n: gpu_ms(torch, lambda: [originals[n](*a, **kw)
                                      for a, kw in calls[n]],
                      reps=10, sleep_cycles=20_000_000)
            for n in PREP_PASSES}


def csr_operands(torch, edges, labels, k):
    """The contraction of a default fit as one cuSPARSE call's operands:
    A_csr, the CSR of the Laplacian-scaled A + I (the default options'
    graph), and W, the [N, K] one-hot of the labels scaled by 1 / n_k, so
    that ``torch.sparse.mm(A_csr, W)`` computes what the staged fit's
    ``gee_spmm`` launches compute (from CSR, not from ELL planes).  Also
    returns the port's ``sparse_torch`` embedding without the row norm, to
    hold the product against."""
    from repro_torch.core.gee import (GEEOptions, class_weight_inv,
                                      gee_sparse_torch,
                                      laplacian_edge_weights)
    from repro_torch.graph.containers import add_self_loops

    aug = add_self_loops(edges)
    w = laplacian_edge_weights(aug)
    e = aug.num_edges
    a = torch.sparse_coo_tensor(
        torch.stack([aug.src[:e].long(), aug.dst[:e].long()]), w[:e],
        (aug.num_nodes, aug.num_nodes)).coalesce().to_sparse_csr()
    lab = torch.from_numpy(labels).to(edges.device).long()
    winv = class_weight_inv(lab.int(), k)
    onehot = torch.zeros((aug.num_nodes, k), dtype=torch.float32,
                         device=edges.device)
    rows = torch.nonzero(lab >= 0)[:, 0]
    onehot[rows, lab[rows]] = winv[lab[rows]]
    want = gee_sparse_torch(edges, lab.int(), k, GEEOptions(
        laplacian=True, diag_aug=True, correlation=False))
    return a, onehot, want


# ---------------------------------------------------------------------------
# retrieval: comparisons
# ---------------------------------------------------------------------------

def score_err(torch, got, want, scale=None) -> tuple:
    """``max_err`` for masked scores: NEG_INF entries must be equal exactly,
    and are left out of the rest (and of each row's scale)."""
    from repro_torch.kernels.ref import NEG_INF

    gm, wm = got == NEG_INF, want.to(got.device) == NEG_INF
    if not torch.equal(gm, wm):
        raise AssertionError(f"NEG_INF entries differ in "
                             f"{int((gm != wm).sum())} places")
    return max_err(torch, torch.where(gm, 0.0, got),
                   torch.where(wm, 0.0, want.to(got.device)), scale)


def term_scale(torch, q, x, metric):
    """[Q, 1]: the size of the terms each query's scores are computed from,
    which scores are held to in place of their own row's max (``max_err``'s
    ``scale``, times ``TERM_ATOL``).  An l2 score (2·dot − ‖q‖²) − ‖x‖²
    rounds like ‖q‖² + ‖x‖² however small the difference (a row of a vertex
    against 5 nearby centroids holds only scores near 1e-3); the summands
    of a cosine score are bounded by 1.  ``x`` is the database [M, K] or
    the candidates [Q, M, K]."""
    if metric == "cosine":
        return torch.ones((q.shape[0], 1), dtype=torch.float64,
                          device=q.device)
    qn2 = q.double().square().sum(dim=1, keepdim=True)
    xn2 = x.double().square().sum(dim=-1)
    xn2 = xn2.amax() if x.dim() == 2 else xn2.amax(dim=1, keepdim=True)
    return qn2 + xn2


def check_topk(torch, got, want, full, scale, cand_ids=None,
               exact=False) -> tuple:
    """Hold a top-k kernel's ``(ids, scores)`` against its plain version's.

    ``full`` is the plain [Q, M] score matrix, ``scale`` its
    ``term_scale`` and ``cand_ids`` [Q, M] each candidate's database id
    (``None``: the id is the position).  Scores as ``score_err``; masked
    slots (-1) in the same places; every returned id a
    distinct candidate whose plain score is its reported score; and the id
    equal to the plain version's wherever no other candidate's plain score
    lies within the round-off (``TERM_ATOL * scale``, no rtol) of that
    slot's.  ``exact``: ids and scores equal bit for bit, tie order
    included."""
    err = score_err(torch, got[1], want[1], scale)
    gi, gs, wi, ws = (t.cpu().numpy() for t in (*got, *want))
    if exact:
        if not (np.array_equal(gi, wi) and np.array_equal(gs, ws)):
            raise AssertionError("top-k differs on exactly representable "
                                 "inputs")
        return err
    if not np.array_equal(gi < 0, wi < 0):
        raise AssertionError("masked top-k slots differ")
    atol = TERM_ATOL * scale.cpu().numpy().reshape(-1, 1)
    full = full.cpu().numpy().astype(np.float64)
    ci = None if cand_ids is None else cand_ids.cpu().numpy()
    for r in range(gi.shape[0]):
        live = gi[r] >= 0
        ids = gi[r][live]
        if len(set(ids.tolist())) != ids.size:
            raise AssertionError(f"row {r}: an id repeats")
        if ci is None:
            pos = ids
        else:
            order = np.argsort(ci[r], kind="stable")
            pos = order[np.searchsorted(ci[r][order], ids)]
            if not np.array_equal(ci[r][pos], ids):
                raise AssertionError(f"row {r}: an id is no candidate")
        true = full[r, pos]
        tol = RTOL * np.abs(true) + atol[r]
        if np.any(np.abs(true - gs[r][live]) > tol):
            raise AssertionError(f"row {r}: an id's plain score is not its "
                                 f"reported score")
        for j in np.flatnonzero(live):
            w = float(ws[r, j])
            if np.count_nonzero(np.abs(full[r] - w) <= atol[r, 0]) <= 1 \
                    and gi[r, j] != wi[r, j]:
                raise AssertionError(f"row {r} slot {j}: id {gi[r, j]} != "
                                     f"{wi[r, j]} with no near tie")
    return err


def same_topk(got_ids, got_s, want_ids, want_s, scale) -> list:
    """Path-level agreement of two top-k results (numpy): the same masked
    slots; scores within the tolerance (``scale``: each query's
    ``term_scale``) slot by slot; ids equal where ``want``'s neighbouring
    scores differ by more than the round-off (``TERM_ATOL * scale``, no
    rtol: a cosine score near 1 would otherwise tie everything within
    1e-5), and within such a near-tie group the same set.  A group that reaches slot k-1 may continue past k, so
    its members are held by score only.  Returns the sizes of the near-tie
    groups of two or more slots."""
    if got_ids.shape != want_ids.shape:
        raise AssertionError(f"shape {got_ids.shape} != {want_ids.shape}")
    if not np.array_equal(got_ids < 0, want_ids < 0):
        raise AssertionError("masked slots differ")
    live = want_ids >= 0
    g = np.where(live, got_s, 0.0).astype(np.float64)
    w = np.where(live, want_s, 0.0).astype(np.float64)
    tie = TERM_ATOL * scale
    tol = RTOL * np.abs(w) + tie
    if np.any(np.abs(g - w) > tol):
        r = int(np.flatnonzero((np.abs(g - w) > tol).any(axis=1))[0])
        raise AssertionError(f"row {r}: scores {got_s[r]} != {want_s[r]}")
    k = w.shape[1]
    groups = []
    for r in range(w.shape[0]):
        j0 = 0
        while j0 < k:
            j1 = j0
            while j1 + 1 < k and abs(w[r, j1 + 1] - w[r, j1]) <= tie[r, 0]:
                j1 += 1
            if j1 < k - 1 and set(got_ids[r, j0:j1 + 1].tolist()) != set(
                    want_ids[r, j0:j1 + 1].tolist()):
                raise AssertionError(f"row {r}: ids {got_ids[r]} != "
                                     f"{want_ids[r]}")
            if j1 > j0:
                groups.append(j1 - j0 + 1)
            j0 = j1 + 1
    return groups


def topk_edge_cases(torch, ts, ref, errs) -> int:
    """The four retrieval kernels against their plain versions, both
    metrics: K = 1 and K = 200; Q = 1; M = 1; k > M; k = MAX_TOPK and
    MAX_TOPK + 1 (the staged route); all slots masked; zero-norm rows; M off
    every block and chunk size; and integer-valued inputs with many exact
    ties, where every sum is exact whatever its order, so ids and scores must
    equal the plain version's bit for bit."""
    rng = np.random.default_rng(1)
    dev = DEVICE
    mt = ts.MAX_TOPK
    # (Q, M, K, k, integer-valued, all masked)
    cases = [(1, 1, 1, 1, False, False), (1, 1, 3, 5, False, False),
             (3, 7, 1, 10, False, False), (5, 300, 200, 10, False, False),
             (64, 5, 5, 3, False, False), (17, 1007, 9, mt, False, False),
             (17, 1007, 9, mt + 1, False, False),
             (64, 70001, 5, 10, False, False), (1, 5000, 3, mt, False, False),
             (200, 2000, 3, 10, False, False), (9, 333, 4, 10, False, True),
             (64, 20000, 3, 10, True, False), (3, 4097, 2, mt, True, False),
             (5, 900, 1, mt + 1, True, False), (2, 50, 5, 64, True, False)]
    n = 0
    for q_, m_, k_dim, k, integer, all_masked in cases:
        def gen(shape):
            if integer:
                return rng.integers(-2, 3, shape).astype(np.float32)
            return rng.standard_normal(shape).astype(np.float32)

        q = torch.from_numpy(gen((q_, k_dim))).to(dev)
        x = torch.from_numpy(gen((m_, k_dim))).to(dev)
        cand = torch.from_numpy(gen((q_, m_, k_dim))).to(dev)
        q[0] = 0.0                                 # zero-norm rows
        x[0] = 0.0
        cand[:, 0] = 0.0
        live = 0.0 if all_masked else 0.8
        valid = torch.from_numpy((rng.random(m_) < live).astype(
            np.float32)).to(dev)
        mask = torch.from_numpy((rng.random((q_, m_)) < live).astype(
            np.float32)).to(dev)
        ids = torch.from_numpy(np.stack([rng.permutation(10 * m_)[:m_]
                                         for _ in range(q_)]).astype(
            np.int32)).to(dev)
        for metric in ("l2", "cosine"):
            sc, gsc = (term_scale(torch, q, x, metric),
                       term_scale(torch, q, cand, metric))
            full = ref.pairwise_scores_ref(q, x, valid, metric)
            errs["pairwise_scores"].append(score_err(
                torch, ts.pairwise_scores(q, x, valid, metric=metric), full,
                sc))
            gfull = ref.gathered_scores_ref(q, cand, mask, metric)
            errs["gathered_scores"].append(score_err(
                torch, ts.gathered_scores(q, cand, mask, metric=metric),
                gfull, gsc))
            before = (ts.scored_topk.launches,
                      ts.scored_topk_gathered.launches)
            got = ts.scored_topk(q, x, valid, k, metric=metric, fused=True)
            errs["scored_topk"].append(check_topk(
                torch, got, ref.masked_topk(full, None, k), full, sc,
                exact=integer))
            got = ts.scored_topk_gathered(q, cand, mask, ids, k,
                                          metric=metric, fused=True)
            errs["scored_topk_gathered"].append(check_topk(
                torch, got, ref.masked_topk(gfull, ids, k), gfull, gsc, ids,
                exact=integer))
            staged = min(k, m_) > mt
            fused_runs = (ts.scored_topk.launches - before[0],
                          ts.scored_topk_gathered.launches - before[1])
            if fused_runs != ((0, 0) if staged else (1, 1)):
                raise AssertionError(f"k={k}, M={m_}: the fused kernels ran "
                                     f"{fused_runs} times")
            n += 1
    return n


def gathered_topk_edge_cases(torch, ts, ref, errs) -> tuple:
    """``scored_topk_gathered`` against its plain version, both metrics:
    kk in {1, 2, 10, 16, 31, 32}; M < 32; M at a chunk boundary +- 1; one
    chunk and many; rows entirely masked; K on both sides of the widest
    K kept in registers (8); and integer-valued inputs whose exact ties
    straddle lanes, warps and chunks, held bit for bit.  In the ``bar``
    rows every live score ties, and the first 64 candidates of each chunk
    (warp 0's first round) score lower, so warp 0's list holds later m
    when the other warps' lists, of the same score and smaller m, are
    offered to it: each must displace the list's last entry.  K runs over
    every width the kernel keeps in registers (1-8) and past it (9, 200).
    Returns the number of cases and the chunk counts the wrapper chose."""
    rng = np.random.default_rng(2)
    dev = DEVICE
    chunk = ts._GATHER_MIN_CHUNK
    # (Q, M, K, k, integer-valued, pattern)
    cases = [(3, 20, 3, 10, False, None), (5, 31, 2, 32, True, None),
             (2, 1, 1, 1, False, None), (4, chunk - 1, 1, 1, True, None),
             (4, chunk + 1, 2, 2, True, None),
             (2, 2 * chunk - 1, 1, 16, True, None),
             (2, 2 * chunk + 1, 1, 31, True, None),
             (1, 70001, 1, 32, True, None), (64, 3 * chunk, 2, 16, True, None),
             (64, 58752, 5, 10, False, None), (7, 3000, 3, 10, False, "rows"),
             (3, 2 * chunk + 5, 1, 10, True, "bar"),
             (3, 2 * chunk + 5, 1, 32, True, "bar"),
             (5, 3001, 4, 10, True, None), (5, 3001, 6, 10, True, None),
             (5, 3001, 7, 10, True, None), (5, 3001, 8, 10, True, None),
             (5, 3001, 9, 10, True, None), (3, 300, 200, 10, False, None)]
    n, chunk_counts = 0, set()
    for q_, m_, k_dim, k, integer, pattern in cases:
        if integer:
            q = rng.integers(-2, 3, (q_, k_dim)).astype(np.float32)
            cand = rng.integers(-2, 3, (q_, m_, k_dim)).astype(np.float32)
        else:
            q = rng.standard_normal((q_, k_dim)).astype(np.float32)
            cand = rng.standard_normal((q_, m_, k_dim)).astype(np.float32)
        mask = (rng.random((q_, m_)) < 0.8).astype(np.float32)
        if pattern == "rows":
            mask[[0, 3]] = 0.0                     # rows entirely masked
        elif pattern == "bar":
            q[:] = 0.0                            # l2: -|x|^2; cosine: 0
            cand[:] = 0.0
            mask[:] = 1.0
            chunk_len = -(-m_ // ts._gathered_chunks(torch.device(dev), q_,
                                                     m_))
            for c0 in range(0, m_, chunk_len):
                cand[:, c0:c0 + 64] = 1.0          # l2 -1, cosine 0
        ids = np.stack([rng.permutation(10 * m_)[:m_]
                        for _ in range(q_)]).astype(np.int32)
        qt, ct, mt, it = (torch.from_numpy(a).to(dev)
                          for a in (q, cand, mask, ids))
        chunk_counts.add(ts._gathered_chunks(qt.device, q_, m_))
        for metric in ("l2", "cosine"):
            gfull = ref.gathered_scores_ref(qt, ct, mt, metric)
            before = ts.scored_topk_gathered.launches
            got = ts.scored_topk_gathered(qt, ct, mt, it, k, metric=metric,
                                          fused=True)
            if ts.scored_topk_gathered.launches != before + 1:
                raise AssertionError(f"M={m_} k={k}: the kernel did not run")
            errs["scored_topk_gathered"].append(check_topk(
                torch, got, ref.masked_topk(gfull, it, k), gfull,
                term_scale(torch, qt, ct, metric), it, exact=integer))
            n += 1
    if not (1 in chunk_counts and max(chunk_counts) > 8):
        raise AssertionError(f"chunk counts {sorted(chunk_counts)} miss one "
                             f"chunk or many")
    return n, sorted(chunk_counts)


def scored_topk_edge_cases(torch, ts, ref, errs) -> tuple:
    """``scored_topk`` against its plain version, both metrics: kk in {1, 2,
    10, 16, 31, 32}; M < 32 and M at a chunk boundary +- 1; Q in {1, QT - 1,
    QT + 1, 64, 65} (QT: the query tile); one chunk to the most; an
    all-invalid database; valid absent, f32, bool and uint8; K over every
    width the kernel keeps in registers (1-8) and past it (9, 200); and
    integer-valued inputs whose exact ties straddle lanes, warps, query
    tiles and chunks, held bit for bit.  In the ``bar`` rows every live
    score ties except the first 64 candidates of each chunk (warp 0's first
    round), which score lower, so warp 0's list holds later m than the
    other warps' lists of the same score.  Returns the number of cases and
    the chunk counts the wrapper chose."""
    rng = np.random.default_rng(3)
    dev = DEVICE
    qt, chunk = ts._QUERY_TILE, ts._MIN_CHUNK
    # (Q, M, K, k, integer-valued, pattern)
    cases = [(1, 1, 1, 1, True, None), (qt - 1, 20, 3, 10, False, None),
             (qt + 1, 31, 2, 32, True, None), (3, chunk - 1, 1, 1, True, None),
             (5, chunk + 1, 2, 2, True, None),
             (qt + 1, 2 * chunk - 1, 1, 16, True, None),
             (qt - 1, 2 * chunk + 1, 1, 31, True, None),
             (1, 92482, 1, 32, True, None), (64, 92482, 5, 10, False, None),
             (64, 92482, 5, 10, True, None), (65, 10000, 3, 10, False, None),
             (64, 3 * chunk, 2, 16, True, None),
             (7, 3000, 3, 10, False, "invalid"),
             (qt + 1, 2 * chunk + 5, 1, 10, True, "bar"),
             (65, 5000, 1, 32, True, "bar"),
             (5, 3001, 4, 10, True, None), (5, 3001, 6, 10, True, None),
             (5, 3001, 7, 10, True, None), (5, 3001, 8, 10, True, None),
             (5, 3001, 9, 10, True, None), (3, 300, 200, 10, False, None)]
    n, chunk_counts = 0, set()
    for case, (q_, m_, k_dim, k, integer, pattern) in enumerate(cases):
        if integer:
            q = rng.integers(-2, 3, (q_, k_dim)).astype(np.float32)
            x = rng.integers(-2, 3, (m_, k_dim)).astype(np.float32)
        else:
            q = rng.standard_normal((q_, k_dim)).astype(np.float32)
            x = rng.standard_normal((m_, k_dim)).astype(np.float32)
        valid = (rng.random(m_) < 0.8).astype(np.float32)
        chunks = ts._num_chunks(torch.device(dev), q_, m_)
        chunk_counts.add(chunks)
        if pattern == "invalid":
            valid[:] = 0.0
        elif pattern == "bar":
            q[:] = 0.0                            # l2: -|x|^2; cosine: 0
            x[:] = 0.0
            valid[:] = 1.0
            for c0 in range(0, m_, -(-m_ // chunks)):
                x[c0:c0 + 64] = 1.0                # l2 -1, cosine 0
        qt_, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        vt = torch.from_numpy(valid).to(dev)
        vt = (None, vt, vt > 0, (vt > 0).to(torch.uint8))[case % 4]
        if pattern == "invalid" and vt is None:
            vt = torch.zeros(m_, dtype=torch.bool, device=dev)
        for metric in ("l2", "cosine"):
            full = ref.pairwise_scores_ref(qt_, xt, vt, metric)
            before = ts.scored_topk.launches
            got = ts.scored_topk(qt_, xt, vt, k, metric=metric, fused=True)
            if ts.scored_topk.launches != before + 1:
                raise AssertionError(f"Q={q_} M={m_} k={k}: the kernel did "
                                     f"not run")
            errs["scored_topk"].append(check_topk(
                torch, got, ref.masked_topk(full, None, k), full,
                term_scale(torch, qt_, xt, metric), exact=integer))
            n += 1
    if not (1 in chunk_counts and max(chunk_counts) > 32):
        raise AssertionError(f"chunk counts {sorted(chunk_counts)} miss one "
                             f"chunk or many")
    return n, sorted(chunk_counts)


def pairwise_edge_cases(torch, ts, ref, errs) -> int:
    """``pairwise_scores`` against its plain version, both metrics: M from 1
    to 10 (the index's centroids, the few-row path) and past it (33, 1,000);
    Q on both sides of the kernels' blocks of query rows (128) and query
    tiles (8); K 1-9 and 200; valid absent, f32, bool and uint8, all zero
    too.  Integer-valued inputs bit for bit, the others within the
    tolerance; the three valid dtypes give the same bits."""
    rng = np.random.default_rng(4)
    dev = DEVICE
    n = 0
    shapes = [(1, 1), (127, 10), (129, 5), (9, 2), (64, 7), (8, 33),
              (9, 1000)]
    for k_dim in (1, 2, 3, 4, 5, 6, 7, 8, 9, 200):
        for (q_, m_), integer in zip(shapes * 2,
                                     [True] * len(shapes)
                                     + [False] * len(shapes)):
            gen = ((lambda s: rng.integers(-2, 3, s)) if integer else
                   rng.standard_normal)
            qt_ = torch.from_numpy(gen((q_, k_dim)).astype(np.float32)).to(dev)
            xt = torch.from_numpy(gen((m_, k_dim)).astype(np.float32)).to(dev)
            live = 0.0 if (q_, m_) == (9, 2) else 0.7
            vf = torch.from_numpy((rng.random(m_) < live).astype(
                np.float32)).to(dev)
            for metric in ("l2", "cosine"):
                sc = term_scale(torch, qt_, xt, metric)
                outs = []
                for v in (None, vf, vf > 0, (vf > 0).to(torch.uint8)):
                    got = ts.pairwise_scores(qt_, xt, v, metric=metric)
                    want = ref.pairwise_scores_ref(qt_, xt, v, metric)
                    errs["pairwise_scores"].append(score_err(torch, got, want,
                                                             sc))
                    if integer and not torch.equal(got, want):
                        raise AssertionError(f"pairwise_scores Q={q_} M={m_} "
                                             f"K={k_dim}: integer-valued "
                                             f"inputs differ from plain")
                    outs.append(got)
                    n += 1
                if not (torch.equal(outs[1], outs[2])
                        and torch.equal(outs[1], outs[3])):
                    raise AssertionError(f"pairwise_scores Q={q_} M={m_}: "
                                         f"bool, uint8 and f32 valid differ")
    return n

def chunk_sweep(torch, ts, name, a, kw) -> dict:
    """A top-k kernel (``scored_topk`` or ``scored_topk_gathered``) on one
    call's inputs at other chunk counts than its policy's: the time of
    each, and the same ids and scores (the total order makes the result
    independent of the chunking).  Also its time at other widths of top-k:
    k = 1 keeps the lists nearly empty, so it reads the cost of the scan
    alone."""
    fn = getattr(ts, name)
    policy_name, counts, kpos = {
        "scored_topk": ("_num_chunks", (1, 4, 8, 12, 16, 24, 32, 48), 3),
        "scored_topk_gathered": ("_gathered_chunks",
                                 (1, 2, 4, 6, 8, 9, 12, 16, 24, 33, 66), 4),
    }[name]
    policy = getattr(ts, policy_name)
    chunks = policy(a[0].device, a[0].shape[0], a[1].shape[-2])
    want = fn(*a, **kw)
    by_k = {k: gpu_ms(torch, lambda: fn(*a[:kpos], k, *a[kpos + 1:], **kw))
            for k in (1, 2, 10, 32)}
    sweep = {}
    try:
        for n in counts:
            setattr(ts, policy_name, lambda *_, n=n: n)
            got = fn(*a, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} at {n} chunks differs from "
                                     f"{chunks} chunks")
            sweep[n] = gpu_ms(torch, lambda: fn(*a, **kw), reps=10)
    finally:
        setattr(ts, policy_name, policy)
    return {"chunks": chunks, "chunk_sweep_ms": sweep, "ms_by_k": by_k}


# cuGraphNodeGetType's CUgraphNodeType values (cuda.h)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_nodes(torch, fn) -> dict:
    """The device work one call of ``fn`` enqueues, by kind ({"kernel": 1,
    "memset": ...}), read from a CUDA graph of one call through the driver
    API.  ``torch.profiler`` dropped one of every four records of a
    contraction kernel in this script, in every session; a graph holds
    every node.  A warm-up call on the capture stream first makes what
    persists between calls on a stream (its ticket counters) outside the
    graph."""
    import ctypes

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=stream):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    counts = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise AssertionError("cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}")
        counts[name] = counts.get(name, 0) + 1
    del g
    torch.cuda.synchronize()
    return counts


def kernels_per_call(torch, fn, calls: int = 4, tries: int = 5) -> tuple:
    """How many device kernels one call of ``fn`` launches, as
    ``torch.profiler`` records them over ``calls`` calls (after a warm-up
    call), the kernels' names, and the sessions it took.  Now and then a
    session records no device activity, or loses some of it (4 calls of a
    one-kernel function recorded 3 kernels): a session whose kernels are
    not a whole number a call is repeated, up to ``tries`` sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names and len(names) % calls == 0:
            return len(names) / calls, sorted(set(names)), session
    raise AssertionError(f"the profiler recorded no whole number of kernels "
                         f"a call in {tries} sessions")


def streaming_phase(torch, card, all_kernels, replay, cl_spec,
                    scale_spec) -> dict:
    """Phase 10: out-of-core streaming at full size.  ``cl_spec`` is the
    Table 2 stand-in held against the in-memory fits, ``scale_spec`` the
    file held against ``sparse_torch`` and timed; ``replay`` is phase 8's
    query replay.  Counts every kernel's launches on the streaming path
    alone: each streamed call runs with every count set to 0 just before it
    and read just after, so the in-memory and SciPy fits it is held against
    add nothing.  Prints one line; returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.api import GEEEmbedder
    from repro_torch.core.chunked import gee_chunked
    from repro_torch.core.fold import fold_degrees, fold_z
    from repro_torch.core.gee import (ALL_OPTION_SETTINGS, GEEOptions,
                                      class_weight_inv, gee_scipy)
    from repro_torch.core.plan import GEEPlan, PreparedGraph
    from repro_torch.graph.datasets import load_file, synth_to_disk
    from repro_torch.graph.io import (DEFAULT_CHUNK_EDGES, ChunkedEdgeList,
                                      open_edge_list)
    from repro_torch.graph.prefetch import (DEFAULT_PREFETCH_DEPTH,
                                            prefetch_windows)
    from repro_torch.launch.gee_search import recall_at_k

    all_on, all_off = GEEEmbedder(num_classes=1).options, GEEOptions()
    stream = {"card": card}
    stream_launches = dict.fromkeys(all_kernels, 0)

    def on_path(fn):
        """Run one call of the streaming path, counting its launches."""
        for k_fn in all_kernels.values():
            k_fn.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for name, k_fn in all_kernels.items():
            stream_launches[name] += k_fn.launches
        return out

    with tempfile.TemporaryDirectory() as tmp:
        # the Table 2 stand-in and the scale file, one entry per undirected
        # edge, written by the port's own writer
        cl_path = os.path.join(tmp, "cl.geeb")
        t0 = time.perf_counter()
        synth_to_disk(cl_spec, cl_path, seed=0)
        stream["cl_write_s"] = time.perf_counter() - t0
        cl_file = load_file(cl_path)           # materialized on the card
        cl_k = cl_file.spec.num_classes
        cl_prep = PreparedGraph(cl_file.edges)
        cl_labels = cl_file.labels
        cl_windows = open_edge_list(cl_path).num_windows

        t0 = time.perf_counter()
        parity = {}
        for opts in ALL_OPTION_SETTINGS:
            z_s = on_path(lambda: GEEEmbedder(
                num_classes=cl_k, options=opts).fit_transform_file(cl_path))
            z_m = GEEEmbedder(num_classes=cl_k, options=opts,
                              backend="cuda").fit_transform(cl_prep,
                                                            cl_labels)
            if z_s.shape != (cl_file.spec.num_nodes, cl_k) \
                    or not bool(torch.isfinite(z_s).all()):
                raise AssertionError(f"streamed {opts.tag()}: bad output")
            parity[opts.tag()] = max_err(torch, z_s, z_m)
        # the default setting against the host SciPy reference
        src, dst, w = cl_file.edges.valid_arrays()
        z_host = gee_scipy(src, dst, w, cl_labels, cl_k, all_on)
        z_s = on_path(lambda: GEEEmbedder(
            num_classes=cl_k).fit_transform_file(cl_path))
        scipy_stream = max_err(torch, z_s.cpu(), torch.from_numpy(z_host))
        # prefetch depths 0 and 2 on the same file
        by_depth = {d: on_path(lambda: gee_chunked(
            open_edge_list(cl_path), cl_labels, cl_k, all_on,
            prefetch_windows=d)) for d in (0, DEFAULT_PREFETCH_DEPTH)}
        depth_err = max_err(torch, by_depth[0],
                            by_depth[DEFAULT_PREFETCH_DEPTH])
        z_m = GEEEmbedder(num_classes=cl_k, backend="cuda").fit_transform(
            cl_prep, cl_labels)
        depth_vs_mem = [max_err(torch, z, z_m) for z in by_depth.values()]
        # retrieval over the streamed embedding: the index build, replays at
        # the default nprobe and at full probe, and brute force
        emb = on_path(lambda: GEEEmbedder(num_classes=cl_k).fit_file(
            cl_path))
        s_index = on_path(emb.build_index)
        rows = np.random.default_rng(11).integers(
            0, cl_file.spec.num_nodes, N_QUERIES)
        ids_d, sc_d, _, _ = on_path(lambda: replay(s_index, rows))
        ids_f, sc_f, _, _ = on_path(lambda: replay(
            s_index, rows, nprobe=s_index.num_cells))
        zq = s_index.z[torch.from_numpy(rows).to(DEVICE)]
        got = on_path(lambda: [
            s_index.search(zq[lo:lo + FLUSH], TOP_K, brute_force=True)
            for lo in range(0, zq.shape[0], FLUSH)])
        ids_b = torch.cat([i for i, _ in got]).cpu().numpy()
        sc_b = torch.cat([s_ for _, s_ in got]).cpu().numpy()
        if not np.array_equal(sc_f, sc_b):
            raise AssertionError("streamed index: full probe != brute force")
        s_recall = recall_at_k(ids_d, sc_d, ids_b, sc_b)
        s_nprobe = s_index.nprobe
        torch.cuda.synchronize()
        stream["cl_s"] = time.perf_counter() - t0
        stream.update(cl_parity=parity, cl_scipy=scipy_stream,
                      cl_depth_err=depth_err, cl_depth_vs_mem=depth_vs_mem,
                      cl_windows=cl_windows, cl_recall=s_recall,
                      cl_nprobe=s_nprobe)
        del cl_prep, cl_file, z_s, z_m, by_depth, emb, s_index

        # the scale file: 2,000,000 nodes, 50,000,000 undirected entries
        spec = scale_spec
        sc_path = os.path.join(tmp, "scale.geeb")
        t0 = time.perf_counter()
        synth_to_disk(spec, sc_path, seed=0)
        stream["scale_write_s"] = time.perf_counter() - t0
        sc_src = open_edge_list(sc_path)
        sc_labels = np.load(sc_path + ".labels.npy")
        n, k, window = spec.num_nodes, spec.num_classes, sc_src.window_edges
        depth = DEFAULT_PREFETCH_DEPTH
        # what the streamed fit may hold on the card, whatever E is: Z's
        # float64 accumulator, its f32 rounding and the epilogue's two
        # [N, K] results (5 f32 units), six [N] f32 units (labels, the
        # float64 degrees, their f32 rounding, dinv), the windows in flight
        # (the one folded, ``depth`` queued, one being staged and one more
        # the reader may hold; 12 B an entry), a both-directions window's
        # fold temporaries (<= 160 B an entry) and 64 MiB of allocator
        # rounding
        bound = (5 * 4 * n * k + 6 * 4 * n + (depth + 3) * 12 * window
                 + 2 * window * 160 + (64 << 20))

        def streamed(opts):
            return on_path(lambda: gee_chunked(sc_src, sc_labels, k, opts))

        scale = {"windows": sc_src.num_windows, "window": window,
                 "bound_bytes": bound}
        for opts in (all_off, all_on):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            z_s = streamed(opts)
            torch.cuda.synchronize()
            peak_s = torch.cuda.max_memory_allocated() - base
            if peak_s >= bound:
                raise AssertionError(f"streamed peak {peak_s} B >= bound "
                                     f"{bound} B")
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                streamed(opts)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            t_med = float(np.median(times))
            del z_s
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sc_mem = PreparedGraph(load_file(sc_path).edges)
            z_m = GEEPlan.build(sc_mem, k, opts,
                                backend="sparse_torch").execute(sc_labels)
            torch.cuda.synchronize()
            peak_m = torch.cuda.max_memory_allocated() - base
            err = max_err(torch, streamed(opts), z_m)
            del sc_mem, z_m
            scale[opts.tag()] = {
                "max_err": err, "host_ms_median_of_3": t_med * 1e3,
                "host_ms": [t * 1e3 for t in times],
                "edges_per_s": 2 * spec.num_edges / t_med,
                "peak_bytes_streamed": peak_s,
                "peak_bytes_in_memory": peak_m}

        # where a streamed fit's time goes (no options, one pass, host
        # clock, median of 3): the same fit with synchronous copies, the
        # pipeline alone (read, ring fill, copy; nothing folded) and the
        # fold alone over the whole file already on the card
        def ingest():
            for _ in prefetch_windows(sc_src, depth, device=DEVICE).windows():
                pass

        resident = ChunkedEdgeList(
            src=torch.from_numpy(np.asarray(sc_src.src)).to(DEVICE),
            dst=torch.from_numpy(np.asarray(sc_src.dst)).to(DEVICE),
            weight=torch.from_numpy(np.asarray(sc_src.weight)).to(DEVICE),
            num_nodes=n, undirected=True)
        scale["split_ms"] = {
            "depth_0": host_ms(torch, lambda: gee_chunked(
                sc_src, sc_labels, k, all_off, prefetch_windows=0), 3),
            "pipeline_alone": host_ms(torch, ingest, 3),
            "fold_alone_resident": host_ms(torch, lambda: gee_chunked(
                resident, sc_labels, k, all_off), 3)}
        del resident

        # the device's busy share over one streamed fit (union of the
        # kernels' and copies' intervals that torch.profiler records, over
        # the host-clock time of the fit under the profiler)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            streamed(all_on)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy_us, end = 0.0, float("-inf")
        for lo, hi in spans:
            if hi > end:
                busy_us += hi - max(lo, end)
                end = hi
        scale["busy_share_profiler"] = busy_us / wall_us
        scale["profiler_device_records"] = len(spans)

        # the fold's device time for one window, by CUDA events: the H2D
        # copy from pinned memory, the degree fold, the class fold
        w0 = next(iter(sc_src.windows()))
        pinned = [t.pin_memory() for t in (w0.src, w0.dst, w0.weight)]
        dev = [t.to(DEVICE) for t in pinned]
        lab = torch.from_numpy(sc_labels).to(DEVICE)
        winv = class_weight_inv(lab, k)
        dinv = torch.rand(n, device=DEVICE)
        deg = torch.zeros(n, device=DEVICE)
        z = torch.zeros(n * k, device=DEVICE)
        scale["window_copy_ms"] = gpu_ms(
            torch, lambda: [t.to(DEVICE, non_blocking=True) for t in pinned])
        scale["window_fold_degrees_ms"] = gpu_ms(
            torch, lambda: fold_degrees(deg, *dev, undirected=True))
        scale["window_fold_z_ms"] = gpu_ms(
            torch, lambda: fold_z(z, *dev, lab, winv, dinv, num_classes=k,
                                  undirected=True))
        # all on: two passes, so two copies a window
        scale["busy_share_events"] = (
            sc_src.num_windows * (2 * scale["window_copy_ms"]
                                  + scale["window_fold_degrees_ms"]
                                  + scale["window_fold_z_ms"])
            / scale[all_on.tag()]["host_ms_median_of_3"])
        stream["scale"] = scale

        # the entry points, each in a process of its own
        env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.gee_run",
             "--edge-file", cl_path, "--lap", "--diag", "--cor", "--verify"],
            capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
        if run.returncode != 0 or \
                "0 entries off the row tolerance: ok" not in run.stdout:
            raise AssertionError(f"gee_run --edge-file failed "
                                 f"(rc {run.returncode}):\n{run.stdout}\n"
                                 f"{run.stderr[-4000:]}")
        report_path = os.path.join(tmp, "gee_search.json")
        search = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.gee_search",
             "--edge-file", cl_path, "--nprobe", str(cl_k), "--queries",
             str(N_QUERIES), "--json", report_path],
            capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
        if search.returncode != 0:
            raise AssertionError(f"gee_search --edge-file failed "
                                 f"(rc {search.returncode}):\n"
                                 f"{search.stdout}\n{search.stderr[-4000:]}")
        with open(report_path) as f:
            search_report = json.load(f)
        if search_report["recall_at_k"] != 1.0:
            raise AssertionError(f"gee_search --edge-file at full probe: "
                                 f"recall {search_report['recall_at_k']}")
        stream["gee_run_stdout"] = run.stdout
        stream["gee_search"] = {k_: v for k_, v in search_report.items()
                                if k_ != "service_stats"}
    for name in ("row_norm", "pairwise_scores", "scored_topk_gathered"):
        if stream_launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the streaming "
                                 f"path")
    stream["launches"] = stream_launches
    sc_on, sc_off = scale[all_on.tag()], scale[all_off.tag()]
    say(f"phase 10 streaming ({card}): {cl_spec.name} written in "
        f"{stream['cl_write_s']:.1f} s, {cl_windows} windows of "
        f"{DEFAULT_CHUNK_EDGES}: fit_transform_file vs the in-memory cuda "
        f"fit of load_file, 8 settings {fmt_err(parity.values())}; default "
        f"vs host gee_scipy {fmt_err([scipy_stream])}; prefetch 0 vs 2 "
        f"{fmt_err([depth_err])} (each vs in-memory "
        f"{fmt_err(depth_vs_mem)}); streamed index: full probe == brute "
        f"force, recall@10 {s_recall:.4f} at nprobe {s_nprobe}; "
        f"launches {stream_launches} in {stream['cl_s']:.1f} s | scale "
        f"N={spec.num_nodes} E={spec.num_edges} K={k} written in "
        f"{stream['scale_write_s']:.1f} s, {scale['windows']} windows: "
        f"vs in-memory sparse_torch {all_off.tag()} "
        f"{fmt_err([sc_off['max_err']])}, {all_on.tag()} "
        f"{fmt_err([sc_on['max_err']])}; streamed fit (median of 3, host "
        f"clock) {sc_off['host_ms_median_of_3']:.1f} ms "
        f"({sc_off['edges_per_s'] / 1e6:.1f} M directed edges/s) "
        f"{all_off.tag()}, {sc_on['host_ms_median_of_3']:.1f} ms "
        f"({sc_on['edges_per_s'] / 1e6:.1f} M/s) {all_on.tag()}; device "
        f"busy {scale['busy_share_profiler']:.3f} of the fit (profiler, "
        f"{scale['profiler_device_records']} records; "
        f"{scale['busy_share_events']:.3f} from per-window event times); "
        f"per window: copy {scale['window_copy_ms']:.4f} ms, degree fold "
        f"{scale['window_fold_degrees_ms']:.4f} ms, class fold "
        f"{scale['window_fold_z_ms']:.4f} ms; split of the no-option fit "
        f"(ms): " + " ".join(f"{key} {v:.1f}"
                             for key, v in scale["split_ms"].items())
        + f"; peak device memory streamed "
        f"{sc_on['peak_bytes_streamed'] / 2**20:.1f} MiB (bound "
        f"{bound / 2**20:.1f} MiB) vs in-memory "
        f"{sc_on['peak_bytes_in_memory'] / 2**20:.1f} MiB; gee_run "
        f"--edge-file --verify ok, gee_search --edge-file recall@10 "
        f"{search_report['recall_at_k']:.4f} at full probe")
    return stream


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core.api import GEEEmbedder
    from repro_torch.core.gee import (ALL_OPTION_SETTINGS, gee_scipy,
                                      gee_sparse_torch)
    from repro_torch.core.plan import GEEPlan, PreparedGraph
    from repro_torch.graph.datasets import TABLE2, synth_like
    from repro_torch.graph.ell import edges_to_bucketed_ell
    from repro_torch.graph.sbm import sample_sbm
    from repro_torch.kernels import build, gee_fused, ops
    from repro_torch.kernels import gee_spmm as gee_spmm_mod
    from repro_torch.kernels import row_norm as row_norm_mod
    from repro_torch.kernels.gee_fused import ENV_FUSED, gee_spmm_fused
    from repro_torch.kernels.gee_spmm import gee_spmm
    from repro_torch.kernels.ref import (gee_spmm_fused_ref, gee_spmm_ref,
                                         row_norm_ref)
    from repro_torch.kernels.row_norm import row_norm
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels import topk_score as topk_mod
    from repro_torch.search import index as index_mod

    os.makedirs(OUT_DIR, exist_ok=True)
    report = {}
    kernels = {"gee_spmm": gee_spmm, "row_norm": row_norm,
               "gee_spmm_fused": gee_spmm_fused}

    # -- phase 1: device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(card)
    say(f"phase 1 device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, tf32 off")
    report["card"] = card

    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, compiler_out = build.build()
    lib = build.load_library()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "nvcc_output.txt"), "w") as f:
        f.write(compiler_out)
    if lib.gee_kernels_max_classes() != gee_fused.MAX_CLASSES:
        raise AssertionError("MAX_CLASSES differs between the .cu source "
                             "and repro_torch.kernels.gee_fused")
    if lib.topk_kernels_max_topk() != topk_mod.MAX_TOPK:
        raise AssertionError("MAX_TOPK differs between the .cu source "
                             "and repro_torch.kernels.topk_score")
    # For comparison: the same sources in one nvcc call, one after the other
    # (after the build above, so the compiler's files are in the page cache).
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                        "-o", os.path.join(tmp, "one_call.so"),
                        *(str(s) for s in build.sources()
                          if s.suffix == ".cu")],
                       capture_output=True, check=True)
        one_call_s = time.perf_counter() - t0
    say(f"phase 2 build: nvcc {' '.join(build.NVCC_FLAGS)} -c, one per "
        f"source, in parallel: {KERNEL_SOURCE} {TOPK_SOURCE} -> "
        f"{os.path.relpath(lib_path, REPO)} in {build_s:.2f} s (the same "
        f"sources in one nvcc -shared call: {one_call_s:.2f} s)")
    report["build_s"] = build_s
    report["build_one_call_s"] = one_call_s

    # -- phase 3a: kernel vs plain on edge cases -------------------------------
    errs = {name: [] for name in kernels}
    n_cases = edge_cases(torch, (gee_spmm, row_norm, gee_spmm_fused),
                         (gee_spmm_ref, row_norm_ref, gee_spmm_fused_ref),
                         errs)
    n_contraction = contraction_edge_cases(
        torch, gee_spmm, gee_spmm_fused, (gee_spmm_ref, gee_spmm_fused_ref),
        errs, gee_spmm_mod.SPAN)
    torch.cuda.synchronize()
    say(f"phase 3a kernel vs plain, {n_cases} edge cases and "
        f"{n_contraction} of the contraction's geometry (span "
        f"{gee_spmm_mod.SPAN}), each launched twice, same bits: "
        + ", ".join(f"{k} {fmt_err(v)}" for k, v in errs.items()))

    # -- phase 3c: the retrieval kernels vs plain on edge cases --------------
    rkernels = {"pairwise_scores": topk_mod.pairwise_scores,
                "gathered_scores": topk_mod.gathered_scores,
                "scored_topk": topk_mod.scored_topk,
                "scored_topk_gathered": topk_mod.scored_topk_gathered}
    errs.update({name: [] for name in rkernels})
    n_cases = topk_edge_cases(torch, topk_mod, ref_mod, errs)
    n_gathered, chunk_counts = gathered_topk_edge_cases(torch, topk_mod,
                                                        ref_mod, errs)
    n_scored, scored_counts = scored_topk_edge_cases(torch, topk_mod,
                                                     ref_mod, errs)
    n_pairwise = pairwise_edge_cases(torch, topk_mod, ref_mod, errs)
    torch.cuda.synchronize()
    say(f"phase 3c retrieval kernels vs plain, {n_cases} edge cases x "
        f"(l2, cosine), {n_gathered} more of scored_topk_gathered (chunk "
        f"counts {chunk_counts}), {n_scored} of scored_topk (chunk counts "
        f"{scored_counts}) and {n_pairwise} of pairwise_scores: "
        + ", ".join(f"{k} {fmt_err(errs[k])}" for k in rkernels))

    # -- graphs ---------------------------------------------------------------
    t0 = time.perf_counter()
    sbm = sample_sbm(10_000, seed=0)
    cl = synth_like(TABLE2["cl-100k-1d8-l5"], seed=0)
    gen_s = time.perf_counter() - t0
    graphs = {
        "sbm-10k": (sbm.edges, sbm.labels, sbm.num_classes),
        "cl-100k-1d8-l5": (cl.edges, cl.labels, cl.spec.num_classes),
    }
    prepared = {g: PreparedGraph(e) for g, (e, _, _) in graphs.items()}
    default = GEEEmbedder(num_classes=1).options
    say(f"graphs: sbm-10k N={sbm.edges.num_nodes} E={sbm.edges.num_edges}, "
        f"cl-100k-1d8-l5 N={cl.edges.num_nodes} E={cl.edges.num_edges} "
        f"(generated in {gen_s:.1f} s)")

    def fit(g, opts, fused):
        edges_or_prep = prepared[g]
        _, labels, k = graphs[g]
        os.environ[ENV_FUSED] = "1" if fused else "0"
        try:
            plan = GEEPlan.build(edges_or_prep, k, opts, backend="cuda")
            if plan.fused != fused:
                raise AssertionError(f"plan for {opts.tag()} is not "
                                     f"{'fused' if fused else 'staged'}")
            return GEEEmbedder(num_classes=k, options=opts,
                               backend="cuda").fit_transform(
                                   edges_or_prep, labels)
        finally:
            del os.environ[ENV_FUSED]

    # Capture the kernels' exact inputs on the main path (default options,
    # both graphs, fused and staged).  These launches come before the
    # counts are reset, so they do not count as main-path launches.
    captured = {}
    for g in graphs:
        with Recorder(gee_fused, "gee_spmm_fused") as rec_f:
            fit(g, default, True)
        with Recorder(ops, "gee_spmm") as rec_s, \
                Recorder(row_norm_mod, "row_norm") as rec_n:
            fit(g, default, False)
        captured[g] = {"gee_spmm_fused": rec_f.calls,
                       "gee_spmm": rec_s.calls, "row_norm": rec_n.calls}
    torch.cuda.synchronize()

    # -- phases 4-5: the main path, counted -----------------------------------
    for fn in kernels.values():
        fn.launches = 0
    results = {}
    t0 = time.perf_counter()
    for g, settings in (("sbm-10k", ALL_OPTION_SETTINGS),
                        ("cl-100k-1d8-l5", (default,))):
        edges, labels, k = graphs[g]
        labels_dev = torch.from_numpy(labels).to(DEVICE)
        errs_g = {}
        for opts in settings:
            ref = gee_sparse_torch(edges, labels_dev, k, opts)
            for fused in (True, False):
                z = fit(g, opts, fused)
                if z.shape != (edges.num_nodes, k) \
                        or not bool(torch.isfinite(z).all()):
                    raise AssertionError(f"{g} {opts.tag()}: bad output")
                errs_g[f"{opts.tag()} {'fused' if fused else 'staged'}"] = \
                    max_err(torch, z, ref)
        results[g] = errs_g
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}

    # the default setting against the host SciPy reference (SBM)
    src, dst, w = sbm.edges.valid_arrays()
    z_host = gee_scipy(src, dst, w, sbm.labels, 3, default)
    z_dev = fit("sbm-10k", default, True).cpu()
    scipy_errs = [max_err(torch, z_dev, torch.from_numpy(z_host))]
    z_dev = fit("sbm-10k", default, False).cpu()
    scipy_errs.append(max_err(torch, z_dev, torch.from_numpy(z_host)))
    scipy_err = worst(scipy_errs)
    say(f"phase 4 main path sbm-10k: 8 settings x (fused, staged) vs "
        f"sparse_torch {fmt_err(results['sbm-10k'].values())}; default vs "
        f"host gee_scipy {fmt_err(scipy_errs)}")
    say(f"phase 5 main path cl-100k-1d8-l5: default (fused, staged) vs "
        f"sparse_torch {fmt_err(results['cl-100k-1d8-l5'].values())} "
        f"(phases 4-5 took {main_s:.1f} s; launches {launches})")
    report.update(main_path_errs=results, scipy_err=scipy_err,
                  launches=launches)

    # -- phase 3b: kernel vs plain on the main path's real buckets -----------
    plain = {"gee_spmm": gee_spmm_ref, "row_norm": row_norm_ref,
             "gee_spmm_fused": gee_spmm_fused_ref}
    n_real = 0
    for g in graphs:
        for name, calls in captured[g].items():
            for args, kwargs in calls:
                errs[name].append(max_err(torch, kernels[name](*args, **kwargs),
                                          plain[name](*args, **kwargs)))
                n_real += 1
    torch.cuda.synchronize()
    say(f"phase 3b kernel vs plain, {n_real} real launches of the main path: "
        + ", ".join(f"{k} {fmt_err(errs[k])}" for k in kernels))

    # -- phase 6: timing ------------------------------------------------------
    timing = {}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    for g in graphs:
        tg = {}
        for name, calls in captured[g].items():
            nbytes = ops_ = 0
            for args, _ in calls:
                if name == "row_norm":
                    nbytes += 8 * args[0].numel()
                    ops_ += 3 * args[0].numel()
                else:
                    r, d = args[0].shape
                    k = args[4] if name == "gee_spmm_fused" else args[2]
                    nbytes += 8 * r * d + 4 * r * k
                    ops_ += int((args[0] >= 0).sum())
                    if name == "gee_spmm_fused":
                        nbytes += 8 * args[2].numel()
            t_kernel = gpu_ms(torch, lambda: [kernels[name](*a, **kw)
                                              for a, kw in calls])
            per_launch = [gpu_ms(torch, lambda: kernels[name](*a, **kw),
                                 reps=10) for a, kw in calls]
            buckets = None
            if name != "row_norm":
                # the staged fit packs A + I (the default's diag-aug)
                bell = prepared[g].bucketed_ell(name == "gee_spmm")
                buckets = bucket_table(torch, kernels[name], calls, bell,
                                       flush)
            t_plain = gpu_ms(torch, lambda: [plain[name](*a, **kw)
                                             for a, kw in calls], reps=10)
            lib_ms = None
            if name == "row_norm":
                import torch.nn.functional as F
                lib_ms = gpu_ms(torch, lambda: [
                    F.normalize(a[0], dim=1, eps=1e-30) for a, _ in calls])
            elif name == "gee_spmm":
                a_csr, w_dense, want = csr_operands(torch, *graphs[g])
                library_err = max_err(torch, torch.sparse.mm(a_csr, w_dense),
                                      want)
                lib_ms = gpu_ms(torch, lambda: torch.sparse.mm(a_csr,
                                                               w_dense))
                del a_csr, w_dense, want
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_ / FP32_OPS_PER_S * 1e3
            tg[name] = {
                "launches_per_fit": len(calls), "ms": t_kernel,
                "ms_per_launch": t_kernel / len(calls), "plain_ms": t_plain,
                "library_ms": lib_ms, "bytes": nbytes,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "shapes": [list(a[0].shape) for a, _ in calls],
                "per_launch_ms": per_launch, "buckets": buckets}
            if name == "gee_spmm":
                tg[name]["library"] = "torch.sparse.mm(A_csr, W), cuSPARSE"
                tg[name]["library_err"] = library_err
        edges, labels, k = graphs[g]
        # end to end: warm (packing cached in the PreparedGraph) and cold
        warm = host_ms(torch, lambda: GEEEmbedder(num_classes=k).fit_transform(
            prepared[g], labels), reps=10)
        # the same warm fit on the device's clock: with the labels already
        # there nothing in the fit waits for the device, so this is device
        # prep + kernels, and warm minus it is host time
        labels_dev = torch.from_numpy(labels).to(DEVICE)
        warm_dev = gpu_ms(torch, lambda: GEEEmbedder(
            num_classes=k).fit_transform(prepared[g], labels_dev), reps=10,
            sleep_cycles=100_000_000)
        # what one cold fit adds at its peak to what this run holds already
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        GEEEmbedder(num_classes=k).fit_transform(edges, labels)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        cold = host_ms(torch, lambda: GEEEmbedder(num_classes=k).fit_transform(
            edges, labels), reps=3)
        pack = host_ms(torch, lambda: edges_to_bucketed_ell(edges), reps=3)
        tg["fit_transform_warm_ms"] = warm
        tg["fit_transform_warm_device_ms"] = warm_dev
        tg["warm_fit_device_ms_by_pass"] = prep_passes(
            torch, gee_fused, lambda: GEEEmbedder(num_classes=k).fit_transform(
                prepared[g], labels_dev))
        tg["fit_transform_cold_ms"] = cold
        tg["host_packing_ms"] = pack
        tg["cold_fit_peak_bytes"] = peak
        timing[g] = tg
        say(f"phase 6 timing {g} (default options, {card}): "
            + "; ".join(f"{n} {tg[n]['ms']:.4f} ms over "
                        f"{tg[n]['launches_per_fit']} launches "
                        f"(bound {tg[n]['bound_ms']:.4f}, plain "
                        f"{tg[n]['plain_ms']:.4f}"
                        + (f", {LIBRARY[n]} {tg[n]['library_ms']:.4f}"
                           if tg[n]["library_ms"] is not None else "") + ")"
                        for n in kernels)
            + "; per bucket, L2 flushed, ms (x bound): " + "; ".join(
                f"{n} " + " ".join(
                    f"[{b['R']}/{b['R_pad']}, {b['D']}] {b['ms']:.4f} "
                    f"({b['ms'] / b['bound_ms']:.1f})" for b in
                    tg[n]["buckets"]["rows"])
                + f", kernels a launch {tg[n]['buckets']['kernels_per_launch']}"
                + f", an empty launch {tg[n]['buckets']['empty_launch_ms']:.4f}"
                for n in ("gee_spmm_fused", "gee_spmm"))
            + f"; fit_transform warm {warm:.2f} ms (device {warm_dev:.2f} "
              f"ms; by pass " + ", ".join(
                  f"{n} {t:.4f}" for n, t in
                  tg["warm_fit_device_ms_by_pass"].items()) + "), "
              f"cold {cold:.1f} ms, "
              f"host packing {pack:.1f} ms, peak memory of a cold fit "
              f"{peak / 2**20:.1f} MiB")
    report["timing"] = timing

    # -- phase 8: the retrieval path ------------------------------------------
    from repro_torch.launch.gee_search import recall_at_k
    from repro_torch.search.service import GEEQueryService

    class fused_env:
        """``REPRO_GEE_FUSED`` set for the block, then restored."""

        def __init__(self, flag):
            self.flag = flag

        def __enter__(self):
            self.prev = os.environ.get(ENV_FUSED)
            os.environ[ENV_FUSED] = self.flag

        def __exit__(self, *exc):
            if self.prev is None:
                del os.environ[ENV_FUSED]
            else:
                os.environ[ENV_FUSED] = self.prev

    def replay(index, rows, nprobe=None):
        """Vertex-id queries through the service, ``FLUSH`` a flush."""
        svc = GEEQueryService(index, None, flush_every=FLUSH, nprobe=nprobe,
                              default_k=TOP_K)
        t0 = time.perf_counter()
        tickets = [svc.submit_rows(rows[lo:lo + FLUSH])
                   for lo in range(0, rows.size, FLUSH)]
        svc.flush()
        wall = time.perf_counter() - t0
        flush_ms = list(svc.stats["flush_ms"])
        svc.close()
        return (np.concatenate([t.ids for t in tickets]),
                np.concatenate([t.scores for t in tickets]), wall, flush_ms)

    def brute(index, zq):
        """Brute-force search in batches of ``FLUSH`` queries."""
        got = [index.search(zq[lo:lo + FLUSH], TOP_K, brute_force=True)
               for lo in range(0, zq.shape[0], FLUSH)]
        return (torch.cat([i for i, _ in got]).cpu().numpy(),
                torch.cat([s for _, s in got]).cpu().numpy())

    def hold_true_scores(index, zq, ids, scores, metric, scale):
        """Every returned id's plain score equals its reported score."""
        t_ids = torch.from_numpy(ids).to(DEVICE)
        cand = index.z[t_ids.clamp(min=0).long()]
        want = ref_mod.gathered_scores_ref(zq, cand, (t_ids >= 0).float(),
                                           metric)
        return score_err(torch, torch.from_numpy(scores).to(DEVICE), want,
                         scale)


    def retrieval_graph(g, seed):
        """A default fit of ``g`` and ``N_QUERIES`` query rows."""
        _, labels, k = graphs[g]
        emb = GEEEmbedder(num_classes=k).fit(prepared[g], labels)
        emb.transform()
        rows = np.random.default_rng(seed).integers(
            0, prepared[g].num_nodes, N_QUERIES)
        return emb, rows

    # Capture the retrieval kernels' exact inputs on the main path (before
    # the counts are reset, so these launches do not count).
    rcaptured = {}
    for g in graphs:
        emb, rows = retrieval_graph(g, 1)
        for metric in ("l2", "cosine"):
            with Recorder(index_mod, "pairwise_scores") as rec_b:
                index = emb.build_index(metric=metric)
            zq = index.z[torch.from_numpy(rows[:2 * FLUSH]).to(DEVICE)]
            with fused_env("1"), \
                    Recorder(index_mod, "pairwise_scores", keep=2) as rec_p, \
                    Recorder(index_mod, "scored_topk_gathered",
                             keep=2) as rec_g:
                replay(index, rows[:2 * FLUSH])
            with fused_env("0"), \
                    Recorder(topk_mod, "gathered_scores", keep=2) as rec_s:
                replay(index, rows[:2 * FLUSH])
            with fused_env("1"), \
                    Recorder(index_mod, "scored_topk", keep=2) as rec_t:
                brute(index, zq)
            rcaptured[(g, metric)] = {
                "pairwise_scores": rec_b.calls + rec_p.calls,
                "gathered_scores": rec_s.calls,
                "scored_topk": rec_t.calls,
                "scored_topk_gathered": rec_g.calls}
    torch.cuda.synchronize()

    for fn in list(kernels.values()) + list(rkernels.values()):
        fn.launches = 0
    retrieval = {}
    t0 = time.perf_counter()
    for g in graphs:
        emb, rows = retrieval_graph(g, 2)
        for metric in ("l2", "cosine"):
            tb = time.perf_counter()
            index = emb.build_index(metric=metric)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - tb) * 1e3
            with fused_env("1"):
                ids_f, s_f, wall, flush_ms = replay(index, rows)
            with fused_env("0"):
                ids_s, s_s, wall_s, flush_ms_s = replay(index, rows)
            with fused_env("1"):
                ids_full, s_full, _, _ = replay(index, rows,
                                                nprobe=index.num_cells)
            zq = index.z[torch.from_numpy(rows).to(DEVICE)]
            with fused_env("1"):
                ids_bf, s_bf = brute(index, zq)
            with fused_env("0"):
                ids_bs, s_bs = brute(index, zq)
            for ids in (ids_f, ids_s, ids_full, ids_bf, ids_bs):
                if ids.shape != (N_QUERIES, TOP_K):
                    raise AssertionError(f"{g} {metric}: shape {ids.shape}")
            for s in (s_f, s_s, s_full, s_bf, s_bs):
                if not np.isfinite(s).all():
                    raise AssertionError(f"{g} {metric}: non-finite score")
            scale = term_scale(torch, zq, index.z, metric)
            scale_np = scale.cpu().numpy()
            ties = (same_topk(ids_s, s_s, ids_f, s_f, scale_np)  # routes
                    + same_topk(ids_bs, s_bs, ids_bf, s_bf, scale_np)
                    + same_topk(ids_full, s_full, ids_bf, s_bf,
                                scale_np))                     # exact
            score_errs = [hold_true_scores(index, zq, i, s, metric, scale)
                          for i, s in ((ids_f, s_f), (ids_s, s_s),
                                       (ids_full, s_full), (ids_bf, s_bf))]
            recall = recall_at_k(ids_f, s_f, ids_bf, s_bf)
            recall_full = recall_at_k(ids_full, s_full, ids_bf, s_bf)
            if recall_full != 1.0:
                raise AssertionError(f"{g} {metric}: full-probe recall "
                                     f"{recall_full}")
            lat = np.asarray(flush_ms)
            retrieval[f"{g} {metric}"] = {
                "num_cells": index.num_cells, "nprobe": index.nprobe,
                "bucket_capacity": index.bucket_capacity,
                "padding_fraction": index.padding_fraction(),
                "build_ms": build_ms,
                "recall_at_10": recall, "recall_at_10_full_probe":
                recall_full, "qps_fused": N_QUERIES / wall,
                "qps_staged": N_QUERIES / wall_s,
                "flush_ms_p50": float(np.percentile(lat, 50)),
                "flush_ms_p95": float(np.percentile(lat, 95)),
                "flush_ms_p50_staged": float(np.percentile(flush_ms_s, 50)),
                "score_err": worst(score_errs),
                # the size of the scores the tolerance separates: slots 1-9
                # of brute force (slot 0 is the query vertex itself)
                "top10_score_median": float(np.median(s_bf[:, 1:])),
                "slot10_score_median": float(np.median(s_bf[:, -1])),
                "tolerance_median": float(np.median(TERM_ATOL * scale_np)),
                "near_tie_groups": len(ties),
                "near_tie_group_max": max(ties, default=0)}
    torch.cuda.synchronize()
    phase8_s = time.perf_counter() - t0
    rlaunches = {name: fn.launches for name, fn in rkernels.items()}
    fit_launches = {name: fn.launches for name, fn in kernels.items()}

    # the captured calls against the plain versions
    plain_r = {
        "pairwise_scores": lambda q, x, v=None, metric="l2":
            ref_mod.pairwise_scores_ref(q, x, v, metric),
        "gathered_scores": lambda q, c, m, metric="l2":
            ref_mod.gathered_scores_ref(q, c, m, metric),
        "scored_topk": lambda q, x, v, k, metric="l2", fused=None:
            ref_mod.scored_topk_ref(q, x, v, k, metric),
        "scored_topk_gathered":
            lambda q, c, m, i, k, metric="l2", fused=None:
            ref_mod.scored_topk_gathered_ref(q, c, m, i, k, metric)}
    n_real = 0
    for calls_by_name in rcaptured.values():
        for name, calls in calls_by_name.items():
            for a, kw in calls:
                got = rkernels[name](*a, **kw)
                want = plain_r[name](*a, **kw)
                sc = term_scale(torch, a[0], a[1], kw["metric"])
                if name == "scored_topk":
                    full = ref_mod.pairwise_scores_ref(a[0], a[1], a[2],
                                                       kw["metric"])
                    errs[name].append(check_topk(torch, got, want, full, sc))
                elif name == "scored_topk_gathered":
                    full = ref_mod.gathered_scores_ref(a[0], a[1], a[2],
                                                       kw["metric"])
                    errs[name].append(check_topk(torch, got, want, full, sc,
                                                 a[3]))
                else:
                    errs[name].append(score_err(torch, got, want, sc))
                n_real += 1
    torch.cuda.synchronize()
    say(f"phase 8 retrieval path, {N_QUERIES} vertex-id queries in flushes "
        f"of {FLUSH}, top {TOP_K}, fused and staged, brute force and full "
        f"probe, on both graphs x (l2, cosine) in {phase8_s:.1f} s: "
        + "; ".join(f"{key} recall@10 {r['recall_at_10']:.4f} at nprobe "
                    f"{r['nprobe']} of {r['num_cells']} (full probe "
                    f"{r['recall_at_10_full_probe']:.1f}; top-10 scores "
                    f"median {r['top10_score_median']:.3g}, tolerance "
                    f"{r['tolerance_median']:.3g}, "
                    f"{r['near_tie_groups']} near-tie groups of up to "
                    f"{r['near_tie_group_max']})"
                    for key, r in retrieval.items())
        + f"; fused == staged, full probe == brute force; launches "
          f"{rlaunches} (and the fits' {fit_launches}); {n_real} captured "
          f"launches "
          f"vs plain: " + ", ".join(f"{k} {fmt_err(errs[k])}"
                                     for k in rkernels))
    report["retrieval"] = retrieval
    report["retrieval_launches"] = rlaunches

    # -- phase 9: retrieval timing --------------------------------------------
    def work(name, a, kw):
        """(bytes, operations) the call must move and do on this run's
        data: each input read once, each output written once; a masked
        gathered slot reads no candidate, and the gathered top-k reads only
        its winners' ids.  A score is 3 multiply-adds per
        class plus ~4 operations."""
        q = a[0]
        nq, kd = q.shape
        if name in ("pairwise_scores", "scored_topk"):
            m = a[1].shape[0]
            valid = a[2] if len(a) > 2 else kw.get("valid")
            nbytes = 4 * (nq * kd + m * kd) + (
                0 if valid is None else valid.element_size() * m)
            live = nq * m
        else:
            m = a[1].shape[1]
            live = int((a[2] > 0).sum())
            nbytes = 4 * (live * kd + nq * kd + nq * m)
            if name == "scored_topk_gathered":
                nbytes += 4 * nq * min(a[4], m)        # the winners' ids
        if name in ("pairwise_scores", "gathered_scores"):
            nbytes += 4 * nq * m
        else:
            nbytes += 8 * nq * (a[3] if name == "scored_topk" else a[4])
        return nbytes, live * (6 * kd + 4)

    # the floor of a launch timed this way: one launch of an empty kernel
    rtiming = {"empty_launch_ms": gpu_ms(torch, lambda: torch.cuda._sleep(0))}
    for g in graphs:
        cap = rcaptured[(g, "l2")]
        tg = {}
        brute = cap["scored_topk"][0][0]
        for name, calls in cap.items():
            # pairwise_scores: the index build, a flush's probe, and the
            # score pass of the staged brute force
            picks = {"pairwise_scores": {
                "build": calls[0], "probe": calls[1],
                "staged": (brute[:3], {"metric": "l2"})}}.get(
                    name, {"flush": calls[0]})
            for shape_name, (a, kw) in picks.items():
                nbytes, nops = work(name, a, kw)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = nops / FP32_OPS_PER_S * 1e3
                entry = {
                    "shape": [list(t.shape) for t in a
                              if isinstance(t, torch.Tensor)],
                    "ms": gpu_ms(torch, lambda: rkernels[name](*a, **kw)),
                    "plain_ms": gpu_ms(torch, lambda: plain_r[name](*a, **kw),
                                       reps=10),
                    "library_ms": None, "bytes": nbytes, "operations": nops,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations"}
                if name == "pairwise_scores":
                    # one call launches exactly one kernel: no cast of the
                    # index's bool mask, no copy
                    (entry["kernels_per_call"], entry["kernel_names"],
                     entry["profiler_sessions"]) = kernels_per_call(
                        torch, lambda: rkernels[name](*a, **kw))
                    if (entry["kernels_per_call"] != 1
                            or not all("pairwise_" in k
                                       for k in entry["kernel_names"])):
                        raise AssertionError(
                            f"pairwise_scores {shape_name}: one call "
                            f"launched {entry['kernels_per_call']} kernels "
                            f"({entry['kernel_names']})")
                if name == "scored_topk":
                    entry.update(chunk_sweep(torch, topk_mod, name, a, kw))
                    entry["staged_ms"] = gpu_ms(torch, lambda: topk_mod.
                                                masked_topk(topk_mod.
                                                pairwise_scores(a[0], a[1],
                                                a[2], metric="l2"), None,
                                                a[3]))
                elif name == "scored_topk_gathered":
                    entry["staged_ms"] = gpu_ms(torch, lambda: topk_mod.
                                                masked_topk(topk_mod.
                                                gathered_scores(a[0], a[1],
                                                a[2], metric="l2"), a[3],
                                                a[4]))
                    entry.update(chunk_sweep(torch, topk_mod, name, a, kw))
                tg[f"{name} {shape_name}"] = entry
        # launches per build and per flush, counted
        emb, rows = retrieval_graph(g, 3)
        counted = {}
        for what, flag in (("build", None), ("flush_fused", "1"),
                           ("flush_staged", "0")):
            if what == "build":
                for fn in rkernels.values():
                    fn.launches = 0
                index = emb.build_index(metric="l2")
            else:
                for fn in rkernels.values():
                    fn.launches = 0
                with fused_env(flag):
                    replay(index, rows[:FLUSH])
            counted[what] = {n: fn.launches for n, fn in rkernels.items()}
        tg["launches"] = counted
        tg["index_build_ms"] = host_ms(
            torch, lambda: emb.build_index(metric="l2"), reps=5)
        # a fused flush's device work (probe, cell sort, gather, top-k):
        # the part of its p50 that the host's clock does not blur
        zq = index.z[torch.from_numpy(rows[:FLUSH]).to(DEVICE)]
        with fused_env("1"):
            tg["flush_device_ms"] = gpu_ms(torch,
                                           lambda: index.search(zq, TOP_K))
        rtiming[g] = tg
        r = retrieval[f"{g} l2"]
        say(f"phase 9 retrieval timing {g} (l2, {card}): "
            + "; ".join(f"{n} {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} "
                        f"by {e['bound_by']}, plain {e['plain_ms']:.4f}"
                        + (f", staged {e['staged_ms']:.4f}"
                           if "staged_ms" in e else "")
                        + (f", {e['kernels_per_call']:g} kernel a call"
                           if "kernels_per_call" in e else "")
                        + (f", {e['chunks']} chunks; ms by chunk count "
                           + " ".join(f"{c}:{t:.4f}" for c, t in
                                      e["chunk_sweep_ms"].items())
                           + "; ms by k " + " ".join(
                               f"{c}:{t:.4f}" for c, t in
                               e["ms_by_k"].items())
                           if "chunk_sweep_ms" in e else "") + ")"
                        for n, e in tg.items()
                        if isinstance(e, dict) and "ms" in e)
            + f"; an empty launch {rtiming['empty_launch_ms']:.4f} ms"
            + f"; index build {tg['index_build_ms']:.2f} ms; replay "
              f"{r['qps_fused']:,.0f} QPS fused ({r['qps_staged']:,.0f} "
              f"staged), flush p50 {r['flush_ms_p50']:.3f} ms p95 "
              f"{r['flush_ms_p95']:.3f} ms, device time of a fused flush "
              f"{tg['flush_device_ms']:.4f} ms; launches {counted}")
    report["retrieval_timing"] = rtiming

    # -- phase 10: streaming ---------------------------------------------------
    all_kernels = {**kernels, **rkernels}
    from repro_torch.graph.datasets import DatasetSpec

    stream = streaming_phase(torch, card, all_kernels, replay,
                             TABLE2["cl-100k-1d8-l5"],
                             DatasetSpec(*SCALE_SPEC))
    stream_launches = stream["launches"]
    report["streaming"] = stream

    # -- phase 7: the kernels line -------------------------------------------
    # Slice 1's kernels: ms per fit of cl-100k-1d8-l5.  The retrieval
    # kernels: ms per launch at cl-100k-1d8-l5's l2 shapes (pairwise_scores
    # at the index build, the others at a flush).  ``launches`` is the
    # count of the kernel's own main path (phases 4-5 or 8);
    # ``launches_streaming`` is phase 10's, counted apart.
    line = {"kernels": []}
    rt = rtiming["cl-100k-1d8-l5"]
    for name in list(kernels) + list(rkernels):
        if name in kernels:
            t, source, n = (timing["cl-100k-1d8-l5"][name], KERNEL_SOURCE,
                            launches[name])
        else:
            t = rt[f"{name} build" if name == "pairwise_scores"
                   else f"{name} flush"]
            source, n = TOPK_SOURCE, rlaunches[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name],
            "launches": n,
            "launches_streaming": stream_launches[name],
            "max_abs_err": worst(errs[name])[0],
            "max_rel_err": worst(errs[name])[1], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    report["kernels"] = line["kernels"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    missing = [k["name"] for k in line["kernels"] if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
