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
  full probe held equal to brute force and fused to staged.

Each path runs with every kernel's launch count set to 0 just before it and
read just after.  Every kernel is timed with CUDA events beside its bound.
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
    65,536, empty rowlab, correlation on and off, rows whose squares are
    denormal."""
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
    for n, k in ((13, 1), (300, 3), (257, 200), (1000, 5)):
        z = rng.standard_normal((n, k)).astype(np.float32)
        z[rng.random(n) < 0.2] = 0.0               # zero rows stay zero
        z[1] = 1e-21                       # its squares are denormal floats
        zt = torch.from_numpy(z).to(dev)
        got, want = row_norm(zt), row_norm_ref(zt)
        errs["row_norm"].append(max_err(torch, got, want))
        # no flushed denormals: flushed, the row's norm would read 0
        torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=0.0)
        if not bool((got[1] != 0).all()):
            raise AssertionError("row_norm flushed a denormal-norm row")
        n_cases += 1
    return n_cases


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
    torch.cuda.synchronize()
    say(f"phase 3a kernel vs plain, {n_cases} edge cases: "
        + ", ".join(f"{k} {fmt_err(v)}" for k, v in errs.items()))

    # -- phase 3c: the retrieval kernels vs plain on edge cases --------------
    rkernels = {"pairwise_scores": topk_mod.pairwise_scores,
                "gathered_scores": topk_mod.gathered_scores,
                "scored_topk": topk_mod.scored_topk,
                "scored_topk_gathered": topk_mod.scored_topk_gathered}
    errs.update({name: [] for name in rkernels})
    n_cases = topk_edge_cases(torch, topk_mod, ref_mod, errs)
    torch.cuda.synchronize()
    say(f"phase 3c retrieval kernels vs plain, {n_cases} edge cases x "
        f"(l2, cosine): " + ", ".join(f"{k} {fmt_err(errs[k])}"
                                     for k in rkernels))

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
            t_plain = gpu_ms(torch, lambda: [plain[name](*a, **kw)
                                             for a, kw in calls], reps=10)
            lib_ms = None
            if name == "row_norm":
                import torch.nn.functional as F
                lib_ms = gpu_ms(torch, lambda: [
                    F.normalize(a[0], dim=1, eps=1e-30) for a, _ in calls])
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_ / FP32_OPS_PER_S * 1e3
            tg[name] = {
                "launches_per_fit": len(calls), "ms": t_kernel,
                "ms_per_launch": t_kernel / len(calls), "plain_ms": t_plain,
                "library_ms": lib_ms, "bytes": nbytes,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "shapes": [list(a[0].shape) for a, _ in calls],
                "per_launch_ms": per_launch}
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
        tg["fit_transform_cold_ms"] = cold
        tg["host_packing_ms"] = pack
        tg["cold_fit_peak_bytes"] = peak
        timing[g] = tg
        say(f"phase 6 timing {g} (default options, {card}): "
            + "; ".join(f"{n} {tg[n]['ms']:.4f} ms over "
                        f"{tg[n]['launches_per_fit']} launches "
                        f"(bound {tg[n]['bound_ms']:.4f}, plain "
                        f"{tg[n]['plain_ms']:.4f}"
                        + (f", F.normalize {tg[n]['library_ms']:.4f}"
                           if tg[n]["library_ms"] is not None else "") + ")"
                        for n in kernels)
            + f"; fit_transform warm {warm:.2f} ms (device {warm_dev:.2f} "
              f"ms), cold {cold:.1f} ms, "
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
            nbytes = 4 * (nq * kd + m * kd
                          + (m if valid is not None else 0))
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

    rtiming = {}
    for g in graphs:
        cap = rcaptured[(g, "l2")]
        tg = {}
        for name, calls in cap.items():
            picks = {"pairwise_scores": {"build": calls[0],
                                         "probe": calls[1]}}.get(
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
                if name == "scored_topk":
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
        rtiming[g] = tg
        r = retrieval[f"{g} l2"]
        say(f"phase 9 retrieval timing {g} (l2, {card}): "
            + "; ".join(f"{n} {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} "
                        f"by {e['bound_by']}, plain {e['plain_ms']:.4f}"
                        + (f", staged {e['staged_ms']:.4f}"
                           if "staged_ms" in e else "") + ")"
                        for n, e in tg.items()
                        if isinstance(e, dict) and "ms" in e)
            + f"; index build {tg['index_build_ms']:.2f} ms; replay "
              f"{r['qps_fused']:,.0f} QPS fused ({r['qps_staged']:,.0f} "
              f"staged), flush p50 {r['flush_ms_p50']:.3f} ms p95 "
              f"{r['flush_ms_p95']:.3f} ms; launches {counted}")
    report["retrieval_timing"] = rtiming

    # -- phase 7: the kernels line -------------------------------------------
    # Slice 1's kernels: ms per fit of cl-100k-1d8-l5.  The retrieval
    # kernels: ms per launch at cl-100k-1d8-l5's l2 shapes (pairwise_scores
    # at the index build, the others at a flush).
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
            "replaces": REPLACES[name], "launches": n,
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
