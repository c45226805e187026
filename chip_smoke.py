#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc/``
with nvcc for sm_90a, holds each kernel against its plain PyTorch version on
the card, drives the port's main path (``GEEEmbedder.fit_transform`` with the
``cuda`` backend, fused and staged) on the paper's 10k-node SBM (all 8 option
settings) and on the ``cl-100k-1d8-l5`` stand-in (20 M directed edges),
checks the embeddings against the port's ``sparse_torch`` reference (and the
default setting against SciPy on the host), times every kernel with CUDA
events beside its memory bound, and prints one JSON line per kernel.  The
last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before that line.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
DEVICE = "cuda"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/gee_kernels.cu"
REPLACES = {
    "gee_spmm": "src/repro/kernels/gee_spmm.py:208",
    "row_norm": "src/repro/kernels/row_norm.py:26",
    "gee_spmm_fused": "src/repro/kernels/gee_fused.py:122",
}


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

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kwargs):
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


def max_err(torch, got, want) -> tuple:
    """Hold ``got`` against ``want`` row by row: each entry within
    ``RTOL * |want| + ATOL * min(1, max |want row|)``, so every row is held
    to its own scale and never more loosely than rtol = atol = 1e-5; a row
    that should be all zeros must be exactly zero.  Returns the max-abs
    error and the max over rows of max |got - want| / max |want|."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0, 0.0
    g = got.detach().double().reshape(got.shape[0], -1)
    w = want.detach().to(g.device).double().reshape(want.shape[0], -1)
    scale = w.abs().amax(dim=1, keepdim=True)
    diff = (g - w).abs()
    bad = ~(diff <= RTOL * w.abs() + ATOL * scale.clamp(max=1.0))  # NaN: bad
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
    say(f"phase 2 build: nvcc {' '.join(build.NVCC_FLAGS)} "
        f"{KERNEL_SOURCE} -> {os.path.relpath(lib_path, REPO)} in "
        f"{build_s:.2f} s")
    report["build_s"] = build_s

    # -- phase 3a: kernel vs plain on edge cases -------------------------------
    errs = {name: [] for name in kernels}
    n_cases = edge_cases(torch, (gee_spmm, row_norm, gee_spmm_fused),
                         (gee_spmm_ref, row_norm_ref, gee_spmm_fused_ref),
                         errs)
    torch.cuda.synchronize()
    say(f"phase 3a kernel vs plain, {n_cases} edge cases: "
        + ", ".join(f"{k} {fmt_err(v)}" for k, v in errs.items()))

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
        + ", ".join(f"{k} {fmt_err(v)}" for k, v in errs.items()))

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

    # -- phase 7: the kernels line -------------------------------------------
    line = {"kernels": []}
    for name in kernels:
        t = timing["cl-100k-1d8-l5"][name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": worst(errs[name])[0],
            "max_rel_err": worst(errs[name])[1], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    report["kernels"] = line["kernels"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    missing = [n for n, c in launches.items() if c <= 0]
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
