"""The paper's GEE pipeline as a CLI (port of
``repro/launch/gee_run.py``).  Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.gee_run --sbm 10000 \\
      --backend cuda --lap --diag --cor
  PYTHONPATH=src python -m repro_torch.launch.gee_run --dataset citeseer \\
      --compare --device cpu
  PYTHONPATH=src python -m repro_torch.launch.gee_run --edge-file g.geeb \\
      --chunk-edges 1048576 --lap --diag --cor --verify   # out-of-core

``--verify`` (edge files) also materializes the file and holds the
streamed result against the in-memory ``sparse_torch`` fit, entry by entry
within 1e-5·|want| + 1e-5·min(1, max |want row|), and exits non-zero when
it does not hold.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.gee import GEEOptions, gee_sparse_torch
from repro_torch.core.plan import GEEPlan, PreparedGraph
from repro_torch.graph.datasets import TABLE2, load
from repro_torch.graph.sbm import sample_sbm
from repro_torch.obs import cli as obs_cli

BACKENDS = ("sparse_torch", "cuda", "chunked", "streamed_sharded",
            "dense_torch", "scipy", "python_loop", "auto")
RTOL = ATOL = 1e-5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device, repeats: int = 3) -> float:
    """Best of ``repeats`` host-clock times of ``fn`` (after a warm-up),
    each ending in a device synchronize."""
    fn()
    _sync(device)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def row_parity(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """``(max_abs_err, entries_off)``: each entry held within
    ``RTOL * |want| + ATOL * min(1, max |want row|)`` (the f32 sums of a
    streamed fold run in another order than the in-memory fit's)."""
    g = got.detach().double().cpu()
    w = want.detach().double().cpu()
    diff = (g - w).abs()
    tol = RTOL * w.abs() + ATOL * w.abs().amax(dim=1,
                                               keepdim=True).clamp(max=1.0)
    return float(diff.max()) if diff.numel() else 0.0, \
        int((~(diff <= tol)).sum())


def _not_ported(backend: str) -> None:
    if backend == "streamed_sharded":
        raise NotImplementedError(
            "--backend streamed_sharded: not yet ported (multi-device folds)")


def _edge_file(args, opts: GEEOptions, device: torch.device) -> int:
    """Out-of-core: the edge list stays on disk, windows stream through
    the single-device fold (``repro_torch.core.fold``)."""
    from repro_torch.core.chunked import gee_chunked
    from repro_torch.graph.io import (DEFAULT_CHUNK_EDGES, load_labels,
                                      open_edge_list)

    _not_ported(args.backend)
    if args.compare:
        print("  (--compare with --edge-file: timing the on-disk streaming "
              "backend; the multi-device one is not yet ported)")
    chunked = open_edge_list(args.edge_file,
                             chunk_edges=args.chunk_edges
                             or DEFAULT_CHUNK_EDGES)
    labels = load_labels(args.edge_file)
    if labels is None:
        labels = np.random.default_rng(args.seed).integers(
            0, args.classes, chunked.num_nodes).astype(np.int32)
        print(f"  (no labels sidecar; random K={args.classes} labels)")
        k = args.classes
    else:
        # an all-unknown (-1) sidecar still gets K=1, not a zero-width Z
        k = max(int(labels.max()) + 1, 1)
    print(f"{args.edge_file}: N={chunked.num_nodes} E={chunked.num_edges}"
          f"{' (undirected storage)' if chunked.undirected else ''} "
          f"K={k} windows={chunked.num_windows}x{chunked.window_edges} "
          f"[{opts.tag()}] on {device}")

    def fn():
        return gee_chunked(chunked, labels, k, opts,
                           prefetch_windows=args.prefetch_windows,
                           device=device)

    dt = _time(fn, device)
    z = fn()
    eps = (2 if chunked.undirected else 1) * chunked.num_edges / dt
    print(f"  {'chunked':12s}: {dt*1e3:9.1f} ms   {eps/1e6:8.2f} M edges/s"
          f"   Z[{z.shape[0]}x{z.shape[1]}] "
          f"norm {float(torch.linalg.norm(z.double())):.4f}")
    if args.verify:
        want = gee_sparse_torch(chunked.to_edge_list(device=device),
                                torch.from_numpy(labels).to(device), k, opts)
        err, off = row_parity(z, want)
        print(f"  parity vs in-memory sparse_torch: max_abs_err {err:.3g}, "
              f"{off} entries off the row tolerance: "
              f"{'ok' if off == 0 else 'FAILED'}")
        if off:
            return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sbm", type=int, default=None,
                    help="SBM node count (paper's simulation)")
    ap.add_argument("--dataset", default=None,
                    help=f"one of {sorted(TABLE2)}, or a path to an edge "
                         f"file (.geeb/.npz/.txt)")
    ap.add_argument("--edge-file", default=None,
                    help="embed an on-disk edge list out-of-core (any "
                         "repro_torch.graph.io format); labels come from the "
                         "<file>.labels.npy sidecar or --classes random")
    ap.add_argument("--chunk-edges", type=int, default=None,
                    help="streaming window for --edge-file / the chunked "
                         "backend (default 1M edges = 12 MB a window)")
    ap.add_argument("--prefetch-windows", type=int, default=None,
                    help="windows staged ahead by background threads when "
                         "streaming (default: REPRO_GEE_PREFETCH_WINDOWS or "
                         "2; 0 = synchronous copies)")
    ap.add_argument("--classes", type=int, default=5,
                    help="synthetic label count when --edge-file has no "
                         "labels sidecar")
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    ap.add_argument("--lap", action="store_true")
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--cor", action="store_true")
    ap.add_argument("--compare", action="store_true",
                    help="time all backends (prep shared via PreparedGraph)")
    ap.add_argument("--plan", action="store_true",
                    help="print the resolved GEEPlan stages per backend")
    ap.add_argument("--verify", action="store_true",
                    help="--edge-file: hold the streamed result against the "
                         "in-memory sparse_torch fit of the same file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    obs_cli.add_flags(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    obs_cli.setup(args)

    opts = GEEOptions(laplacian=args.lap, diag_aug=args.diag,
                      correlation=args.cor)
    if args.edge_file:
        rc = _edge_file(args, opts, device)
        obs_cli.finish(args)
        return rc

    if args.sbm:
        s = sample_sbm(args.sbm, seed=args.seed, device=device)
        edges, labels, k = s.edges, s.labels, s.num_classes
        name = f"sbm-{args.sbm}"
    else:
        ds = load(args.dataset or "citeseer", seed=args.seed, device=device)
        edges, labels, k = ds.edges, ds.labels, ds.spec.num_classes
        name = ds.spec.name
    print(f"{name}: N={edges.num_nodes} E={edges.num_edges//2} K={k} "
          f"[{opts.tag()}] on {device}")

    backends = (("sparse_torch", "chunked", "cuda", "auto", "dense_torch",
                 "scipy", "python_loop") if args.compare
                else (args.backend,))
    # one PreparedGraph for every cell: symmetrized upload, self loops,
    # Laplacian fold, ELL packing and the window manifest are derived once
    prep = PreparedGraph.wrap(edges)
    for b in backends:
        _not_ported(b)
        if b == "python_loop" and edges.num_edges > 3_000_000:
            print(f"  {b:12s}: skipped (too slow at this size)")
            continue
        if b == "dense_torch" and edges.num_nodes > 30_000:
            print(f"  {b:12s}: skipped (the O(N^2) oracle at this size)")
            continue
        plan = GEEPlan.build(prep, k, opts, backend=b,
                             chunk_edges=args.chunk_edges,
                             prefetch_windows=args.prefetch_windows)
        if args.plan:
            print("\n".join("  " + ln for ln in
                            plan.describe().splitlines()))
        dt = _time(lambda: plan.execute(labels), device)
        z = plan.execute(labels)
        print(f"  {b:12s}: {dt*1e3:9.1f} ms   Z[{z.shape[0]}x{z.shape[1]}] "
              f"norm {float(torch.linalg.norm(z.double())):.4f}")
    obs_cli.finish(args)
    return 0


__all__ = ["main", "row_parity", "BACKENDS"]


if __name__ == "__main__":
    raise SystemExit(main())
