"""The paper's GEE pipeline as a CLI (port of
``repro/launch/gee_run.py``).  Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.gee_run --sbm 10000 \\
      --backend cuda --lap --diag --cor
  PYTHONPATH=src python -m repro_torch.launch.gee_run --dataset citeseer \\
      --compare --device cpu
  PYTHONPATH=src python -m repro_torch.launch.gee_run --edge-file g.geeb \\
      --chunk-edges 1048576 --lap --diag --cor --verify   # out-of-core
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.gee_run \\
      --edge-file g.geeb --backend streamed_sharded --device cpu --verify

``--verify`` (edge files) also materializes the file and holds the
streamed result against the in-memory ``sparse_torch`` fit, entry by entry
within 1e-5·|want| + 1e-5·min(1, max |want row|), and exits non-zero when
it does not hold.

``--backend streamed_sharded`` folds across the ranks of a process group:
a world of one by default; under ``torchrun`` (``WORLD_SIZE`` in the
environment) the script joins the group it describes, NCCL on the card
(one card a rank, ``LOCAL_RANK``) and gloo with ``--device cpu``.  Every
rank computes; only rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.fold import (gather_rows, gee_streamed_sharded,
                                   world_size)
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


def _join_group(device_arg) -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` set), join the default process
    group it describes: NCCL with one card a rank, gloo on the CPU.
    Returns whether a group was joined."""
    if "WORLD_SIZE" not in os.environ:
        return False
    on_cpu = device_arg is not None and torch.device(device_arg).type == "cpu"
    if not on_cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if on_cpu else "nccl")
    return True


def _edge_file(args, opts: GEEOptions, device: torch.device, world: int,
               say) -> int:
    """Out-of-core: the edge list stays on disk, windows stream through
    the fold (``repro_torch.core.fold``): ``streamed_sharded`` splits each
    window across the group's ranks, anything else runs the one-device
    ``chunked`` fold."""
    from repro_torch.core.chunked import gee_chunked
    from repro_torch.graph.io import (DEFAULT_CHUNK_EDGES, load_labels,
                                      open_edge_list, open_window_parallel)

    if args.compare:
        say("  (--compare with --edge-file: timing the on-disk streaming "
            "backends)")
    chunk = args.chunk_edges or DEFAULT_CHUNK_EDGES
    streamed = args.backend == "streamed_sharded" or args.compare
    chunked = (open_window_parallel(args.edge_file, world, chunk_edges=chunk)
               if streamed else open_edge_list(args.edge_file,
                                               chunk_edges=chunk))
    labels = load_labels(args.edge_file)
    if labels is None:
        labels = np.random.default_rng(args.seed).integers(
            0, args.classes, chunked.num_nodes).astype(np.int32)
        say(f"  (no labels sidecar; random K={args.classes} labels)")
        k = args.classes
    else:
        # an all-unknown (-1) sidecar still gets K=1, not a zero-width Z
        k = max(int(labels.max()) + 1, 1)
    say(f"{args.edge_file}: N={chunked.num_nodes} E={chunked.num_edges}"
        f"{' (undirected storage)' if chunked.undirected else ''} "
        f"K={k} windows={chunked.num_windows}x{chunked.window_edges} "
        f"[{opts.tag()}] on {device}")
    pf = args.prefetch_windows
    cells = []
    if args.backend != "streamed_sharded" or args.compare:
        cells.append(("chunked", lambda: gee_chunked(
            chunked, labels, k, opts, prefetch_windows=pf, device=device)))
    if streamed:
        cells.append((f"streamed x{world}", lambda: gather_rows(
            gee_streamed_sharded(chunked, labels, k, opts,
                                 prefetch_windows=pf, device=device),
            chunked.num_nodes)))
    want = None
    if args.verify:
        want = gee_sparse_torch(chunked.to_edge_list(device=device),
                                torch.from_numpy(labels).to(device), k, opts)
    rc = 0
    for name, fn in cells:
        dt = _time(fn, device)
        z = fn()
        eps = (2 if chunked.undirected else 1) * chunked.num_edges / dt
        say(f"  {name:12s}: {dt*1e3:9.1f} ms   {eps/1e6:8.2f} M edges/s"
            f"   Z[{z.shape[0]}x{z.shape[1]}] "
            f"norm {float(torch.linalg.norm(z.double())):.4f}")
        if want is not None:
            err, off = row_parity(z, want)
            say(f"  parity vs in-memory sparse_torch: max_abs_err "
                f"{err:.3g}, {off} entries off the row tolerance: "
                f"{'ok' if off == 0 else 'FAILED'}")
            rc = rc or int(off > 0)
    return rc


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
    joined = _join_group(args.device)
    try:
        return _run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args) -> int:
    device = resolve_device(args.device)
    world = world_size()
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    def say(line: str) -> None:
        if rank0:
            print(line)

    obs_cli.setup(args)
    opts = GEEOptions(laplacian=args.lap, diag_aug=args.diag,
                      correlation=args.cor)
    if args.edge_file:
        rc = _edge_file(args, opts, device, world, say)
        if rank0:
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
    say(f"{name}: N={edges.num_nodes} E={edges.num_edges//2} K={k} "
        f"[{opts.tag()}] on {device}")

    backends = (("sparse_torch", "chunked", "streamed_sharded", "cuda",
                 "auto", "dense_torch", "scipy", "python_loop")
                if args.compare else (args.backend,))
    # one PreparedGraph for every cell: symmetrized upload, self loops,
    # Laplacian fold, ELL packing and the window manifest are derived once
    prep = PreparedGraph.wrap(edges)
    for b in backends:
        if b == "python_loop" and edges.num_edges > 3_000_000:
            say(f"  {b:12s}: skipped (too slow at this size)")
            continue
        if b == "dense_torch" and edges.num_nodes > 30_000:
            say(f"  {b:12s}: skipped (the O(N^2) oracle at this size)")
            continue
        plan = GEEPlan.build(prep, k, opts, backend=b,
                             chunk_edges=args.chunk_edges,
                             prefetch_windows=args.prefetch_windows)
        if args.plan and not args.trace:
            say("\n".join("  " + ln for ln in plan.describe().splitlines()))
        dt = _time(lambda: plan.execute(labels), device)
        z = plan.execute(labels)
        say(f"  {b:12s}: {dt*1e3:9.1f} ms   Z[{z.shape[0]}x{z.shape[1]}] "
            f"norm {float(torch.linalg.norm(z.double())):.4f}")
        if args.plan and args.trace:
            say("\n".join("  " + ln for ln in
                           plan.describe(timings=True).splitlines()))
    if rank0:
        obs_cli.finish(args)
    return 0


__all__ = ["main", "row_parity", "BACKENDS"]


if __name__ == "__main__":
    raise SystemExit(main())
