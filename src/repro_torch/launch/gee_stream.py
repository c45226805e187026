"""Edge-stream replay CLI: incremental GEE against a from-scratch
recompute (port of ``repro/launch/gee_stream.py``).

Holds out a fraction of a graph's undirected edges, promotes the rest into
an ``IncrementalGEE``, then replays the held-out edges (plus label churn)
through the coalescing ``GEEDeltaServer`` in fixed-size batches, timing
every update.  ``--verify-every`` checks the streamed state against a
from-scratch ``sparse_torch`` fit of the mutated graph and times it, so the
output reports the update-against-recompute gap the incremental subsystem
exists for.  ``--queries Q`` also serves Q vertex-id queries a batch from a
live index (a ``GEEQueryService`` subscribed to the state), timing the
index repair and the query flush apart.  Runs on the card unless
``--device cpu`` is given; the accumulators stay on the host, the Z cache
and the index on the device.

  PYTHONPATH=src python -m repro_torch.launch.gee_stream --sbm 2000 \\
      --stream-frac 0.2 --batch 64 --lap --diag --cor
  PYTHONPATH=src python -m repro_torch.launch.gee_stream --sbm 800 \\
      --device cpu --queries 64

Crash safety: with ``--snapshot-dir`` every batch commits as one atomic
WAL record before it is applied, a consistent snapshot (state, vertex
index, watermark) is taken every ``--snapshot-every`` batches, and
``--recover`` resumes a killed run from the newest snapshot and a WAL
replay, with the RNG at the same position, so the resumed stream ends
where an uninterrupted one does.  The directory's files are the
reference's: a run of either package resumes in the other.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.gee import GEEOptions, gee_sparse_torch
from repro_torch.core.incremental import IncrementalGEE
from repro_torch.graph.containers import edge_list_from_numpy, symmetrize
from repro_torch.graph.datasets import TABLE2, load
from repro_torch.graph.delta import (edge_delta_from_numpy,
                                     label_delta_from_numpy,
                                     symmetrize_delta)
from repro_torch.graph.sbm import sample_sbm
from repro_torch.obs import cli as obs_cli
from repro_torch.search.index import ClassPartitionedIndex
from repro_torch.search.service import GEEDeltaServer, GEEQueryService
from repro_torch.serve.snapshot import GEESnapshotter, recover


def _undirected_pairs(edges):
    """Valid directed entries -> one row per undirected edge (src <= dst)."""
    src, dst, w = edges.valid_arrays()
    keep = src <= dst
    return src[keep], dst[keep], w[keep]


def prepare_stream(args):
    """Deterministic stream setup shared by fresh and recovered runs: load
    the graph (on the host), permute the undirected edges with the seeded
    RNG, split base and stream -- the reference's draws, so one seed gives
    both packages the same stream.  Returns a dict; ``rng`` is positioned
    right after the permutation draw, so per-batch label draws replay
    identically across runs."""
    if args.sbm:
        s = sample_sbm(args.sbm, seed=args.seed, device="cpu")
        edges, labels, k = s.edges, s.labels, s.num_classes
        name = f"sbm-{args.sbm}"
    else:
        ds = load(args.dataset or "citeseer", seed=args.seed, device="cpu")
        edges, labels, k = ds.edges, ds.labels, ds.spec.num_classes
        name = ds.spec.name
    opts = GEEOptions(laplacian=args.lap, diag_aug=args.diag,
                      correlation=args.cor)
    rng = np.random.default_rng(args.seed)
    su, du, wu = _undirected_pairs(edges)
    perm = rng.permutation(su.size)
    su, du, wu = su[perm], du[perm], wu[perm]
    n_stream = int(round(su.size * args.stream_frac))
    n_base = su.size - n_stream
    base = symmetrize(edge_list_from_numpy(
        su[:n_base], du[:n_base], wu[:n_base], edges.num_nodes,
        device="cpu"))
    return dict(name=name, edges=edges, labels=labels, k=k, opts=opts,
                rng=rng, su=su, du=du, wu=wu, n_stream=n_stream,
                n_base=n_base, base=base)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sbm", type=int, default=None)
    ap.add_argument("--dataset", default=None,
                    help=f"one of {sorted(TABLE2)}")
    ap.add_argument("--stream-frac", type=float, default=0.2,
                    help="fraction of undirected edges replayed as a stream")
    ap.add_argument("--batch", type=int, default=64,
                    help="undirected edge inserts per delta batch")
    ap.add_argument("--label-frac", type=float, default=0.02,
                    help="label flips per batch, as a fraction of --batch")
    ap.add_argument("--verify-every", type=int, default=20,
                    help="full-recompute check every this many batches")
    ap.add_argument("--max-batches", type=int, default=None,
                    help="cap on stream batches")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="start no batch after the stream has run this "
                         "long")
    ap.add_argument("--queries", type=int, default=0,
                    help="vertex-id queries served a batch from a live "
                         "index (repaired before each query flush)")
    ap.add_argument("--k", type=int, default=10,
                    help="neighbors a query (with --queries)")
    ap.add_argument("--lap", action="store_true")
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--cor", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    ap.add_argument("--snapshot-dir", default=None,
                    help="run crash-safe: WAL every batch + periodic "
                         "snapshots under this directory")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="batches between snapshots (with --snapshot-dir)")
    ap.add_argument("--recover", action="store_true",
                    help="resume from the newest snapshot in --snapshot-dir "
                         "(+ WAL replay) instead of starting fresh")
    obs_cli.add_flags(ap)
    args = ap.parse_args(argv)
    if args.recover and not args.snapshot_dir:
        ap.error("--recover requires --snapshot-dir")
    return args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms_summary(ts) -> str:
    ts = np.asarray(ts) if len(ts) else np.zeros(1)
    return (f"mean={ts.mean():.2f} ms p50={np.percentile(ts, 50):.2f} ms "
            f"p95={np.percentile(ts, 95):.2f} ms")


def run(args, around_batches=None) -> dict:
    """Run the stream ``args`` describe (``parse_args``); print progress and
    return the numbers, with the live ``inc`` and ``index`` (None without
    ``--queries`` or ``--snapshot-dir``).  ``around_batches`` is a context
    manager entered around the batch loop alone (a profiler, say)."""
    device = resolve_device(args.device)
    st = prepare_stream(args)
    name, edges, labels, k, opts = (st["name"], st["edges"], st["labels"],
                                    st["k"], st["opts"])
    rng, su, du, wu = st["rng"], st["su"], st["du"], st["wu"]
    n_stream, n_base = st["n_stream"], st["n_base"]
    print(f"{name}: N={edges.num_nodes} K={k} [{opts.tag()}] on {device}  "
          f"base E={n_base} streaming E={n_stream} in batches of {args.batch}")

    n_labels = max(1, int(round(args.batch * args.label_frac))) \
        if args.label_frac > 0 else 0
    n_batches = -(-n_stream // args.batch)
    if args.max_batches is not None:
        n_batches = min(n_batches, args.max_batches)
    snapshotter = index = service = None
    start_batch = 0
    promote_ms = None

    if args.recover:
        t0 = time.perf_counter()
        rec = recover(args.snapshot_dir, device=device)
        inc, index = rec.inc, rec.index
        # Resume position: the snapshot records the last batch folded into
        # it; WAL records replayed past it may carry a later one.
        start_batch = max(int(rec.extra.get("batch", -1)),
                          int(rec.last_meta.get("batch", -1))) + 1
        print(f"  recovered snapshot step {rec.snapshot_step} "
              f"(watermark {rec.snapshot_watermark}) + "
              f"{rec.replayed_deltas} replayed deltas in "
              f"{(time.perf_counter()-t0)*1e3:.1f} ms; "
              f"resuming at batch {start_batch}/{n_batches}")
        if args.trace:
            for ev in rec.timeline:
                print(f"    recovery: {ev}")
        # Replay the RNG draws the applied batches consumed, so the resumed
        # stream continues the exact sequence of the uninterrupted run.
        for _ in range(start_batch if n_labels else 0):
            rng.integers(0, edges.num_nodes, n_labels)
            rng.integers(0, k, n_labels)
        if index is not None:
            service = GEEQueryService(index, inc, flush_every=10**9,
                                      default_k=args.k)
        snapshotter = GEESnapshotter(args.snapshot_dir,
                                     every=args.snapshot_every)
        snapshotter.log = rec.log              # reuse the scanned WAL handle
    else:
        t0 = time.perf_counter()
        inc = IncrementalGEE.from_graph(st["base"], labels, k, opts,
                                        device=device)
        promote_ms = (time.perf_counter() - t0) * 1e3
        inc.embedding()
        _sync(device)
        print(f"  promotion (from_graph) {promote_ms:.1f} ms; with the "
              f"first materialize {(time.perf_counter()-t0)*1e3:.1f} ms")

    if (args.snapshot_dir or args.queries) and index is None:
        t0 = time.perf_counter()
        index = ClassPartitionedIndex.build(inc.embedding(), inc.labels, k)
        _sync(device)
        print(f"  index build {(time.perf_counter()-t0)*1e3:.1f} ms")
        service = GEEQueryService(index, inc, flush_every=10**9,
                                  default_k=args.k)
    if args.snapshot_dir and snapshotter is None:
        snapshotter = GEESnapshotter(args.snapshot_dir,
                                     every=args.snapshot_every)
        # Baseline snapshot before any stream batch: a kill during batch 0
        # still recovers (to the base fit) instead of refitting.
        snapshotter.snapshot(inc, index, service=service,
                             extra={"batch": -1})

    if snapshotter is not None:
        # One explicit flush per stream batch -> the batch's edge and label
        # deltas commit as ONE atomic WAL record (no torn batches at a
        # kill point); auto-flush would split them.
        server = GEEDeltaServer(inc, flush_every=10**9, log=snapshotter.log)
    else:
        server = GEEDeltaServer(inc, flush_every=args.batch)

    qrng = np.random.default_rng(args.seed + 1)    # apart from the stream's
    y = inc.labels.copy() if args.recover else labels.copy()
    update_ts, recompute_ts, max_err = [], [], 0.0
    repair_ts, repair_rows, repair_moves, query_ts = [], [], [], []
    rows_recomputed, row_edges_scanned = [], []
    t_stream = time.perf_counter()
    with around_batches or contextlib.nullcontext():
        for b in range(start_batch, n_batches):
            if args.max_seconds is not None and \
                    time.perf_counter() - t_stream > args.max_seconds:
                break
            lo, hi = n_base + b * args.batch, n_base + min(
                (b + 1) * args.batch, n_stream)
            delta = symmetrize_delta(edge_delta_from_numpy(
                su[lo:hi], du[lo:hi], wu[lo:hi]))
            recomputed0 = inc.stats["rows_recomputed"]
            scanned0 = inc.stats["row_edges_scanned"]
            t0 = time.perf_counter()
            server.meta = {"batch": b}
            server.submit(delta)
            if n_labels:
                nodes = rng.integers(0, edges.num_nodes, n_labels)
                newl = rng.integers(0, k, n_labels).astype(np.int32)
                server.submit(label_delta_from_numpy(nodes, newl))
                y[nodes] = newl
            server.flush()
            server.embed()
            _sync(device)
            update_ts.append(time.perf_counter() - t0)
            rows_recomputed.append(inc.stats["rows_recomputed"] - recomputed0)
            row_edges_scanned.append(inc.stats["row_edges_scanned"]
                                     - scanned0)
            if args.queries:
                moves0 = service.stats["bucket_moves"]
                t0 = time.perf_counter()
                repair_rows.append(service.repair())
                _sync(device)
                repair_ts.append(time.perf_counter() - t0)
                repair_moves.append(service.stats["bucket_moves"] - moves0)
                t0 = time.perf_counter()
                service.submit_rows(qrng.integers(0, edges.num_nodes,
                                                  args.queries))
                service.flush()                # ends in the copy to host
                query_ts.append(time.perf_counter() - t0)
            if snapshotter is not None:
                snapshotter.tick(inc, index, service=service,
                                 delta_server=server, extra={"batch": b})

            if args.verify_every and (b + 1) % args.verify_every == 0:
                cur = inc.to_edge_list()
                yt = torch.from_numpy(y).to(device)
                zr = gee_sparse_torch(cur, yt, k, opts)   # warm-up
                _sync(device)
                t0 = time.perf_counter()
                zr = gee_sparse_torch(cur, yt, k, opts)
                _sync(device)
                recompute_ts.append(time.perf_counter() - t0)
                err = float((inc.embedding() - zr).abs().max())
                max_err = max(max_err, err)
                print(f"  batch {b+1:4d}/{n_batches}: verify "
                      f"max_err={err:.2e}  "
                      f"recompute={recompute_ts[-1]*1e3:.1f} ms")
    stream_s = time.perf_counter() - t_stream

    if snapshotter is not None:
        # Final snapshot at the stream end, then release the writer thread.
        snapshotter.snapshot(inc, index, service=service,
                             delta_server=server,
                             extra={"batch": n_batches - 1})
        print(f"  snapshotter stats: {snapshotter.stats}  "
              f"wal head_seq={snapshotter.log.head_seq}")
        snapshotter.close()
    if service is not None:
        service.close()

    ts = np.asarray(update_ts) * 1e3 if update_ts else np.zeros(1)
    print(f"  update latency over {len(update_ts)} batches: "
          f"{_ms_summary(ts)}")
    if args.queries and update_ts:
        print(f"  index repair {_ms_summary(np.asarray(repair_ts) * 1e3)} "
              f"({int(np.sum(repair_rows))} rows, "
              f"{int(np.sum(repair_moves))} bucket moves); query flush of "
              f"{args.queries}: {_ms_summary(np.asarray(query_ts) * 1e3)}")
    if recompute_ts:
        rc = float(np.mean(recompute_ts)) * 1e3
        print(f"  full recompute: {rc:.2f} ms -> "
              f"update/recompute = {ts.mean()/rc:.2f}x  "
              f"(max verify err {max_err:.2e})")
    print(f"  server stats: {server.stats}")
    print(f"  incremental stats: {inc.stats}")
    return {"update_ms_mean": float(ts.mean()),
            "update_ms": [t * 1e3 for t in update_ts],
            "recompute_ms": float(np.mean(recompute_ts)) * 1e3
            if recompute_ts else None,
            "max_err": max_err,
            "batches_run": len(update_ts),
            "stream_s": stream_s,
            "watermark": int(inc.applied_seq),
            "promote_ms": promote_ms,
            "rows_recomputed": rows_recomputed,
            "row_edges_scanned": row_edges_scanned,
            "repair_ms": [t * 1e3 for t in repair_ts],
            "repair_rows": repair_rows, "repair_moves": repair_moves,
            "query_ms": [t * 1e3 for t in query_ts],
            "inc": inc, "index": index}


def main(argv=None):
    args = parse_args(argv)
    obs_cli.setup(args)
    out = run(args)
    obs_cli.finish(args)
    return {k: v for k, v in out.items() if k not in ("inc", "index")}


if __name__ == "__main__":
    main()
