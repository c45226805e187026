"""Vertex-similarity retrieval driver: build an index, replay a query stream
(port of ``repro/launch/gee_search.py``).

Embeds a graph (an SBM, a Table 2 stand-in, or an edge file streamed in
bounded memory), builds the class-partitioned index over Z, replays a
stream of vertex-id queries through the batched ``GEEQueryService`` and
reports build time, QPS, per-flush latency percentiles and recall@k
against exact brute force on a sample.  Runs on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.gee_search --sbm 5000 \\
      --queries 2000
  PYTHONPATH=src python -m repro_torch.launch.gee_search --sbm 2000 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.gee_search --dataset citeseer \\
      --nprobe 2 --k 20
  PYTHONPATH=src python -m repro_torch.launch.gee_search --edge-file g.geeb \\
      --chunk-edges 1048576 --queries 10000
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.api import GEEEmbedder
from repro_torch.core.gee import GEEOptions
from repro_torch.graph.datasets import TABLE2, load
from repro_torch.graph.io import load_labels
from repro_torch.graph.sbm import sample_sbm
from repro_torch.obs import cli as obs_cli
from repro_torch.search.service import GEEQueryService


def recall_at_k(got_ids: np.ndarray, got_scores: np.ndarray,
                exact_ids: np.ndarray, exact_scores: np.ndarray,
                tol: float = 1e-5) -> float:
    """Mean fraction of retrieved ids that belong in the exact top-k.

    Tie-tolerant: a retrieved id whose score reaches the k-th exact score
    within ``tol`` counts even when the id differs -- equal-score
    candidates are interchangeable.
    """
    k = got_ids.shape[1]
    exact_sets = [set(int(x) for x in row if x >= 0) for row in exact_ids]
    hits = 0.0
    for i in range(got_ids.shape[0]):
        kth = exact_scores[i, -1]
        ok = sum(1 for x, s in zip(got_ids[i], got_scores[i])
                 if int(x) >= 0 and (int(x) in exact_sets[i]
                                     or s >= kth - tol))
        hits += min(ok, k) / k
    return hits / max(got_ids.shape[0], 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sbm", type=int, default=None,
                    help="SBM node count (paper's simulation)")
    ap.add_argument("--dataset", default=None,
                    help=f"one of {sorted(TABLE2)}")
    ap.add_argument("--edge-file", default=None,
                    help="embed an on-disk edge list out-of-core first "
                         "(any repro_torch.graph.io format; labels from the "
                         "<file>.labels.npy sidecar)")
    ap.add_argument("--chunk-edges", type=int, default=None,
                    help="streaming window for --edge-file")
    ap.add_argument("--metric", default="l2", choices=("l2", "cosine"))
    ap.add_argument("--nprobe", type=int, default=None,
                    help="cells scanned per query (default ceil(sqrt(C)))")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=1000,
                    help="total vertex-id queries replayed")
    ap.add_argument("--batch", type=int, default=64,
                    help="service flush threshold (queries per batch)")
    ap.add_argument("--recall-sample", type=int, default=200,
                    help="queries checked against exact brute force")
    ap.add_argument("--lap", action="store_true")
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--cor", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    ap.add_argument("--json", type=str, default="",
                    help="also write a JSON report here")
    obs_cli.add_flags(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    obs_cli.setup(args)

    opts = GEEOptions(laplacian=args.lap, diag_aug=args.diag,
                      correlation=args.cor)
    if not (args.lap or args.diag or args.cor):
        opts = GEEOptions(laplacian=True, diag_aug=True, correlation=True)

    t0 = time.perf_counter()
    if args.edge_file:
        labels = load_labels(args.edge_file)
        if labels is None:
            raise SystemExit(f"--edge-file needs a labels sidecar "
                             f"({args.edge_file}.labels.npy)")
        emb = GEEEmbedder(num_classes=max(int(labels.max()) + 1, 1),
                          options=opts, device=str(device),
                          chunk_edges=args.chunk_edges)
        emb.fit_file(args.edge_file, labels)
        name = args.edge_file
    else:
        if args.sbm:
            s = sample_sbm(args.sbm, seed=args.seed, device=device)
            edges, labels, k_cls = s.edges, s.labels, s.num_classes
            name = f"sbm-{args.sbm}"
        else:
            ds = load(args.dataset or "citeseer", seed=args.seed,
                      device=device)
            edges, labels, k_cls = ds.edges, ds.labels, ds.spec.num_classes
            name = ds.spec.name
        emb = GEEEmbedder(num_classes=k_cls, options=opts,
                          device=str(device)).fit(edges, labels)
    z = emb.transform()
    _sync(device)
    t_embed = time.perf_counter() - t0
    n = int(z.shape[0])

    t0 = time.perf_counter()
    index = emb.build_index(metric=args.metric, nprobe=args.nprobe)
    _sync(device)
    t_build = time.perf_counter() - t0
    print(f"{name}: N={n} K={emb.num_classes} [{opts.tag()}] on {device}  "
          f"embed {t_embed*1e3:.1f} ms, index build {t_build*1e3:.1f} ms  "
          f"(C={index.num_cells} cells, bucket cap "
          f"{index.bucket_capacity}, padding "
          f"{index.padding_fraction()*100:.0f}%, nprobe={index.nprobe})")

    rng = np.random.default_rng(args.seed)
    qrows = rng.integers(0, n, args.queries)
    z_host = z.cpu().numpy()
    service = GEEQueryService(index, None, flush_every=args.batch,
                              nprobe=args.nprobe, default_k=args.k)
    # warm the search path outside the timed replay
    service.search(z_host[qrows[: min(args.batch, args.queries)]], k=args.k)
    service.stats["flush_ms"].clear()

    t0 = time.perf_counter()
    for lo in range(0, args.queries, args.batch):
        service.submit_rows(qrows[lo:lo + args.batch])
    service.flush()
    wall = time.perf_counter() - t0
    lat = np.asarray(service.stats["flush_ms"])
    qps = args.queries / wall
    print(f"  replay: {args.queries} queries in {wall*1e3:.1f} ms  "
          f"({qps:,.0f} QPS)  flush latency p50={np.percentile(lat, 50):.2f}"
          f" ms p95={np.percentile(lat, 95):.2f} ms")

    m = min(args.recall_sample, args.queries)
    sample = z_host[qrows[:m]]
    ids_ivf, sc_ivf = index.search(sample, args.k, nprobe=args.nprobe)
    ids_bf, sc_bf = index.search(sample, args.k, brute_force=True)
    rec = recall_at_k(ids_ivf.cpu().numpy(), sc_ivf.cpu().numpy(),
                      ids_bf.cpu().numpy(), sc_bf.cpu().numpy())
    print(f"  recall@{args.k} vs brute force ({m} queries): {rec:.4f}")

    report = {"graph": name, "nodes": n, "num_cells": index.num_cells,
              "nprobe": index.nprobe if args.nprobe is None else args.nprobe,
              "metric": args.metric, "k": args.k, "device": str(device),
              "t_embed_s": t_embed, "t_build_s": t_build,
              "qps": qps, "flush_ms_p50": float(np.percentile(lat, 50)),
              "flush_ms_p95": float(np.percentile(lat, 95)),
              "recall_at_k": rec,
              "service_stats": {kk: vv for kk, vv in service.stats.items()
                                if kk != "flush_ms"}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"  wrote {args.json}")
    obs_cli.finish(args)
    return report


if __name__ == "__main__":
    main()
