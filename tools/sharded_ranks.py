#!/usr/bin/env python3
"""The multi-device folds across the ranks of a real process group, one
device a rank.

    torchrun --standalone --nproc-per-node 4 tools/sharded_ranks.py
    torchrun --standalone --nproc-per-node 2 tools/sharded_ranks.py \\
        --device cpu --sbm 400 --nodes 500 --edges 4000

On the card every rank joins NCCL on its own GPU (``LOCAL_RANK``); with
``--device cpu`` the ranks join gloo.  Every rank builds the same graphs
from a seed: the paper's SBM (``--sbm`` nodes) in memory, and the
``cl-100k-1d8-l5`` stand-in written as a ``.geeb`` by rank 0
(``--nodes`` / ``--edges`` shrink it).  It runs ``gee_distributed`` (both
local backends on the SBM, the scatter on the file's graph) and
``gee_streamed_sharded`` over the file, under all 8 option settings,
gathers each result and holds it against the in-memory ``sparse_torch``
fit on its own device, entry by entry within 1e-5·|want| + 1e-5·min(1,
max |want row|); then it times the file's sharded stream (median of 5,
host clock, each fit ending in a device sync and a barrier).  Rank 0 prints
one line and writes the JSON to ``--out`` (default
``chiprun_out/sharded_ranks.json``).  Exits non-zero if any rank fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

RTOL = ATOL = 1e-5


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max-abs error, raising if an entry is off the row tolerance."""
    g, w = got.double().cpu(), want.double().cpu()
    diff = (g - w).abs()
    tol = RTOL * w.abs() + ATOL * w.abs().amax(dim=1,
                                               keepdim=True).clamp(max=1.0)
    off = int((~(diff <= tol)).sum())
    if off or g.shape != w.shape:
        raise AssertionError(f"{off} entries off the row tolerance")
    return float(diff.max()) if diff.numel() else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo; default: one card a rank (NCCL)")
    ap.add_argument("--sbm", type=int, default=10_000)
    ap.add_argument("--nodes", type=int, default=None,
                    help="the file's nodes (default: cl-100k-1d8-l5's)")
    ap.add_argument("--edges", type=int, default=None,
                    help="the file's undirected entries (default: its)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "sharded_ranks.json"))
    args = ap.parse_args(argv)
    on_cpu = args.device is not None and torch.device(args.device).type \
        == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            print("sharded_ranks: no GPU; pass --device cpu", file=sys.stderr)
            return 1
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if on_cpu else "nccl")
    try:
        return run(args, on_cpu)
    finally:
        dist.destroy_process_group()


def run(args, on_cpu: bool) -> int:
    from repro_torch import resolve_device
    from repro_torch.core.fold import world_size
    from repro_torch.graph.datasets import TABLE2, DatasetSpec, synth_to_disk

    device = resolve_device("cpu" if on_cpu else None)
    rank, world = dist.get_rank(), world_size()
    spec = TABLE2["cl-100k-1d8-l5"]
    spec = DatasetSpec(spec.name, args.nodes or spec.num_nodes,
                       args.edges or spec.num_edges, spec.num_classes)
    # rank 0 writes the file; the others wait for it
    tmp = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(tmp, src=0)
    path = os.path.join(tmp[0], "cl.geeb")
    try:
        if rank == 0:
            synth_to_disk(spec, path, seed=0)
        dist.barrier()
        rc = _measure(args, on_cpu, device, rank, world, spec, path)
        dist.barrier()              # every rank is done with the file
        return rc
    finally:
        if rank == 0:
            shutil.rmtree(tmp[0], ignore_errors=True)


def _measure(args, on_cpu, device, rank, world, spec, path) -> int:
    from repro_torch.core.distributed import gee_distributed
    from repro_torch.core.fold import gather_rows, gee_streamed_sharded
    from repro_torch.core.gee import ALL_OPTION_SETTINGS, GEEOptions
    from repro_torch.core.plan import GEEPlan, PreparedGraph
    from repro_torch.graph.datasets import load_file
    from repro_torch.graph.io import open_window_parallel
    from repro_torch.graph.sbm import sample_sbm

    def fit(prep, labels, k, opts):
        return GEEPlan.build(prep, k, opts,
                             backend="sparse_torch").execute(labels)

    sbm = sample_sbm(args.sbm, seed=0, device=device)
    sbm_prep = PreparedGraph(sbm.edges)
    cl = load_file(path, device=device)
    cl_prep = PreparedGraph(cl.edges)
    files = open_window_parallel(path, world)
    errs = {}
    for name, prep, labels, k, lbs in (
            ("sbm", sbm_prep, sbm.labels, sbm.num_classes,
             ("segment_sum", "cuda")),
            ("cl", cl_prep, cl.labels, spec.num_classes, ("segment_sum",))):
        for lb in lbs:
            e = []
            for opts in ALL_OPTION_SETTINGS:
                z = gather_rows(gee_distributed(prep, labels, k, opts,
                                                local_backend=lb),
                                prep.num_nodes)
                e.append(max_err(z, fit(prep, labels, k, opts)))
            errs[f"gee_distributed {name} {lb}"] = max(e)
    e = []
    for opts in ALL_OPTION_SETTINGS:
        z = gather_rows(gee_streamed_sharded(files, cl.labels,
                                             spec.num_classes, opts,
                                             device=device), files.num_nodes)
        e.append(max_err(z, fit(cl_prep, cl.labels, spec.num_classes, opts)))
    errs["gee_streamed_sharded cl.geeb segment_sum"] = max(e)

    def sync():
        if not on_cpu:
            torch.cuda.synchronize(device)
        dist.barrier()

    times = {}
    for opts in (GEEOptions(), GEEOptions(True, True, True)):
        def once():
            gather_rows(gee_streamed_sharded(files, cl.labels,
                                             spec.num_classes, opts,
                                             device=device), files.num_nodes)
            sync()
        once()
        ts = []
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            once()
            ts.append((time.perf_counter() - t0) * 1e3)
        times[opts.tag()] = {"host_ms_median": float(np.median(ts)),
                             "host_ms": ts}
    names = [None] * world
    dist.all_gather_object(names, "cpu" if on_cpu
                           else torch.cuda.get_device_name(device))
    if rank == 0:
        card = "cpu" if on_cpu else subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        report = {"world": world, "backend": dist.get_backend(),
                  "devices": names, "card": card, "file": spec.name,
                  "nodes": spec.num_nodes, "edges": spec.num_edges,
                  "sbm": args.sbm, "max_abs_err": errs,
                  "streamed_fit": times}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"sharded_ranks: {world} ranks over {report['backend']} "
              f"({card}): 8 settings vs in-memory sparse_torch "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + "; the file's sharded stream (median of "
              f"{args.reps}, host clock) "
              + ", ".join(f"{k} {v['host_ms_median']:.1f} ms"
                          for k, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
