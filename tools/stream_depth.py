#!/usr/bin/env python3
"""A streamed fit's time at prefetch depths against one another, each depth
in fresh processes, on one GPU.

    python3 tools/stream_depth.py                        # depths 0 and 2
    python3 tools/stream_depth.py --depths 0,2 --rounds 2 --repeats 5

Writes one ``.geeb`` of ``synth_to_disk`` (by default ``chip_smoke.py``'s
scale file: 2,000,000 nodes, 50,000,000 undirected entries, K = 5, 48
windows of 1,048,576) into a temporary directory, then runs one fresh
process a depth, in the order A B B A, ``--rounds`` times, so that drift
over the call falls on both alike.  Each process opens the file, fits it
once with no options and once with all on to warm up, then times
``--repeats`` streamed fits (``gee_chunked``, host clock ending in a
device synchronize) with no options and with all on, and the pipeline
alone (every window read, filled and copied to the device, nothing
folded).  Prints the card's name and power limit, one line
a process and a summary (the median over processes of each process's
median), and writes ``chiprun_out/stream_depth.json``.

``--device cpu`` runs the same at any size on the host (a check that the
script still drives the port; its times are not the card's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = ("scale-2m-50m", 2_000_000, 50_000_000, 5)


def worker(path: str, depth: int, repeats: int, device: str) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.core.chunked import gee_chunked
    from repro_torch.core.gee import GEEOptions
    from repro_torch.graph.io import load_labels, open_edge_list
    from repro_torch.graph.prefetch import prefetch_windows

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    src = open_edge_list(path)
    labels = load_labels(path)
    k = int(labels.max()) + 1
    all_off = GEEOptions()
    all_on = GEEOptions(laplacian=True, diag_aug=True, correlation=True)

    def fit(opts):
        return gee_chunked(src, labels, k, opts, prefetch_windows=depth,
                           device=dev)

    def pipeline():
        for w in prefetch_windows(src, depth, device=dev).windows():
            w.to(dev)

    def times_ms(fn) -> list:
        out = []
        for _ in range(repeats):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    # warm-up: allocator, pinned ring, pages, and the kernels' library (a
    # fit with correlation launches ``row_norm``; the first such launch
    # loads the library, and builds it where no build is cached)
    fit(all_off)
    fit(all_on)
    sync()
    got = {"depth": depth, "windows": src.num_windows,
           "torch_threads": torch.get_num_threads(),
           "no_options_ms": times_ms(lambda: fit(all_off)),
           "all_on_ms": times_ms(lambda: fit(all_on)),
           "pipeline_alone_ms": times_ms(pipeline)}
    for key in ("no_options_ms", "all_on_ms", "pipeline_alone_ms"):
        got[key.replace("_ms", "_median_ms")] = float(np.median(got[key]))
    return got


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", default="0,2")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--nodes", type=int, default=SCALE[1])
    ap.add_argument("--edges", type=int, default=SCALE[2])
    ap.add_argument("--classes", type=int, default=SCALE[3])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "stream_depth.json"))
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--depth", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.depth, args.repeats,
                                args.device)), flush=True)
        return 0

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.graph.datasets import DatasetSpec, synth_to_disk

    depths = [int(d) for d in args.depths.split(",")]
    card = card_line()
    print(card, flush=True)
    spec = DatasetSpec(SCALE[0], args.nodes, args.edges, args.classes)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scale.geeb")
        t0 = time.perf_counter()
        synth_to_disk(spec, path, seed=0)
        write_s = time.perf_counter() - t0
        order = []
        for _ in range(args.rounds):
            order += depths + depths[::-1]
        for depth in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", path,
                 "--depth", str(depth), "--repeats", str(args.repeats),
                 "--device", args.device],
                capture_output=True, text=True, timeout=900, cwd=ROOT)
            if proc.returncode != 0:
                raise SystemExit(f"depth {depth} failed "
                                 f"(rc {proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(got)
            print(f"depth {depth}: no options "
                  f"{got['no_options_median_ms']:.1f} ms, all on "
                  f"{got['all_on_median_ms']:.1f}, pipeline alone "
                  f"{got['pipeline_alone_median_ms']:.1f} (medians of "
                  f"{args.repeats}; no options "
                  + " ".join(f"{t:.1f}" for t in got["no_options_ms"])
                  + ")", flush=True)
    summary = {}
    for depth in depths:
        mine = [r for r in runs if r["depth"] == depth]
        summary[depth] = {
            key: float(np.median([r[f"{key}_median_ms"] for r in mine]))
            for key in ("no_options", "all_on", "pipeline_alone")}
    print(f"{spec.name} N={spec.num_nodes} E={spec.num_edges} "
          f"K={spec.num_classes}, written in {write_s:.1f} s, "
          f"{runs[0]['windows']} windows, {args.device} ({card}); median "
          f"over {len(order) // len(depths)} processes a depth: "
          + "; ".join(f"depth {d}: no options {s['no_options']:.1f} ms, all "
                      f"on {s['all_on']:.1f}, pipeline alone "
                      f"{s['pipeline_alone']:.1f}"
                      for d, s in summary.items()), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "device": args.device,
                   "spec": [spec.name, spec.num_nodes, spec.num_edges,
                            spec.num_classes],
                   "write_s": write_s, "order": order, "runs": runs,
                   "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
