#!/usr/bin/env python3
"""Flush latency of the port's query service, for one tree or several in
turn, on one GPU.

    python3 tools/flush_replay.py                          # this checkout
    python3 tools/flush_replay.py --trees OTHER . --rounds 2

For each tree (a checkout of this repo; ``.`` is this one) a fresh process
imports that tree's ``repro_torch``, builds its kernels, fits sbm-10k
(``sample_sbm(10_000, seed=0)``) and cl-100k-1d8-l5 (``synth_like``, seed 0)
with the default options, builds an l2 index on each, and replays 4,096
vertex-id queries through ``GEEQueryService`` in flushes of 64, top 10, as
``chip_smoke.py``'s phase 8 does: one replay fused and one staged to warm
up, then ``--replays`` of each, every replay's flush p50 / p95 (host clock)
and QPS kept.  It also times one flush's device work (``index.search`` on
64 queries already on the device, by CUDA events) and, with ``--profile``,
records one fused replay with ``torch.profiler``: the device's busy time a
flush and its idle share of the unprofiled p50.  With ``--edge-cases`` (a
tree whose ``chip_smoke.py`` has them) the sbm-10k replays run again after
``chip_smoke.py``'s phase-3c edge cases of ``scored_topk`` and
``pairwise_scores``.

With several trees, the processes run in the order A B B A, ``--rounds``
times, so that drift over the call falls on both alike.  Prints a summary and
writes ``chiprun_out/flush_replay.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_QUERIES, FLUSH, TOP_K = 4096, 64, 10
GRAPHS = ("sbm-10k", "cl-100k-1d8-l5")


def worker(tree: str, replays: int, profile: bool, edge_cases: bool) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.core.api import GEEEmbedder
    from repro_torch.core.plan import PreparedGraph
    from repro_torch.graph.datasets import TABLE2, synth_like
    from repro_torch.graph.sbm import sample_sbm
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.gee_fused import ENV_FUSED
    from repro_torch.search.service import GEEQueryService

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    load_library()
    dev = torch.device("cuda")

    def replay(index, rows, fused: bool):
        os.environ[ENV_FUSED] = "1" if fused else "0"
        try:
            svc = GEEQueryService(index, None, flush_every=FLUSH,
                                  default_k=TOP_K)
            t0 = time.perf_counter()
            for lo in range(0, rows.size, FLUSH):
                svc.submit_rows(rows[lo:lo + FLUSH])
            svc.flush()
            wall = time.perf_counter() - t0
            lat = np.asarray(svc.stats["flush_ms"])
            svc.close()
        finally:
            del os.environ[ENV_FUSED]
        return {"p50": float(np.percentile(lat, 50)),
                "p95": float(np.percentile(lat, 95)),
                "qps": N_QUERIES / wall}

    def replays_of(index, rows) -> dict:
        replay(index, rows, True)   # warm-up
        replay(index, rows, False)
        out = {"fused": [], "staged": []}
        for _ in range(replays):
            out["fused"].append(replay(index, rows, True))
            out["staged"].append(replay(index, rows, False))
        return out

    def device_ms(index, rows) -> float:
        q = index.z[torch.from_numpy(rows[:FLUSH]).to(dev)].contiguous()
        os.environ[ENV_FUSED] = "1"
        try:
            for _ in range(3):
                index.search(q, TOP_K)
            torch.cuda.synchronize()
            times = []
            for _ in range(20):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(1_000_000)
                a.record()
                index.search(q, TOP_K)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
        finally:
            del os.environ[ENV_FUSED]
        return float(np.median(times))

    def busy_ms(index, rows) -> float | None:
        """Device busy time a flush over one profiled fused replay (the
        union of its kernels' and copies' intervals), or None when the
        profiler recorded no device activity."""
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        os.environ[ENV_FUSED] = "1"
        try:
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                svc = GEEQueryService(index, None, flush_every=FLUSH,
                                      default_k=TOP_K)
                for lo in range(0, rows.size, FLUSH):
                    svc.submit_rows(rows[lo:lo + FLUSH])
                svc.flush()
                svc.close()
                torch.cuda.synchronize()
        finally:
            del os.environ[ENV_FUSED]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if not spans:
            return None
        total, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        total += cur_e - cur_s
        return total / 1e3 / (N_QUERIES // FLUSH)

    t0 = time.perf_counter()
    sbm = sample_sbm(10_000, seed=0)
    cl = synth_like(TABLE2["cl-100k-1d8-l5"], seed=0)
    graphs = {"sbm-10k": (sbm.edges, sbm.labels, sbm.num_classes),
              "cl-100k-1d8-l5": (cl.edges, cl.labels, cl.spec.num_classes)}
    result = {"tree": tree, "setup_s": None, "graphs": {}}
    for g, (edges, labels, k) in graphs.items():
        emb = GEEEmbedder(num_classes=k).fit(PreparedGraph(edges), labels)
        emb.transform()
        index = emb.build_index(metric="l2")
        torch.cuda.synchronize()
        rows = np.random.default_rng(2).integers(0, edges.num_nodes,
                                                 N_QUERIES)
        entry = replays_of(index, rows)
        entry["device_ms_a_flush"] = device_ms(index, rows)
        if profile:
            entry["busy_ms_a_flush"] = busy_ms(index, rows)
        if edge_cases and g == "sbm-10k":
            entry["after_edge_cases"] = after_edge_cases(tree, torch, index,
                                                         rows, replays_of)
        result["graphs"][g] = entry
    result["setup_s"] = time.perf_counter() - t0
    return result


def after_edge_cases(tree, torch, index, rows, replays_of) -> dict | str:
    """The replays again, right after the tree's ``chip_smoke.py`` phase-3c
    edge cases of ``scored_topk`` and ``pairwise_scores``."""
    from collections import defaultdict

    sys.path.insert(0, tree)
    import chip_smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_score as ts

    if not hasattr(chip_smoke, "scored_topk_edge_cases"):
        return "this tree's chip_smoke.py has no such edge cases"
    errs = defaultdict(list)
    chip_smoke.scored_topk_edge_cases(torch, ts, ref, errs)
    chip_smoke.pairwise_edge_cases(torch, ts, ref, errs)
    torch.cuda.synchronize()
    return replays_of(index, rows)


def summary(runs: list) -> list[str]:
    lines = []
    for label in dict.fromkeys(r["label"] for r in runs):
        mine = [r for r in runs if r["label"] == label]
        for g in GRAPHS:
            for route in ("fused", "staged"):
                p50 = [x["p50"] for r in mine
                       for x in r["graphs"][g][route]]
                qps = [x["qps"] for r in mine
                       for x in r["graphs"][g][route]]
                lines.append(
                    f"{label} {g} {route}: flush p50 median "
                    f"{np.median(p50):.4f} ms (min {min(p50):.4f}, max "
                    f"{max(p50):.4f}, {len(p50)} replays), QPS median "
                    f"{np.median(qps):,.0f}")
            dev = [r["graphs"][g]["device_ms_a_flush"] for r in mine]
            busy = [r["graphs"][g].get("busy_ms_a_flush") for r in mine]
            busy = [b for b in busy if b is not None]
            lines.append(
                f"{label} {g}: device time of a fused flush's search "
                f"{np.median(dev):.4f} ms"
                + (f"; device busy {np.median(busy):.4f} ms a flush in a "
                   f"profiled replay" if busy else ""))
            after = [r["graphs"][g].get("after_edge_cases") for r in mine]
            after = [a for a in after if isinstance(a, dict)]
            if after:
                p50 = [x["p50"] for a in after for x in a["fused"]]
                lines.append(f"{label} {g} fused after the edge cases: flush "
                             f"p50 median {np.median(p50):.4f} ms (min "
                             f"{min(p50):.4f}, max {max(p50):.4f})")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--replays", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--edge-cases", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        res = worker(args.worker, args.replays, args.profile, args.edge_cases)
        with open(args.out, "w") as f:
            json.dump(res, f)
        return 0

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    trees = [os.path.abspath(os.path.join(ROOT, t)) for t in args.trees]
    labels = {t: name for t, name in zip(trees, args.trees)}
    order = trees + trees[::-1] if len(trees) > 1 else trees
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for rnd in range(args.rounds):
        for i, tree in enumerate(order):
            tmp = os.path.join(out_dir, f"flush_replay_{rnd}_{i}.json")
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   tree, "--out", tmp, "--replays", str(args.replays)]
            cmd += ["--profile"] * args.profile
            cmd += ["--edge-cases"] * args.edge_cases
            subprocess.run(cmd, check=True)
            with open(tmp) as f:
                run = json.load(f)
            os.remove(tmp)
            run["label"], run["position"] = labels[tree], len(runs)
            runs.append(run)
            g = run["graphs"]["sbm-10k"]["fused"]
            print(f"run {len(runs)} {labels[tree]}: sbm-10k fused p50 "
                  + " ".join(f"{x['p50']:.4f}" for x in g), flush=True)
    lines = summary(runs)
    print("\n".join(lines))
    with open(os.path.join(out_dir, "flush_replay.json"), "w") as f:
        json.dump({"card": card, "runs": runs, "summary": lines}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
