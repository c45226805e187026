"""The configurations' graphs, made on the device from the seed, and the
set-up every loop shares.

A configuration's graph is one fixed structure, drawn from its
``structure_seed`` (a deployment embeds one dataset, not a new one each
run); the run's seed renumbers its vertices and shuffles its edge list, as
a loader might present the same graph.  So every seed does the same work
(the same degrees, degree buckets, classes and cells, in another order),
and the same seed gives the same input.

A graph model is a module of its own, ``perfbench/graphs/<generator>.py``,
found by the name in the configuration's ``generator`` key.  It defines
``draw(cfg, seed, device)``, which returns one entry per undirected edge
(``src``, ``dst``, int32 on the device), the labels (int32 [N]),
``num_nodes`` and ``num_classes``; the program symmetrizes.  A new model
is a new file.  Draw with :func:`generator` on the device, in a few large
calls, so set-up pays milliseconds for what numpy pays seconds.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def draw(cfg: dict, seed: int, device) -> dict:
    """The graph model named by ``cfg["generator"]``, drawn from ``seed``."""
    model = importlib.import_module(f"perfbench.graphs.{cfg['generator']}")
    return model.draw(cfg, seed, device)


def renumber(graph: dict, seed: int, device) -> dict:
    """The same graph with its vertices renumbered and its edges shuffled
    by ``seed``: vertex v becomes ``perm[v]`` (returned) and keeps its
    label."""
    g = generator(seed, device)
    n = graph["num_nodes"]
    perm = torch.randperm(n, generator=g, device=device)
    order = torch.randperm(graph["src"].numel(), generator=g, device=device)
    labels = torch.empty_like(graph["labels"])
    labels[perm] = graph["labels"]
    return dict(graph, src=perm[graph["src"].long()][order].to(torch.int32),
                dst=perm[graph["dst"].long()][order].to(torch.int32),
                labels=labels, perm=perm)


def make(cfg: dict, seed: int, device) -> dict:
    """The configuration's graph (``cfg["structure_seed"]`` draws it),
    renumbered by ``seed``."""
    return renumber(draw(cfg, cfg["structure_seed"], device), seed, device)


def prepare(cfg: dict, seed: int, device, clock) -> SimpleNamespace:
    """Set-up every loop starts with: the graph on the device, symmetrized
    by the program and wrapped in one ``PreparedGraph``; host copies of
    the undirected edges, the labels and the renumbering (``perm``) for
    the traffic and the reference; then the card's peak reset (the
    synthesis's temporaries are not the system's) and the kernel library
    built or found.  Clock phases ``synthesis`` and ``build``."""
    from repro_torch.core.plan import PreparedGraph
    from repro_torch.graph.containers import EdgeList, symmetrize

    device = torch.device(device)
    g = make(cfg, seed, device)
    n, k = g["num_nodes"], g["num_classes"]
    m = int(g["src"].numel())
    base = EdgeList(src=g["src"], dst=g["dst"],
                    weight=torch.ones(m, dtype=torch.float32, device=device),
                    num_nodes=n, num_edges=m)
    host = {"src": g["src"].cpu().numpy(), "dst": g["dst"].cpu().numpy(),
            "labels": g["labels"].cpu().numpy(),
            "perm": g["perm"].cpu().numpy()}
    prepared = PreparedGraph(symmetrize(base))
    del g, base
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    clock.phase("synthesis")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        from repro_torch.kernels.build import load_library
        load_library()
    clock.phase("build")
    return SimpleNamespace(prepared=prepared, host=host, n=n, k=k)


__all__ = ["generator", "draw", "make", "prepare", "renumber"]
