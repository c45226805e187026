"""``synth_like``: the stand-in of a Network Repository graph of the
paper's Table 2 that ``repro_torch/graph/datasets.py::synth_like`` makes:
uniform labels, E undirected edges whose two endpoints are drawn from
weights ``1/sqrt(1 + rank)`` over a shuffled rank, self loops redrawn as
an offset of 1..N-1 from the source (duplicate edges kept)."""

from __future__ import annotations

import torch

from perfbench.graphs import generator


def draw(cfg: dict, seed: int, device) -> dict:
    n, e = int(cfg["num_nodes"]), int(cfg["num_edges"])
    k = int(cfg["num_classes"])
    g = generator(seed, device)
    labels = torch.randint(0, k, (n,), generator=g, device=device,
                           dtype=torch.int64)
    w = 1.0 / torch.sqrt(1.0 + torch.arange(n, dtype=torch.float64,
                                            device=device))
    w = w[torch.randperm(n, generator=g, device=device)]
    cdf = torch.cumsum(w / w.sum(), 0)
    cdf[-1] = 1.0

    def endpoints():
        u = torch.rand(e, dtype=torch.float64, generator=g, device=device)
        return torch.searchsorted(cdf, u, right=True).clamp(max=n - 1)

    src, dst = endpoints(), endpoints()
    loops = src == dst
    shift = torch.randint(0, n - 1, (e,), generator=g, device=device)
    dst = torch.where(loops, (src + 1 + shift) % n, dst)
    return {"src": src.to(torch.int32), "dst": dst.to(torch.int32),
            "labels": labels.to(torch.int32), "num_nodes": n,
            "num_classes": k}
