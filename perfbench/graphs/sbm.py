"""``sbm``: the paper's stochastic block model (its Fig. 3 setting): class
priors, one edge probability within a class and one between classes,
every pair i < j drawn once.  The same model as
``repro_torch/graph/sbm.py``, drawn by rows of the Bernoulli matrix
instead of by geometric skips."""

from __future__ import annotations

import torch

from perfbench.graphs import generator

_ROW_BLOCK = 1 << 10


def draw(cfg: dict, seed: int, device) -> dict:
    n = int(cfg["num_nodes"])
    priors = torch.tensor(cfg["priors"], dtype=torch.float64, device=device)
    p_in, p_out = float(cfg["p_within"]), float(cfg["p_between"])
    k = priors.numel()
    g = generator(seed, device)
    cdf = torch.cumsum(priors, 0)
    cdf[-1] = 1.0
    u = torch.rand(n, dtype=torch.float64, generator=g, device=device)
    labels = torch.searchsorted(cdf, u, right=True).clamp(max=k - 1)
    prob = torch.full((k, k), p_out, dtype=torch.float32, device=device)
    prob.fill_diagonal_(p_in)
    cols = torch.arange(n, device=device)
    src, dst = [], []
    for r0 in range(0, n, _ROW_BLOCK):
        r1 = min(n, r0 + _ROW_BLOCK)
        rows = torch.arange(r0, r1, device=device)
        p = prob[labels[r0:r1]][:, labels]
        hit = torch.rand((r1 - r0, n), generator=g, device=device) < p
        hit &= cols[None, :] > rows[:, None]
        i, j = hit.nonzero(as_tuple=True)
        src.append((i + r0).to(torch.int32))
        dst.append(j.to(torch.int32))
    return {"src": torch.cat(src), "dst": torch.cat(dst),
            "labels": labels.to(torch.int32), "num_nodes": n,
            "num_classes": k}
