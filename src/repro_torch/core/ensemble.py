"""GEE-based vertex clustering (the encoder ensemble), port of
``repro/core/ensemble.py``.

Alternate a GEE embedding with nearest-centroid relabelling until the
labels stop changing, over several random restarts, and keep the replicate
with the smallest within-cluster sum of squares.  The embedding is the
plain ``gee_sparse_torch`` scatter over prep shared by every restart, as
the reference uses its segment-sum path.

Restarts are drawn from a ``torch.Generator``; the reference draws them
with ``jax.random``, so the two packages start from other labels for the
same seed and agree only in what they recover.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gee import GEEOptions, gee_sparse_torch
from repro_torch.core.plan import PreparedGraph

_DEFAULT_OPTS = GEEOptions(laplacian=True, diag_aug=True, correlation=True)


@dataclasses.dataclass(frozen=True)
class ClusterResult:
    labels: torch.Tensor     # [N] int32 cluster assignment
    embedding: torch.Tensor  # [N, K] final embedding
    score: torch.Tensor      # scalar: mean within-cluster SSE (lower=better)
    iters: torch.Tensor      # iterations until convergence


def _assign_nearest_centroid(z: torch.Tensor, labels: torch.Tensor, k: int):
    """One refinement sweep: class means of Z, then the nearest-mean
    relabel and its mean squared distance."""
    valid = (labels >= 0) & (labels < k)
    onehot = torch.zeros((z.shape[0], k), dtype=z.dtype, device=z.device)
    onehot[valid, labels[valid].long()] = 1.0
    counts = onehot.sum(0)
    means = (onehot.T @ z) / torch.clamp(counts, min=1.0)[:, None]
    # empty clusters: a mean at infinity, so nothing is assigned to them
    means = torch.where((counts > 0)[:, None], means,
                        torch.full_like(means, float("inf")))
    d2 = torch.sum((z[:, None, :] - means[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(torch.isnan(d2), torch.full_like(d2, float("inf")), d2)
    best, new = torch.min(d2, dim=-1)
    score = torch.where(torch.isfinite(best), best,
                        torch.zeros_like(best)).mean()
    return new.to(torch.int32), score


def gee_cluster_once(edges, init_labels, num_classes: int,
                     max_iters: int = 30,
                     opts: GEEOptions = _DEFAULT_OPTS) -> ClusterResult:
    """One replicate: embed with the current labels, relabel, repeat until
    nothing changes or ``max_iters``.  ``edges`` is an ``EdgeList`` or a
    ``PreparedGraph``; the self loops and the Laplacian fold are prepared
    once, outside the loop."""
    prepared = PreparedGraph.wrap(edges)
    eff = prepared.effective_edges(opts)
    inner = GEEOptions(correlation=opts.correlation)
    labels = torch.as_tensor(init_labels).to(device=prepared.device,
                                             dtype=torch.int32)
    score = torch.tensor(float("inf"), device=prepared.device)
    iters = 0
    changed = True
    while changed and iters < max_iters:
        z = gee_sparse_torch(eff, labels, num_classes, inner)
        new, score = _assign_nearest_centroid(z, labels, num_classes)
        changed = bool((new != labels).any())
        labels = new
        iters += 1
    z = gee_sparse_torch(eff, labels, num_classes, inner)
    return ClusterResult(labels=labels, embedding=z, score=score,
                         iters=torch.tensor(iters, dtype=torch.int32))


def gee_cluster(edges, num_classes: int, *, replicates: int = 5,
                max_iters: int = 30, seed: int = 0,
                generator: torch.Generator | None = None,
                opts: GEEOptions = _DEFAULT_OPTS) -> ClusterResult:
    """Ensemble clustering: the best of ``replicates`` random restarts by
    score.  Restart labels come from ``generator`` (``None``: a CPU
    generator seeded with ``seed``); every restart shares one
    ``PreparedGraph``."""
    prepared = PreparedGraph.wrap(edges)
    if generator is None:
        generator = torch.Generator().manual_seed(int(seed))
    best: ClusterResult | None = None
    for _ in range(replicates):
        init = torch.randint(0, num_classes, (prepared.num_nodes,),
                             generator=generator, dtype=torch.int32,
                             device=generator.device)
        res = gee_cluster_once(prepared, init, num_classes, max_iters, opts)
        if best is None or float(res.score) < float(best.score):
            best = res
    if best is None:
        raise ValueError(f"replicates must be >= 1, got {replicates}")
    return best


def adjusted_rand_index(a, b) -> float:
    """ARI between two labelings (numpy-side helper for tests and
    benchmarks; a copy of the reference's)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = a.shape[0]
    ka, kb = int(a.max()) + 1, int(b.max()) + 1
    ct = np.zeros((ka, kb), np.int64)
    np.add.at(ct, (a, b), 1)

    def comb(x):
        return x * (x - 1) // 2

    sum_ij = comb(ct).sum()
    sum_a = comb(ct.sum(1)).sum()
    sum_b = comb(ct.sum(0)).sum()
    total = comb(np.int64(n))
    expected = sum_a * sum_b / max(total, 1)
    max_index = (sum_a + sum_b) / 2
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


__all__ = ["ClusterResult", "gee_cluster_once", "gee_cluster",
           "adjusted_rand_index"]
