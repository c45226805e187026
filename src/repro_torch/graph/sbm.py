"""Stochastic Block Model graph generator (port of ``repro/graph/sbm.py``).

The paper simulates SBM graphs with 3 classes, class priors
[0.2, 0.3, 0.5], within-class probability 0.13 and between-class
probability 0.1.  ``sample_sbm`` makes the same rng calls in the same order
as the reference, so one seed gives the same edges in both packages.
Sampling is O(E) expected time per block pair (geometric skipping).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graph.containers import EdgeList, edge_list_from_numpy

PAPER_PRIORS = (0.2, 0.3, 0.5)
PAPER_P_WITHIN = 0.13
PAPER_P_BETWEEN = 0.10


@dataclasses.dataclass(frozen=True)
class SBMSample:
    edges: EdgeList          # directed (symmetrized) edge list
    labels: np.ndarray       # [N] int32
    num_classes: int


def _sample_pairs_block(rng: np.random.Generator, rows: np.ndarray,
                        cols: np.ndarray, p: float,
                        upper_only: bool) -> tuple[np.ndarray, np.ndarray]:
    """Sample Bernoulli(p) entries of the |rows| x |cols| block via
    geometric skipping; returns (i, j) global index arrays."""
    nr, nc = rows.size, cols.size
    total = nr * nc
    if total == 0 or p <= 0.0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    out = []
    pos = -1
    log1mp = np.log1p(-p)
    est = int(p * total * 1.2) + 16
    while True:
        u = rng.random(est)
        gaps = np.floor(np.log(u) / log1mp).astype(np.int64) + 1
        idx = pos + np.cumsum(gaps)
        take = idx < total
        out.append(idx[take])
        if not take.all():
            break
        pos = int(idx[-1])
    flat = np.concatenate(out) if out else np.empty(0, np.int64)
    bi, bj = flat // nc, flat % nc
    gi, gj = rows[bi], cols[bj]
    if upper_only:
        keep = gi < gj
        gi, gj = gi[keep], gj[keep]
    return gi, gj


def sample_sbm(num_nodes: int, priors: Sequence[float] = PAPER_PRIORS,
               p_within: float = PAPER_P_WITHIN,
               p_between: float = PAPER_P_BETWEEN, seed: int = 0,
               pad_to: int | None = None, device=None) -> SBMSample:
    """Sample an SBM graph; its edge list lands on ``device`` (``None``:
    the card)."""
    rng = np.random.default_rng(seed)
    k = len(priors)
    labels = rng.choice(k, size=num_nodes,
                        p=np.asarray(priors)).astype(np.int32)
    order = np.argsort(labels, kind="stable")
    groups = [order[labels[order] == c] for c in range(k)]
    src_all, dst_all = [], []
    for a in range(k):
        for b in range(a, k):
            p = p_within if a == b else p_between
            gi, gj = _sample_pairs_block(
                rng, groups[a], groups[b], p, upper_only=(a == b))
            src_all.append(gi)
            dst_all.append(gj)
    src = np.concatenate(src_all)
    dst = np.concatenate(dst_all)
    # one entry per undirected edge -> symmetrize to directed
    s = np.concatenate([src, dst]).astype(np.int32)
    d = np.concatenate([dst, src]).astype(np.int32)
    edges = edge_list_from_numpy(s, d, None, num_nodes, pad_to=pad_to,
                                 device=device)
    return SBMSample(edges=edges, labels=labels, num_classes=k)


__all__ = ["SBMSample", "sample_sbm", "PAPER_PRIORS", "PAPER_P_WITHIN",
           "PAPER_P_BETWEEN"]
