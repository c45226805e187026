"""The paper's benchmark graphs (Table 2) as synthetic stand-ins (port of
the in-memory part of ``repro/graph/datasets.py``).

The six Network-Repository datasets are regenerated with matching
statistics: the same node count, edge count and class count as Table 2,
with a heavy-tailed degree profile.  ``synth_like`` makes the reference's
rng calls in the same order, so one seed gives the same graph in both
packages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np

from repro_torch.graph.containers import EdgeList, edge_list_from_numpy


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int
    num_edges: int     # undirected edge count, as in paper Table 2
    num_classes: int

    @property
    def density(self) -> float:
        n, e = self.num_nodes, self.num_edges
        return 2.0 * e / (n * (n - 1))


# Paper Table 2 (node/edge counts as printed).
TABLE2: Dict[str, DatasetSpec] = {
    "citeseer": DatasetSpec("citeseer", 3_327, 4_732, 6),
    "cora": DatasetSpec("cora", 2_708, 5_429, 7),
    "proteins-all": DatasetSpec("proteins-all", 43_471, 162_088, 3),
    "pubmed": DatasetSpec("pubmed", 19_717, 44_338, 3),
    "cl-100k-1d8-l9": DatasetSpec("cl-100k-1d8-l9", 92_482, 373_986, 9),
    "cl-100k-1d8-l5": DatasetSpec("cl-100k-1d8-l5", 92_482, 10_000_000, 5),
}


@dataclasses.dataclass(frozen=True)
class GraphDataset:
    spec: DatasetSpec
    edges: EdgeList          # directed/symmetrized
    labels: np.ndarray       # [N] int32


def _skewed_endpoint_probs(rng: np.random.Generator, n: int) -> np.ndarray:
    """Zipf-ish stub weights for preferential endpoints."""
    w = 1.0 / (1.0 + np.arange(n, dtype=np.float64)) ** 0.5
    rng.shuffle(w)
    return w / w.sum()


def _sample_loop_free_pairs(rng: np.random.Generator, n: int, count: int,
                            p: np.ndarray):
    """``count`` endpoint pairs drawn from ``p``, self loops rerolled.

    The reroll offsets from *src* by 1..n-1, so the new endpoint can never
    be src again.
    """
    src = rng.choice(n, size=count, p=p).astype(np.int32)
    dst = rng.choice(n, size=count, p=p).astype(np.int32)
    loops = src == dst
    dst[loops] = (src[loops] + 1 + rng.integers(0, n - 1, loops.sum())) % n
    if np.any(src == dst):
        raise RuntimeError("self loops survived the reroll")
    return src, dst


def synth_like(spec: DatasetSpec, seed: int = 0, pad_to: int | None = None,
               device=None) -> GraphDataset:
    """Sample a graph matching (N, E, K) with a heavy-tailed degree
    profile; its edge list lands on ``device`` (``None``: the card)."""
    rng = np.random.default_rng(seed)
    n, e, k = spec.num_nodes, spec.num_edges, spec.num_classes
    labels = rng.integers(0, k, size=n).astype(np.int32)
    src, dst = _sample_loop_free_pairs(rng, n, e,
                                       _skewed_endpoint_probs(rng, n))
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    edges = edge_list_from_numpy(s, d, None, n, pad_to=pad_to, device=device)
    return GraphDataset(spec=spec, edges=edges, labels=labels)


def load(name: str, seed: int = 0, pad_to: int | None = None,
         device=None) -> GraphDataset:
    """Resolve a Table 2 spec name to its synthetic stand-in (the same graph
    as the reference's ``load`` for the same seed), on ``device``
    (``None``: the card).  Edge-file paths, which the reference also takes,
    wait for the port of the out-of-core reader."""
    key = name.lower()
    if key in TABLE2:
        return synth_like(TABLE2[key], seed=seed, pad_to=pad_to,
                          device=device)
    if (os.path.sep in name or os.path.exists(name)
            or os.path.splitext(name)[1]):
        raise NotImplementedError(
            f"{name!r} looks like an edge-file path; loading edge files is "
            f"not yet ported to repro_torch")
    raise KeyError(f"unknown dataset {name!r} (not a Table 2 name); "
                   f"available: {sorted(TABLE2)}")


__all__ = ["DatasetSpec", "TABLE2", "GraphDataset", "synth_like", "load"]
