"""The paper's benchmark graphs (Table 2) as synthetic stand-ins, and edge
files on disk (port of ``repro/graph/datasets.py``).

The six Network-Repository datasets are regenerated with matching
statistics: the same node count, edge count and class count as Table 2,
with a heavy-tailed degree profile.  ``synth_like`` and ``synth_to_disk``
make the reference's rng calls in the same order, so one seed gives the
same graph, and the same ``.geeb`` bytes, in both packages.
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


def _looks_like_path(name: str) -> bool:
    from repro_torch.graph.io import TEXT_SUFFIXES

    suffix = os.path.splitext(name)[1].lower()
    return (os.path.sep in name or os.path.exists(name)
            or suffix in (".geeb", ".npz") or suffix in TEXT_SUFFIXES)


def load_file(path: str, pad_to: int | None = None, device=None,
              **open_kw) -> GraphDataset:
    """Materialize an on-disk edge list (any ``repro_torch.graph.io``
    format) on ``device`` (``None``: the card): undirected storage is
    symmetrized, labels come from the ``<path>.labels.npy`` sidecar (all
    ``-1`` when absent).  Graphs too large to materialize stream instead:
    ``GEEEmbedder.fit_file`` / ``gee_chunked_from_file``."""
    from repro_torch.graph.io import load_labels, open_edge_list

    chunked = open_edge_list(path, **open_kw)
    edges = chunked.to_edge_list(pad_to=pad_to, device=device)
    labels = load_labels(path)
    if labels is None:
        labels = np.full(chunked.num_nodes, -1, np.int32)
    k = int(labels.max()) + 1 if labels.size and labels.max() >= 0 else 1
    # directed storage is taken to hold both directions of each edge, so
    # E//2 is its undirected count (approximate for asymmetric lists)
    und_edges = (chunked.num_edges if chunked.undirected
                 else chunked.num_edges // 2)
    spec = DatasetSpec(
        name=os.path.splitext(os.path.basename(path))[0],
        num_nodes=chunked.num_nodes, num_edges=und_edges, num_classes=k)
    return GraphDataset(spec=spec, edges=edges, labels=labels)


def load(name: str, seed: int = 0, pad_to: int | None = None,
         device=None) -> GraphDataset:
    """Resolve a Table 2 spec name (its synthetic stand-in, the same graph
    as the reference's for the same seed) or an edge-file path
    (``load_file``), on ``device`` (``None``: the card).  Spec names win
    over a stray file of the same name."""
    key = name.lower()
    if key in TABLE2:
        return synth_like(TABLE2[key], seed=seed, pad_to=pad_to,
                          device=device)
    if _looks_like_path(name):
        return load_file(name, pad_to=pad_to, device=device)
    raise KeyError(f"unknown dataset {name!r} (not a Table 2 name, and "
                   f"not an edge-file path); available: {sorted(TABLE2)}")


def synth_to_disk(spec: DatasetSpec, path: str, seed: int = 0,
                  chunk_edges: int = 1 << 20) -> str:
    """Stream a ``synth_like``-style graph straight to disk, chunk by
    chunk (peak host memory O(N + chunk_edges)).

    The file (``.geeb`` or text) stores one entry per undirected edge
    (``undirected=True``); labels go to the ``<path>.labels.npy`` sidecar.
    The rng calls are the reference's, so the bytes are too.
    """
    from repro_torch.graph.io import (TEXT_SUFFIXES, BinaryEdgeWriter,
                                      save_labels)

    suffix = os.path.splitext(path)[1].lower()
    if suffix not in (".geeb",) + TEXT_SUFFIXES:
        raise ValueError(f"synth_to_disk streams to .geeb or text, "
                         f"got {suffix!r}")
    rng = np.random.default_rng(seed)
    n, e, k = spec.num_nodes, spec.num_edges, spec.num_classes
    labels = rng.integers(0, k, size=n).astype(np.int32)
    p = _skewed_endpoint_probs(rng, n)

    def chunks():
        left = e
        while left > 0:
            c = min(left, chunk_edges)
            yield _sample_loop_free_pairs(rng, n, c, p)
            left -= c

    if suffix == ".geeb":
        with BinaryEdgeWriter(path, n, e, undirected=True) as writer:
            for src, dst in chunks():
                writer.append(src, dst)
    else:
        with open(path, "w") as f:
            f.write(f"# nodes {n} edges {e} undirected 1\n")
            for src, dst in chunks():
                f.writelines(f"{s} {d}\n" for s, d in zip(src, dst))
    save_labels(path, labels)
    return path


__all__ = ["DatasetSpec", "TABLE2", "GraphDataset", "synth_like", "load",
           "load_file", "synth_to_disk"]
