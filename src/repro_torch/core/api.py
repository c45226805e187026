"""Public API: ``GEEEmbedder`` and ``node_features`` (port of
``repro/core/api.py``, with similarity retrieval: ``build_index``,
``neighbors``, ``index``).

In-memory graphs go through ``fit``/``fit_transform``; graphs on disk (any
``repro_torch.graph.io`` format) through ``fit_file`` /
``fit_transform_file``, which stream windows in bounded device memory.
``partial_fit`` (incremental updates) is not yet ported.

The embedder runs on the card unless the caller asks for the CPU:
``device=None`` resolves to ``cuda`` and raises ``RuntimeError`` when no GPU
is present.  ``backend="auto"`` picks the hand-written kernels on the card
(``repro_torch.core.plan.select_backend``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.chunked import gee_chunked
from repro_torch.core.gee import GEEOptions
from repro_torch.core.plan import GEEPlan, PreparedGraph
from repro_torch.graph.containers import EdgeList
from repro_torch.graph.io import (DEFAULT_CHUNK_EDGES, ChunkedEdgeList,
                                  load_labels, open_edge_list)
from repro_torch.search.index import (DEFAULT_PAD_MULTIPLE,
                                      ClassPartitionedIndex)


@dataclasses.dataclass
class GEEEmbedder:
    """Fit/transform-style wrapper around GEE.

    backend: 'auto' (default: ``cuda`` on the card, ``sparse_torch`` on
             the CPU, ``chunked`` past the memory budget), 'cuda',
             'sparse_torch', 'chunked', 'dense_torch', 'scipy' or
             'python_loop'.  File-backed fits always stream.
    device:  where the graph and the embedding live; ``None`` is the card.
    chunk_edges: the streaming window ('chunked' and file-backed fits).
    prefetch_windows: windows staged ahead by background threads when
             streaming (``None``: ``REPRO_GEE_PREFETCH_WINDOWS`` or 2; 0:
             synchronous copies).
    """

    num_classes: int
    options: GEEOptions = GEEOptions(laplacian=True, diag_aug=True,
                                     correlation=True)
    backend: str = "auto"
    device: Optional[str] = None
    chunk_edges: Optional[int] = None
    prefetch_windows: Optional[int] = None

    _prepared: Optional[PreparedGraph] = dataclasses.field(default=None,
                                                          repr=False)
    _chunked: Optional[ChunkedEdgeList] = dataclasses.field(default=None,
                                                           repr=False)
    _labels: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    _z: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    _index: Optional[ClassPartitionedIndex] = dataclasses.field(
        default=None, repr=False)

    # -- construction helpers ------------------------------------------------
    @staticmethod
    def from_arrays(src, dst, weight, labels, num_classes: int,
                    num_nodes: int | None = None, undirected: bool = True,
                    **kw) -> "GEEEmbedder":
        emb = GEEEmbedder(num_classes=num_classes, **kw)
        prepared = PreparedGraph.from_arrays(
            src, dst, weight, num_nodes=num_nodes, undirected=undirected,
            device=resolve_device(emb.device))
        return emb.fit(prepared, labels)

    # -- sklearn-ish surface -------------------------------------------------
    def fit(self, edges: "EdgeList | PreparedGraph", labels) -> "GEEEmbedder":
        """Fit an in-memory graph, moved to this embedder's device.  A
        ``PreparedGraph`` already there keeps its memoized prep artifacts
        (refits, backend switches and option sweeps then share them)."""
        device = resolve_device(self.device)
        prepared = PreparedGraph.wrap(edges)
        if prepared.device != device:
            prepared = PreparedGraph(prepared.base.to(device))
        self._prepared = prepared
        self._chunked = None
        self._labels = torch.as_tensor(labels).to(device=device,
                                                  dtype=torch.int32)
        self._z = None
        self._reset_index()
        return self

    def fit_file(self, path: str, labels=None, **open_kw) -> "GEEEmbedder":
        """Fit from an on-disk edge list without materializing it.

        ``path`` is any ``repro_torch.graph.io`` format (``.geeb``
        memory-maps; text converts to a mapped sidecar once).
        ``labels=None`` reads the ``<path>.labels.npy`` sidecar;
        ``open_kw`` goes to ``open_edge_list``.  ``transform`` then streams
        the two-pass fold on this embedder's device, whatever ``backend``
        says.
        """
        device = resolve_device(self.device)
        self._chunked = open_edge_list(
            path, chunk_edges=self.chunk_edges or DEFAULT_CHUNK_EDGES,
            **open_kw)
        if labels is None:
            labels = load_labels(path)
            if labels is None:
                raise ValueError(
                    f"no labels given and no sidecar {path}.labels.npy")
        self._prepared = None
        self._labels = torch.as_tensor(labels).to(device=device,
                                                  dtype=torch.int32)
        self._z = None
        self._reset_index()
        return self

    def fit_transform_file(self, path: str, labels=None,
                           **open_kw) -> torch.Tensor:
        """``fit_file`` + ``transform`` in one call (bounded memory)."""
        return self.fit_file(path, labels, **open_kw).transform()

    def partial_fit(self, delta) -> "GEEEmbedder":
        """Incremental updates are not yet ported."""
        raise NotImplementedError(
            "partial_fit: not yet ported (incremental updates)")

    @property
    def prepared(self) -> Optional[PreparedGraph]:
        """The fitted graph's memoized prep artifacts (None for
        file-backed fits)."""
        return self._prepared

    def current_edges(self) -> EdgeList:
        """The graph embedded.  For file-backed fits this materializes the
        on-disk list (symmetrized if stored undirected) on this embedder's
        device: fine for inspection, contrary to the point at scale."""
        if self._chunked is not None:
            return self._chunked.to_edge_list(
                device=resolve_device(self.device))
        if self._prepared is None:
            raise RuntimeError("call fit() first")
        return self._prepared.base

    def _num_nodes(self) -> int:
        if self._chunked is not None:
            return self._chunked.num_nodes
        return self._prepared.num_nodes

    def transform(self) -> torch.Tensor:
        if self._prepared is None and self._chunked is None:
            raise RuntimeError("call fit() first")
        if self._z is None:
            if self._chunked is not None:
                self._z = gee_chunked(
                    self._chunked, self._labels, self.num_classes,
                    self.options, prefetch_windows=self.prefetch_windows,
                    device=self._labels.device)
            else:
                self._z = GEEPlan.build(
                    self._prepared, self.num_classes, self.options,
                    backend=self.backend, chunk_edges=self.chunk_edges,
                    prefetch_windows=self.prefetch_windows,
                ).execute(self._labels)
        return self._z

    def fit_transform(self, edges: "EdgeList | PreparedGraph",
                      labels) -> torch.Tensor:
        return self.fit(edges, labels).transform()

    # -- classification on top of the embedding ------------------------------
    def class_means(self) -> torch.Tensor:
        """Per-class mean of Z over labeled vertices, [K, K]; empty classes
        get ``inf`` rows so ``predict`` never assigns to them."""
        z = self.transform()
        onehot = torch.zeros((z.shape[0], self.num_classes), dtype=z.dtype,
                             device=z.device)
        valid = self._labels >= 0
        onehot[valid, self._labels[valid].long()] = 1.0
        counts = onehot.sum(0)
        means = (onehot.T @ z) / torch.clamp(counts, min=1.0)[:, None]
        return torch.where((counts > 0)[:, None], means,
                           torch.full_like(means, float("inf")))

    def predict(self, rows=None) -> torch.Tensor:
        """Nearest-class-mean vertex classification.  ``rows`` restricts to
        a vertex subset (any array-like of ids; always returns 1-D)."""
        z = self.transform()
        if rows is not None:
            idx = torch.as_tensor(rows, device=z.device).long().reshape(-1)
            z = z[idx]
        means = self.class_means()
        d2 = torch.sum((z[:, None, :] - means[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(torch.isnan(d2), torch.full_like(d2, float("inf")),
                         d2)
        return torch.argmin(d2, dim=-1).to(torch.int32)

    # -- similarity retrieval on top of the embedding ------------------------
    def build_index(self, *, metric: str = "l2", nprobe: int | None = None,
                    pad_multiple: int | None = None) -> ClassPartitionedIndex:
        """Build (and cache) a vertex-similarity index over the embedding,
        on this embedder's device: a :class:`ClassPartitionedIndex` whose
        coarse cells are the class structure."""
        self._index = ClassPartitionedIndex.build(
            self.transform(), self._labels.cpu().numpy(), self.num_classes,
            metric=metric, nprobe=nprobe,
            pad_multiple=pad_multiple or DEFAULT_PAD_MULTIPLE)
        return self._index

    def neighbors(self, query_rows=None, k: int = 10, *, queries=None,
                  nprobe: int | None = None, brute_force: bool = False):
        """Top-``k`` most similar vertices per query.

        ``query_rows`` queries by vertex id (each vertex is its own best
        hit); ``queries`` passes explicit [Q, K] vectors instead.  Builds
        the index on first use.  Returns ``(ids [Q, k] int32, scores [Q, k]
        f32)`` on the embedder's device.
        """
        if self._index is None:
            self.build_index()
        if queries is not None:
            return self._index.search(queries, k, nprobe=nprobe,
                                      brute_force=brute_force)
        if query_rows is None:
            raise ValueError("pass query_rows (vertex ids) or queries "
                             "(explicit vectors)")
        return self._index.search_rows(query_rows, k, nprobe=nprobe,
                                       brute_force=brute_force)

    @property
    def index(self) -> Optional[ClassPartitionedIndex]:
        """The cached similarity index (None until ``build_index`` /
        ``neighbors``)."""
        return self._index

    def _reset_index(self) -> None:
        self._index = None


def node_features(edges: "EdgeList | PreparedGraph", labels,
                  num_classes: int,
                  options: GEEOptions = GEEOptions(laplacian=True,
                                                   diag_aug=True,
                                                   correlation=True),
                  backend: str = "auto", device=None) -> torch.Tensor:
    """One-call functional form: graph + labels -> [N, K] features, on
    ``device`` (``None``: the card)."""
    return GEEEmbedder(num_classes=num_classes, options=options,
                       backend=backend, device=device).fit_transform(
                           edges, labels)


__all__ = ["GEEEmbedder", "node_features"]
