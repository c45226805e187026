"""Public API: ``GEEEmbedder`` and ``node_features`` (port of
``repro/core/api.py``, with similarity retrieval: ``build_index``,
``neighbors``, ``index``).

In-memory graphs go through ``fit``/``fit_transform``; graphs on disk (any
``repro_torch.graph.io`` format) through ``fit_file`` /
``fit_transform_file``, which stream windows in bounded device memory.
``partial_fit`` applies edge and label deltas to an in-memory fit in
O(|delta| + affected-row edges) (``repro_torch.core.incremental``), and a
cached similarity index is repaired across them, not rebuilt.

``backend="distributed"`` and ``"streamed_sharded"`` run over a
``torch.distributed`` process group (``group=None``: the default one, or a
world of one), each rank on its own shard, and assemble the ranks' row
blocks, so ``fit_transform`` returns the whole [N, K] on every rank.

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
from repro_torch.core.fold import gather_rows, gee_streamed_sharded
from repro_torch.core.gee import GEEOptions
from repro_torch.core.incremental import (Delta, DirtyRowTracker,
                                          IncrementalGEE)
from repro_torch.core.plan import GEEPlan, PreparedGraph
from repro_torch.graph.containers import EdgeList
from repro_torch.graph.io import (DEFAULT_CHUNK_EDGES, ChunkedEdgeList,
                                  load_labels, open_edge_list)
from repro_torch.obs import trace as obs_trace
from repro_torch.search.index import (DEFAULT_PAD_MULTIPLE,
                                      ClassPartitionedIndex)


@dataclasses.dataclass
class GEEEmbedder:
    """Fit/transform-style wrapper around GEE.

    backend: 'auto' (default: ``cuda`` on the card, ``sparse_torch`` on
             the CPU, ``chunked`` past the memory budget, or
             ``streamed_sharded`` across the ranks of a group), 'cuda',
             'sparse_torch', 'chunked', 'streamed_sharded', 'distributed',
             'dense_torch', 'scipy' or 'python_loop'.  File-backed fits
             always stream: ``streamed_sharded`` across the group's ranks
             if asked for, else ``chunked``.
    device:  where the graph and the embedding live; ``None`` is the card.
    chunk_edges: the streaming window ('chunked' and file-backed fits).
    prefetch_windows: windows staged ahead by background threads when
             streaming (``None``: ``REPRO_GEE_PREFETCH_WINDOWS`` or 2; 0:
             synchronous copies).
    local_backend: each rank's compute under 'distributed' and
             'streamed_sharded': 'segment_sum' (default) or 'cuda' (an ELL
             plane a rank through the ``gee_spmm`` kernel).
    group:   their ``torch.distributed`` process group (the reference's
             ``mesh``); ``None`` is the default group, or a world of one.
    """

    num_classes: int
    options: GEEOptions = GEEOptions(laplacian=True, diag_aug=True,
                                     correlation=True)
    backend: str = "auto"
    device: Optional[str] = None
    chunk_edges: Optional[int] = None
    prefetch_windows: Optional[int] = None
    local_backend: str = "segment_sum"
    group: Optional[object] = None

    _prepared: Optional[PreparedGraph] = dataclasses.field(default=None,
                                                          repr=False)
    _chunked: Optional[ChunkedEdgeList] = dataclasses.field(default=None,
                                                           repr=False)
    _labels: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    _z: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    _inc: Optional[IncrementalGEE] = dataclasses.field(default=None,
                                                       repr=False)
    _index: Optional[ClassPartitionedIndex] = dataclasses.field(
        default=None, repr=False)
    _index_tracker: Optional[DirtyRowTracker] = dataclasses.field(
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
        (refits, backend switches and option sweeps then share them).
        Spans: ``api.fit``, and ``api.labels`` around the labels' upload
        from pageable host memory."""
        with obs_trace.span("api.fit"):
            device = resolve_device(self.device)
            prepared = PreparedGraph.wrap(edges)
            if prepared.device != device:
                prepared = PreparedGraph(prepared.base.to(device))
            self._prepared = prepared
            self._chunked = None
            with obs_trace.span("api.labels"):
                self._labels = torch.as_tensor(labels).to(device=device,
                                                          dtype=torch.int32)
            self._z = None
            self._inc = None
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
        self._inc = None
        self._reset_index()
        return self

    def fit_transform_file(self, path: str, labels=None,
                           **open_kw) -> torch.Tensor:
        """``fit_file`` + ``transform`` in one call (bounded memory)."""
        return self.fit_file(path, labels, **open_kw).transform()

    def partial_fit(self, delta: Delta) -> "GEEEmbedder":
        """Apply an ``EdgeDelta`` / ``LabelDelta`` (or a sequence of them)
        in O(|delta| + affected-row edges) instead of refitting O(E).

        The first call promotes the fitted graph into an ``IncrementalGEE``
        (host accumulators, Z cached on this embedder's device); from then
        on ``transform`` serves from its cached Z, whatever ``backend``
        says.
        """
        if self._prepared is None:
            if self._chunked is not None:
                raise RuntimeError(
                    "partial_fit needs the in-memory path: file-backed fits "
                    "stream from disk and keep no live adjacency.  "
                    "fit(chunked.to_edge_list(), labels) first if the graph "
                    "fits in memory.")
            raise RuntimeError("call fit() first")
        if self._inc is None:
            self._inc = IncrementalGEE.from_graph(
                self._prepared.base, self._labels.cpu().numpy(),
                self.num_classes, self.options,
                device=self._labels.device)
            # Track invalidations so a live similarity index repairs its
            # buckets instead of rebuilding (see build_index / neighbors).
            self._index_tracker = DirtyRowTracker(self._inc.n)
            self._inc.add_dirty_listener(self._index_tracker)
        self._inc.apply(delta)
        self._labels = torch.from_numpy(self._inc.labels.copy()).to(
            self._labels.device)
        self._z = None
        return self

    @property
    def incremental(self) -> Optional[IncrementalGEE]:
        """The live streaming state (None until ``partial_fit`` is
        called)."""
        return self._inc

    @property
    def prepared(self) -> Optional[PreparedGraph]:
        """The fitted graph's memoized prep artifacts (None for
        file-backed fits)."""
        return self._prepared

    def current_edges(self) -> EdgeList:
        """The graph embedded.  For file-backed fits this materializes the
        on-disk list (symmetrized if stored undirected) on this embedder's
        device: fine for inspection, contrary to the point at scale.  Once
        streaming, the mutated graph."""
        if self._inc is not None:
            return self._inc.to_edge_list()
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
        if self._inc is not None:
            # Refresh only when rows are actually stale, so repeat reads
            # between deltas serve the cached tensor.
            if self._z is None or self._inc.num_pending_rows:
                self._z = self._inc.embedding()
            return self._z
        if self._z is None:
            with obs_trace.span("api.transform"):
                self._z = self._compute()
        return self._z

    def _compute(self) -> torch.Tensor:
        if self._chunked is not None:
            if self.backend == "streamed_sharded":
                z = gee_streamed_sharded(
                    self._chunked, self._labels, self.num_classes,
                    self.options, group=self.group,
                    local_backend=self.local_backend,
                    prefetch_windows=self.prefetch_windows,
                    device=self._labels.device)
                return gather_rows(z, self._chunked.num_nodes,
                                   group=self.group)
            return gee_chunked(
                self._chunked, self._labels, self.num_classes, self.options,
                prefetch_windows=self.prefetch_windows,
                device=self._labels.device)
        # One plan over the shared PreparedGraph (the multi-device backends
        # included), so a refit, an option change or a backend switch
        # reuses every prep artifact.
        with obs_trace.span("plan.build"):
            plan = GEEPlan.build(
                self._prepared, self.num_classes, self.options,
                backend=self.backend, chunk_edges=self.chunk_edges,
                prefetch_windows=self.prefetch_windows,
                local_backend=self.local_backend, group=self.group)
        return plan.execute(self._labels)

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
        coarse cells are the class structure.  After ``partial_fit`` deltas
        the cached index is repaired in place on the next :meth:`neighbors`
        call -- stale rows move between buckets; no rebuild."""
        self._index = ClassPartitionedIndex.build(
            self.transform(), self._labels.cpu().numpy(), self.num_classes,
            metric=metric, nprobe=nprobe,
            pad_multiple=pad_multiple or DEFAULT_PAD_MULTIPLE)
        if self._index_tracker is not None:
            self._index_tracker.drain()   # fresh index == already repaired
        return self._index

    def neighbors(self, query_rows=None, k: int = 10, *, queries=None,
                  nprobe: int | None = None, brute_force: bool = False):
        """Top-``k`` most similar vertices per query.

        ``query_rows`` queries by vertex id (each vertex is its own best
        hit); ``queries`` passes explicit [Q, K] vectors instead.  Builds
        the index on first use and repairs it after ``partial_fit``
        deltas.  Returns ``(ids [Q, k] int32, scores [Q, k]
        f32)`` on the embedder's device.
        """
        if self._index is None:
            self.build_index()
        self._repair_index()
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
        self._index_tracker = None   # a new graph gets a new tracker

    def _repair_index(self) -> None:
        """Fold ``partial_fit`` invalidations into the cached index."""
        if self._index is None or self._index_tracker is None \
                or not self._index_tracker.pending:
            return
        rows = self._index_tracker.drain()
        z = self.transform()
        self._index.update_rows(rows, z[torch.from_numpy(rows).to(z.device)])


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
