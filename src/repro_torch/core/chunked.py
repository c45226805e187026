"""Out-of-core GEE: the two-pass, window-streamed form of
``gee_sparse_torch`` (port of ``repro/core/chunked.py``).

The accumulator state -- class counts, degrees and ``Z`` -- is
O(N + N*K), small next to the edge list, and every GEE formula is a sum
over edges, so the edge list never needs to be resident:

  pass 1   (Laplacian only) degrees of the augmented graph, one
           ``index_add_`` per window;
  pass 2   ``Z[i, y_j] += w_ij d_i^{-1/2} d_j^{-1/2} / n_{y_j}`` per window
           into a flat [N*K] accumulator;
  finalize diag-aug self loops and the correlation row norm, O(N*K), once
           (the ``row_norm`` kernel on the card).

Undirected storage (one entry per edge {i, j}) is folded in both
directions, self loops once, matching ``symmetrize``.  The fold is
``repro_torch.core.fold.stream_fold``.
"""

from __future__ import annotations

import torch

from repro_torch.core.epilogue import finalize
from repro_torch.core.fold import stream_fold
from repro_torch.core.gee import GEEOptions
from repro_torch.graph.io import (DEFAULT_CHUNK_EDGES, load_labels,
                                  open_edge_list)


def gee_chunked(chunked, labels, num_classes: int,
                opts: GEEOptions = GEEOptions(),
                prefetch_windows: int | None = None,
                device=None) -> torch.Tensor:
    """Window-streamed GEE over any ``WindowSource`` on ``device``
    (``None``: where the windows already live, else the card).

    Numerically the ``gee_sparse_torch`` contract up to the order of the
    f32 sums; device memory stays O(window + N*K).  Under correlation the
    epilogue's row norm is the ``row_norm`` kernel on the card;
    ``prefetch_windows`` stages windows ahead on background threads
    (``None``: ``REPRO_GEE_PREFETCH_WINDOWS`` or 2; ``0``: synchronous).
    """
    k = int(num_classes)
    z, winv, dinv = stream_fold(chunked, labels, k, opts,
                                prefetch_windows=prefetch_windows,
                                device=device)
    labels = torch.as_tensor(labels).to(device=z.device, dtype=torch.int32)
    return finalize(z, labels, winv, dinv, num_classes=k, opts=opts,
                    impl="auto")


def gee_chunked_from_file(path: str, labels=None,
                          num_classes: int | None = None,
                          opts: GEEOptions = GEEOptions(),
                          chunk_edges: int = DEFAULT_CHUNK_EDGES,
                          prefetch_windows: int | None = None,
                          device=None, **open_kw) -> torch.Tensor:
    """Embed straight from an edge file (any ``repro_torch.graph.io``
    format) on ``device`` (``None``: the card).  ``labels=None`` reads the
    ``<path>.labels.npy`` sidecar; ``num_classes=None`` is
    ``max(labels) + 1``."""
    chunked = open_edge_list(path, chunk_edges=chunk_edges, **open_kw)
    if labels is None:
        labels = load_labels(path)
        if labels is None:
            raise ValueError(f"no labels given and no sidecar "
                             f"{path}.labels.npy")
    if num_classes is None:
        num_classes = int(max(int(torch.as_tensor(labels).max()) + 1, 1))
    return gee_chunked(chunked, labels, num_classes, opts,
                       prefetch_windows=prefetch_windows, device=device)


__all__ = ["gee_chunked", "gee_chunked_from_file"]
