"""The shared GEE accumulator fold, single-device half (port of the first
half of ``repro/core/fold.py``).

Every scalable GEE path streams edge windows, folds each into O(N + N*K)
accumulator state (degrees, the embedding ``Z``) and applies the one
O(N*K) epilogue (``repro_torch.core.epilogue.finalize``).  The fold is
exact under any edge order and any padding (weight-0 entries are no-ops).

The reference's fold is plain XLA (``segment_sum``); no Pallas kernel
reaches it, so here it is plain torch: ``index_add_`` into a flat
[N*K] accumulator with an int64 index (no N*K overflow), updated in place
window by window.  ``index_add_`` adds one term after another (with
atomics on the card, in an order that varies from run to run), and a
running f32 sum over a hub row drifts with its length: a star's hub row
of 20,307 terms reads 3.9e-5 off its exact sum
(``tests/test_torch_stream.py::test_hub_row_accumulates_in_float64``),
past the row-scaled tolerance the streamed result is held to.  So the
degree and class accumulators are float64, and each is rounded to f32
once, when the fold ends.  The terms themselves are the reference's f32
products.

The multi-device half of the reference (``combine_partials``,
``gee_streamed_sharded``) is not yet ported.
"""

from __future__ import annotations

import time

import torch

from repro_torch import resolve_device
from repro_torch.core.epilogue import inv_sqrt_degrees
from repro_torch.core.gee import GEEOptions, class_weight_inv
from repro_torch.graph.prefetch import prefetch_windows as _prefetch_windows
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


# ---------------------------------------------------------------------------
# the fold primitives
# ---------------------------------------------------------------------------

def both_directions(src, dst, weight):
    """Expand one-entry-per-undirected-edge arrays to both directions in
    one concatenation; a self loop's reversed copy weighs 0, so the loop
    counts once."""
    w_rev = weight.masked_fill(src == dst, 0.0)
    return (torch.cat([src, dst]), torch.cat([dst, src]),
            torch.cat([weight, w_rev]))


def _scatter_terms(src, dst, weight, labels, winv, dinv, num_classes: int):
    """The flat int64 targets ``src*K + y_dst`` and the terms
    ``w * dinv_src * dinv_dst / n_y`` of one window (0 for unlabeled
    targets and padding)."""
    src = src.long()
    dst = dst.long()
    yd = labels[dst].long()
    valid = yd >= 0
    yd_safe = yd.clamp(min=0)
    w_hat = weight * dinv[src] * dinv[dst]
    contrib = torch.where(valid, w_hat * winv[yd_safe],
                          torch.zeros_like(w_hat))
    return src * num_classes + yd_safe, contrib


def scatter_partial(src, dst, weight, labels, winv, dinv, num_rows: int,
                    num_classes: int) -> torch.Tensor:
    """The one edge->Z scatter: ``Z[i, y_j] += w_ij dinv_i dinv_j / n_k``
    as a fresh flat [num_rows * K] f32 sum (accumulated in float64).
    ``dinv`` is all ones when Laplacian normalization is off (``w * 1.0``
    is exact)."""
    flat, contrib = _scatter_terms(src, dst, weight, labels, winv, dinv,
                                   num_classes)
    out = torch.zeros(num_rows * num_classes, dtype=torch.float64,
                      device=contrib.device)
    return out.index_add_(0, flat, contrib.double()).to(torch.float32)


def fold_degrees(deg, src, dst, weight, *, undirected: bool):
    """deg += the window's weighted out-degrees (both directions if
    undirected), in place, in ``deg``'s dtype; returns ``deg``."""
    if undirected:
        src, dst, weight = both_directions(src, dst, weight)
    return deg.index_add_(0, src.long(), weight.to(deg.dtype))


def fold_z(z_flat, src, dst, weight, labels, winv, dinv, *,
           num_classes: int, undirected: bool):
    """z += the window's per-class sums (:func:`scatter_partial`'s terms),
    in place, in ``z_flat``'s dtype; returns ``z_flat``."""
    if undirected:
        src, dst, weight = both_directions(src, dst, weight)
    flat, contrib = _scatter_terms(src, dst, weight, labels, winv, dinv,
                                   num_classes)
    return z_flat.index_add_(0, flat, contrib.to(z_flat.dtype))


# ---------------------------------------------------------------------------
# the single-device streaming instance (what repro_torch.core.chunked wraps)
# ---------------------------------------------------------------------------

def stream_fold(source, labels, num_classes: int, opts: GEEOptions, *,
                prefetch_windows: int | None = None, device=None):
    """Two-pass fold of a ``WindowSource`` on ``device``.

    ``device=None`` is the device the source's windows already live on
    (an in-memory manifest), else the card.  Returns ``(z_flat, winv,
    dinv)``, all f32, for :func:`repro_torch.core.epilogue.finalize`.
    Device memory stays O(window + N*K) however large E grows.

    ``prefetch_windows`` stages that many windows ahead on background
    threads (read, pad, pinned copy on a side stream); ``None`` resolves
    through ``REPRO_GEE_PREFETCH_WINDOWS`` (default 2) and ``0`` copies
    each window synchronously when the fold reaches it.
    """
    if device is None:
        device = getattr(source, "device", None)
    device = resolve_device(device)
    n, k = source.num_nodes, int(num_classes)
    labels = torch.as_tensor(labels).to(device=device, dtype=torch.int32)
    if labels.shape[0] != n:
        raise ValueError(f"labels cover {labels.shape[0]} nodes, "
                         f"graph has {n}")
    winv = class_weight_inv(labels, k)
    und = source.undirected
    source = _prefetch_windows(source, prefetch_windows, device=device)
    tr = obs_trace.get_tracer()
    traced = tr.enabled and device.type == "cuda"
    degree_windows = 0

    if opts.laplacian:
        deg = torch.zeros(n, dtype=torch.float64, device=device)
        for i, w in enumerate(source.windows()):             # pass 1
            with tr.span("fold.window", phase="degrees", idx=i,
                         edges=int(w.num_edges)):
                w = w.to(device)
                fold_degrees(deg, w.src, w.dst, w.weight, undirected=und)
                if traced:       # async launches: sync for honest spans
                    torch.cuda.synchronize(device)
            degree_windows += 1
        deg = deg.to(torch.float32)
        if opts.diag_aug:
            deg += 1.0
        dinv = inv_sqrt_degrees(deg)
    else:
        dinv = torch.ones(n, dtype=torch.float32, device=device)

    t_scatter = time.perf_counter()
    scatter_windows = edges_folded = 0
    z = torch.zeros(n * k, dtype=torch.float64, device=device)
    for i, w in enumerate(source.windows()):                 # pass 2
        with tr.span("fold.window", phase="scatter", idx=i,
                     edges=int(w.num_edges)):
            w = w.to(device)
            fold_z(z, w.src, w.dst, w.weight, labels, winv, dinv,
                   num_classes=k, undirected=und)
            if traced:
                torch.cuda.synchronize(device)
        scatter_windows += 1
        edges_folded += int(w.num_edges)

    _record_fold(degree_windows, scatter_windows, edges_folded,
                 time.perf_counter() - t_scatter)
    return z.to(torch.float32), winv, dinv


def _record_fold(degree_windows: int, scatter_windows: int, edges: int,
                 scatter_s: float) -> None:
    """Registry bookkeeping, once per fold (never per window).

    ``fold.windows`` / ``fold.windows.scatter`` count the scatter pass's
    windows, ``fold.windows.degrees`` the Laplacian degree pass's;
    ``fold.edges`` and the ``fold.edges_per_sec`` gauge come from the
    scatter pass only (host clock; untraced it includes launches still in
    flight on the card).
    """
    reg = obs_metrics.get_registry()
    reg.counter("fold.windows").inc(scatter_windows)
    reg.counter("fold.windows.scatter").inc(scatter_windows)
    reg.counter("fold.windows.degrees").inc(degree_windows)
    reg.counter("fold.edges").inc(edges)
    if scatter_s > 0 and edges:
        reg.gauge("fold.edges_per_sec").set(edges / scatter_s)


__all__ = ["both_directions", "scatter_partial", "fold_degrees", "fold_z",
           "stream_fold"]
