"""The shared GEE accumulator fold (port of ``repro/core/fold.py``).

Every scalable GEE path streams edge windows, folds each into O(N + N*K)
accumulator state (degrees, the embedding ``Z``) and applies the one
O(N*K) epilogue (``repro_torch.core.epilogue.finalize``).  The fold is
exact under any edge order and any padding (weight-0 entries are no-ops),
which lets one accumulator serve every data placement:

  ``repro_torch.core.chunked``      one device, windows from disk
                                    (``stream_fold`` + ``finalize``)
  ``repro_torch.core.distributed``  P ranks, one in-memory window
                                    (per-rank partial + ``combine_partials``)
  ``gee_streamed_sharded``          P ranks, windows from disk: each window
                                    splits into P disjoint sub-windows, rank
                                    r folds its own into a partial, and one
                                    reduce-scatter and the epilogue end it.

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

The multi-device half is SPMD over a ``torch.distributed`` process group
where the reference is one controller with a ``shard_map`` over a mesh:
every sharded function takes ``group=None`` (the default group if one is
initialized, else a world of one that makes no collective call), each rank
runs the reference's per-device body on its own shard, and the result is
this rank's row block ``[N_pad/P, K]``, as the reference's row-sharded
output gives each device.  ``gather_rows`` assembles the whole [N, K].
The reference's ``psum_scatter`` is ``dist.reduce_scatter_tensor`` on the
flat [N_pad*K] partial (row-major, so its chunks are the same row blocks),
and its ``psum`` of degrees a ``dist.all_reduce`` in float64.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.epilogue import apply_epilogue, inv_sqrt_degrees
from repro_torch.core.gee import GEEOptions, class_weight_inv
from repro_torch.graph.containers import EdgeList, edge_list_from_numpy
from repro_torch.graph.ell import ell_planes
from repro_torch.graph.partition import (directed_entries, plane_width,
                                        shard_plane)
from repro_torch.graph.prefetch import PlaneWindow
from repro_torch.graph.prefetch import prefetch_windows as _prefetch_windows
from repro_torch.kernels.gee_spmm import gee_spmm
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


# ---------------------------------------------------------------------------
# the multi-device half: SPMD over a process group
# ---------------------------------------------------------------------------

LOCAL_BACKENDS = ("segment_sum", "cuda")


def _group_of(group) -> tuple:
    """``(P, rank, live)``: ``live`` is False for a world of one with no
    process group, which makes no collective call."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1, 0, False
    return dist.get_world_size(group), dist.get_rank(group), True


def world_size(group=None) -> int:
    """Ranks in ``group`` (``None``: the default group, or 1 when no group
    is initialized); the reference's ``axis_size`` of the mesh axes."""
    return _group_of(group)[0]


def pad_nodes(n: int, p: int) -> int:
    """Smallest multiple of p >= n (row padding for the reduce-scatter)."""
    return ((n + p - 1) // p) * p


def pad_labels(labels, n_pad: int, device) -> torch.Tensor:
    """Labels as int32 on ``device``, padded with -1 (no class) to
    ``n_pad`` rows."""
    labels = torch.as_tensor(labels).to(device=device, dtype=torch.int32)
    if labels.shape[0] < n_pad:
        labels = torch.cat([labels, labels.new_full(
            (n_pad - labels.shape[0],), -1)])
    return labels


def all_reduce_degrees(deg: torch.Tensor, *, group=None) -> torch.Tensor:
    """Sum every rank's partial degrees (float64, in place); a world of one
    with no group has nothing to sum."""
    if _group_of(group)[2]:
        dist.all_reduce(deg, group=group)
    return deg


def degrees_to_dinv(deg: torch.Tensor, diag_aug: bool) -> torch.Tensor:
    """The summed degrees rounded to f32, + 1 under diag-aug (the self
    loops are never appended as edges), inverted as the epilogue does."""
    deg = deg.to(torch.float32)
    if diag_aug:
        deg += 1.0
    return inv_sqrt_degrees(deg)


def combine_partials(z_part: torch.Tensor, labels: torch.Tensor,
                     winv: torch.Tensor, dinv: torch.Tensor, *, group=None,
                     opts) -> torch.Tensor:
    """The tail every multi-device fold shares.

    Reduce-scatters this rank's [N_pad, K] partial (f32 or float64) into
    its row block (the only O(N*K) collective), rounds it to f32 and
    applies the epilogue row-locally: the diag-aug term and the
    correlation row norm touch one row at a time, so a row-sharded Z
    needs no other collective.  ``labels`` and ``dinv`` are the full
    [N_pad] vectors.  On the card the row norm is the ``row_norm`` kernel.
    """
    p, r, live = _group_of(group)
    n_pad, k = z_part.shape
    rows = n_pad // p
    if live:
        block = z_part.new_empty(rows * k)
        dist.reduce_scatter_tensor(block, z_part.reshape(-1).contiguous(),
                                   group=group)
        z_part = block.reshape(rows, k)
    return finish_row_block(z_part, r, labels, winv, dinv, opts=opts)


def finish_row_block(z_rows: torch.Tensor, rank: int, labels: torch.Tensor,
                     winv: torch.Tensor, dinv: torch.Tensor, *,
                     opts) -> torch.Tensor:
    """Rank ``rank``'s summed row block, finished: rounded to f32 and
    through the epilogue on its slice of the full [N_pad] ``labels`` and
    ``dinv``."""
    rows = z_rows.shape[0]
    lo = rank * rows
    return apply_epilogue(z_rows.to(torch.float32), labels[lo:lo + rows],
                          winv, dinv[lo:lo + rows], opts=opts, impl="auto")


def gather_rows(z_block: torch.Tensor, num_nodes: int, *,
                group=None) -> torch.Tensor:
    """Every rank's row block, concatenated in rank order and cut to the
    graph's ``num_nodes`` rows: the whole [N, K] on every rank."""
    p, _, live = _group_of(group)
    if live:
        out = z_block.new_empty((p * z_block.shape[0], z_block.shape[1]))
        dist.all_gather_into_tensor(out, z_block.contiguous(), group=group)
        z_block = out
    return z_block[:num_nodes]


def plane_partial(cols: torch.Tensor, vals: torch.Tensor,
                  labels: torch.Tensor, winv: torch.Tensor,
                  dinv: torch.Tensor | None,
                  num_classes: int) -> torch.Tensor:
    """One ELL plane's [rows, K] contraction by the ``gee_spmm`` kernel
    (its plain version for CPU tensors).  ``dinv=None`` skips the
    Laplacian scaling of the slots (the reference multiplies by ones)."""
    if dinv is not None:
        vals = vals * dinv[:, None] * dinv[cols.long()]
    ylab, contrib = ell_planes(cols, vals, labels, winv)
    return gee_spmm(ylab, contrib, num_classes)


def _window_plane(window: EdgeList, num_shards: int, shard: int,
                  num_rows: int, undirected: bool, device):
    """Host ELL pack of one window for the ``cuda`` local backend: both
    directions of undirected storage, then rank ``shard``'s plane at a
    pow2-laddered width, so a stream's windows share a few widths."""
    src, dst, w = directed_entries(*window.valid_arrays(), undirected)
    edges = edge_list_from_numpy(src, dst, w, num_rows, device="cpu")
    width = plane_width(src, w, num_shards, laddered=True)
    return shard_plane(edges, num_shards, shard, num_rows, width=width,
                       device=device)


def _slice_stage(device: torch.device, lo: int, hi: int):
    """Stage of a padded window: this rank's sub-window ``[lo, hi)``, sliced
    on the host before the copy so a rank moves 1/P of the window (an owning
    copy on the host: the window may sit in a reused staging buffer)."""
    on_card = device.type == "cuda"

    def stage(w: EdgeList) -> EdgeList:
        def take(t):
            t = t[lo:hi]
            return t.to(device, non_blocking=True) if on_card \
                else t.to(device, copy=True)
        return EdgeList(src=take(w.src), dst=take(w.dst),
                        weight=take(w.weight), num_nodes=w.num_nodes,
                        num_edges=min(max(w.num_edges - lo, 0), hi - lo))
    return stage


def _plane_stage(num_shards: int, shard: int, num_rows: int,
                 undirected: bool, device: torch.device):
    """Stage of a padded window for the ``cuda`` local backend: this rank's
    ELL plane, packed on the host and copied to ``device``."""
    def stage(w: EdgeList) -> PlaneWindow:
        cols, vals = _window_plane(w, num_shards, shard, num_rows,
                                   undirected, device)
        return PlaneWindow(int(w.num_edges), cols, vals)
    return stage


def _staged(source, depth, stage, device, pad_to: int):
    """The source's windows padded to ``pad_to``, each through ``stage``:
    on background threads when the prefetcher takes the source, else
    here."""
    pf = _prefetch_windows(source, depth, stage=stage, device=device)
    for w in pf.windows(pad_to=pad_to):
        yield w if pf is not source else stage(w)


def gee_streamed_sharded(source, labels, num_classes: int,
                         opts: GEEOptions = GEEOptions(), *, group=None,
                         local_backend: str = "segment_sum",
                         prefetch_windows: int | None = None,
                         device=None) -> torch.Tensor:
    """Disk-bounded multi-device GEE: stream windows, fold this rank's
    share of each.

    ``source`` is anything ``repro_torch.graph.io.as_window_source`` takes
    (an ``EdgeList``, a ``ChunkedEdgeList`` such as a mapped ``.geeb``) or
    a ``PreparedGraph``.  Each window is padded to ``pad_nodes(window, P)``
    and rank r folds its slice ``[r*g/P, (r+1)*g/P)``, sliced on the host
    before the copy, into a float64 partial: host-to-device traffic and
    device memory are O(window/P + N*K) a rank.  ``local_backend="cuda"``
    packs each window into this rank's ELL plane (rank-interleaved, as
    ``repro_torch.graph.partition.shard_edges_to_ell``) and contracts it
    with the ``gee_spmm`` kernel; the Laplacian degree pass always folds
    the slices.  One reduce-scatter and the row-local epilogue end it
    (:func:`combine_partials`).

    ``device=None`` is where the source's windows already live, else the
    card; ``prefetch_windows`` as in ``stream_fold``.  Returns this rank's
    row block [N_pad/P, K] (a world of one: [N, K]); :func:`gather_rows`
    assembles the whole.  Numerically the ``gee_sparse_torch`` contract up
    to the order of the sums.
    """
    from repro_torch.graph.io import as_window_source

    if hasattr(source, "chunked") and not hasattr(source, "windows"):
        source = source.chunked()      # PreparedGraph (duck-typed: no cycle)
    source = as_window_source(source)
    if local_backend not in LOCAL_BACKENDS:
        raise ValueError(f"unknown local_backend {local_backend!r}; "
                         f"pick one of {LOCAL_BACKENDS}")
    if device is None:
        device = getattr(source, "device", None)
    device = resolve_device(device)
    p, r, _ = _group_of(group)
    n, k = source.num_nodes, int(num_classes)
    labels = torch.as_tensor(labels).to(device=device, dtype=torch.int32)
    if labels.shape[0] != n:
        raise ValueError(f"labels cover {labels.shape[0]} nodes, "
                         f"graph has {n}")
    n_pad = pad_nodes(n, p)
    labels = pad_labels(labels, n_pad, device)
    winv = class_weight_inv(labels, k)
    und = source.undirected
    g = pad_nodes(source.window_edges, p)   # window split into P sub-windows
    c = g // p
    sub = _slice_stage(device, r * c, (r + 1) * c)
    tr = obs_trace.get_tracer()
    traced = tr.enabled and device.type == "cuda"
    degree_windows = 0

    if opts.laplacian:
        deg = torch.zeros(n_pad, dtype=torch.float64, device=device)
        for i, w in enumerate(_staged(source, prefetch_windows, sub, device,
                                      g)):                   # pass 1
            with tr.span("fold.window", phase="degrees", idx=i, shards=p,
                         edges=int(w.num_edges)):
                fold_degrees(deg, w.src, w.dst, w.weight, undirected=und)
                if traced:       # async launches: sync for honest spans
                    torch.cuda.synchronize(device)
            degree_windows += 1
        dinv = degrees_to_dinv(all_reduce_degrees(deg, group=group),
                               opts.diag_aug)
    else:
        dinv = torch.ones(n_pad, dtype=torch.float32, device=device)

    t_scatter = time.perf_counter()
    scatter_windows = edges_folded = 0
    z = torch.zeros(n_pad * k, dtype=torch.float64, device=device)
    stage = sub if local_backend == "segment_sum" else \
        _plane_stage(p, r, n_pad, und, device)
    for i, w in enumerate(_staged(source, prefetch_windows, stage, device,
                                  g)):                       # pass 2
        with tr.span("fold.window", phase="scatter", idx=i, shards=p,
                     edges=int(w.num_edges)):
            if isinstance(w, PlaneWindow):
                z += plane_partial(w.cols, w.vals, labels, winv,
                                   dinv if opts.laplacian else None,
                                   k).reshape(-1)
            else:
                fold_z(z, w.src, w.dst, w.weight, labels, winv, dinv,
                       num_classes=k, undirected=und)
            if traced:
                torch.cuda.synchronize(device)
        scatter_windows += 1
        edges_folded += int(w.num_edges)

    with tr.span("fold.combine", shards=p, n=n, k=k):
        out = combine_partials(z.reshape(n_pad, k), labels, winv, dinv,
                               group=group, opts=opts)
        if traced:
            torch.cuda.synchronize(device)
    _record_fold(degree_windows, scatter_windows, edges_folded,
                 time.perf_counter() - t_scatter)
    return out


__all__ = ["both_directions", "scatter_partial", "fold_degrees", "fold_z",
           "stream_fold", "LOCAL_BACKENDS", "world_size", "pad_nodes",
           "pad_labels", "all_reduce_degrees", "degrees_to_dinv",
           "combine_partials", "finish_row_block", "gather_rows", "plane_partial",
           "gee_streamed_sharded"]
