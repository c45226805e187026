"""ELL packing: edge list -> fixed-width row tiles (port of
``repro/graph/ell.py``).

The packers are host numpy and produce arrays identical to the reference's
(same width ladder 8, 16, 32, ..., same ``SUBLANE`` row padding, same dump
row ``n`` for bucket padding), then hand them over as tensors on the
requested device:

  * ``edges_to_ell``          one plane, width = global max degree.
  * ``edges_to_bucketed_ell`` rows partitioned into degree buckets of
                              geometrically growing width; each row lands
                              in the narrowest bucket that fits its degree.

The kernels consume *planes*, built on the device by ``ell_planes``:

  ylab    [R, D] int32   class of the neighbor in each slot, -1 = padding
  contrib [R, D] float32 w_ij / n_k contribution of the slot, 0 = padding
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.graph.containers import ELL, EdgeList
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# Row padding of the packers.  It is the reference's TPU sublane height and
# is kept so the packings are identical arrays; the CUDA kernels need no
# row padding.
SUBLANE = 8


@dataclasses.dataclass(frozen=True)
class ELLBucket:
    """One degree bucket: all member rows share the same tile width.

    cols:    [R_pad, width] int32 neighbor ids (0 in padding slots).
    vals:    [R_pad, width] float32 edge weights (0 in padding slots).
    row_ids: [R_pad] int32 original node id of each packed row; padding rows
             point at the dump row ``num_nodes``.
    num_rows: number of *real* rows (<= R_pad).
    width:    tile width of this bucket.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    row_ids: torch.Tensor
    num_rows: int
    width: int

    def real_rows(self) -> "ELLBucket":
        """The bucket without its padding rows, which are its trailing
        ``R_pad - num_rows`` rows: contiguous views of the leading rows."""
        n = self.num_rows
        return dataclasses.replace(self, cols=self.cols[:n],
                                   vals=self.vals[:n],
                                   row_ids=self.row_ids[:n])


@dataclasses.dataclass(frozen=True)
class BucketedELL:
    """Degree-bucketed ELL tiling of one graph.

    Rows with degree 0 appear in no bucket.  Scatter targets use
    ``num_nodes`` as a dump row, so consumers allocate N+1 output rows and
    slice ``[:N]``.
    """

    buckets: Tuple[ELLBucket, ...]
    num_nodes: int

    @property
    def total_slots(self) -> int:
        return sum(int(b.cols.shape[0]) * b.width for b in self.buckets)


# ---------------------------------------------------------------------------
# O(E) row grouping (shared by both packers)
# ---------------------------------------------------------------------------

def _group_edges_by_row(edges: EdgeList, max_degree: int | None):
    """Counting-sort edges by source row.

    Returns (src, dst, w, counts, slot): arrays sorted by src, per-row edge
    counts [N] (post-truncation), and each edge's slot index within its
    row.  Weight-0 (padding) edges are dropped first.
    """
    n = edges.num_nodes
    src, dst, w = edges.valid_arrays()
    keep = w != 0
    src, dst, w = src[keep], dst[keep], w[keep]

    order = np.argsort(src, kind="stable")   # radix sort on int32: O(E)
    src, dst, w = src[order], dst[order], w[order]
    counts = np.bincount(src, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    slot = np.arange(src.size, dtype=np.int64) - indptr[src]
    if max_degree is not None:
        keep2 = slot < max_degree
        src, dst, w, slot = src[keep2], dst[keep2], w[keep2], slot[keep2]
        counts = np.minimum(counts, max_degree)
    return src, dst, w, counts, slot


def _target(edges: EdgeList, device) -> torch.device:
    return edges.device if device is None else torch.device(device)


# ---------------------------------------------------------------------------
# single-plane packer (width = global max degree)
# ---------------------------------------------------------------------------

def edges_to_ell(edges: EdgeList, row_pad: int = SUBLANE,
                 max_degree: int | None = None, device=None) -> ELL:
    """Edge list -> single-plane ELL on ``device`` (default: the edges')."""
    n = edges.num_nodes
    src, dst, w, counts, slot = _group_edges_by_row(edges, max_degree)
    dmax = max(int(counts.max()) if counts.size else 1, 1)
    n_pad = ((n + row_pad - 1) // row_pad) * row_pad
    cols = np.zeros((n_pad, dmax), np.int32)
    vals = np.zeros((n_pad, dmax), np.float32)
    cols[src, slot] = dst
    vals[src, slot] = w
    dev = _target(edges, device)
    return ELL(cols=torch.from_numpy(cols).to(dev),
               vals=torch.from_numpy(vals).to(dev), num_nodes=n)


# ---------------------------------------------------------------------------
# degree-bucketed packer
# ---------------------------------------------------------------------------

def bucket_widths(max_degree: int, base: int = SUBLANE) -> Tuple[int, ...]:
    """Geometric width ladder 8, 16, 32, ... covering ``max_degree``."""
    widths = [base]
    while widths[-1] < max_degree:
        widths.append(widths[-1] * 2)
    return tuple(widths)


def edges_to_bucketed_ell(edges: EdgeList, row_pad: int = SUBLANE,
                          widths: Sequence[int] | None = None,
                          max_degree: int | None = None,
                          device=None) -> BucketedELL:
    """Edge list -> degree-bucketed ELL on ``device`` (default: the
    edges').  Each row goes to the narrowest bucket whose width >= its
    degree; empty rows go nowhere.  Runs under a ``pack.bucketed_ell``
    span, and observes its wall time, traced or not, into the registry's
    ``pack.bucketed_ell_ms`` histogram (one observation a packing)."""
    t0 = time.perf_counter()
    with obs_trace.span("pack.bucketed_ell", nodes=edges.num_nodes):
        out = _bucketed_ell(edges, row_pad, widths, max_degree, device)
    obs_metrics.get_registry().histogram("pack.bucketed_ell_ms").observe(
        (time.perf_counter() - t0) * 1e3)
    return out


def _bucketed_ell(edges: EdgeList, row_pad: int, widths, max_degree,
                  device) -> BucketedELL:
    n = edges.num_nodes
    src, dst, w, counts, slot = _group_edges_by_row(edges, max_degree)
    dmax = max(int(counts.max()) if counts.size else 1, 1)
    if widths is None:
        widths = bucket_widths(dmax)
    widths = tuple(sorted(set(int(x) for x in widths)))
    if widths[-1] < dmax:
        raise ValueError(f"widths {widths} do not cover max degree {dmax}")
    dev = _target(edges, device)

    # bucket index per row: narrowest width >= degree; -1 for empty rows
    bucket_of_row = np.searchsorted(widths, counts, side="left")
    bucket_of_row[counts == 0] = -1

    buckets = []
    for b, width in enumerate(widths):
        rows = np.nonzero(bucket_of_row == b)[0]
        if rows.size == 0:
            continue
        r_pad = ((rows.size + row_pad - 1) // row_pad) * row_pad
        cols = np.zeros((r_pad, width), np.int32)
        vals = np.zeros((r_pad, width), np.float32)
        row_pos = np.empty(n, np.int64)
        row_pos[rows] = np.arange(rows.size)
        emask = bucket_of_row[src] == b
        cols[row_pos[src[emask]], slot[emask]] = dst[emask]
        vals[row_pos[src[emask]], slot[emask]] = w[emask]
        row_ids = np.full((r_pad,), n, np.int32)   # padding -> dump row
        row_ids[: rows.size] = rows
        buckets.append(ELLBucket(
            cols=torch.from_numpy(cols).to(dev),
            vals=torch.from_numpy(vals).to(dev),
            row_ids=torch.from_numpy(row_ids).to(dev),
            num_rows=int(rows.size), width=int(width)))
    return BucketedELL(buckets=tuple(buckets), num_nodes=n)


# ---------------------------------------------------------------------------
# plane construction (the gee_sparse_torch label/weight preprocessing)
# ---------------------------------------------------------------------------

def ell_planes(cols: torch.Tensor, vals: torch.Tensor, labels: torch.Tensor,
               winv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cols, vals) + labels -> (ylab, contrib) kernel planes.

    A slot contributes w * 1/n_k iff it is a real edge (w != 0) whose
    neighbor has a known label; otherwise ylab=-1, contrib=0.
    """
    n = labels.shape[0]
    yd = labels[torch.clamp(cols, 0, n - 1).long()]
    valid = (vals != 0) & (yd >= 0)
    ylab = torch.where(valid, yd, torch.full_like(yd, -1)).to(torch.int32)
    contrib = torch.where(valid, vals * winv[torch.clamp(yd, min=0).long()],
                          torch.zeros_like(vals))
    return ylab, contrib.to(torch.float32)


def bucketed_degrees(bell: BucketedELL, device) -> torch.Tensor:
    """Weighted out-degree [N] of the packed graph on ``device``, assembled
    across buckets (padding rows add into the dropped dump row)."""
    n = bell.num_nodes
    deg = torch.zeros(n + 1, dtype=torch.float32, device=device)
    for b in bell.buckets:
        deg.index_add_(0, b.row_ids.long(), b.vals.sum(dim=1))
    return deg[:n]


def laplacian_vals(bucket: ELLBucket, dinv: torch.Tensor) -> torch.Tensor:
    """``vals * d_row^{-1/2} * d_col^{-1/2}`` of one bucket; padding rows
    (dump row) and padding slots (column 0, weight 0) stay exact zeros."""
    n = dinv.shape[0]
    rows = bucket.row_ids.long().clamp(max=n - 1)
    return bucket.vals * dinv[rows][:, None] \
        * dinv[bucket.cols.clamp(0, n - 1).long()]


# ---------------------------------------------------------------------------
# padding accounting
# ---------------------------------------------------------------------------

def ell_stats(edges: EdgeList, row_pad: int = SUBLANE) -> dict:
    """Slots-per-edge overhead of single-plane vs bucketed packing, from
    the real packers."""
    _, _, _, counts, _ = _group_edges_by_row(edges, None)
    e = int(counts.sum())
    ell = edges_to_ell(edges, row_pad=row_pad, device="cpu")
    bell = edges_to_bucketed_ell(edges, row_pad=row_pad, device="cpu")
    flat_slots = int(ell.cols.shape[0]) * int(ell.cols.shape[1])
    return {
        "num_nodes": edges.num_nodes,
        "num_edges": e,
        "max_degree": max(int(counts.max()) if counts.size else 1, 1),
        "flat_slots": flat_slots,
        "flat_overhead": flat_slots / max(e, 1),
        "bucketed_slots": bell.total_slots,
        "bucketed_overhead": bell.total_slots / max(e, 1),
        "num_buckets": len(bell.buckets),
    }


__all__ = ["ELL", "ELLBucket", "BucketedELL", "SUBLANE", "edges_to_ell",
           "edges_to_bucketed_ell", "ell_planes", "bucketed_degrees",
           "laplacian_vals", "ell_stats", "bucket_widths"]
