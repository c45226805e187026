"""Carry graph state from the reference package into the port.

GEE has no model weights; what carries across is the graph and its prep.
Both functions take plain numpy arrays (what ``np.asarray`` gives for the
reference's arrays), so this module needs nothing of the reference:

* ``edge_list_from_reference``: an ``EdgeList``'s ``src``/``dst``/``weight``
  (padding tail included) with its ``num_nodes``/``num_edges``.
* ``bucketed_ell_from_reference``: a ``BucketedELL``'s per-bucket
  ``(cols, vals, row_ids, num_rows, width)``.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.containers import EdgeList
from repro_torch.graph.ell import BucketedELL, ELLBucket


def edge_list_from_reference(src, dst, weight, num_nodes: int,
                             num_edges: int, device=None) -> EdgeList:
    """The reference's edge-list arrays -> ``EdgeList`` on ``device``
    (``None``: the card), padding tail and ``num_edges`` kept as given."""
    device = resolve_device(device)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    weight = np.asarray(weight, np.float32)
    if not src.shape == dst.shape == weight.shape or src.ndim != 1:
        raise ValueError("src, dst and weight must be 1-D of one length")
    if not 0 <= num_edges <= src.shape[0]:
        raise ValueError(f"num_edges {num_edges} outside [0, "
                         f"{src.shape[0]}]")
    return EdgeList(src=torch.from_numpy(src.copy()).to(device),
                    dst=torch.from_numpy(dst.copy()).to(device),
                    weight=torch.from_numpy(weight.copy()).to(device),
                    num_nodes=int(num_nodes), num_edges=int(num_edges))


def bucketed_ell_from_reference(
        buckets: Iterable[Sequence], num_nodes: int,
        device=None) -> BucketedELL:
    """The reference's ``BucketedELL`` -> the port's, on ``device``.

    ``buckets`` yields ``(cols, vals, row_ids, num_rows, width)`` per
    bucket, the arrays as numpy.
    """
    device = resolve_device(device)
    out = []
    for cols, vals, row_ids, num_rows, width in buckets:
        cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals, np.float32)
        row_ids = np.asarray(row_ids, np.int32)
        if cols.shape != vals.shape or cols.ndim != 2 \
                or cols.shape[1] != width or row_ids.shape != cols.shape[:1]:
            raise ValueError(f"bucket of width {width} has inconsistent "
                             f"shapes {cols.shape}, {vals.shape}, "
                             f"{row_ids.shape}")
        out.append(ELLBucket(
            cols=torch.from_numpy(cols.copy()).to(device),
            vals=torch.from_numpy(vals.copy()).to(device),
            row_ids=torch.from_numpy(row_ids.copy()).to(device),
            num_rows=int(num_rows), width=int(width)))
    return BucketedELL(buckets=tuple(out), num_nodes=int(num_nodes))


__all__ = ["edge_list_from_reference", "bucketed_ell_from_reference"]
