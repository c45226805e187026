"""Edge partitioning for the multi-device folds (port of
``repro/graph/partition.py``).

Edges are 1-D sharded across the ranks of a process group.  Each shard is
padded to a common length so the global arrays stay rectangular; padding
entries weigh 0 (exact no-ops).  A random permutation before the split
evens out both the edge counts and the expected per-class mass across
shards.

``shard_edges_to_ell`` is the same strategy for the ``cuda`` local
backend: each shard's edges are packed into an ELL plane over the full row
range (every rank contracts a *partial* [N_pad, K] embedding, as the
scatter does), at one common width.  Edge r of row i goes to shard
``r % P``, slot ``r // P`` (rank interleaving), which bounds every shard's
row degree at ``ceil(deg_i / P)`` and makes the packing deterministic.
``width=`` pins the plane width; ``stable_plane_width`` pow2-ladders it so a
stream's windows reuse a few widths.

Everything here is host numpy, and the integer outputs equal the
reference's bit for bit; tensors are handed over on ``device`` (``None``:
the card).  ``shard_plane`` packs one shard alone, which is what one rank
needs: the same slots as its block of ``shard_edges_to_ell``, in 1/P of
the host memory.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.containers import EdgeList, edge_list_from_numpy
from repro_torch.graph.ell import _group_edges_by_row
from repro_torch.obs import trace as obs_trace


def shard_edges(edges: EdgeList, num_shards: int, seed: int = 0,
                pad_multiple: int = 8, device=None) -> EdgeList:
    """An ``EdgeList`` whose arrays are shuffled and padded to
    ``num_shards * L``, so shard ``s`` is the block ``[s*L, (s+1)*L)``; on
    ``device`` (``None``: the card)."""
    src, dst, w = edges.valid_arrays()
    e = src.shape[0]
    perm = np.random.default_rng(seed).permutation(e)
    src, dst, w = src[perm], dst[perm], w[perm]
    per = -(-e // num_shards)
    per = ((per + pad_multiple - 1) // pad_multiple) * pad_multiple
    return edge_list_from_numpy(src, dst, w, edges.num_nodes,
                                pad_to=per * num_shards, device=device)


def stable_plane_width(max_row_degree: int, num_shards: int = 1,
                       base: int = 8) -> int:
    """Pow2-laddered per-shard plane width: ``ceil(max_row_degree / P)``
    rounded up to a power of two (at least ``base``), so the windows of a
    stream share O(log max_degree) widths."""
    need = max(1, -(-max(int(max_row_degree), 0) // num_shards))
    width = base
    while width < need:
        width *= 2
    return width


def directed_entries(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                     undirected: bool
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The entries a plane packs: both directions of undirected storage
    (a self loop once), else the arrays as they are."""
    if not undirected:
        return src, dst, weight
    nonloop = src != dst
    return (np.concatenate([src, dst[nonloop]]),
            np.concatenate([dst, src[nonloop]]),
            np.concatenate([weight, weight[nonloop]]))


def plane_width(src: np.ndarray, weight: np.ndarray, num_shards: int, *,
                laddered: bool = False) -> int:
    """A shard plane's width: ``ceil(max_row_degree / P)`` over the entries
    of nonzero weight, or its pow2 ladder (:func:`stable_plane_width`),
    which a stream's windows pack at.  Rows are every node, padded to a
    multiple of P."""
    deg = int(np.bincount(src[weight != 0], minlength=1).max())
    if laddered:
        return stable_plane_width(deg, num_shards)
    return max(1, -(-deg // num_shards))


def _pack(edges: EdgeList, num_shards: int, num_rows: int,
          width: int | None, shards: Sequence[int]
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Host planes ``[len(shards), num_rows, width]`` of the listed
    shards under rank interleaving (empty slots: col 0, weight 0)."""
    with obs_trace.span("pack.shard_ell", shards=num_shards, rows=num_rows,
                        edges=edges.num_edges) as sp:
        gs, gd, gw, _, slot = _group_edges_by_row(edges, None)
        need = plane_width(gs, gw, num_shards)
        if width is None:
            width = need
        elif width < need:
            raise ValueError(f"width {width} cannot hold the densest row: "
                             f"need {need} "
                             f"(= ceil(max_degree / num_shards))")
        sp.tag(width=int(width))
        pos = np.full(num_shards, -1, np.int64)   # shard -> output plane
        pos[list(shards)] = np.arange(len(shards))
        plane = pos[slot % num_shards]
        mine = plane >= 0
        sslot = slot[mine] // num_shards
        cols = np.zeros((len(shards), num_rows, width), np.int32)
        vals = np.zeros((len(shards), num_rows, width), np.float32)
        cols[plane[mine], gs[mine], sslot] = gd[mine]
        vals[plane[mine], gs[mine], sslot] = gw[mine]
        return cols, vals


def shard_edges_to_ell(edges: EdgeList, num_shards: int, num_rows: int,
                       width: int | None = None, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard's ELL plane over all ``num_rows`` rows, stacked:
    ``(cols, vals)`` shaped [num_shards * num_rows, width] on ``device``
    (``None``: the card).

    ``width=None`` packs at the minimum ``ceil(max_row_degree / P)``; a
    pinned width too small for the densest row raises ``ValueError``.
    The packing is deterministic, so the reference's unused ``seed`` is
    not taken.
    """
    cols, vals = _pack(edges, num_shards, num_rows, width,
                       range(num_shards))
    device = resolve_device(device)
    w = cols.shape[2]
    return (torch.from_numpy(cols.reshape(num_shards * num_rows, w))
            .to(device),
            torch.from_numpy(vals.reshape(num_shards * num_rows, w))
            .to(device))


def shard_plane(edges: EdgeList, num_shards: int, shard: int, num_rows: int,
                width: int | None = None, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard ``shard``'s plane alone: rows ``[shard*num_rows,
    (shard+1)*num_rows)`` of :func:`shard_edges_to_ell`, [num_rows, width],
    on ``device`` (``None``: the card)."""
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range for {num_shards}")
    cols, vals = _pack(edges, num_shards, num_rows, width, (shard,))
    device = resolve_device(device)
    return (torch.from_numpy(cols[0]).to(device),
            torch.from_numpy(vals[0]).to(device))


__all__ = ["shard_edges", "stable_plane_width", "directed_entries",
           "plane_width", "shard_edges_to_ell", "shard_plane"]
