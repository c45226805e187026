"""Graph containers as dataclasses of tensors (port of
``repro/graph/containers.py``).

Conventions carried over from the reference unchanged:

* Edge lists are *directed*: an undirected edge {i, j} is stored as the two
  entries (i, j, w) and (j, i, w).  ``symmetrize`` converts.
* Padding edges have ``weight == 0`` and ``src == dst == 0`` and sit in a
  tail after the ``num_edges`` valid entries; weight-zero contributions are
  exact no-ops for every GEE formula.
* Unknown labels are ``-1``: such nodes get a zero row in W but still
  receive an embedding row in Z.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Padded edge list on one device.

    Attributes:
      src:     [E_pad] int32 source node ids.
      dst:     [E_pad] int32 destination node ids.
      weight:  [E_pad] float32 edge weights (0 for padding slots).
      num_nodes: N.
      num_edges: number of *valid* (non-padding) entries.
    """

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    num_nodes: int
    num_edges: int

    @property
    def padded_size(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "EdgeList":
        """The same edge list on ``device`` (``self`` if already there)."""
        device = torch.device(device)
        if self.src.device == device or (
                device.index is None and self.src.device.type == device.type):
            return self
        return EdgeList(src=self.src.to(device), dst=self.dst.to(device),
                        weight=self.weight.to(device),
                        num_nodes=self.num_nodes, num_edges=self.num_edges)

    def valid_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side ``(src, dst, weight)`` of the valid (non-padding)
        prefix: how host consumers (SciPy/loop backends, ELL packing) strip
        the padding tail."""
        e = self.num_edges
        return (self.src[:e].cpu().numpy(), self.dst[:e].cpu().numpy(),
                self.weight[:e].cpu().numpy())

    def with_padding(self, multiple: int) -> "EdgeList":
        """Pad the arrays so E_pad is a multiple of ``multiple``."""
        e = self.padded_size
        target = ((e + multiple - 1) // multiple) * multiple
        if target == e:
            return self
        pad = target - e
        z32 = torch.zeros(pad, dtype=torch.int32, device=self.device)
        zf = torch.zeros(pad, dtype=torch.float32, device=self.device)
        return EdgeList(
            src=torch.cat([self.src, z32]),
            dst=torch.cat([self.dst, z32]),
            weight=torch.cat([self.weight, zf]),
            num_nodes=self.num_nodes,
            num_edges=self.num_edges,
        )


def edge_list_from_numpy(src: np.ndarray, dst: np.ndarray,
                         weight: np.ndarray | None, num_nodes: int,
                         pad_to: int | None = None,
                         device=None) -> EdgeList:
    """Host arrays -> ``EdgeList`` on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if weight is None:
        weight = np.ones(src.shape, np.float32)
    weight = np.asarray(weight, np.float32)
    e = src.shape[0]
    size = e if pad_to is None else max(pad_to, e)
    s = np.zeros((size,), np.int32)
    d = np.zeros((size,), np.int32)
    w = np.zeros((size,), np.float32)
    s[:e], d[:e], w[:e] = src, dst, weight
    return EdgeList(
        src=torch.from_numpy(s).to(device),
        dst=torch.from_numpy(d).to(device),
        weight=torch.from_numpy(w).to(device),
        num_nodes=int(num_nodes), num_edges=int(e),
    )


def symmetrize(edges: EdgeList) -> EdgeList:
    """Turn a one-entry-per-undirected-edge list into a directed list.

    Self loops are kept single.  The reversed copies of the valid non-loop
    edges are packed directly after the valid prefix (before any padding),
    and ``num_edges`` is exact: 2E minus one per self loop.
    """
    e = edges.num_edges
    vsrc, vdst, vw = edges.src[:e], edges.dst[:e], edges.weight[:e]
    nonloop = vsrc != vdst
    return EdgeList(
        src=torch.cat([vsrc, vdst[nonloop], edges.src[e:]]),
        dst=torch.cat([vdst, vsrc[nonloop], edges.dst[e:]]),
        weight=torch.cat([vw, vw[nonloop], edges.weight[e:]]),
        num_nodes=edges.num_nodes,
        num_edges=e + int(nonloop.sum()),
    )


def add_self_loops(edges: EdgeList, value: float = 1.0) -> EdgeList:
    """Diagonal augmentation: A + I as an edge-list concatenation.

    The loop entries are spliced in directly after the valid prefix (not
    after any padding), so consumers that slice ``[:num_edges]`` see them.
    """
    n, e = edges.num_nodes, edges.num_edges
    ids = torch.arange(n, dtype=torch.int32, device=edges.device)
    loops_w = torch.full((n,), value, dtype=torch.float32,
                         device=edges.device)
    return EdgeList(
        src=torch.cat([edges.src[:e], ids, edges.src[e:]]),
        dst=torch.cat([edges.dst[:e], ids, edges.dst[e:]]),
        weight=torch.cat([edges.weight[:e], loops_w, edges.weight[e:]]),
        num_nodes=n,
        num_edges=e + n,
    )


def degrees(edges: EdgeList) -> torch.Tensor:
    """Weighted out-degree per node, [N] float32 (padding adds 0)."""
    deg = torch.zeros(edges.num_nodes, dtype=torch.float32,
                      device=edges.device)
    return deg.index_add_(0, edges.src.long(), edges.weight)


@dataclasses.dataclass(frozen=True)
class ELL:
    """Fixed-max-degree row-major tiling.

    cols: [N_pad, D_max] int32 neighbor ids (0 in padding slots).
    vals: [N_pad, D_max] float32 edge weights (0 in padding slots).
    num_nodes: N (<= N_pad).
    """

    cols: torch.Tensor
    vals: torch.Tensor
    num_nodes: int


__all__ = ["EdgeList", "ELL", "edge_list_from_numpy", "symmetrize",
           "add_self_loops", "degrees"]
