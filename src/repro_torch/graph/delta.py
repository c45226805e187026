"""Padded delta batches for streaming graph updates (port of
``repro/graph/delta.py``).

A delta batch is a fixed-size, padded container with a static
``num_deltas``: padding slots are exact no-ops, and the appliers
(``IncrementalGEE``) slice the valid prefix.

Two delta kinds cover every GEE input mutation:

* ``EdgeDelta``   -- weighted edge increments.  ``weight > 0`` inserts or
  up-weights the directed edge (src, dst); ``weight < 0`` down-weights it
  (removal = the negated current weight); ``weight == 0`` marks padding.
  Undirected streams store both directions, exactly like ``EdgeList`` --
  ``symmetrize_delta`` converts.
* ``LabelDelta``  -- label reassignments ``y[node] <- new_label`` (-1 makes a
  node unknown again).  Padding slots carry ``node == -1``.

The fields are **host numpy arrays** (int32 ids and labels, float32
weights), never device tensors: every consumer reads them on the host --
the appliers, the coalescers and the write-ahead log -- so a device copy
would only be copied back.  Array-likes given to the constructors
(lists, numpy arrays, CPU tensors) are converted.

``coalesce_edge_deltas`` / ``coalesce_label_deltas`` merge a backlog of
batches into one minimal batch (sum duplicate (src, dst) increments and
drop exact cancellations; last write wins per node) -- the serving queue
uses them so a burst of updates costs one state update.

Every batch carries a **sequence number** ``seq`` (-1 = unsequenced).  The
durability layer (``repro_torch.serve.snapshot``) stamps each logged batch
with a monotonically increasing seq; ``IncrementalGEE`` records the highest
applied seq as its *watermark* and skips batches at or below it, so
write-ahead-log replay after crash recovery is idempotent.  Coalescing
keeps the highest input seq; symmetrizing and padding preserve it.

>>> import numpy as np
>>> d = edge_delta_from_numpy(np.array([3]), np.array([9]),
...                           np.array([1.0]))      # insert edge {3, 9}
>>> d = symmetrize_delta(d)                         # store both directions
>>> d.num_deltas, d.src.tolist(), d.dst.tolist()
(2, [3, 9], [9, 3])
>>> merged = coalesce_edge_deltas([d, symmetrize_delta(
...     edge_delta_from_numpy(np.array([3]), np.array([9]),
...                           np.array([-1.0])))])  # insert then remove
>>> merged.num_deltas                               # cancels to nothing
0
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def _pad_to_multiple(d: int, multiple: int) -> int:
    return ((d + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """Padded batch of directed weighted-edge increments.

    Attributes:
      src:     [D_pad] int32 source node ids (0 in padding slots).
      dst:     [D_pad] int32 destination node ids (0 in padding slots).
      weight:  [D_pad] float32 weight increments (0 == padding/no-op).
      num_deltas: number of valid entries.
      seq:     replay sequence number (-1 = unsequenced).
    """

    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    num_deltas: int
    seq: int = -1

    @property
    def padded_size(self) -> int:
        return int(self.src.shape[0])

    def with_padding(self, multiple: int) -> "EdgeDelta":
        """Pad so D_pad is a multiple of ``multiple``."""
        pad = _pad_to_multiple(self.padded_size, multiple) - self.padded_size
        if not pad:
            return self
        return EdgeDelta(
            src=np.concatenate([self.src, np.zeros(pad, np.int32)]),
            dst=np.concatenate([self.dst, np.zeros(pad, np.int32)]),
            weight=np.concatenate([self.weight, np.zeros(pad, np.float32)]),
            num_deltas=self.num_deltas, seq=self.seq)


@dataclasses.dataclass(frozen=True)
class LabelDelta:
    """Padded batch of label reassignments.

    Attributes:
      node:      [D_pad] int32 node ids (-1 in padding slots).
      new_label: [D_pad] int32 new labels, -1 = unknown (0 in padding slots).
      num_deltas: number of valid entries.
      seq:       replay sequence number (-1 = unsequenced).
    """

    node: np.ndarray
    new_label: np.ndarray
    num_deltas: int
    seq: int = -1

    @property
    def padded_size(self) -> int:
        return int(self.node.shape[0])

    def with_padding(self, multiple: int) -> "LabelDelta":
        pad = _pad_to_multiple(self.padded_size, multiple) - self.padded_size
        if not pad:
            return self
        return LabelDelta(
            node=np.concatenate([self.node, np.full(pad, -1, np.int32)]),
            new_label=np.concatenate([self.new_label,
                                      np.zeros(pad, np.int32)]),
            num_deltas=self.num_deltas, seq=self.seq)


def edge_delta_from_numpy(src, dst, weight=None,
                          pad_to: int | None = None,
                          seq: int = -1) -> EdgeDelta:
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if weight is None:
        weight = np.ones(src.shape, np.float32)
    weight = np.asarray(weight, np.float32)
    d = src.shape[0]
    size = d if pad_to is None else max(pad_to, d)
    s = np.zeros((size,), np.int32)
    t = np.zeros((size,), np.int32)
    w = np.zeros((size,), np.float32)
    s[:d], t[:d], w[:d] = src, dst, weight
    return EdgeDelta(src=s, dst=t, weight=w, num_deltas=int(d),
                     seq=int(seq))


def label_delta_from_numpy(node, new_label,
                           pad_to: int | None = None,
                           seq: int = -1) -> LabelDelta:
    node = np.asarray(node, np.int32)
    new_label = np.asarray(new_label, np.int32)
    d = node.shape[0]
    size = d if pad_to is None else max(pad_to, d)
    nd = np.full((size,), -1, np.int32)
    lb = np.zeros((size,), np.int32)
    nd[:d], lb[:d] = node, new_label
    return LabelDelta(node=nd, new_label=lb, num_deltas=int(d),
                      seq=int(seq))


def symmetrize_delta(delta: EdgeDelta) -> EdgeDelta:
    """One-entry-per-undirected-increment -> directed, as ``symmetrize``.

    Self loops stay single; the reversed valid entries are packed adjacent
    to the valid prefix with an exact ``num_deltas``.
    """
    d = delta.num_deltas
    src, dst, w = delta.src, delta.dst, delta.weight
    vsrc, vdst, vw = src[:d], dst[:d], w[:d]
    nonloop = vsrc != vdst
    return EdgeDelta(
        src=np.concatenate([vsrc, vdst[nonloop], src[d:]]),
        dst=np.concatenate([vdst, vsrc[nonloop], dst[d:]]),
        weight=np.concatenate([vw, vw[nonloop], w[d:]]),
        num_deltas=d + int(nonloop.sum()),
        seq=delta.seq,
    )


def coalesce_edge_deltas(deltas: Sequence[EdgeDelta],
                         pad_multiple: int | None = None) -> EdgeDelta:
    """Merge a backlog into one batch: duplicate (src, dst) increments sum,
    and pairs whose increments cancel exactly are dropped.  The output is
    in ascending (src, dst) order."""
    srcs = [d.src[: d.num_deltas] for d in deltas]
    dsts = [d.dst[: d.num_deltas] for d in deltas]
    ws = [d.weight[: d.num_deltas].astype(np.float64) for d in deltas]
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int32)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int32)
    w = np.concatenate(ws) if ws else np.empty(0, np.float64)
    if src.size:
        key = src.astype(np.int64) * (int(dst.max()) + 1) \
            + dst.astype(np.int64)
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        wsum = np.zeros(uniq.size, np.float64)
        np.add.at(wsum, inv, w)
        keep = wsum != 0.0
        src, dst, w = src[first[keep]], dst[first[keep]], wsum[keep]
    seq = max((d.seq for d in deltas), default=-1)
    out = edge_delta_from_numpy(src, dst, w.astype(np.float32), seq=seq)
    if pad_multiple:
        out = out.with_padding(pad_multiple)
    return out


def coalesce_label_deltas(deltas: Sequence[LabelDelta],
                          pad_multiple: int | None = None) -> LabelDelta:
    """Merge a backlog into one batch: last write per node wins (nodes in
    the order of their first write)."""
    final: dict[int, int] = {}
    for d in deltas:
        nodes = d.node[: d.num_deltas]
        labs = d.new_label[: d.num_deltas]
        for nd, lb in zip(nodes.tolist(), labs.tolist()):
            final[nd] = lb
    nodes = np.fromiter(final.keys(), np.int32, len(final))
    labs = np.fromiter(final.values(), np.int32, len(final))
    seq = max((d.seq for d in deltas), default=-1)
    out = label_delta_from_numpy(nodes, labs, seq=seq)
    if pad_multiple:
        out = out.with_padding(pad_multiple)
    return out


__all__ = ["EdgeDelta", "LabelDelta", "edge_delta_from_numpy",
           "label_delta_from_numpy", "symmetrize_delta",
           "coalesce_edge_deltas", "coalesce_label_deltas"]
