"""Incremental (streaming) GEE: O(|delta|) updates instead of O(E) refits
(port of ``repro/core/incremental.py``).

GEE is linear in the adjacency: Z = A_hat @ W where W only depends on the
labels.  ``IncrementalGEE`` holds the *unnormalized* accumulators

  S[i, k]   per-class neighbor sums  (A_aug @ onehot(y), Laplacian-scaled
            when the option is on, including the diagonal-augmentation term)
  nk[k]     class counts (the 1/n_k normalization is applied at query time)
  deg[i]    weighted out-degrees of the raw graph

plus a host-side adjacency (out- and in-neighbor dicts), and applies
``EdgeDelta`` / ``LabelDelta`` batches in O(|delta| + affected-row edges):

* plain / diag_aug: an edge increment (u, v, w) touches only row u; a label
  flip at j touches j's in-neighbors (and j's own diagonal term).
* laplacian: a degree change at u rescales d_u^{-1/2}, which multiplies
  every edge incident to u -- so rows {u} + in-neighbors(u) are rebuilt
  from their adjacency lists.
* correlation: a per-row postprocess -- renormalize only touched rows.

Where the state lives:

* The accumulators (``S``, ``nk``, ``deg``, ``_dinv``: float64; ``labels``:
  int32) and the adjacency stay on the **host** and are updated with the
  reference's numpy code in the reference's order of additions
  (``np.add.at`` is sequential), so after the same deltas ``S`` is
  bit-equal to the reference's.  Device atomics would sum in no fixed
  order, and a recovered run could then not match an uninterrupted one
  bit for bit.
* The **Z cache lives on the device** (the card unless the caller asks for
  the CPU): a refresh copies ``S[rows]`` there, scales it by 1/n_k in
  float64, casts to float32 and, under "correlation", row-normalizes it
  with ``epilogue.row_l2_normalize`` (the ``row_norm`` kernel on the card).
  Edge deltas invalidate only the affected rows; label deltas also dirty
  the global 1/n_k scaling, which forces one full refresh on the next read.
  ``add_dirty_listener`` pushes the invalidations to consumers of Z such as
  the vertex-similarity index.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.epilogue import inv_sqrt_degrees_np, row_l2_normalize
from repro_torch.core.gee import GEEOptions
from repro_torch.graph.containers import EdgeList, edge_list_from_numpy
from repro_torch.graph.delta import EdgeDelta, LabelDelta

Delta = Union[EdgeDelta, LabelDelta]

_DIAG_W = 1.0          # diagonal-augmentation weight (A + I)


class DirtyRowTracker:
    """Listener-side accumulator for ``add_dirty_listener`` events.

    Register the tracker itself as the listener; it folds per-row
    invalidations (a full invalidation collapses the set to the all-rows
    sentinel), and ``drain`` hands the pending rows to whatever repairs
    derived state -- the vertex-similarity index above all.  Shared by
    ``GEEQueryService``, ``GEEEmbedder`` and ``recover``.
    """

    def __init__(self, num_rows: int):
        self.n = int(num_rows)
        self._rows: set[int] = set()
        self._all = False

    def __call__(self, rows, full: bool = False) -> None:
        if full:
            self._all = True
            self._rows.clear()
        elif not self._all:
            self._rows.update(int(r) for r in rows)

    @property
    def pending(self) -> int:
        """Rows a ``drain`` would return (n when fully invalidated)."""
        return self.n if self._all else len(self._rows)

    @property
    def full(self) -> bool:
        return self._all

    def drain(self) -> np.ndarray:
        """Rows needing repair (every row when full); clears the state."""
        if self._all:
            rows = np.arange(self.n, dtype=np.int64)
        else:
            rows = np.fromiter(self._rows, np.int64, len(self._rows))
        self._rows.clear()
        self._all = False
        return rows


def fill_adjacency(adj: list, rows: np.ndarray, cols: np.ndarray,
                   vals: np.ndarray) -> None:
    """Fill per-row neighbor dicts from row-grouped (sorted) triplets."""
    if rows.size == 0:
        return
    starts = np.r_[0, np.flatnonzero(np.diff(rows)) + 1, rows.size]
    cols = cols.tolist()
    vals = vals.tolist()
    for a, b in zip(starts[:-1], starts[1:]):
        adj[int(rows[a])] = dict(zip(cols[a:b], vals[a:b]))


class IncrementalGEE:
    """Mutable GEE state supporting O(|delta|) edge/label updates.

    Build with ``from_graph`` (or ``GEEEmbedder.partial_fit``), mutate with
    ``apply``, query with ``embedding`` (a tensor on ``device``: the card
    unless the caller asks for the CPU).  ``to_edge_list`` reconstructs the
    current graph for from-scratch verification.
    """

    def __init__(self, num_nodes: int, num_classes: int,
                 opts: GEEOptions = GEEOptions(), device=None):
        self.n = int(num_nodes)
        self.k = int(num_classes)
        self.opts = opts
        self.device = resolve_device(device)
        self.labels = np.full(self.n, -1, np.int32)
        self.nk = np.zeros(self.k, np.float64)
        self.deg = np.zeros(self.n, np.float64)          # raw out-degree
        self.out_nbrs: list[dict[int, float]] = [dict() for _ in range(self.n)]
        self.in_nbrs: list[dict[int, float]] = [dict() for _ in range(self.n)]
        self.S = np.zeros((self.n, self.k), np.float64)
        self._dinv = self._dinv_of(self._deg_aug())      # laplacian only
        self._z: torch.Tensor | None = None              # cached f32 Z
        self._dirty_rows: set[int] = set()
        self._winv_dirty = False
        self._dirty_listeners: list = []
        # Highest applied delta sequence number (-1 = nothing sequenced).
        # Sequenced batches at or below the watermark are skipped, making
        # write-ahead-log replay idempotent (repro_torch.serve.snapshot).
        self.applied_seq = -1
        self.stats = {
            "edge_deltas": 0, "label_deltas": 0, "rows_recomputed": 0,
            "row_edges_scanned": 0, "z_rows_patched": 0, "z_full_refreshes": 0,
            "skipped_replays": 0,
        }

    # -- construction --------------------------------------------------------
    @classmethod
    def from_graph(cls, edges: EdgeList, labels, num_classes: int,
                   opts: GEEOptions = GEEOptions(),
                   device=None) -> "IncrementalGEE":
        """Promote a fitted graph.  The Z cache goes to ``device``; by
        default, the device the edge list is on."""
        self = cls(edges.num_nodes, num_classes, opts,
                   device=edges.device if device is None else device)
        y = np.asarray(labels, np.int32)
        if y.shape[0] != self.n:
            raise ValueError(f"labels shape {y.shape} != num_nodes {self.n}")
        self.labels = y.copy()
        valid = y >= 0
        self.nk = np.bincount(y[valid], minlength=self.k).astype(np.float64)

        src, dst, w = edges.valid_arrays()
        w = w.astype(np.float64)
        keep = w != 0
        src, dst, w = src[keep], dst[keep], w[keep]
        np.add.at(self.deg, src, w)
        # Adjacency build: coalesce duplicate (u, v) pairs once, then fill
        # per-row dicts from contiguous segments (C-speed dict(zip(...))).
        key = src.astype(np.int64) * self.n + dst.astype(np.int64)
        uniq, inv = np.unique(key, return_inverse=True)
        wsum = np.zeros(uniq.size, np.float64)
        np.add.at(wsum, inv, w)
        nz = wsum != 0
        uniq, wsum = uniq[nz], wsum[nz]
        usrc, udst = uniq // self.n, uniq % self.n
        fill_adjacency(self.out_nbrs, usrc, udst, wsum)
        order = np.argsort(udst, kind="stable")
        fill_adjacency(self.in_nbrs, udst[order], usrc[order], wsum[order])

        if opts.laplacian:
            self._dinv = self._dinv_of(self._deg_aug())
            w_hat = w * self._dinv[src] * self._dinv[dst]
        else:
            w_hat = w
        yd = y[dst]
        m = yd >= 0
        np.add.at(self.S, (src[m], yd[m]), w_hat[m])
        if opts.diag_aug:
            rows = np.nonzero(valid)[0]
            dh = (self._dinv[rows] ** 2 * _DIAG_W if opts.laplacian
                  else np.full(rows.shape, _DIAG_W))
            np.add.at(self.S, (rows, y[rows]), dh)
        return self

    # -- small helpers -------------------------------------------------------
    def _deg_aug(self) -> np.ndarray:
        return self.deg + (_DIAG_W if self.opts.diag_aug else 0.0)

    @staticmethod
    def _dinv_of(deg: np.ndarray) -> np.ndarray:
        # the shared epilogue numerics (EPS_NORM clamp)
        return inv_sqrt_degrees_np(deg)

    def _winv(self) -> np.ndarray:
        return np.where(self.nk > 0, 1.0 / np.maximum(self.nk, 1.0), 0.0)

    def _recompute_rows(self, rows: Iterable[int]):
        """Rebuild S[rows] from their out-adjacency (laplacian-aware), in
        one vectorized pass over the concatenated neighbor lists -- the hot
        path of a laplacian edge-delta batch."""
        rows = list(rows)
        rs: list[int] = []
        js: list[int] = []
        ws: list[float] = []
        for r in rows:
            nb = self.out_nbrs[r]
            rs.extend([r] * len(nb))
            js.extend(nb.keys())
            ws.extend(nb.values())
            self.S[r] = 0.0
        self.stats["rows_recomputed"] += len(rows)
        self.stats["row_edges_scanned"] += len(rs)
        lap = self.opts.laplacian
        if rs:
            ra = np.asarray(rs, np.int64)
            ja = np.asarray(js, np.int64)
            wa = np.asarray(ws, np.float64)
            if lap:
                wa = wa * self._dinv[ra] * self._dinv[ja]
            yj = self.labels[ja]
            m = yj >= 0
            np.add.at(self.S, (ra[m], yj[m]), wa[m])
        if self.opts.diag_aug and rows:
            ra = np.asarray(rows, np.int64)
            yr = self.labels[ra]
            ra = ra[yr >= 0]
            yr = yr[yr >= 0]
            dh = (self._dinv[ra] ** 2 if lap
                  else np.ones(ra.shape, np.float64)) * _DIAG_W
            np.add.at(self.S, (ra, yr), dh)

    def add_dirty_listener(self, fn) -> None:
        """Subscribe ``fn(rows, full)`` to invalidation events.

        Called after each applied delta batch with ``rows`` (np.int64 array
        of rows whose Z changed) and ``full`` (True when the global 1/n_k
        scaling moved, i.e. *every* cached row is stale regardless of
        ``rows``).  Listeners must not mutate this object.
        """
        self._dirty_listeners.append(fn)

    def remove_dirty_listener(self, fn) -> None:
        """Unsubscribe a listener registered with ``add_dirty_listener``
        (no-op if absent)."""
        try:
            self._dirty_listeners.remove(fn)
        except ValueError:
            pass

    def _notify_dirty(self, rows, full: bool = False):
        if not self._dirty_listeners:
            return
        rows = np.asarray(rows, np.int64)
        for fn in self._dirty_listeners:
            fn(rows, full)

    def _adj_add(self, u: int, v: int, w: float):
        nw = self.out_nbrs[u].get(v, 0.0) + w
        if nw == 0.0:
            self.out_nbrs[u].pop(v, None)
            self.in_nbrs[v].pop(u, None)
        else:
            self.out_nbrs[u][v] = nw
            self.in_nbrs[v][u] = nw

    # -- delta application ---------------------------------------------------
    def _seq_skip(self, delta) -> bool:
        """True when a sequenced batch is at/below the watermark (already
        applied -- a WAL replay duplicate; skipping keeps replay exact)."""
        seq = getattr(delta, "seq", -1)
        if 0 <= seq <= self.applied_seq:
            self.stats["skipped_replays"] += 1
            return True
        return False

    def _seq_advance(self, delta) -> None:
        seq = getattr(delta, "seq", -1)
        if seq >= 0:
            self.applied_seq = seq

    def apply(self, delta: Delta | Sequence[Delta]) -> "IncrementalGEE":
        if isinstance(delta, EdgeDelta):
            return self.apply_edges(delta)
        if isinstance(delta, LabelDelta):
            return self.apply_labels(delta)
        if isinstance(delta, Iterable):
            for d in delta:
                self.apply(d)
            return self
        raise TypeError(f"unsupported delta type {type(delta).__name__}")

    def apply_edges(self, delta: EdgeDelta) -> "IncrementalGEE":
        if self._seq_skip(delta):
            return self
        d = delta.num_deltas
        u = np.asarray(delta.src)[:d]
        v = np.asarray(delta.dst)[:d]
        w = np.asarray(delta.weight)[:d].astype(np.float64)
        keep = w != 0
        u, v, w = u[keep], v[keep], w[keep]
        if u.size and (u.min() < 0 or v.min() < 0
                       or u.max() >= self.n or v.max() >= self.n):
            raise ValueError("edge delta references a node id outside "
                             "[0, num_nodes); grow the graph at construction "
                             "time (EdgeDelta padding is weight == 0, not a "
                             "sentinel id)")
        self.stats["edge_deltas"] += int(u.size)
        if not u.size:
            self._seq_advance(delta)       # an all-padding batch still counts
            return self

        deg_before = self.deg[u].copy()
        np.add.at(self.deg, u, w)
        for ui, vi, wi in zip(u.tolist(), v.tolist(), w.tolist()):
            self._adj_add(ui, vi, wi)

        if not self.opts.laplacian:
            yv = self.labels[v]
            m = yv >= 0
            np.add.at(self.S, (u[m], yv[m]), w[m])
            touched = set(u.tolist())
        else:
            # Rows needing a rebuild: every delta source (content changed)
            # plus the in-neighbors of every node whose degree -- hence
            # d^{-1/2} -- actually moved.
            touched = set(u.tolist())
            changed = set(u[self.deg[u] != deg_before].tolist())
            if changed:
                idx = np.fromiter(changed, np.int64, len(changed))
                aug = self.deg[idx] + (_DIAG_W if self.opts.diag_aug else 0.0)
                self._dinv[idx] = self._dinv_of(aug)
            affected = set(touched)
            for node in changed:
                affected.update(self.in_nbrs[node].keys())
            self._recompute_rows(affected)
            touched = affected
        self._dirty_rows.update(touched)
        self._seq_advance(delta)
        self._notify_dirty(np.fromiter(touched, np.int64, len(touched)))
        return self

    def apply_labels(self, delta: LabelDelta) -> "IncrementalGEE":
        if self._seq_skip(delta):
            return self
        d = delta.num_deltas
        nodes = np.asarray(delta.node)[:d]
        labs = np.asarray(delta.new_label)[:d]
        # Validate the whole batch before mutating anything (atomicity: a
        # bad entry must not leave the state half-updated -- apply_edges
        # has the same contract).
        live = nodes >= 0                      # negative node == padding
        if np.any(nodes[live] >= self.n):
            raise ValueError("label delta references a node id >= num_nodes")
        if np.any(labs[live] >= self.k):
            raise ValueError(f"label delta assigns a label >= num_classes "
                             f"{self.k}")
        lap = self.opts.laplacian
        dirtied: set[int] = set()
        any_flip = False
        for nd, nl in zip(nodes.tolist(), labs.tolist()):
            if nd < 0:
                continue                       # padding slot
            old = int(self.labels[nd])
            self.stats["label_deltas"] += 1
            if old == nl:
                continue
            any_flip = True
            if old >= 0:
                self.nk[old] -= 1
            if nl >= 0:
                self.nk[nl] += 1
            self.labels[nd] = nl
            self._winv_dirty = True
            dj = self._dinv[nd] if lap else 1.0
            for i, wij in self.in_nbrs[nd].items():
                w_hat = wij * (self._dinv[i] * dj if lap else 1.0)
                if old >= 0:
                    self.S[i, old] -= w_hat
                if nl >= 0:
                    self.S[i, nl] += w_hat
                self._dirty_rows.add(i)
                dirtied.add(i)
            self.stats["row_edges_scanned"] += len(self.in_nbrs[nd])
            if self.opts.diag_aug:
                dh = (dj * dj if lap else 1.0) * _DIAG_W
                if old >= 0:
                    self.S[nd, old] -= dh
                if nl >= 0:
                    self.S[nd, nl] += dh
                self._dirty_rows.add(nd)
                dirtied.add(nd)
        self._seq_advance(delta)
        if any_flip:
            # the 1/n_k column rescale touches every row with mass in the
            # affected classes -- full invalidation, matching
            # ``num_pending_rows``
            self._notify_dirty(np.fromiter(dirtied, np.int64, len(dirtied)),
                               full=True)
        return self

    # -- queries -------------------------------------------------------------
    def _materialize_rows(self, rows: np.ndarray,
                          winv: np.ndarray) -> torch.Tensor:
        """Z[rows] on the device: S[rows] * 1/n_k in float64, cast to
        float32, then the correlation row norm (``row_norm`` on the card)."""
        s = torch.from_numpy(self.S[rows]).to(self.device)
        w = torch.from_numpy(winv).to(self.device)
        z = (s * w[None, :]).to(torch.float32)
        if self.opts.correlation:
            z = row_l2_normalize(z, impl="auto")
        return z

    def embedding(self, rows=None) -> torch.Tensor:
        """Current Z (float32, on this state's device).  Cached; only
        invalidated rows are redone (a label delta dirties the global 1/n_k
        scaling and forces one full refresh).  Every call returns a new
        tensor -- ``rows=None`` a copy of the whole cache, so a caller
        writing to it never corrupts later reads."""
        winv = self._winv()
        if self._z is None or self._winv_dirty:
            self._z = self._materialize_rows(np.arange(self.n), winv)
            self._winv_dirty = False
            self._dirty_rows.clear()
            self.stats["z_full_refreshes"] += 1
        elif self._dirty_rows:
            idx = np.fromiter(self._dirty_rows, np.int64,
                              len(self._dirty_rows))
            self._z[torch.from_numpy(idx).to(self.device)] = \
                self._materialize_rows(idx, winv)
            self.stats["z_rows_patched"] += idx.size
            self._dirty_rows.clear()
        if rows is None:
            return self._z.clone()
        idx = torch.as_tensor(np.asarray(rows, np.int64)).to(self.device)
        return self._z[idx]

    @property
    def num_pending_rows(self) -> int:
        """Rows whose cached Z is stale (serving-layer visibility)."""
        return self.n if self._winv_dirty or self._z is None \
            else len(self._dirty_rows)

    # -- reconstruction (verification / interop) -----------------------------
    def adjacency_triplets(self) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        """Live adjacency as row-grouped (src int64, dst int64, weight
        float64) arrays, each row in its dict's order."""
        src: list[int] = []
        dst: list[int] = []
        w: list[float] = []
        for i, nb in enumerate(self.out_nbrs):
            if nb:
                src.extend([i] * len(nb))
                dst.extend(nb.keys())
                w.extend(nb.values())
        return (np.asarray(src, np.int64), np.asarray(dst, np.int64),
                np.asarray(w, np.float64))

    def to_edge_list(self, pad_to: int | None = None) -> EdgeList:
        """Flatten the live adjacency back into a deterministic EdgeList
        (rows ascending, each row's neighbors ascending) on this state's
        device."""
        src, dst, w = self.adjacency_triplets()
        order = np.lexsort((dst, src))
        src, dst, w = src[order], dst[order], w[order]
        keep = w != 0.0
        return edge_list_from_numpy(
            src[keep].astype(np.int32), dst[keep].astype(np.int32),
            w[keep].astype(np.float32), self.n, pad_to=pad_to,
            device=self.device)


__all__ = ["Delta", "DirtyRowTracker", "IncrementalGEE", "fill_adjacency"]
