"""Class-partitioned ANN index over GEE embeddings (port of
``repro/search/index.py``).

GEE already is a coarse quantizer: the embedding places every vertex near
the mean of its class, so the IVF cells are the classes.

  build    class means from the labels (empty classes are inactive cells);
           every vertex, unknown-label (-1) ones included, goes to its
           nearest active mean (``pairwise_scores``, then the first
           maximum).
  layout   one [C, B] int32 cell table on the host, rows padded with -1 to
           a common bucket capacity B (a ``pad_multiple`` multiple), with a
           lazy copy on the index's device.
  query    probe scores against the C centroids, the ``nprobe`` best cells,
           gather their members, score and top-k them
           (``scored_topk_gathered``).  ``nprobe == num_cells`` is exact;
           ``brute_force=True`` scores all N rows (``scored_topk``).
  repair   ``update_rows`` moves re-embedded vertices between buckets in
           O(|rows|) host work (swap-with-last removal, append insertion,
           capacity growth by ``pad_multiple``).

The embeddings, the centroids and the table's device copy live on the
index's device (the card unless the caller gives CPU tensors or asks for
the CPU); the table and its bookkeeping are host numpy, as in the
reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.topk_score import (fused_topk_enabled,
                                            pairwise_scores, scored_topk,
                                            scored_topk_gathered)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

DEFAULT_PAD_MULTIPLE = 128


def index_stats_view(builds: int = 0) -> "obs_metrics.StatsView":
    """The index's registry-backed stats dict (one scope per instance)."""
    return obs_metrics.get_registry().stats_view(
        "gee.index", {"builds": builds, "queries": 0,
                      "brute_force_queries": 0, "cells_probed": 0,
                      "candidates_scored": 0, "repaired_rows": 0,
                      "bucket_moves": 0, "table_grows": 0})


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_nprobe(num_cells: int) -> int:
    """ceil(sqrt(C)), the classic IVF default, never below 1."""
    return max(1, int(np.ceil(np.sqrt(max(num_cells, 1)))))


def _first_argmax(scores: torch.Tensor) -> np.ndarray:
    """Row-wise index of the first maximum, on the host (as
    ``jnp.argmax``)."""
    return torch.argmax(scores, dim=1).cpu().numpy().astype(np.int64)


@dataclasses.dataclass
class ClassPartitionedIndex:
    """IVF-style vertex index whose coarse cells are GEE class means.

    Build with :meth:`build`; query with :meth:`search` /
    :meth:`search_rows`; keep fresh with :meth:`update_rows`.
    """

    metric: str
    nprobe: int
    pad_multiple: int
    _z: torch.Tensor                 # [N, K] database embeddings (device)
    _centroids: torch.Tensor         # [C, K] cell centers (device)
    _active: np.ndarray              # [C] bool: cell has a centroid
    _active_dev: torch.Tensor        # device copy of _active (fixed)
    _table: np.ndarray               # [C, B] int32 member ids, -1 = empty
    _cell_len: np.ndarray            # [C] int64 live entries per cell
    _row_cell: np.ndarray            # [N] int32 cell of each vertex
    _row_slot: np.ndarray            # [N] int64 slot within its cell row
    _table_dev: torch.Tensor | None  # device copy of _table (lazy refresh)
    stats: dict

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, z, labels, num_classes: int, *, metric: str = "l2",
              nprobe: int | None = None,
              pad_multiple: int = DEFAULT_PAD_MULTIPLE
              ) -> "ClassPartitionedIndex":
        """Index ``z`` [N, K] using the class structure of ``labels``.

        The index lives on ``z``'s device when ``z`` is a tensor, else on
        the card.  It keeps its own copy of ``z`` (``update_rows`` writes it
        in place).  ``labels`` may contain
        ``-1``: such vertices contribute to no centroid but are still
        indexed.  If every label is unknown the index is a single cell
        holding everything (= brute force).
        """
        if isinstance(z, torch.Tensor):
            device = z.device
            z = z.clone()
        else:
            device = resolve_device(None)
            z = torch.from_numpy(np.array(z, np.float32))
        z = z.to(device=device, dtype=torch.float32).contiguous()
        n, dim = z.shape
        y = np.asarray(labels, np.int64)
        if y.shape[0] != n:
            raise ValueError(f"labels shape {y.shape} != num rows {n}")
        c = int(num_classes)

        valid = y >= 0
        counts = np.bincount(y[valid], minlength=c).astype(np.float64)
        active = counts > 0
        if active.any():
            # Class sums as a one-hot product, in a fixed order: index_add_
            # on the card sums with atomics in an order that changes from
            # run to run, which could move a vertex near a tie between cells.
            onehot = np.zeros((n, c), np.float32)
            onehot[np.flatnonzero(valid), y[valid]] = 1.0
            sums = torch.from_numpy(onehot).to(device).T @ z
            denom = torch.from_numpy(np.maximum(counts, 1.0).astype(
                np.float32)).to(device)
            centroids = sums / denom[:, None]
        else:
            # all-unknown labels: one catch-all cell at the global mean
            active = np.zeros(c, bool)
            active[0] = True
            centroids = torch.zeros((c, dim), dtype=torch.float32,
                                    device=device)
            centroids[0] = z.mean(dim=0)
        active_dev = torch.from_numpy(active).to(device)
        centroids = torch.where(active_dev[:, None], centroids, 0.0)
        centroids = centroids.contiguous()

        # Assign every vertex to its nearest active centroid (same metric
        # the queries will use, through the same kernel).
        cscores = pairwise_scores(z, centroids, active_dev, metric=metric)
        assign = _first_argmax(cscores)

        cell_len = np.bincount(assign, minlength=c).astype(np.int64)
        cap = _ceil_to(max(int(cell_len.max()) if n else 1, 1),
                       max(int(pad_multiple), 1))
        table = np.full((c, cap), -1, np.int32)
        order = np.argsort(assign, kind="stable")
        starts = np.zeros(c, np.int64)
        np.cumsum(cell_len[:-1], out=starts[1:])
        slot = np.arange(n, dtype=np.int64) - starts[assign[order]]
        table[assign[order], slot] = order.astype(np.int32)
        row_slot = np.empty(n, np.int64)
        row_slot[order] = slot

        return cls(
            metric=metric,
            nprobe=int(nprobe) if nprobe is not None
            else default_nprobe(int(active.sum())),
            pad_multiple=int(pad_multiple),
            _z=z, _centroids=centroids, _active=active,
            _active_dev=active_dev,
            _table=table, _cell_len=cell_len,
            _row_cell=assign.astype(np.int32), _row_slot=row_slot,
            _table_dev=None,
            stats=index_stats_view(builds=1),
        )

    # -- introspection -------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self._z.device

    @property
    def num_points(self) -> int:
        return int(self._z.shape[0])

    @property
    def dim(self) -> int:
        return int(self._z.shape[1])

    @property
    def num_cells(self) -> int:
        """Active cells (classes with at least one labeled member)."""
        return int(self._active.sum())

    @property
    def bucket_capacity(self) -> int:
        return int(self._table.shape[1])

    @property
    def z(self) -> torch.Tensor:
        """The indexed embeddings (device, [N, K]); kept current by
        ``update_rows``."""
        return self._z

    def padding_fraction(self) -> float:
        """Wasted table slots / total."""
        total = self._table.size
        return 1.0 - float(self._cell_len.sum()) / max(total, 1)

    # -- queries -------------------------------------------------------------
    def _table_device(self) -> torch.Tensor:
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self._table).to(self.device)
        return self._table_dev

    def search(self, queries, k: int = 10, *, nprobe: int | None = None,
               brute_force: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-``k`` database rows for each query vector.

        ``queries``: [Q, K] (or a single [K] vector), moved to the index's
        device.  Returns ``(ids [Q, k] int32, scores [Q, k] f32)`` there;
        ``ids == -1`` marks slots with fewer than k reachable candidates.
        ``nprobe >= num_cells`` (or ``brute_force=True``) is exact.
        Spans: ``index.search``, inside it ``index.upload`` (the queries to
        the device) and, probing, ``_ivf_search``'s.
        """
        with obs_trace.span("index.search"):
            return self._search(queries, k, nprobe, brute_force)

    def _search(self, queries, k, nprobe, brute_force):
        with obs_trace.span("index.upload"):
            if not isinstance(queries, torch.Tensor):
                queries = torch.from_numpy(np.array(queries, np.float32))
            queries = queries.to(device=self.device, dtype=torch.float32)
        squeeze = queries.dim() == 1
        if squeeze:
            queries = queries[None, :]
        queries = queries.contiguous()
        if queries.shape[1] != self.dim:
            raise ValueError(f"query dim {queries.shape[1]} != index dim "
                             f"{self.dim}")
        self.stats["queries"] += int(queries.shape[0])
        p = self.nprobe if nprobe is None else int(nprobe)
        p = max(1, min(p, int(self._active.shape[0])))
        # resolved per call, so flipping REPRO_GEE_FUSED between calls
        # re-routes
        fused = fused_topk_enabled(self.device)
        if brute_force:
            self.stats["brute_force_queries"] += int(queries.shape[0])
            ids, scores = _exact_search(queries, self._z, k=int(k),
                                        metric=self.metric, fused=fused)
        else:
            self.stats["cells_probed"] += int(queries.shape[0]) * p
            self.stats["candidates_scored"] += (int(queries.shape[0]) * p
                                                * self.bucket_capacity)
            ids, scores = _ivf_search(
                queries, self._z, self._centroids, self._active_dev,
                self._table_device(), k=int(k), nprobe=p, metric=self.metric,
                fused=fused)
        if squeeze:
            return ids[0], scores[0]
        return ids, scores

    def search_rows(self, rows, k: int = 10, *, nprobe: int | None = None,
                    brute_force: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Like :meth:`search` with the queries taken from the index itself
        (vertex-id queries).  Each vertex is its own best match under both
        metrics; callers wanting strict neighbors drop the self hit."""
        rows = torch.as_tensor(np.asarray(rows, np.int64)).to(self.device)
        return self.search(self._z[rows], k, nprobe=nprobe,
                           brute_force=brute_force)

    # -- incremental repair --------------------------------------------------
    def update_rows(self, rows, z_rows) -> int:
        """Re-embed ``rows`` with ``z_rows`` and repair their buckets.

        O(|rows|) host bookkeeping + one device row update; centroids stay
        fixed.  Returns the number of rows that changed buckets.
        """
        rows = np.asarray(rows, np.int64).reshape(-1)
        if rows.size == 0:
            return 0
        if not isinstance(z_rows, torch.Tensor):
            z_rows = torch.from_numpy(np.array(z_rows, np.float32))
        z_rows = z_rows.to(device=self.device, dtype=torch.float32).reshape(
            rows.size, self.dim)
        # In place, where the reference builds a new array: the index owns
        # its copy of Z (``build`` clones it), so no caller's tensor moves.
        self._z[torch.from_numpy(rows).to(self.device)] = z_rows

        cscores = pairwise_scores(z_rows.contiguous(), self._centroids,
                                  self._active_dev, metric=self.metric)
        new_cell = _first_argmax(cscores).astype(np.int32)

        # Only rows that changed cells go through the Python bucket surgery.
        movers = np.flatnonzero(new_cell != self._row_cell[rows])
        moved = int(movers.size)
        for r, nc in zip(rows[movers].tolist(),
                         new_cell[movers].tolist()):
            oc = int(self._row_cell[r])
            # swap-with-last removal from the old bucket
            slot = int(self._row_slot[r])
            last = int(self._cell_len[oc]) - 1
            tail = int(self._table[oc, last])
            self._table[oc, slot] = tail
            self._row_slot[tail] = slot
            self._table[oc, last] = -1
            self._cell_len[oc] = last
            # append to the new bucket, growing capacity if it is full
            if int(self._cell_len[nc]) == self.bucket_capacity:
                grow = np.full((self._table.shape[0], self.pad_multiple), -1,
                               np.int32)
                self._table = np.concatenate([self._table, grow], axis=1)
                self.stats["table_grows"] += 1
            self._table[nc, int(self._cell_len[nc])] = r
            self._row_slot[r] = int(self._cell_len[nc])
            self._cell_len[nc] += 1
            self._row_cell[r] = nc
        if moved:
            self._table_dev = None
        self.stats["repaired_rows"] += int(rows.size)
        self.stats["bucket_moves"] += moved
        return moved


# ---------------------------------------------------------------------------
# query paths
# ---------------------------------------------------------------------------

def _exact_search(queries, z, *, k, metric, fused=False):
    """Brute force: score all N rows, top-k.  The recall oracle.

    ``fused=True`` runs the fused score-and-top-k kernel, so the [Q, N]
    scores never reach device memory; staged otherwise.  Identical results
    either way.
    """
    return scored_topk(queries, z, None, k, metric=metric, fused=fused)


def _ivf_search(queries, z, centroids, active, table, *, k, nprobe, metric,
                fused=False):
    """Probe -> gather -> batched masked score -> top-k.  Spans:
    ``index.probe``, ``index.candidates`` (the cell sort, the table and Z
    gathers, the mask), ``index.topk``."""
    span = obs_trace.span
    with span("index.probe"):
        cscores = pairwise_scores(queries, centroids, active,
                                  metric=metric)                # [Q, C]
    with span("index.candidates"):
        # the nprobe best cells, equal scores in ascending cell order (the
        # reference's stable top_k)
        cells = torch.sort(cscores, dim=1, descending=True,
                           stable=True).indices[:, :nprobe]     # [Q, P]
        ids = table[cells]                                      # [Q, P, B]
        q = ids.shape[0]
        ids = ids.reshape(q, nprobe * table.shape[1]).contiguous()
        # Over-probing (nprobe > active cells) selects NEG_INF cells whose
        # table rows are all -1 -- masked out below, never scored as real.
        cand = z[ids.clamp(0, z.shape[0] - 1).long()]          # [Q, P*B, K]
        mask = (ids >= 0).to(torch.float32)
    with span("index.topk"):
        return scored_topk_gathered(queries, cand, mask, ids, k,
                                    metric=metric, fused=fused)


__all__ = ["DEFAULT_PAD_MULTIPLE", "ClassPartitionedIndex", "default_nprobe",
           "index_stats_view"]
