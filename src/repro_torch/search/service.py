"""GEE serving layer: streaming delta ingestion and batched similarity
queries (port of ``repro/search/service.py``).

* :class:`GEEDeltaServer` -- the write path.  Queues ``EdgeDelta`` /
  ``LabelDelta`` batches against an ``IncrementalGEE``, coalescing
  duplicates before applying, with an optional write-ahead log.
* :class:`GEEQueryService` -- the read path.  Queues vertex-similarity
  queries against a :class:`repro_torch.search.index.ClassPartitionedIndex`
  and answers them in padded batches, one index search per flush.

The two compose through ``IncrementalGEE``'s dirty-row notifications: the
query service subscribes at construction, so whenever a delta is applied
(directly, through ``GEEEmbedder.partial_fit`` or by a delta-server flush)
it learns which embedding rows moved, and the next flush *repairs* those
index buckets (``ClassPartitionedIndex.update_rows`` on just the stale
rows) instead of rebuilding.  A label flip moves the global 1/n_k scaling
and invalidates every row; the repair then re-scores all rows against the
fixed centroids but never re-derives the cell structure.  Spans:
``serve.query_flush`` (tagged ``oldest_wait_us``, the oldest ticket's
wait from submit to flush, while the tracer is on), inside it
``serve.query_repair``, ``serve.flush.rows`` (the row tickets' gathers and
copies, the concatenation and padding), ``index.search`` and
``serve.flush.answers`` (the answers' copies to the host, handed to the
tickets); ``serve.delta_flush``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.incremental import DirtyRowTracker
from repro_torch.graph.delta import (EdgeDelta, LabelDelta,
                                     coalesce_edge_deltas,
                                     coalesce_label_deltas)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.search.index import ClassPartitionedIndex


class LoadShedError(RuntimeError):
    """A bounded queue refused new work (backpressure made visible).

    Raised instead of silently growing the backlog past ``max_pending``;
    every shed is counted in the owning service's / router's ``stats``.
    """


@dataclasses.dataclass
class QueryTicket:
    """One pending similarity query batch (any number of query vectors)."""

    uid: int
    k: int
    queries: Optional[np.ndarray] = None     # [q, K] explicit vectors ...
    rows: Optional[np.ndarray] = None        # ... or vertex ids, resolved
    ids: Optional[np.ndarray] = None
    scores: Optional[np.ndarray] = None
    done: bool = False
    # the tracer's clock at submit, kept only while the tracer is enabled
    submitted_ns: Optional[int] = None


class GEEQueryService:
    """Batched vertex-similarity query server over a class-partitioned index.

    ``submit``/``submit_rows`` enqueue; the queue flushes when the backlog
    reaches ``flush_every`` query vectors or on an explicit :meth:`flush`.
    Each flush (1) repairs the index buckets of every embedding row the
    subscribed ``IncrementalGEE`` (``inc``) dirtied since the last flush,
    (2) pads the gathered query batch to a ``pad_multiple``, and (3) runs
    one batched search and scatters results back to the tickets.
    """

    def __init__(self, index: ClassPartitionedIndex, inc=None,
                 flush_every: int = 64, pad_multiple: int = 64,
                 nprobe: int | None = None, default_k: int = 10,
                 max_pending: int | None = None):
        self.index = index
        self.inc = inc
        self.flush_every = int(flush_every)
        self.pad_multiple = max(int(pad_multiple), 1)
        self.nprobe = nprobe
        self.default_k = int(default_k)
        # Queue bound: a submit that would push the backlog past this sheds
        # (raises LoadShedError, counted); None = unbounded.
        self.max_pending = None if max_pending is None else int(max_pending)
        self._queue: list[QueryTicket] = []
        self._pending = 0
        self._uid = 0
        self._tracker: Optional[DirtyRowTracker] = None
        self.stats = obs_metrics.get_registry().stats_view(
            "gee.query", {"submitted": 0, "flushes": 0, "queries_scored": 0,
                          "pad_queries": 0, "repaired_rows": 0,
                          "bucket_moves": 0, "full_refreshes": 0,
                          "shed_queries": 0, "flush_ms": []})
        if inc is not None:
            if inc.n != index.num_points:
                raise ValueError(
                    f"IncrementalGEE has {inc.n} rows but the index holds "
                    f"{index.num_points}")
            self._tracker = DirtyRowTracker(inc.n)
            inc.add_dirty_listener(self._tracker)

    def close(self) -> None:
        """Unsubscribe from the incremental state and release the metrics
        scope (idempotent); a retired service then costs the write path
        nothing."""
        if self.inc is not None and self._tracker is not None:
            self.inc.remove_dirty_listener(self._tracker)
            self._tracker = None
        self.stats.close()

    @property
    def stale_rows(self) -> int:
        """Rows whose index entry lags the incremental state (the next
        flush repairs them)."""
        return self._tracker.pending if self._tracker is not None else 0

    @property
    def backlog(self) -> int:
        """Queued-but-unanswered query vectors."""
        return self._pending

    # -- ingest --------------------------------------------------------------
    def submit(self, queries, k: int | None = None) -> QueryTicket:
        """Queue explicit query vectors ([q, K] or a single [K]); may
        trigger a flush.  Returns the ticket carrying the results once
        ``done``."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        return self._enqueue(QueryTicket(uid=self._next_uid(),
                                         k=self._k(k), queries=q),
                             q.shape[0])

    def submit_rows(self, rows, k: int | None = None) -> QueryTicket:
        """Queue vertex-id queries.  The vectors are read from the index at
        flush time, *after* bucket repair, so a query for a just-updated
        vertex sees its fresh embedding."""
        r = np.asarray(rows, np.int64).reshape(-1)
        return self._enqueue(QueryTicket(uid=self._next_uid(),
                                         k=self._k(k), rows=r), r.size)

    def _k(self, k) -> int:
        return self.default_k if k is None else int(k)

    def _next_uid(self) -> int:
        self._uid += 1
        return self._uid

    def _enqueue(self, ticket: QueryTicket, n_queries: int) -> QueryTicket:
        tr = obs_trace.get_tracer()
        if tr.enabled:
            ticket.submitted_ns = tr.now_ns()
        if self.max_pending is not None \
                and self._pending + n_queries > self.max_pending:
            self.stats["shed_queries"] += n_queries
            raise LoadShedError(
                f"query backlog {self._pending} + {n_queries} would exceed "
                f"max_pending={self.max_pending}; flush or route elsewhere")
        self._queue.append(ticket)
        self._pending += n_queries
        self.stats["submitted"] += n_queries
        if self._pending >= self.flush_every:
            self.flush()
        return ticket

    # -- repair --------------------------------------------------------------
    def repair(self) -> int:
        """Apply pending invalidations to the index; returns rows repaired.
        Runs automatically at the start of every flush."""
        if self.inc is None or self._tracker is None \
                or not self._tracker.pending:
            return 0
        self.stats["full_refreshes"] += int(self._tracker.full)
        rows = self._tracker.drain()
        moves = self.index.update_rows(rows, self.inc.embedding(rows))
        self.stats["repaired_rows"] += int(rows.size)
        self.stats["bucket_moves"] += moves
        return int(rows.size)

    # -- flush ---------------------------------------------------------------
    def flush(self) -> list[QueryTicket]:
        """Repair, then answer every queued ticket in one padded batch."""
        if not self._queue:
            self.repair()
            return []
        t0 = time.perf_counter()
        with obs_trace.span("serve.query_flush",
                            pending=self._pending) as sp:
            oldest = self._queue[0].submitted_ns
            if oldest is not None:
                sp.tag(oldest_wait_us=(obs_trace.get_tracer().now_ns()
                                       - oldest) // 1000)
            tickets = self._flush_batch(sp)
        elapsed = time.perf_counter() - t0
        self.stats["flush_ms"].append(elapsed * 1e3)
        scored = sum(t.queries.shape[0] if t.queries is not None
                     else t.rows.size for t in tickets)
        if elapsed > 0 and scored:
            obs_metrics.get_registry().gauge(
                "serve.queries_per_sec").set(scored / elapsed)
        return tickets

    def _flush_batch(self, sp) -> list[QueryTicket]:
        with obs_trace.span("serve.query_repair"):
            repaired = self.repair()
        sp.tag(repaired_rows=repaired)

        tickets, self._queue = self._queue, []
        self._pending = 0
        with obs_trace.span("serve.flush.rows", tickets=len(tickets)):
            # Row tickets gather only their rows on the device, then copy
            # them to the host -- never the whole [N, K] database.
            z = self.index.z
            blocks = [t.queries if t.queries is not None
                      else z[torch.from_numpy(t.rows).to(z.device)]
                      .cpu().numpy()
                      for t in tickets]
            counts = [b.shape[0] for b in blocks]
            q = np.concatenate(blocks, axis=0)
            total = q.shape[0]
            target = -(-total // self.pad_multiple) * self.pad_multiple
            if target > total:
                q = np.concatenate(
                    [q, np.zeros((target - total, q.shape[1]), np.float32)],
                    axis=0)
        self.stats["pad_queries"] += target - total
        k_max = max(t.k for t in tickets)
        ids, scores = self.index.search(q, k_max, nprobe=self.nprobe)
        with obs_trace.span("serve.flush.answers"):
            ids = ids.cpu().numpy()
            scores = scores.cpu().numpy()
            off = 0
            for t, c in zip(tickets, counts):
                t.ids = ids[off:off + c, :t.k]
                t.scores = scores[off:off + c, :t.k]
                t.done = True
                off += c
        self.stats["flushes"] += 1
        self.stats["queries_scored"] += total
        sp.tag(queries=total)
        return tickets

    def search(self, queries, k: int | None = None):
        """Synchronous convenience: flush the backlog, answer ``queries``
        immediately.  Returns ``(ids, scores)`` numpy arrays."""
        ticket = self.submit(queries, k)
        if not ticket.done:
            self.flush()
        return ticket.ids, ticket.scores


# ---------------------------------------------------------------------------
# the write path: coalescing queue + cached-Z invalidation
# ---------------------------------------------------------------------------

class GEEDeltaServer:
    """Streaming front-end over
    :class:`repro_torch.core.incremental.IncrementalGEE`.

    Updates are queued and *coalesced* -- duplicate (src, dst) edge
    increments sum into one, repeated label writes keep only the last --
    and the merged batch is applied once, either when the backlog reaches
    ``flush_every`` entries or when a read (``embed``) needs fresh state.
    Reads between flushes are served from the incremental state's cached Z.
    Coalesced batches are padded to ``pad_multiple``.

    Durability: pass ``log=`` (a ``repro_torch.serve.snapshot.DeltaLog`` --
    any object with ``append(deltas, meta) -> stamped deltas`` works) and
    every flush writes one atomic write-ahead record *before* applying,
    with the flush's edge and label batches committing together; crash
    recovery replays the log past the latest snapshot's watermark.  ``meta``
    (a small JSON-able dict attribute) rides along on each record.

    Backpressure: ``max_backlog`` bounds the queued-but-unapplied deltas.
    A submit that would exceed it forces a synchronous flush first (writes
    are never shed: there is exactly one write path, and dropping a delta
    would fork history); the forced flushes are counted in
    ``stats["backpressure_flushes"]``.
    """

    def __init__(self, inc, flush_every: int = 256, pad_multiple: int = 64,
                 log=None, max_backlog: int | None = None):
        self.inc = inc
        self.flush_every = int(flush_every)
        self.pad_multiple = int(pad_multiple)
        self.log = log
        self.max_backlog = None if max_backlog is None else int(max_backlog)
        self.meta: Optional[dict] = None     # stamped onto WAL records
        self._edge_backlog: list = []
        self._label_backlog: list = []
        self._pending = 0
        self.stats = obs_metrics.get_registry().stats_view(
            "gee.delta", {"submitted": 0, "flushes": 0, "applied_deltas": 0,
                          "coalesced_away": 0, "rows_invalidated": 0,
                          "reads": 0, "stale_reads": 0,
                          "rejected_deltas": 0, "logged_records": 0,
                          "backpressure_flushes": 0})

    # -- ingest --------------------------------------------------------------
    def submit(self, delta) -> None:
        """Queue an ``EdgeDelta`` or ``LabelDelta``; may trigger a flush."""
        if not isinstance(delta, (EdgeDelta, LabelDelta)):
            raise TypeError(f"unsupported delta type {type(delta).__name__}")
        if self.max_backlog is not None and self._pending \
                and self._pending + delta.num_deltas > self.max_backlog:
            self.stats["backpressure_flushes"] += 1
            self.flush()
        if isinstance(delta, EdgeDelta):
            self._edge_backlog.append(delta)
        else:
            self._label_backlog.append(delta)
        self._pending += delta.num_deltas
        self.stats["submitted"] += delta.num_deltas
        if self._pending >= self.flush_every:
            self.flush()

    def _validate_backlog(self) -> None:
        """Reject a poisoned backlog *before* it reaches the WAL: a bad
        batch must neither mutate state nor be replayed at recovery."""
        n, k = self.inc.n, self.inc.k
        for d in self._edge_backlog:
            m = d.num_deltas
            u, v = d.src[:m], d.dst[:m]
            if m and (u.min() < 0 or v.min() < 0
                      or u.max() >= n or v.max() >= n):
                raise ValueError("edge delta references a node id outside "
                                 "[0, num_nodes)")
        for d in self._label_backlog:
            m = d.num_deltas
            nodes, labs = d.node[:m], d.new_label[:m]
            live = nodes >= 0
            if np.any(nodes[live] >= n):
                raise ValueError("label delta references a node id >= "
                                 "num_nodes")
            if np.any(labs[live] >= k):
                raise ValueError(f"label delta assigns a label >= "
                                 f"num_classes {k}")

    def flush(self) -> int:
        """Coalesce, log (when a WAL is attached) and apply the backlog;
        returns deltas actually applied."""
        if not self._pending:
            return 0
        stale_before = self.inc.num_pending_rows
        with obs_trace.span("serve.delta_flush", pending=self._pending,
                            logged=self.log is not None) as sp:
            applied = self._flush_backlog(stale_before)
            sp.tag(applied=applied)
        return applied

    def _flush_backlog(self, stale_before: int) -> int:
        applied = 0
        try:
            self._validate_backlog()
            merged = []
            if self._edge_backlog:
                merged.append(coalesce_edge_deltas(
                    self._edge_backlog, pad_multiple=self.pad_multiple))
            if self._label_backlog:
                merged.append(coalesce_label_deltas(
                    self._label_backlog, pad_multiple=self.pad_multiple))
            if self.log is not None and merged:
                # WAL discipline: one atomic record per flush, written
                # before anything mutates.  A crash in between leaves a
                # logged-but-unapplied record, which replay covers.
                merged = self.log.append(merged, meta=self.meta)
                self.stats["logged_records"] += 1
            for d in merged:
                self.inc.apply(d)
                applied += d.num_deltas
            self._edge_backlog.clear()
            self._label_backlog.clear()
        except ValueError:
            # Drop the poisoned backlog before re-raising.  Validation runs
            # before the WAL append and the appliers are atomic, so neither
            # the log nor the incremental state carries the bad batch;
            # keeping it queued would wedge every later submit/flush/read.
            rejected = (sum(d.num_deltas for d in self._edge_backlog)
                        + sum(d.num_deltas for d in self._label_backlog))
            self._edge_backlog.clear()
            self._label_backlog.clear()
            self._pending = 0
            self.stats["rejected_deltas"] += rejected
            raise
        self.stats["flushes"] += 1
        self.stats["applied_deltas"] += applied
        self.stats["coalesced_away"] += self._pending - applied
        # rows newly dirtied by THIS flush (a label delta counts N: the
        # 1/n_k rescale invalidates every cached row); rows still dirty
        # from an earlier, unread flush are not counted again.
        self.stats["rows_invalidated"] += max(
            0, self.inc.num_pending_rows - stale_before)
        self._pending = 0
        return applied

    # -- reads ---------------------------------------------------------------
    def embed(self, rows=None, max_staleness: int | None = 0):
        """Serve embedding rows (a tensor on the state's device).

        ``max_staleness`` bounds how many queued-but-unapplied deltas a read
        may ignore: 0 (default) forces a flush first; None serves straight
        from the cached Z no matter the backlog (monitoring-style reads).
        """
        if max_staleness is not None and self._pending > max_staleness:
            self.flush()
        if self._pending:
            self.stats["stale_reads"] += 1
        self.stats["reads"] += 1
        return self.inc.embedding(rows)


__all__ = ["LoadShedError", "QueryTicket", "GEEQueryService",
           "GEEDeltaServer"]
