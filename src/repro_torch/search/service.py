"""Batched vertex-similarity queries (port of the read path of
``repro/search/service.py``).

:class:`GEEQueryService` queues vertex-similarity queries against a
:class:`repro_torch.search.index.ClassPartitionedIndex` and answers them in
padded batches, one index search per flush, with the reference's flush,
padding, shedding, stats and spans (``serve.query_flush``,
``serve.query_repair``).

Incremental updates are not ported yet, so the service takes no
incremental state: ``inc`` must be ``None``, and the repair step of a
flush has nothing to do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.search.index import ClassPartitionedIndex


class LoadShedError(RuntimeError):
    """A bounded queue refused new work (backpressure made visible).

    Raised instead of silently growing the backlog past ``max_pending``;
    every shed is counted in the service's ``stats``.
    """


@dataclasses.dataclass
class QueryTicket:
    """One pending similarity query batch (any number of query vectors)."""

    uid: int
    k: int
    queries: Optional[np.ndarray] = None     # [q, K] explicit vectors ...
    rows: Optional[np.ndarray] = None        # ... or vertex ids
    ids: Optional[np.ndarray] = None
    scores: Optional[np.ndarray] = None
    done: bool = False


class GEEQueryService:
    """Batched vertex-similarity query server over a class-partitioned index.

    ``submit``/``submit_rows`` enqueue; the queue flushes when the backlog
    reaches ``flush_every`` query vectors or on an explicit :meth:`flush`.
    Each flush pads the gathered query batch to a ``pad_multiple``, runs
    one batched search and scatters results back to the tickets.
    """

    def __init__(self, index: ClassPartitionedIndex, inc=None,
                 flush_every: int = 64, pad_multiple: int = 64,
                 nprobe: int | None = None, default_k: int = 10,
                 max_pending: int | None = None):
        if inc is not None:
            raise NotImplementedError(
                "incremental updates are not yet ported to repro_torch; "
                "pass inc=None")
        self.index = index
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
        self.stats = obs_metrics.get_registry().stats_view(
            "gee.query", {"submitted": 0, "flushes": 0, "queries_scored": 0,
                          "pad_queries": 0, "repaired_rows": 0,
                          "bucket_moves": 0, "full_refreshes": 0,
                          "shed_queries": 0, "flush_ms": []})

    def close(self) -> None:
        """Release the service's metrics scope (idempotent)."""
        self.stats.close()

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
        """Queue vertex-id queries; the vectors are read from the index at
        flush time."""
        r = np.asarray(rows, np.int64).reshape(-1)
        return self._enqueue(QueryTicket(uid=self._next_uid(),
                                         k=self._k(k), rows=r), r.size)

    def _k(self, k) -> int:
        return self.default_k if k is None else int(k)

    def _next_uid(self) -> int:
        self._uid += 1
        return self._uid

    def _enqueue(self, ticket: QueryTicket, n_queries: int) -> QueryTicket:
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
        """Apply pending invalidations to the index; without incremental
        state there are none.  Returns rows repaired (0)."""
        return 0

    # -- flush ---------------------------------------------------------------
    def flush(self) -> list[QueryTicket]:
        """Repair, then answer every queued ticket in one padded batch."""
        if not self._queue:
            self.repair()
            return []
        t0 = time.perf_counter()
        with obs_trace.span("serve.query_flush",
                            pending=self._pending) as sp:
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
        # Row tickets gather only their rows on the device, then copy them
        # to the host -- never the whole [N, K] database.
        z = self.index.z
        blocks = [t.queries if t.queries is not None
                  else z[torch.from_numpy(t.rows).to(z.device)].cpu().numpy()
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


__all__ = ["LoadShedError", "QueryTicket", "GEEQueryService"]
