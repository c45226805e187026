"""Read replicas for the GEE query stack (port of
``repro/serve/replica.py``).

One write path, N read paths: a single sequenced delta stream (the
``DeltaLog`` discipline of ``repro_torch.serve.snapshot``) feeds any number
of :class:`GEEReplica` instances -- each a full ``IncrementalGEE`` +
``ClassPartitionedIndex`` + ``GEEQueryService`` stack, typically recovered
from the same snapshot directory.  :class:`ReplicaRouter` fans reads across
them with two guarantees:

* **Bounded staleness** -- a read admitted with ``max_lag=L`` is answered
  by a replica whose watermark is within L deltas of the stream head; a
  lagging replica is caught up *before* it serves (O(lag)).
* **Visible load shedding** -- every replica's query service has a bounded
  queue (``GEEQueryService(max_pending=...)``).  The router admits to the
  least-loaded fresh replica; when every candidate's queue is full the
  read is *shed*: ``LoadShedError`` reaches the caller and
  ``stats["shed_reads"]`` counts it.

Replicas are in-process objects; on one card they share its memory and
its stream of work.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.search.service import GEEQueryService, LoadShedError
from repro_torch.serve.snapshot import recover


class GEEReplica:
    """One read replica: incremental state + index + batched query service.

    Writes arrive only as sequenced deltas (``apply``), normally through
    the owning :class:`ReplicaRouter`; the watermark in ``IncrementalGEE``
    makes duplicate delivery a no-op.
    """

    def __init__(self, inc, index, *, name: str = "replica",
                 **service_kwargs):
        self.name = name
        self.inc = inc
        self.index = index
        self.service = GEEQueryService(index, inc, **service_kwargs)

    @classmethod
    def from_directory(cls, directory: str, *, name: str = "replica",
                       verify: bool = True, device=None,
                       **service_kwargs) -> "GEEReplica":
        """Hydrate a replica from a snapshot directory: newest loadable
        snapshot + full WAL replay (``repro_torch.serve.snapshot.recover``),
        on ``device`` (``None``: the card)."""
        st = recover(directory, verify=verify, with_index=True,
                     device=device)
        if st.index is None:
            raise ValueError(f"snapshot under {directory!r} carries no "
                             f"index; replicas need one to serve reads")
        return cls(st.inc, st.index, name=name, **service_kwargs)

    @property
    def watermark(self) -> int:
        """Highest applied delta sequence number (-1 = snapshot only)."""
        return self.inc.applied_seq

    @property
    def backlog(self) -> int:
        """Queued-but-unanswered query vectors (admission signal)."""
        return self.service.backlog

    def apply(self, deltas) -> None:
        """Apply sequenced delta(s); already-applied seqs are skipped."""
        if not isinstance(deltas, (list, tuple)):
            deltas = [deltas]
        for d in deltas:
            self.inc.apply(d)

    def close(self) -> None:
        self.service.close()


class ReplicaRouter:
    """Fan reads across replicas fed from one sequenced delta stream.

    Writes: :meth:`publish` stamps the batch (through the attached
    ``DeltaLog`` when one is given, making the stream durable, or a local
    counter otherwise) and retains it until every replica has applied it.
    Replicas catch up lazily, when a read's staleness bound demands it.

    Reads: :meth:`submit_rows` / :meth:`read_rows` admit to the fresh
    (watermark >= head - max_lag, catching up as needed) replica with the
    smallest queue; a full queue falls through to the next candidate, and
    ``LoadShedError`` is raised -- and counted -- only when every replica
    sheds.
    """

    def __init__(self, replicas: Sequence[GEEReplica], *,
                 log=None, max_lag: int = 0):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.replicas = list(replicas)
        self.log = log
        self.max_lag = int(max_lag)
        self._lock = threading.Lock()
        self._retained: list = []            # stamped, not yet fully applied
        self._head = max((r.watermark for r in replicas), default=-1)
        if log is not None:
            self._head = max(self._head, log.head_seq)
        self.stats = obs_metrics.get_registry().stats_view(
            "serve.router", {"published_deltas": 0, "reads": 0,
                             "shed_reads": 0, "catch_ups": 0,
                             "catch_up_deltas": 0,
                             "routed": {r.name: 0 for r in replicas}})

    # -- write side ----------------------------------------------------------
    @property
    def head_seq(self) -> int:
        """Sequence number of the newest published delta."""
        return self._head

    def publish(self, deltas, meta: dict | None = None) -> list:
        """Stamp and retain one delta batch; returns the stamped deltas.

        With a ``DeltaLog`` attached the batch is durably appended first;
        replicas then see exactly the stamped objects, keeping one sequence
        space across the log, the primary and every replica.
        """
        if not isinstance(deltas, (list, tuple)):
            deltas = [deltas]
        with self._lock:
            if self.log is not None:
                stamped = self.log.append(list(deltas), meta=meta)
            else:
                stamped = [dataclasses.replace(d, seq=self._head + 1 + i)
                           for i, d in enumerate(deltas)]
            self._retained.extend(stamped)
            self._head = stamped[-1].seq
            self.stats["published_deltas"] += len(stamped)
        return stamped

    def _trim_retained(self) -> None:
        """Drop retained deltas every replica has applied (lock held)."""
        floor = min(r.watermark for r in self.replicas)
        self._retained = [d for d in self._retained if d.seq > floor]

    def catch_up(self, replica: GEEReplica, target_seq: int | None = None
                 ) -> int:
        """Apply retained deltas past the replica's watermark (up to
        ``target_seq``, default: the head); returns deltas applied."""
        target = self._head if target_seq is None else int(target_seq)
        with self._lock:
            pending = [d for d in self._retained
                       if replica.watermark < d.seq <= target]
            replica.apply(pending)
            applied = len(pending)
            if applied:
                self.stats["catch_ups"] += 1
                self.stats["catch_up_deltas"] += applied
            self._trim_retained()
        return applied

    # -- read side -----------------------------------------------------------
    def _candidates(self, max_lag: int) -> list[GEEReplica]:
        fresh_floor = self._head - max_lag
        fresh = [r for r in self.replicas if r.watermark >= fresh_floor]
        stale = [r for r in self.replicas if r.watermark < fresh_floor]
        # Fresh replicas first (no catch-up cost), least-loaded within each
        # group; a stale replica is chosen only when every fresh queue is
        # full, and then it catches up before serving.
        key = lambda r: r.backlog                          # noqa: E731
        return sorted(fresh, key=key) + sorted(stale, key=key)

    def submit_rows(self, rows, k: int | None = None,
                    max_lag: int | None = None):
        """Admit a vertex-id query batch to a fresh-enough replica.

        Returns ``(replica, ticket)`` -- the ticket completes at that
        replica's next flush.  Raises :class:`LoadShedError` (counted) when
        every staleness-eligible replica's queue is full.
        """
        lag = self.max_lag if max_lag is None else int(max_lag)
        rows = np.asarray(rows, np.int64).reshape(-1)
        self.stats["reads"] += 1
        last_err: Optional[LoadShedError] = None
        for replica in self._candidates(lag):
            if replica.watermark < self._head - lag:
                self.catch_up(replica)
            try:
                ticket = replica.service.submit_rows(rows, k)
            except LoadShedError as e:
                last_err = e
                continue
            self.stats["routed"][replica.name] += 1
            return replica, ticket
        self.stats["shed_reads"] += 1
        raise last_err if last_err is not None else LoadShedError(
            "no admissible replica")

    def read_rows(self, rows, k: int | None = None,
                  max_lag: int | None = None):
        """Synchronous read: admit, flush that replica, return
        ``(ids, scores)`` numpy arrays."""
        replica, ticket = self.submit_rows(rows, k, max_lag)
        if not ticket.done:
            replica.service.flush()
        return ticket.ids, ticket.scores

    def flush_all(self) -> None:
        """Flush every replica's query queue (drains pending tickets)."""
        for r in self.replicas:
            r.service.flush()

    def close(self) -> None:
        for r in self.replicas:
            r.close()
        self.stats.close()


__all__ = ["GEEReplica", "ReplicaRouter", "LoadShedError"]
