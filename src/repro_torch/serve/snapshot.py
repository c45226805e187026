"""Crash-safe GEE serving: delta write-ahead log and consistent snapshots
(port of ``repro/serve/snapshot.py``).

* :class:`DeltaLog` -- an append-only write-ahead log of delta batches.
  One atomic record (tmp file, fsync, rename) per applied flush; each delta
  in a record gets a monotonically increasing sequence number.  The write
  path (``GEEDeltaServer(log=...)``) appends *before* applying, so a crash
  between the two leaves a logged-but-unapplied batch, which replay covers.
* :class:`GEESnapshotter` -- periodic consistent snapshots of the serving
  state through ``CheckpointManager``'s versioned, retained, atomically
  written store.  A snapshot is taken at a delta boundary (queued writes
  flushed, index repaired, cached Z materialized) and holds the
  accumulators S, n_k, degrees, d^{-1/2}, labels, the live adjacency (as
  row-grouped triplets), the cached Z, the index's cell tables and the
  delta-sequence **watermark** (``IncrementalGEE.applied_seq``).

:func:`recover` loads the newest *loadable* snapshot (a corrupt or
partially written one fails its digest and is skipped) and replays only
the WAL records past its watermark; the accumulators are restored byte
for byte, and replay is idempotent (the watermark skips what was already
applied).

The files are the reference's, record for record and leaf for leaf: WAL
records ``wal/rec_%010d_%03d.npz`` with the same keys and dtypes (int32
ids and labels, float32 weights, the JSON ``meta`` as a 0-d string array)
and snapshots ``snapshots/step_%010d`` in ``repro_torch.checkpoint.ckpt``'s
layout, so a directory written by either package recovers in the other.
The Z cache and the centroids are copied from the device to the host when
the state is captured, before the writer thread sees them.  The port's
index has no ``impl`` knob: a snapshot records ``"impl": "auto"`` (which
the reference accepts) and ``restore_index`` ignores the field.

Snapshot step numbering is ``watermark + 1`` (a pre-stream snapshot is
step 0), and the WAL is pruned only up to the *oldest retained* snapshot's
watermark, so every snapshot the manager keeps stays replayable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.gee import GEEOptions
from repro_torch.core.incremental import (Delta, DirtyRowTracker,
                                          IncrementalGEE, fill_adjacency)
from repro_torch.graph.delta import (EdgeDelta, LabelDelta,
                                     edge_delta_from_numpy,
                                     label_delta_from_numpy)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.search.index import ClassPartitionedIndex, index_stats_view

SNAPSHOT_VERSION = 1

_REC_RE = re.compile(r"^rec_(\d{10})_(\d{3})\.npz$")


# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------

class DeltaLog:
    """Append-only, atomically written log of delta batches.

    One ``.npz`` file per record; a record holds one *or several* deltas
    (e.g. the merged edge batch and the merged label batch of one serving
    flush) that commit together -- a crash never tears a record in two.
    Sequence numbers are per delta and strictly increasing across records;
    ``replay`` yields ``(seq, delta, meta)`` with ``delta.seq`` stamped so
    ``IncrementalGEE``'s watermark makes re-delivery a no-op.
    """

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        recs = self._records()
        self._next = (recs[-1][0] + recs[-1][1]) if recs else 0
        self.stats = obs_metrics.get_registry().stats_view(
            "wal", {"appended_records": 0, "appended_deltas": 0,
                    "replayed_deltas": 0, "pruned_records": 0})

    def _records(self) -> list[tuple[int, int, str]]:
        """Sorted (first_seq, count, filename) of every record on disk."""
        out = []
        for name in os.listdir(self.directory):
            m = _REC_RE.match(name)
            if m:
                out.append((int(m.group(1)), int(m.group(2)), name))
        return sorted(out)

    @property
    def head_seq(self) -> int:
        """Highest assigned sequence number (-1 when the log is empty)."""
        return self._next - 1

    def append(self, deltas: "Delta | Sequence[Delta]",
               meta: dict | None = None) -> list:
        """Atomically log one record; returns the seq-stamped deltas.

        WAL discipline: call this first, then apply exactly the stamped
        batches it returns -- their ``seq`` is what makes a later replay
        skip them.
        """
        batch = self.stamp(deltas)
        payload: dict[str, np.ndarray] = {
            "meta": np.array(json.dumps(meta or {})),
            "kinds": np.array([("edge" if isinstance(d, EdgeDelta)
                                else "label") for d in batch]),
        }
        for i, d in enumerate(batch):
            n = d.num_deltas
            if isinstance(d, EdgeDelta):
                payload[f"d{i}_src"] = np.asarray(d.src)[:n].astype(np.int32)
                payload[f"d{i}_dst"] = np.asarray(d.dst)[:n].astype(np.int32)
                payload[f"d{i}_weight"] = \
                    np.asarray(d.weight)[:n].astype(np.float32)
            elif isinstance(d, LabelDelta):
                payload[f"d{i}_node"] = \
                    np.asarray(d.node)[:n].astype(np.int32)
                payload[f"d{i}_new_label"] = \
                    np.asarray(d.new_label)[:n].astype(np.int32)
            else:
                raise TypeError(f"unsupported delta type {type(d).__name__}")
        first = batch[0].seq
        fname = f"rec_{first:010d}_{len(batch):03d}.npz"
        dest = os.path.join(self.directory, fname)
        with obs_trace.span("wal.append", seq=first, deltas=len(batch)):
            fd, tmp = tempfile.mkstemp(prefix=".wal_tmp_",
                                       dir=self.directory)
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, dest)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        self._next = first + len(batch)
        self.stats["appended_records"] += 1
        self.stats["appended_deltas"] += len(batch)
        obs_metrics.get_registry().counter("wal.appended_bytes").inc(
            os.path.getsize(dest))
        return batch

    def stamp(self, deltas: "Delta | Sequence[Delta]") -> list:
        """Assign the next sequence numbers to a batch (list returned in
        apply order).  Called by :meth:`append`."""
        batch = list(deltas) if isinstance(deltas, (list, tuple)) \
            else [deltas]
        if not batch:
            raise ValueError("empty delta record")
        return [dataclasses.replace(d, seq=self._next + i)
                for i, d in enumerate(batch)]

    def replay(self, after_seq: int = -1
               ) -> Iterator[tuple[int, "Delta", dict]]:
        """Yield ``(seq, delta, meta)`` for every logged delta with
        ``seq > after_seq``, in commit order."""
        for first, count, name in self._records():
            if first + count - 1 <= after_seq:
                continue
            path = os.path.join(self.directory, name)
            obs_metrics.get_registry().counter("wal.replayed_bytes").inc(
                os.path.getsize(path))
            with np.load(path) as data:
                meta = json.loads(str(data["meta"]))
                kinds = [str(k) for k in data["kinds"]]
                for i, kind in enumerate(kinds):
                    seq = first + i
                    if seq <= after_seq:
                        continue
                    if kind == "edge":
                        d = edge_delta_from_numpy(
                            data[f"d{i}_src"], data[f"d{i}_dst"],
                            data[f"d{i}_weight"], seq=seq)
                    else:
                        d = label_delta_from_numpy(
                            data[f"d{i}_node"], data[f"d{i}_new_label"],
                            seq=seq)
                    self.stats["replayed_deltas"] += 1
                    yield seq, d, meta

    def prune(self, upto_seq: int) -> int:
        """Drop records fully covered by ``seq <= upto_seq`` (already
        folded into every retained snapshot); returns records removed."""
        removed = 0
        for first, count, name in self._records():
            if first + count - 1 <= upto_seq:
                os.unlink(os.path.join(self.directory, name))
                removed += 1
        self.stats["pruned_records"] += removed
        return removed


# ---------------------------------------------------------------------------
# state capture / restore
# ---------------------------------------------------------------------------

def capture_state(inc: IncrementalGEE, index=None,
                  extra: dict | None = None) -> tuple[dict, dict]:
    """Snapshot the serving state into a flat array tree and a JSON extra.

    The caller quiesces first (flush the delta server, repair the index) --
    :meth:`GEESnapshotter.snapshot` does exactly that.  Every array is a
    host copy (Z and the centroids come off the device here), so the
    snapshot stays consistent while it is written asynchronously and the
    live state keeps mutating.
    """
    z = inc.embedding().cpu().numpy()        # materializes the cached Z
    adj_src, adj_dst, adj_w = inc.adjacency_triplets()
    tree = {
        "S": inc.S.copy(), "nk": inc.nk.copy(), "deg": inc.deg.copy(),
        "dinv": inc._dinv.copy(), "labels": inc.labels.copy(),
        "z": z,
        "adj_src": adj_src, "adj_dst": adj_dst, "adj_weight": adj_w,
    }
    meta = {
        "version": SNAPSHOT_VERSION,
        "watermark": int(inc.applied_seq),
        "num_nodes": int(inc.n), "num_classes": int(inc.k),
        "opts": {"laplacian": inc.opts.laplacian,
                 "diag_aug": inc.opts.diag_aug,
                 "correlation": inc.opts.correlation},
        "has_index": index is not None,
    }
    if index is not None:
        tree.update({
            "index_table": index._table.copy(),
            "index_cell_len": index._cell_len.copy(),
            "index_row_cell": index._row_cell.copy(),
            "index_row_slot": index._row_slot.copy(),
            "index_active": index._active.copy(),
            "index_centroids": index._centroids.cpu().numpy(),
        })
        meta["index_meta"] = {"metric": index.metric,
                              "nprobe": int(index.nprobe),
                              "pad_multiple": int(index.pad_multiple),
                              "impl": "auto"}
    meta.update(extra or {})
    return tree, meta


def restore_incremental(arrays: dict, extra: dict,
                        device=None) -> IncrementalGEE:
    """Rebuild an :class:`IncrementalGEE` from a snapshot, byte-exact on
    the accumulators (S is restored, not recomputed), with its Z cache on
    ``device`` (``None``: the card)."""
    opts = GEEOptions(**extra["opts"])
    inc = IncrementalGEE(extra["num_nodes"], extra["num_classes"], opts,
                         device=device)
    inc.S = np.asarray(arrays["S"], np.float64)
    inc.nk = np.asarray(arrays["nk"], np.float64)
    inc.deg = np.asarray(arrays["deg"], np.float64)
    inc._dinv = np.asarray(arrays["dinv"], np.float64)
    inc.labels = np.asarray(arrays["labels"], np.int32)
    src = np.asarray(arrays["adj_src"], np.int64)
    dst = np.asarray(arrays["adj_dst"], np.int64)
    w = np.asarray(arrays["adj_weight"], np.float64)
    fill_adjacency(inc.out_nbrs, src, dst, w)
    order = np.argsort(dst, kind="stable")
    fill_adjacency(inc.in_nbrs, dst[order], src[order], w[order])
    inc._z = torch.from_numpy(np.asarray(arrays["z"], np.float32)).to(
        inc.device)
    inc._winv_dirty = False
    inc._dirty_rows.clear()
    inc.applied_seq = int(extra["watermark"])
    return inc


def restore_index(arrays: dict, extra: dict,
                  inc: IncrementalGEE) -> ClassPartitionedIndex:
    """Rebuild the vertex-similarity index around the restored embedding,
    on the state's device.

    Cell tables, centroids and slot assignments come from the snapshot
    (centroids are *build-time* state -- a rebuild after label churn would
    derive different cells); the [N, K] database is the restored cached Z,
    which the snapshot's quiesce step made identical to the index's view.
    """
    im = extra["index_meta"]
    active = np.asarray(arrays["index_active"], bool)
    return ClassPartitionedIndex(
        metric=im["metric"], nprobe=int(im["nprobe"]),
        pad_multiple=int(im["pad_multiple"]),
        _z=inc.embedding(),
        _centroids=torch.from_numpy(np.asarray(
            arrays["index_centroids"], np.float32)).to(inc.device),
        _active=active,
        _active_dev=torch.from_numpy(active).to(inc.device),
        _table=np.asarray(arrays["index_table"], np.int32),
        _cell_len=np.asarray(arrays["index_cell_len"], np.int64),
        _row_cell=np.asarray(arrays["index_row_cell"], np.int32),
        _row_slot=np.asarray(arrays["index_row_slot"], np.int64),
        _table_dev=None,
        stats=index_stats_view(builds=0),
    )


# ---------------------------------------------------------------------------
# periodic snapshotting
# ---------------------------------------------------------------------------

class GEESnapshotter:
    """Periodic consistent snapshots and the WAL, under one directory.

    Layout: ``<dir>/snapshots/step_*`` (the ``CheckpointManager`` store:
    atomic renames, ``keep_last`` retention) and ``<dir>/wal/rec_*`` (the
    :class:`DeltaLog`).  Wire ``snapshotter.log`` into the write path
    (``GEEDeltaServer(log=...)``) and call :meth:`tick` once per applied
    stream batch; every ``every`` ticks the serving state is quiesced,
    captured and written, and the WAL is pruned back to the oldest snapshot
    the manager still retains.
    """

    def __init__(self, directory: str, *, every: int = 32,
                 keep_last: int = 3, failure_hook=None):
        self.directory = directory
        self.every = max(int(every), 1)
        self.manager = CheckpointManager(
            os.path.join(directory, "snapshots"), interval=1,
            keep_last=keep_last, failure_hook=failure_hook)
        self.log = DeltaLog(os.path.join(directory, "wal"))
        self._ticks = 0
        self.stats = obs_metrics.get_registry().stats_view(
            "snapshot", {"ticks": 0, "snapshots": 0,
                         "wal_records_pruned": 0})

    def tick(self, inc: IncrementalGEE, index=None, *, service=None,
             delta_server=None, extra: dict | None = None) -> Optional[int]:
        """Count one stream batch; snapshot at the configured cadence.
        Returns the snapshot step when one was taken, else None."""
        self._ticks += 1
        self.stats["ticks"] += 1
        if self._ticks % self.every:
            return None
        return self.snapshot(inc, index, service=service,
                             delta_server=delta_server, extra=extra)

    def snapshot(self, inc: IncrementalGEE, index=None, *, service=None,
                 delta_server=None, extra: dict | None = None) -> int:
        """Quiesce (flush writes, repair the index, materialize Z), capture
        and durably write one snapshot; prune the WAL.  Returns the step
        (``watermark + 1``)."""
        tr = obs_trace.get_tracer()
        with tr.span("snapshot.write") as sp:
            with tr.span("snapshot.quiesce"):
                if delta_server is not None:
                    delta_server.flush()
                if service is not None:
                    service.repair()
            with tr.span("snapshot.capture"):
                tree, meta = capture_state(inc, index, extra=extra)
            step = int(inc.applied_seq) + 1
            sp.tag(step=step)
            with tr.span("snapshot.save", step=step):
                self.manager.save_async(step, tree, meta)
                self.manager.wait()            # durable before WAL pruning
            self.stats["snapshots"] += 1
            with tr.span("snapshot.prune_wal"):
                steps = ckpt.available_steps(self.manager.directory)
                if steps:
                    self.stats["wal_records_pruned"] += \
                        self.log.prune(min(steps) - 1)
        return step

    def close(self):
        self.manager.close()


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveredState:
    """What :func:`recover` hands back: a live, caught-up serving core.

    ``timeline`` is the recovery narrative: one event dict per phase
    (snapshot choice -- with the corrupt steps walked past -- WAL replay,
    index repair), each with its wall time.  The same events are emitted
    as ``recover.*`` spans and registry metrics.
    """

    inc: IncrementalGEE
    index: Optional[ClassPartitionedIndex]
    log: DeltaLog
    snapshot_step: Optional[int]
    snapshot_watermark: int
    replayed_deltas: int
    repaired_rows: int
    last_meta: dict
    extra: dict
    skipped_steps: tuple = ()
    timeline: list = dataclasses.field(default_factory=list)


def recover(directory: str, *, verify: bool = True,
            with_index: bool = True, cold_start: dict | None = None,
            device=None) -> RecoveredState:
    """Load the newest loadable snapshot under ``directory`` and replay the
    WAL past its watermark, onto ``device`` (``None``: the card).

    Cost is O(snapshot size + |deltas since snapshot|): the accumulators
    are restored byte-exact, replayed batches go through the normal
    incremental path, and the index is repaired once over the rows the
    replay dirtied.  Corrupt or partially written snapshots fail digest
    verification and recovery falls back to the previous retained step.

    ``cold_start`` handles a WAL-only directory (a crash before the first
    snapshot): pass ``{"num_nodes": N, "num_classes": K}`` (optionally
    ``"opts"``, a :class:`GEEOptions` or its kwargs dict) and recovery
    replays the *entire* WAL into a fresh empty :class:`IncrementalGEE` at
    watermark -1.  With no snapshot and no ``cold_start``,
    ``FileNotFoundError`` is raised.
    """
    tr = obs_trace.get_tracer()
    reg = obs_metrics.get_registry()
    timeline: list[dict] = []
    t_total = time.perf_counter()
    with tr.span("recover", directory=directory) as sp_root:
        skipped: list[int] = []
        t0 = time.perf_counter()
        with tr.span("recover.load_snapshot") as sp:
            mgr = CheckpointManager(os.path.join(directory, "snapshots"),
                                    interval=1)
            try:
                step, arrays, extra = mgr.restore_latest_arrays(
                    verify=verify, skipped=skipped)
            finally:
                mgr.close()
            sp.tag(step=step, skipped_steps=list(skipped))
        if step is None:
            if cold_start is None:
                raise FileNotFoundError(
                    f"no loadable snapshot under {directory!r} "
                    f"(never snapshotted, or every retained snapshot is "
                    f"corrupt; pass cold_start= to replay a WAL-only "
                    f"directory)")
            opts = cold_start.get("opts", GEEOptions())
            if isinstance(opts, dict):
                opts = GEEOptions(**opts)
            inc = IncrementalGEE(int(cold_start["num_nodes"]),
                                 int(cold_start["num_classes"]), opts,
                                 device=device)
            index, watermark, extra = None, -1, {}
            timeline.append({
                "event": "cold_start", "skipped_steps": list(skipped),
                "ms": (time.perf_counter() - t0) * 1e3})
        else:
            inc = restore_incremental(arrays, extra, device=device)
            index = (restore_index(arrays, extra, inc)
                     if with_index and extra.get("has_index") else None)
            watermark = int(extra["watermark"])
            timeline.append({
                "event": "load_snapshot", "step": int(step),
                "watermark": watermark, "skipped_steps": list(skipped),
                "with_index": index is not None,
                "ms": (time.perf_counter() - t0) * 1e3})
        reg.counter("recover.snapshots_skipped").inc(len(skipped))

        log = DeltaLog(os.path.join(directory, "wal"))
        tracker = DirtyRowTracker(inc.n)
        inc.add_dirty_listener(tracker)
        replayed, last_meta = 0, {}
        bytes0 = reg.counter("wal.replayed_bytes").get()
        t0 = time.perf_counter()
        with tr.span("recover.replay", after_seq=watermark) as sp:
            try:
                for _seq, delta, meta in log.replay(after_seq=watermark):
                    inc.apply(delta)
                    replayed += 1
                    if meta:
                        last_meta = meta
            finally:
                inc.remove_dirty_listener(tracker)
            sp.tag(replayed=replayed)
        replay_s = time.perf_counter() - t0
        replay_bytes = reg.counter("wal.replayed_bytes").get() - bytes0
        if replay_s > 0 and replay_bytes:
            reg.gauge("wal.replay_bytes_per_sec").set(
                replay_bytes / replay_s)
        timeline.append({"event": "replay", "replayed_deltas": replayed,
                         "bytes": int(replay_bytes),
                         "head_seq": int(log.head_seq),
                         "ms": replay_s * 1e3})

        repaired = 0
        if index is not None and tracker.pending:
            t0 = time.perf_counter()
            with tr.span("recover.repair_index"):
                rows = tracker.drain()
                index.update_rows(rows, inc.embedding(rows))
                repaired = int(rows.size)
            timeline.append({"event": "repair_index",
                             "repaired_rows": repaired,
                             "ms": (time.perf_counter() - t0) * 1e3})
        total_ms = (time.perf_counter() - t_total) * 1e3
        timeline.append({"event": "recovered", "snapshot_step": step,
                         "watermark": int(watermark),
                         "replayed_deltas": replayed, "ms": total_ms})
        sp_root.tag(step=step, replayed=replayed,
                    skipped_steps=list(skipped))
        reg.counter("recover.runs").inc()
        reg.histogram("recover.total_ms").observe(total_ms)
    return RecoveredState(inc=inc, index=index, log=log, snapshot_step=step,
                          snapshot_watermark=watermark,
                          replayed_deltas=replayed, repaired_rows=repaired,
                          last_meta=last_meta, extra=extra,
                          skipped_steps=tuple(skipped), timeline=timeline)


__all__ = ["SNAPSHOT_VERSION", "DeltaLog", "capture_state",
           "restore_incremental", "restore_index", "GEESnapshotter",
           "RecoveredState", "recover"]
