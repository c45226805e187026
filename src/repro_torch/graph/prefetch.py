"""Pipelined window prefetch: overlap reads, padding and host-to-device
copies with the fold (port of ``repro/graph/prefetch.py``).

:class:`PrefetchingWindowSource` wraps any ``WindowSource`` with a small
pipeline:

* a **reader thread** walks the source in order.  For a host-backed
  ``ChunkedEdgeList`` it only hands out, window by window, a slot of a ring
  of ``depth + 2`` reused staging buffers; on the card the ring is
  **pinned** host memory, so a copy out of it is a true asynchronous DMA;
* a bounded **worker pool** (``depth`` threads) fills each window's slot
  straight from the backing arrays -- ``depth`` windows at a time, since
  one thread's copies out of the mapped file were a streamed fit's
  bottleneck -- and runs the *stage* on it.  The default stage copies it
  to the device with ``non_blocking=True`` on a side ``torch.cuda.Stream``
  and records a CUDA event after the copies.  The consumer's stream waits on that event
  before the fold touches the window; the ring slot is handed back with
  the event and is refilled only once the event has completed, never
  while its copy may still be reading it.  The staged tensors are marked
  with ``record_stream`` for the consumer's stream, so the caching
  allocator does not reuse their memory while the fold still reads them;
* the consumer draws staged windows from a bounded FIFO, in the source's
  order, and any worker exception is raised where it is consumed.

``depth`` bounds the pool and the queue, so at most ``depth + 2`` windows
of host staging memory exist.  ``depth=0`` stages synchronously, with no
threads.  On the CPU the stage is an owning copy out of the ring.

Observability (``repro_torch.obs``): ``fold.prefetch_wait`` spans and the
``fold.prefetch_stall_ms`` histogram / ``fold.prefetch.queue_depth`` gauge
on the consumer side; ``fold.prefetch_fill`` (reader) and
``fold.prefetch_stage`` (worker) spans on the producer side.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.containers import EdgeList, edge_list_from_numpy
from repro_torch.graph.io import ChunkedEdgeList
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

ENV_PREFETCH_WINDOWS = "REPRO_GEE_PREFETCH_WINDOWS"
DEFAULT_PREFETCH_DEPTH = 2


def resolve_prefetch_depth(depth: int | None = None) -> int:
    """Effective prefetch depth: explicit value > env override > default
    (``REPRO_GEE_PREFETCH_WINDOWS``, then :data:`DEFAULT_PREFETCH_DEPTH`).
    Negative values clamp to 0 (synchronous)."""
    if depth is None:
        raw = os.environ.get(ENV_PREFETCH_WINDOWS, "").strip()
        if raw:
            try:
                depth = int(raw)
            except ValueError:
                raise ValueError(
                    f"{ENV_PREFETCH_WINDOWS}={raw!r} is not an integer")
        else:
            depth = DEFAULT_PREFETCH_DEPTH
    return max(0, int(depth))


class PlaneWindow(NamedTuple):
    """A window already packed into one rank's ELL plane by a prefetch
    stage (``repro_torch.core.fold.gee_streamed_sharded`` with the ``cuda``
    local backend)."""

    num_edges: int        # stored entries of the whole window
    cols: object          # [n_pad, width] int32, on the device
    vals: object          # [n_pad, width] float32, on the device


class _Stop(Exception):
    """Internal: the consumer went away; reader and ring unwind quietly."""


def _default_stage(device: torch.device) -> Callable[[EdgeList], EdgeList]:
    """Stage that copies a window onto ``device``: asynchronous copies on
    the card (run on the pipeline's copy stream), an owning copy on the
    host (the window may sit in a reused staging buffer)."""
    if device.type == "cuda":
        def stage(w: EdgeList) -> EdgeList:
            return EdgeList(
                src=w.src.to(device, non_blocking=True),
                dst=w.dst.to(device, non_blocking=True),
                weight=w.weight.to(device, non_blocking=True),
                num_nodes=w.num_nodes, num_edges=w.num_edges)
    else:
        def stage(w: EdgeList) -> EdgeList:
            return EdgeList(src=w.src.to(device, copy=True),
                            dst=w.dst.to(device, copy=True),
                            weight=w.weight.to(device, copy=True),
                            num_nodes=w.num_nodes, num_edges=w.num_edges)
    return stage


class _StagingRing:
    """Fixed pool of reused (src, dst, weight) host buffers, pinned when
    they feed the card.

    The reader acquires a free slot, fills it and hands it to a stage
    task, which releases it together with the CUDA event recorded after
    the slot's copies (``None`` on the host).  ``acquire`` waits for that
    event before it returns the slot for refilling.  Blocking acquires poll
    a stop event, so shutdown never deadlocks on an abandoned ring.
    """

    def __init__(self, slots: int, width: int, pinned: bool):
        self._free: queue.Queue = queue.Queue()
        self._bufs = []
        for i in range(slots):
            # every fill writes the whole width, so no zeroing here
            self._bufs.append(tuple(
                torch.empty(width, dtype=dt, pin_memory=pinned)
                for dt in (torch.int32, torch.int32, torch.float32)))
            self._free.put((i, None))

    def acquire(self, stop: threading.Event) -> int:
        while True:
            if stop.is_set():
                raise _Stop
            try:
                slot, done = self._free.get(timeout=0.05)
            except queue.Empty:
                continue
            if done is not None:
                done.synchronize()    # the slot's last copy has finished
            return slot

    def release(self, slot: int, done=None) -> None:
        self._free.put((slot, done))

    def buffers(self, slot: int):
        return self._bufs[slot]


def _record_on(window, stream) -> None:
    """Mark a staged window's device tensors as used on ``stream``, so the
    caching allocator keeps them until the fold's work on it is done."""
    if isinstance(window, EdgeList):
        tensors = (window.src, window.dst, window.weight)
    elif isinstance(window, PlaneWindow):
        tensors = (window.cols, window.vals)
    else:
        return
    for t in tensors:
        if t.is_cuda:
            t.record_stream(stream)


class PrefetchingWindowSource:
    """Wrap a ``WindowSource`` so windows are read, padded and staged to
    ``device`` ahead of the consuming fold.

    Satisfies the ``WindowSource`` protocol itself (metadata delegates to
    the wrapped source).  ``windows()`` yields exactly the windows the
    wrapped source would yield, in order, each transformed by ``stage``
    (default: copied to ``device``; ``None`` is the card).  A custom
    ``stage`` may receive a window backed by a reused staging buffer: it
    must copy the data onward before it returns, and on the card it runs
    with the pipeline's copy stream current.

    ``depth=0`` applies the stage synchronously with no threads.
    """

    def __init__(self, source, depth: int = DEFAULT_PREFETCH_DEPTH, *,
                 stage: Optional[Callable] = None, device=None):
        self.source = source
        self.depth = max(0, int(depth))
        self.device = resolve_device(device)
        self._stage = stage if stage is not None \
            else _default_stage(self.device)

    # WindowSource protocol: metadata delegates to the wrapped source ------
    @property
    def num_nodes(self) -> int:
        return self.source.num_nodes

    @property
    def undirected(self) -> bool:
        return self.source.undirected

    @property
    def num_edges(self) -> int:
        return self.source.num_edges

    @property
    def window_edges(self) -> int:
        return self.source.window_edges

    @property
    def num_windows(self) -> int:
        return self.source.num_windows

    def windows(self, pad_to: int | None = None) -> Iterator:
        if self.depth == 0:
            return (self._stage(w) for w in self.source.windows(pad_to=pad_to))
        return self._pipeline(pad_to)

    # the pipeline ---------------------------------------------------------
    def _pipeline(self, pad_to: int | None) -> Iterator:
        depth = self.depth
        on_card = self.device.type == "cuda"
        consumer = torch.cuda.current_stream(self.device) if on_card \
            else None
        copies = torch.cuda.Stream(self.device) if on_card else None
        stop = threading.Event()
        out: queue.Queue = queue.Queue(maxsize=depth)
        pool = ThreadPoolExecutor(max_workers=depth,
                                  thread_name_prefix="gee-prefetch")
        reader = threading.Thread(
            target=self._read_loop,
            args=(pad_to, stop, out, pool, copies, consumer),
            name="gee-prefetch-reader", daemon=True)
        reader.start()
        tr = obs_trace.get_tracer()
        reg = obs_metrics.get_registry()
        stall = reg.histogram("fold.prefetch_stall_ms")
        depth_gauge = reg.gauge("fold.prefetch.queue_depth")
        idx = 0
        try:
            while True:
                depth_gauge.set(out.qsize())
                t0 = time.perf_counter()
                with tr.span("fold.prefetch_wait", idx=idx, depth=depth):
                    kind, item = out.get()
                    if kind == "item":
                        item = item.result()   # (window, event) or raises
                if kind == "done":
                    return
                if kind == "error":
                    raise item
                if item is None:
                    continue           # an all-padding window: exact no-op
                stall.observe((time.perf_counter() - t0) * 1e3)
                window, ready = item
                if ready is not None:
                    consumer.wait_event(ready)
                yield window
                idx += 1
        finally:
            stop.set()
            while True:                 # unblock a reader stuck in put()
                try:
                    out.get_nowait()
                except queue.Empty:
                    break
            pool.shutdown(wait=True)
            reader.join(timeout=10.0)

    def _read_loop(self, pad_to, stop: threading.Event, out: queue.Queue,
                   pool: ThreadPoolExecutor, copies, consumer) -> None:
        def put(envelope) -> bool:
            while not stop.is_set():
                try:
                    out.put(envelope, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            if isinstance(self.source, ChunkedEdgeList) \
                    and self.source.device is None:
                tasks = self._ring_tasks(pad_to, stop, copies, consumer)
            else:
                tasks = self._generic_tasks(pad_to, stop, copies, consumer)
            for task in tasks:
                if not put(("item", pool.submit(task))):
                    raise _Stop
            put(("done", None))
        except _Stop:
            pass
        except BaseException as e:              # raised at the consumer
            put(("error", e))

    def _ring_tasks(self, pad_to, stop, copies, consumer):
        """Host-backed ``ChunkedEdgeList`` fast path: each task fills a
        reused staging slot straight from the backing arrays (mmap page-ins
        land on the workers) and stages it, with ``chunks()``'s semantics
        exactly: the same padding, the same all-padding-window skip (the
        task returns ``None``), the same single empty-graph window."""
        ch = self.source
        c = ch.effective_chunk_edges
        pad = max(c, pad_to or 0)
        n = ch.num_nodes
        if ch.num_edges == 0:
            def task_empty():
                w = edge_list_from_numpy(
                    np.empty(0, np.int32), np.empty(0, np.int32),
                    np.empty(0, np.float32), n, pad_to=pad, device="cpu")
                return self._run_stage(w, copies, consumer)
            yield task_empty
            return
        ring = _StagingRing(self.depth + 2, pad,
                            pinned=self.device.type == "cuda")
        tr = obs_trace.get_tracer()
        src_a, dst_a, w_a = ch.src, ch.dst, ch.weight
        for lo in range(0, ch.num_edges, c):
            hi = min(lo + c, ch.num_edges)
            slot = ring.acquire(stop)

            def task(slot=slot, lo=lo, hi=hi):
                done = None
                e = hi - lo
                try:
                    ts, td, tw = ring.buffers(slot)
                    bs, bd, bw = ts.numpy(), td.numpy(), tw.numpy()
                    with tr.span("fold.prefetch_fill", lo=int(lo), edges=e):
                        bw[:e] = w_a[lo:hi]
                        if not bw[:e].any():
                            return None    # all-padding window: exact no-op
                        bs[:e] = src_a[lo:hi]
                        bd[:e] = dst_a[lo:hi]
                        bs[e:] = 0
                        bd[e:] = 0
                        bw[e:] = 0.0
                    w = EdgeList(src=ts, dst=td, weight=tw, num_nodes=n,
                                 num_edges=e)
                    staged, done = self._run_stage(w, copies, consumer)
                    return staged, done
                finally:
                    ring.release(slot, done)
            yield task

    def _generic_tasks(self, pad_to, stop, copies, consumer):
        """Any other source: iterate it on the reader thread (the read
        leaves the consumer's critical path) and stage each fresh window on
        a worker."""
        tr = obs_trace.get_tracer()
        it = iter(self.source.windows(pad_to=pad_to))
        i = 0
        while True:
            if stop.is_set():
                raise _Stop
            with tr.span("fold.prefetch_fill", idx=i):
                try:
                    w = next(it)
                except StopIteration:
                    return

            def task(w=w):
                return self._run_stage(w, copies, consumer)
            yield task
            i += 1

    def _run_stage(self, w, copies, consumer):
        """Stage one window; returns ``(staged, ready)``, where ``ready``
        is the CUDA event recorded on the copy stream after the stage's
        copies (``None`` on the host)."""
        with obs_trace.span("fold.prefetch_stage", edges=int(w.num_edges)):
            if copies is None:
                return self._stage(w), None
            with torch.cuda.stream(copies):
                staged = self._stage(w)
                ready = torch.cuda.Event()
                ready.record(copies)
            _record_on(staged, consumer)
            return staged, ready


class ThrottledWindowSource:
    """A ``WindowSource`` wrapper that sleeps before yielding each window
    (a simulated slow disk for overlap benchmarks and order tests);
    ``jitter_s`` adds a seeded uniform extra delay per window."""

    def __init__(self, source, delay_s: float = 0.0, jitter_s: float = 0.0,
                 seed: int = 0):
        self.source = source
        self.delay_s = float(delay_s)
        self.jitter_s = float(jitter_s)
        self.seed = int(seed)

    @property
    def num_nodes(self) -> int:
        return self.source.num_nodes

    @property
    def undirected(self) -> bool:
        return self.source.undirected

    @property
    def num_edges(self) -> int:
        return self.source.num_edges

    @property
    def window_edges(self) -> int:
        return self.source.window_edges

    @property
    def num_windows(self) -> int:
        return self.source.num_windows

    @property
    def device(self):
        return getattr(self.source, "device", None)

    def windows(self, pad_to: int | None = None) -> Iterator[EdgeList]:
        import random
        rng = random.Random(self.seed)
        for w in self.source.windows(pad_to=pad_to):
            pause = self.delay_s
            if self.jitter_s:
                pause += rng.random() * self.jitter_s
            if pause > 0:
                time.sleep(pause)
            yield w


def prefetch_windows(source, depth: int | None = None, *,
                     stage: Optional[Callable] = None, device=None):
    """Wrap ``source`` for background staging onto ``device`` (``None``:
    the card).  The source comes back unchanged when the resolved depth is
    0, when it is already prefetching, or when its windows already live on
    ``device``."""
    depth = resolve_prefetch_depth(depth)
    if depth <= 0 or isinstance(source, PrefetchingWindowSource):
        return source
    device = resolve_device(device)
    if getattr(source, "device", None) == device:
        return source
    return PrefetchingWindowSource(source, depth, stage=stage, device=device)


__all__ = ["ENV_PREFETCH_WINDOWS", "DEFAULT_PREFETCH_DEPTH",
           "resolve_prefetch_depth", "PrefetchingWindowSource",
           "PlaneWindow", "ThrottledWindowSource", "prefetch_windows"]
