"""Structured span tracing for the GEE pipeline (port of
``repro/obs/trace.py``; only the device annotation differs).

The paper's claim is a *measurement* ("millions of edges within
minutes"), but until now the repo could only time itself from the
outside: a benchmark wraps a whole fit in ``perf_counter`` and learns
nothing about where the time went -- prep vs. scatter vs. epilogue,
cache hit vs. rebuild, which stream window stalled.  This module is the
inside view: a thread-safe span tracer whose records export as
Chrome/Perfetto trace-event JSON, so one ``gee_run --trace out.json``
produces a timeline that ``ui.perfetto.dev`` (or ``chrome://tracing``)
loads directly.

Design constraints, in order:

  1. **Near-zero cost when disabled.**  The instrumentation lives on hot
     paths (every plan stage, every stream window).  ``span()`` on a
     disabled tracer returns one preallocated no-op context manager --
     no allocation, no lock, no clock read.  The measured overhead gate
     lives in :func:`tracer_overhead_pct` (CI asserts <= 2% on a full
     ``gee()`` fit).
  2. **Correct nesting, even under exceptions.**  Spans per thread form
     a stack; ``__exit__`` always pops and always records, so a span
     that dies by exception still closes and its parents still nest
     around it.
  3. **Device alignment.**  When tracing is enabled, every span also
     enters a ``torch.profiler.record_function`` of the same name, so a
     simultaneous ``torch.profiler.profile()`` capture shows these host
     spans on the same timeline as the device kernels they launched.
     Span names are the reference's, so traces from the two packages
     line up.
  4. **Device intervals without syncs.**  Once the process has
     initialised CUDA, a live span records a timing event
     (``torch.Event``) on the current stream at enter (after its host
     clock read) and at exit (before it).  Nothing waits on them while
     work runs: :meth:`Tracer.events` resolves them afterwards into
     ``dev_ts_us`` / ``dev_dur_us`` on the tracer's own epoch, through
     two anchors (one when the first device span opens, one at
     resolution), each a synchronize, then the narrowest of a few
     brackets of a host clock read, an event record, a synchronize and a
     host clock read.  The two map the device clock linearly onto the
     host's; their bracket widths and the drift between them are in
     :meth:`Tracer.metadata`.

Every span has a ``span_id`` and the ``parent_id`` of the span open on
its thread when it opened (``None`` at a root); :func:`self_times`
subtracts what a span's children cover.

The process-global default tracer (:func:`get_tracer` /
:func:`set_tracer` / :func:`enable` / :func:`span`) is what the library
instrumentation uses; tests build private :class:`Tracer` instances.

>>> t = Tracer(enabled=True, annotate_device=False)
>>> with t.span("fit", backend="sparse_torch"):
...     with t.span("scatter"):
...         pass
>>> [e.name for e in t.events()], [e.depth for e in t.events()]
(['scatter', 'fit'], [1, 0])
>>> t.events()[0].parent_id == t.events()[1].span_id
True
>>> sorted(t.chrome_trace())
['displayTimeUnit', 'metadata', 'traceEvents']
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["Tracer", "SpanEvent", "span", "get_tracer", "set_tracer",
           "enable", "disable", "self_times", "tracer_overhead_pct"]

# Brackets tried for each clock anchor; the narrowest is kept.
ANCHOR_TRIES = 3


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One closed span: a Chrome trace-event "complete" (ph=X) record.

    ``dev_ts_us`` / ``dev_dur_us`` are the span's device interval (the
    events it recorded at enter and exit on the current stream), mapped
    onto the tracer's epoch; ``None`` where no device events were
    recorded (the CPU, or CUDA not yet initialised).
    """

    name: str
    ts_us: float                 # start, microseconds since tracer epoch
    dur_us: float
    tid: int
    depth: int                   # nesting level at open time (0 = root)
    args: dict
    span_id: int = 0
    parent_id: Optional[int] = None
    dev_ts_us: Optional[float] = None
    dev_dur_us: Optional[float] = None

    def to_chrome(self, pid: int) -> dict:
        args = dict(self.args)
        args["depth"] = self.depth
        args["span_id"] = self.span_id
        args["parent_id"] = self.parent_id
        return {"name": self.name, "ph": "X", "cat": "gee",
                "ts": self.ts_us, "dur": self.dur_us,
                "pid": pid, "tid": self.tid, "args": args}


def self_times(events) -> dict:
    """``{span_id: us}``: each span's duration less what its children
    (the spans whose ``parent_id`` is its id) cover."""
    out = {e.span_id: e.dur_us for e in events}
    for e in events:
        if e.parent_id in out:
            out[e.parent_id] -= e.dur_us
    return out


class _NullSpan:
    """The disabled-path context manager: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kw):
        """No-op twin of :meth:`_LiveSpan.tag`."""


_NULL = _NullSpan()


class _LiveSpan:
    """An open span: records itself on exit (exception or not)."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_depth", "_annot",
                 "_id", "_parent", "_ev0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._annot = None

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self._depth = len(stack)
        self._parent = stack[-1]._id if stack else None
        self._id = next(tr._ids)
        stack.append(self)
        if tr.annotate_device:
            annot = _trace_annotation(self.name)
            if annot is not None:
                annot.__enter__()
                self._annot = annot
        dev = tr._device()
        self._t0 = tr._clock()
        self._ev0 = dev.record() if dev is not None else None
        return self

    def tag(self, **kw) -> None:
        """Attach tags discovered mid-span (e.g. a cache-hit flag that is
        only known after the lookup ran)."""
        self.args.update(kw)

    def __exit__(self, exc_type, exc, tb):
        tr = self._tracer
        ev1 = tr._dev.record() if self._ev0 is not None else None
        t1 = tr._clock()
        if self._annot is not None:
            self._annot.__exit__(exc_type, exc, tb)
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        tr._record(SpanEvent(
            name=self.name,
            ts_us=(self._t0 - tr._epoch_ns) / 1e3,
            dur_us=(t1 - self._t0) / 1e3,
            tid=threading.get_ident() & 0x7FFFFFFF,
            depth=self._depth,
            args=self.args,
            span_id=self._id,
            parent_id=self._parent), self._ev0, ev1)
        return False


def _trace_annotation(name: str):
    """A ``torch.profiler.record_function`` of the span's name."""
    import torch.profiler

    return torch.profiler.record_function(name)


class _CudaEvents:
    """Timing events on the current CUDA stream, from a pool: an event
    goes back to the pool once its time has been read.  ``torch.Event``
    finds the current stream in C++; ``torch.cuda.Event.record`` builds a
    Python stream object first, which made a span three times as dear on
    an H100's host (13.8 against 50.6 us)."""

    def __init__(self, torch):
        self._torch = torch
        self._pool: list = []

    def record(self):
        try:
            ev = self._pool.pop()      # atomic: spans open on many threads
        except IndexError:
            ev = self._torch.Event(device="cuda", enable_timing=True)
        ev.record()
        return ev

    def elapsed_us(self, a, b) -> float:
        return a.elapsed_time(b) * 1e3

    def synchronize(self) -> None:
        self._torch.cuda.synchronize()

    def release(self, events) -> None:
        self._pool.extend(events)


def _cuda_events():
    """A :class:`_CudaEvents` once this process has initialised CUDA, so
    a run on the CPU never creates a CUDA context for its spans."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return _CudaEvents(torch)


class Tracer:
    """Thread-safe span recorder with Chrome/Perfetto JSON export.

    ``enabled=False`` (the default) makes :meth:`span` return a shared
    no-op context manager; flipping :meth:`enable` starts recording.
    ``max_events`` bounds memory on long streams -- events past the
    bound are dropped and counted (``dropped``), never silently.
    ``annotate_device=True`` additionally wraps every span in
    ``torch.profiler.record_function`` so host spans line up with device
    kernels inside a ``torch.profiler.profile()`` capture.

    ``device_events`` is where device intervals come from: ``None`` (the
    default) is CUDA's timing events once the process has initialised
    CUDA, ``False`` records none, and an object with ``record()``,
    ``elapsed_us(a, b)``, ``synchronize()`` and ``release(events)`` is
    used as given.  ``clock`` is the host clock in nanoseconds
    (``time.perf_counter_ns``, CLOCK_MONOTONIC on Linux).  Each span
    with device events holds its two events until :meth:`events`
    resolves them.
    """

    def __init__(self, enabled: bool = False, max_events: int = 1_000_000,
                 annotate_device: bool = True, device_events=None,
                 clock: Callable[[], int] = time.perf_counter_ns):
        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        self.annotate_device = bool(annotate_device)
        self.dropped = 0
        self._clock = clock
        self._epoch_ns = clock()
        self._epoch_monotonic_ns = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        self._epoch_wall_ns = time.time_ns()
        self._events: list[SpanEvent] = []
        self._pending: list = []      # (index in _events, enter, exit)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._auto = device_events is None
        self._dev = None if self._auto or device_events is False \
            else device_events
        self._anchors: list = []      # (host mid ns, bracket ns, event)

    # -- control -------------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._release_pending()
            self.dropped = 0

    def now_ns(self) -> int:
        """The tracer's host clock (nanoseconds)."""
        return self._clock()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **tags):
        """Open a span (context manager).  On a disabled tracer this is
        the no-op singleton -- the near-zero hot-path cost."""
        if not self.enabled:
            return _NULL
        return _LiveSpan(self, name, tags)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open_spans(self) -> tuple:
        """Names of this thread's currently-open spans, outermost first
        (the nesting-correctness tests key on this)."""
        return tuple(s.name for s in self._stack())

    def _device(self):
        """The device event source, once there is one; the first call
        that finds it takes the first anchor."""
        dev = self._dev
        if dev is None:
            dev = _cuda_events() if self._auto else None
            if dev is None:
                return None
            with self._lock:
                if self._dev is None:
                    self._dev = dev
                dev = self._dev
        if not self._anchors:
            with self._lock:
                if not self._anchors:
                    self._anchors.append(self._anchor(dev))
        return dev

    def _anchor(self, dev) -> tuple:
        """One point of both clocks, after the card has drained: an event
        whose device time lies between two host reads.  The narrowest of
        ``ANCHOR_TRIES`` brackets is kept (the first pays for warming the
        event path)."""
        dev.synchronize()
        best = None
        for _ in range(ANCHOR_TRIES):
            h0 = self._clock()
            ev = dev.record()
            dev.synchronize()
            h1 = self._clock()
            if best is None or h1 - h0 < best[1]:
                if best is not None:
                    dev.release([best[2]])
                best = ((h0 + h1) / 2, h1 - h0, ev)
            else:
                dev.release([ev])
        return best

    def _record(self, event: SpanEvent, ev0=None, ev1=None) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                if ev0 is not None:
                    self._dev.release((ev0, ev1))
                return
            if ev0 is not None:
                self._pending.append((len(self._events), ev0, ev1))
            self._events.append(event)

    def _release_pending(self) -> None:
        if self._pending:
            self._dev.release([ev for _, e0, e1 in self._pending
                               for ev in (e0, e1)])
            self._pending = []

    def _resolve(self) -> None:
        """Give every pending span its device interval (under the lock):
        a second anchor, the linear map from the first, then each event's
        time since the first anchor's event."""
        if not self._pending:
            return
        dev = self._dev
        first = self._anchors[0]
        last = self._anchor(dev)
        self._anchors.append(last)
        d_us = dev.elapsed_us(first[2], last[2])
        scale = (last[0] - first[0]) / d_us if d_us > 0 else 1e3
        base = first[0] - self._epoch_ns
        for i, e0, e1 in self._pending:
            t0 = dev.elapsed_us(first[2], e0)
            t1 = dev.elapsed_us(first[2], e1)
            self._events[i] = dataclasses.replace(
                self._events[i], dev_ts_us=(base + t0 * scale) / 1e3,
                dev_dur_us=(t1 - t0) * scale / 1e3)
        self._release_pending()

    # -- export --------------------------------------------------------------
    def events(self) -> tuple:
        """Snapshot of the recorded spans (close order), their device
        intervals resolved."""
        with self._lock:
            self._resolve()
            return tuple(self._events)

    def metadata(self) -> dict:
        """The tracer's epoch on CLOCK_MONOTONIC and on the wall clock,
        and its device clock: each anchor's bracket width, and the drift
        of the device clock against the host's between the first anchor
        and the last (``None`` before any device span resolved)."""
        out = {"clock": "CLOCK_MONOTONIC",
               "epoch_monotonic_ns": self._epoch_monotonic_ns,
               "epoch_wall_ns": self._epoch_wall_ns, "device": None}
        with self._lock:
            anchors = list(self._anchors)
        if len(anchors) >= 2:
            dev = self._dev
            first, last = anchors[0], anchors[-1]
            d_us = dev.elapsed_us(first[2], last[2])
            host_us = (last[0] - first[0]) / 1e3
            out["device"] = {
                "anchor_width_us": [a[1] / 1e3 for a in anchors],
                "anchor_host_us": [(a[0] - self._epoch_ns) / 1e3
                                   for a in anchors],
                "span_us": host_us,
                "drift_us": host_us - d_us,
                "drift_ppm": (host_us - d_us) / d_us * 1e6 if d_us > 0
                else 0.0}
        return out

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object Perfetto loads directly: the
        host spans on each thread's track, and beside each thread a
        device track holding every span's device interval under the
        span's name (the gaps there are the card's idle time)."""
        pid = os.getpid()
        spans = self.events()
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": "gee-repro"}}]
        events += [e.to_chrome(pid) for e in spans]
        tracks = {}
        for e in spans:
            if e.dev_ts_us is None:
                continue
            tid = tracks.setdefault(e.tid, e.tid | 0x80000000)
            events.append({"name": e.name, "ph": "X", "cat": "gee.device",
                           "ts": e.dev_ts_us, "dur": e.dev_dur_us,
                           "pid": pid, "tid": tid,
                           "args": {"span_id": e.span_id}})
        events += [{"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": dev_tid, "args": {"name": f"device ({tid})"}}
                   for tid, dev_tid in tracks.items()]
        return {"displayTimeUnit": "ms", "traceEvents": events,
                "metadata": self.metadata()}

    def write(self, path: str) -> str:
        """Serialize :meth:`chrome_trace` to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# ---------------------------------------------------------------------------
# the process-global default tracer (what library instrumentation uses)
# ---------------------------------------------------------------------------

_default = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (returns the previous one)."""
    global _default
    prev, _default = _default, tracer
    return prev


def enable(**kw) -> Tracer:
    """Enable the global tracer (optionally replacing its settings)."""
    for k, v in kw.items():
        setattr(_default, k, v)
    return _default.enable()


def disable() -> Tracer:
    return _default.disable()


def span(name: str, **tags):
    """Open a span on the global default tracer.

    The disabled path is one attribute load + one branch + the kwargs
    dict -- cheap enough for per-window instrumentation
    (:func:`tracer_overhead_pct` is the measured guarantee).
    """
    t = _default
    if not t.enabled:
        return _NULL
    return _LiveSpan(t, name, tags)


# ---------------------------------------------------------------------------
# the overhead gate
# ---------------------------------------------------------------------------

def tracer_overhead_pct(fn: Callable[[], object], *, repeats: int = 5,
                        calibration_calls: int = 50_000,
                        tracer: Optional[Tracer] = None) -> dict:
    """Measure the disabled-instrumentation overhead of ``fn``, in percent.

    Noise-free decomposition instead of an A/B wall-clock diff (which on
    shared CI runners drowns a sub-percent effect in scheduler jitter):

      1. run ``fn`` once under a private *enabled* tracer to count how
         many spans one call opens (``span_count``);
      2. micro-time the disabled ``span()`` enter/exit path
         (min over batches of ``calibration_calls``);
      3. min-of-``repeats`` time ``fn`` with tracing disabled.

    ``overhead_pct = 100 * span_count * t_disabled_span / t_fn`` -- the
    exact cost the disabled instrumentation adds to one call.  Returns a
    dict with the components and the headline ``overhead_pct``
    (LOWER is better; the CI gate asserts <= 2%).
    """
    probe = Tracer(enabled=True, annotate_device=False, device_events=False)
    prev = set_tracer(probe)
    try:
        fn()                                    # count spans (+ jit warmup)
        span_count = len(probe.events()) + probe.dropped
    finally:
        set_tracer(prev)

    was_enabled = _default.enabled
    _default.disable()
    try:
        per_call = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(calibration_calls):
                with span("overhead-probe", tag=0):
                    pass
            per_call = min(per_call,
                           (time.perf_counter() - t0) / calibration_calls)

        t_fn = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            t_fn = min(t_fn, time.perf_counter() - t0)
    finally:
        _default.enabled = was_enabled

    overhead = 100.0 * span_count * per_call / max(t_fn, 1e-12)
    return {"span_count": int(span_count),
            "disabled_span_ns": per_call * 1e9,
            "fn_s": t_fn,
            "overhead_pct": overhead}
