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

The process-global default tracer (:func:`get_tracer` /
:func:`set_tracer` / :func:`enable` / :func:`span`) is what the library
instrumentation uses; tests build private :class:`Tracer` instances.

>>> t = Tracer(enabled=True, annotate_device=False)
>>> with t.span("fit", backend="sparse_torch"):
...     with t.span("scatter"):
...         pass
>>> [e.name for e in t.events()], [e.depth for e in t.events()]
(['scatter', 'fit'], [1, 0])
>>> sorted(t.chrome_trace()) == ["displayTimeUnit", "traceEvents"]
True
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Optional

__all__ = ["Tracer", "SpanEvent", "span", "get_tracer", "set_tracer",
           "enable", "disable", "tracer_overhead_pct"]


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One closed span: a Chrome trace-event "complete" (ph=X) record."""

    name: str
    ts_us: float                 # start, microseconds since tracer epoch
    dur_us: float
    tid: int
    depth: int                   # nesting level at open time (0 = root)
    args: dict

    def to_chrome(self, pid: int) -> dict:
        args = dict(self.args)
        args["depth"] = self.depth
        return {"name": self.name, "ph": "X", "cat": "gee",
                "ts": self.ts_us, "dur": self.dur_us,
                "pid": pid, "tid": self.tid, "args": args}


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

    __slots__ = ("_tracer", "name", "args", "_t0", "_depth", "_annot")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._annot = None

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self._depth = len(stack)
        stack.append(self)
        if tr.annotate_device:
            annot = _trace_annotation(self.name)
            if annot is not None:
                annot.__enter__()
                self._annot = annot
        self._t0 = time.perf_counter_ns()
        return self

    def tag(self, **kw) -> None:
        """Attach tags discovered mid-span (e.g. a cache-hit flag that is
        only known after the lookup ran)."""
        self.args.update(kw)

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._annot is not None:
            self._annot.__exit__(exc_type, exc, tb)
        tr = self._tracer
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
            args=self.args))
        return False


def _trace_annotation(name: str):
    """A ``torch.profiler.record_function`` of the span's name."""
    import torch.profiler

    return torch.profiler.record_function(name)


class Tracer:
    """Thread-safe span recorder with Chrome/Perfetto JSON export.

    ``enabled=False`` (the default) makes :meth:`span` return a shared
    no-op context manager; flipping :meth:`enable` starts recording.
    ``max_events`` bounds memory on long streams -- events past the
    bound are dropped and counted (``dropped``), never silently.
    ``annotate_device=True`` additionally wraps every span in
    ``torch.profiler.record_function`` so host spans line up with device
    kernels inside a ``torch.profiler.profile()`` capture.
    """

    def __init__(self, enabled: bool = False, max_events: int = 1_000_000,
                 annotate_device: bool = True):
        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        self.annotate_device = bool(annotate_device)
        self.dropped = 0
        self._epoch_ns = time.perf_counter_ns()
        self._events: list[SpanEvent] = []
        self._lock = threading.Lock()
        self._local = threading.local()

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
            self.dropped = 0

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

    def _record(self, event: SpanEvent) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    # -- export --------------------------------------------------------------
    def events(self) -> tuple:
        """Snapshot of the recorded spans (close order)."""
        with self._lock:
            return tuple(self._events)

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object Perfetto loads directly."""
        pid = os.getpid()
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": "gee-repro"}}]
        events += [e.to_chrome(pid) for e in self.events()]
        return {"displayTimeUnit": "ms", "traceEvents": events}

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
    probe = Tracer(enabled=True, annotate_device=False)
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
