"""Named metrics: counters, gauges, bounded histograms, one registry (a
copy of the framework-free ``repro/obs/metrics.py``, so that the port
imports nothing of the reference).

Before this module the repo's telemetry was six divergent ad-hoc
``stats`` dicts (query service, delta server, batched decoder, replica
router, WAL, snapshotter) -- plain ints that nothing aggregated, plus
two *unbounded* lists (``flush_ms``, ``batch_occupancy``) that grew
forever in long-running services.  This module gives every component
the same three primitives behind one process-global registry:

* :class:`Counter` -- monotone event count (``wal.appends``).
* :class:`Gauge`   -- last-written value, for derived rates
  (``fold.edges_per_sec``).
* :class:`Histogram` -- bounded latency/occupancy distribution: exact
  ``count``/``sum``/``min``/``max`` over *all* observations, plus a
  fixed-size reservoir (Vitter's Algorithm R, seeded per histogram so
  runs are reproducible) for p50/p95/p99.  Until the reservoir cap is
  hit the stored values are exact and in insertion order, so the legacy
  list semantics survive for every CI-sized scenario.

API compat is load-bearing: tests and launch scripts read
``service.stats["flushes"]``, append to ``stats["flush_ms"]``, call
``np.asarray`` on it, and sum ``router.stats["routed"].values()``.
:class:`StatsView` keeps all of that working while routing the storage
through the registry -- the legacy dict becomes a *view*, and
``registry.snapshot()`` / ``registry.to_prometheus()`` see every update
made through it.

>>> reg = MetricsRegistry()
>>> stats = reg.stats_view("svc", {"flushes": 0, "flush_ms": []})
>>> stats["flushes"] += 2
>>> stats["flush_ms"].append(4.0)
>>> stats["flushes"], len(stats["flush_ms"])
(2, 1)
>>> reg.snapshot()["counters"]["svc.flushes"]
2
"""

from __future__ import annotations

import json
import random
import threading
from collections.abc import MutableMapping

__all__ = ["Counter", "Gauge", "Histogram", "BoundedSeries",
           "MetricsRegistry", "StatsView", "get_registry", "set_registry"]


class Counter:
    """Monotone event counter (int)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: int) -> None:
        """Direct assignment -- exists for the legacy ``stats[k] = v``
        write path, not for new code."""
        with self._lock:
            self.value = value

    def get(self) -> int:
        return self.value


class Gauge:
    """Last-written value (float) -- derived rates, sizes, ratios."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def get(self) -> float:
        return self.value


class Histogram:
    """Bounded distribution: exact aggregates + a reservoir for quantiles.

    ``count``/``sum``/``min``/``max`` are exact over every observation.
    The value store is capped at ``cap`` entries: below the cap it *is*
    the exact, ordered observation list; past it, reservoir sampling
    (Algorithm R, per-histogram seeded RNG) keeps a uniform sample so
    p50/p95/p99 stay meaningful at any stream length while memory stays
    O(cap) -- the fix for the unbounded ``flush_ms``/``batch_occupancy``
    lists.
    """

    DEFAULT_CAP = 1024

    __slots__ = ("name", "cap", "count", "total", "vmin", "vmax",
                 "_values", "_rng", "_lock")

    def __init__(self, name: str, cap: int = DEFAULT_CAP, seed: int = 0):
        self.name = name
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self._values: list[float] = []
        self._rng = random.Random(seed ^ hash(name) & 0xFFFFFFFF)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            if self.vmin is None or value < self.vmin:
                self.vmin = value
            if self.vmax is None or value > self.vmax:
                self.vmax = value
            if len(self._values) < self.cap:
                self._values.append(value)
            else:
                j = self._rng.randrange(self.count)
                if j < self.cap:
                    self._values[j] = value

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.vmin = self.vmax = None
            self._values.clear()

    def values(self) -> list:
        with self._lock:
            return list(self._values)

    def percentile(self, q: float) -> float:
        """q in [0, 100], nearest-rank over the reservoir (0.0 if empty)."""
        vals = sorted(self.values())
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, round(q / 100.0 * (len(vals) - 1))))
        return vals[idx]

    def summary(self) -> dict:
        with self._lock:
            n, s = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        return {"count": n, "sum": s,
                "min": vmin if vmin is not None else 0.0,
                "max": vmax if vmax is not None else 0.0,
                "mean": (s / n) if n else 0.0,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class BoundedSeries:
    """List-flavored facade over a :class:`Histogram`.

    The legacy code treats ``stats["flush_ms"]`` as a plain list --
    ``append``, ``clear``, ``len``, iteration, truthiness, and
    ``np.asarray`` (which consumes ``__len__`` + ``__getitem__``).  This
    wrapper keeps all of those working while the storage is bounded; it
    adds the quantile accessors so callers can stop materializing
    arrays just to compute a percentile.
    """

    __slots__ = ("_hist",)

    def __init__(self, hist: Histogram):
        self._hist = hist

    @property
    def histogram(self) -> Histogram:
        return self._hist

    def append(self, value: float) -> None:
        self._hist.observe(value)

    def clear(self) -> None:
        self._hist.reset()

    def extend(self, values) -> None:
        for v in values:
            self._hist.observe(v)

    def __len__(self) -> int:
        return len(self._hist._values)

    def __getitem__(self, i):
        return self._hist.values()[i]

    def __iter__(self):
        return iter(self._hist.values())

    def __bool__(self) -> bool:
        return self._hist.count > 0

    def __eq__(self, other):
        if isinstance(other, BoundedSeries):
            other = other._hist.values()
        return self._hist.values() == list(other)

    def __repr__(self) -> str:
        return repr(self._hist.values())

    def p50(self) -> float:
        return self._hist.percentile(50)

    def p95(self) -> float:
        return self._hist.percentile(95)

    def p99(self) -> float:
        return self._hist.percentile(99)

    def summary(self) -> dict:
        return self._hist.summary()


class MetricsRegistry:
    """Thread-safe registry of named metrics with JSON + Prometheus export.

    Names are dot-delimited (``"gee.query.flushes"``); components claim a
    prefix via :meth:`stats_view` or build metrics directly with
    :meth:`counter`/:meth:`gauge`/:meth:`histogram` (get-or-create, so
    instrumentation code never has to coordinate initialization order).
    Multiple instances of one component get distinct scopes
    (``gee.query``, ``gee.query#1``, ...) and :meth:`drop_scope` frees a
    scope when the component closes.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._scopes: set[str] = set()

    # -- get-or-create -------------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name)
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name)
            return m

    def histogram(self, name: str, cap: int = Histogram.DEFAULT_CAP,
                  seed: int = 0) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name, cap, seed)
            return m

    # -- scopes --------------------------------------------------------------
    def claim_scope(self, prefix: str) -> str:
        """Reserve a unique scope name: ``prefix``, else ``prefix#1``, ..."""
        with self._lock:
            name, i = prefix, 0
            while name in self._scopes:
                i += 1
                name = f"{prefix}#{i}"
            self._scopes.add(name)
            return name

    def drop_scope(self, scope: str) -> None:
        """Release a scope and delete its metrics (component shutdown)."""
        with self._lock:
            self._scopes.discard(scope)
            pre = scope + "."
            for table in (self._counters, self._gauges, self._histograms):
                for name in [n for n in table if n.startswith(pre)]:
                    del table[name]

    def stats_view(self, prefix: str, spec: dict) -> "StatsView":
        """Build a legacy-compatible stats dict backed by this registry.

        ``spec`` is the component's historical dict literal: int values
        become counters, lists become histograms (seeded with any
        initial entries), nested dicts become nested views.
        """
        return StatsView(self, self.claim_scope(prefix), spec)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {n: c.get() for n, c in sorted(counters.items())},
            "gauges": {n: g.get() for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary() for n, h in sorted(hists.items())},
        }

    def write_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition (names mangled to ``[a-z0-9_]``)."""
        def mangle(name):
            return "".join(c if c.isalnum() or c == "_" else "_"
                           for c in name)

        snap = self.snapshot()
        lines = []
        for name, value in snap["counters"].items():
            m = mangle(name)
            lines += [f"# TYPE {m} counter", f"{m} {value}"]
        for name, value in snap["gauges"].items():
            m = mangle(name)
            lines += [f"# TYPE {m} gauge", f"{m} {value}"]
        for name, s in snap["histograms"].items():
            m = mangle(name)
            lines.append(f"# TYPE {m} summary")
            for q in ("p50", "p95", "p99"):
                lines.append(
                    f"{m}{{quantile=\"0.{q[1:]}\"}} {s[q]}")
            lines += [f"{m}_sum {s['sum']}", f"{m}_count {s['count']}"]
        return "\n".join(lines) + "\n"


class StatsView(MutableMapping):
    """A legacy ``stats`` dict re-homed onto the metrics registry.

    Reads return plain ints (counters) or a :class:`BoundedSeries`
    (histograms), so every existing consumer -- ``stats["flushes"] ==
    1``, ``stats["x"] += 1``, ``stats["flush_ms"].append(ms)``,
    ``sum(stats["routed"].values())`` -- behaves exactly as before,
    while :meth:`MetricsRegistry.snapshot` sees every write.
    """

    def __init__(self, registry: MetricsRegistry, scope: str, spec: dict):
        self._registry = registry
        self._scope = scope
        self._counters: dict[str, Counter] = {}
        self._series: dict[str, BoundedSeries] = {}
        self._nested: dict[str, StatsView] = {}
        self._order: list[str] = []
        for key, value in spec.items():
            self._install(key, value)

    # -- wiring --------------------------------------------------------------
    def _install(self, key: str, value) -> None:
        name = f"{self._scope}.{key}"
        if isinstance(value, list):
            series = BoundedSeries(self._registry.histogram(name))
            series.extend(value)
            self._series[key] = series
        elif isinstance(value, dict):
            self._nested[key] = StatsView(
                self._registry, self._registry.claim_scope(name), value)
        else:
            counter = self._registry.counter(name)
            if value:
                counter.set(int(value))
            self._counters[key] = counter
        self._order.append(key)

    @property
    def scope(self) -> str:
        return self._scope

    def close(self) -> None:
        """Release the backing scope (component shutdown)."""
        for nested in self._nested.values():
            nested.close()
        self._registry.drop_scope(self._scope)

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, key: str):
        if key in self._counters:
            return self._counters[key].get()
        if key in self._series:
            return self._series[key]
        if key in self._nested:
            return self._nested[key]
        raise KeyError(key)

    def __setitem__(self, key: str, value) -> None:
        if key in self._counters:
            self._counters[key].set(int(value))
        elif key in self._series:
            series = self._series[key]
            if value is not series:          # x[k] = [] style reset
                series.clear()
                series.extend(value)
        elif key in self._nested:
            nested = self._nested[key]
            if value is not nested:
                for k, v in dict(value).items():
                    nested[k] = v
        else:
            self._install(key, value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("StatsView keys are registry metrics; "
                        "use close() to drop the whole scope")

    def __iter__(self):
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def __repr__(self) -> str:
        return repr(self.to_dict())

    def to_dict(self) -> dict:
        """Plain-data copy (series materialized) for printing / JSON."""
        out = {}
        for key in self._order:
            value = self[key]
            if isinstance(value, BoundedSeries):
                out[key] = list(value)
            elif isinstance(value, StatsView):
                out[key] = value.to_dict()
            else:
                out[key] = value
        return out


# ---------------------------------------------------------------------------
# the process-global default registry
# ---------------------------------------------------------------------------

_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (returns the previous one)."""
    global _default
    prev, _default = _default, registry
    return prev
