"""Observability: structured tracing and a metrics registry (port of
``repro/obs``).  Standard library only, apart from the
``torch.profiler.record_function`` overlay of live spans.
"""

from repro_torch.obs.metrics import (
    BoundedSeries,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StatsView,
    get_registry,
    set_registry,
)
from repro_torch.obs.trace import (
    SpanEvent,
    Tracer,
    disable,
    enable,
    get_tracer,
    set_tracer,
    span,
    tracer_overhead_pct,
)

__all__ = [
    "BoundedSeries", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "StatsView", "get_registry", "set_registry",
    "SpanEvent", "Tracer", "disable", "enable", "get_tracer", "set_tracer",
    "span", "tracer_overhead_pct",
]
