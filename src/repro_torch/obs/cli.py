"""Shared ``--trace`` / ``--metrics-out`` wiring for the port's launch
drivers (port of ``repro/obs/cli.py``).

* :func:`add_flags` registers the arguments on an ``ArgumentParser``;
* :func:`setup` enables the global tracer when ``--trace`` was given
  (before any instrumented work runs);
* :func:`finish` writes the Chrome/Perfetto trace JSON and the
  metrics-registry snapshot, printing where they went.

The reference also prints the plan-stage span coverage; the port's plan
emits no stage spans yet, so that figure is not reported here.
"""

from __future__ import annotations

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def add_flags(ap) -> None:
    """Register ``--trace`` and ``--metrics-out`` on ``ap``."""
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome/Perfetto "
                         "trace-event JSON here at exit (load it at "
                         "ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics-registry snapshot (counters, "
                         "gauges, histogram summaries) as JSON here at exit")


def setup(args) -> None:
    """Enable the global tracer when ``--trace`` was requested."""
    if getattr(args, "trace", None):
        obs_trace.enable()


def finish(args) -> None:
    """Write the artifacts ``--trace`` / ``--metrics-out`` asked for."""
    tr = obs_trace.get_tracer()
    if getattr(args, "trace", None) and tr.enabled:
        n_events = len(tr.events())
        tr.write(args.trace)
        line = f"  trace: {n_events} spans -> {args.trace}"
        if tr.dropped:
            line += f"  ({tr.dropped} dropped past max_events)"
        print(line)
    if getattr(args, "metrics_out", None):
        obs_metrics.get_registry().write_json(args.metrics_out)
        print(f"  metrics -> {args.metrics_out}")
