"""Shared ``--trace`` / ``--metrics-out`` wiring for the port's launch
drivers (port of ``repro/obs/cli.py``).

* :func:`add_flags` registers the arguments on an ``ArgumentParser``;
* :func:`setup` enables the global tracer when ``--trace`` was given
  (before any instrumented work runs);
* :func:`finish` writes the Chrome/Perfetto trace JSON and the
  metrics-registry snapshot, printing where they went, the plan-stage
  span coverage (:func:`plan_span_coverage`) and the device clock's
  anchors and drift (:func:`device_clock_line`).
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


def plan_span_coverage(tracer: obs_trace.Tracer | None = None):
    """Fraction of the last ``plan.execute`` span covered by its direct
    children (the ``plan.stage.*`` spans), or ``None`` when no plan ran
    under the tracer.  Near 1.0 the stage spans account for the fit's
    time instead of hiding it between spans."""
    tr = tracer if tracer is not None else obs_trace.get_tracer()
    events = tr.events()
    roots = [e for e in events if e.name == "plan.execute"]
    if not roots:
        return None
    root = roots[-1]
    if root.dur_us <= 0:
        return None
    own = obs_trace.self_times(
        [root] + [e for e in events if e.parent_id == root.span_id])
    return 1.0 - own[root.span_id] / root.dur_us


def device_clock_line(tracer: obs_trace.Tracer | None = None):
    """The device clock's anchors (bracket widths) and drift, one line,
    or ``None`` when no span recorded device events."""
    tr = tracer if tracer is not None else obs_trace.get_tracer()
    dev = tr.metadata()["device"]
    if dev is None:
        return None
    widths = ", ".join(f"{w:.1f}" for w in dev["anchor_width_us"])
    return (f"  device clock: anchors bracket {widths} us; drift "
            f"{dev['drift_us']:.1f} us over {dev['span_us'] / 1e6:.3f} s "
            f"({dev['drift_ppm']:.1f} ppm)")


def finish(args) -> None:
    """Write the artifacts ``--trace`` / ``--metrics-out`` asked for."""
    tr = obs_trace.get_tracer()
    if getattr(args, "trace", None) and tr.enabled:
        cov = plan_span_coverage(tr)
        n_events = len(tr.events())
        tr.write(args.trace)
        line = f"  trace: {n_events} spans -> {args.trace}"
        if tr.dropped:
            line += f"  ({tr.dropped} dropped past max_events)"
        if cov is not None:
            line += f"  [plan stages cover {cov * 100:.1f}% of fit time]"
        print(line)
        clock = device_clock_line(tr)
        if clock is not None:
            print(clock)
    if getattr(args, "metrics_out", None):
        obs_metrics.get_registry().write_json(args.metrics_out)
        print(f"  metrics -> {args.metrics_out}")
