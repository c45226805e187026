"""The benchmark's readers of the port's spans and of its packing histogram
(``perfbench/metrics/``), each against hand-built ``SpanEvent`` records:
what it reads, what it divides by, and that it returns nothing where the
program recorded nothing (as a tree without these spans does)."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.obs import metrics as t_metrics
from repro_torch.obs.trace import SpanEvent

METRICS = Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
NEW = ("fit_api_self_ms", "fit_prep_host_ms", "fit_prep_device_ms",
       "flush_rows_ms", "query_queue_wait_ms", "pack_ms")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "test_reader_" + name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, sid, parent=None, dur=0.0, dev=None, **args):
    return SpanEvent(name=name, ts_us=0.0, dur_us=dur, tid=1,
                     depth=0 if parent is None else 1, args=args,
                     span_id=sid, parent_id=parent, dev_ts_us=None
                     if dev is None else 0.0, dev_dur_us=dev)


def _fit(base, api_fit, labels, transform, build, execute, prep=()):
    """One fit's spans, ids from ``base``; ``prep`` is (host, device) us
    pairs of ``prep.*`` spans inside the execute."""
    spans = [_span("api.labels", base + 1, base, labels),
             _span("api.fit", base, None, api_fit),
             _span("plan.build", base + 3, base + 2, build)]
    for i, (host, dev) in enumerate(prep):
        spans.append(_span("prep.planes", base + 10 + i, base + 5, host, dev,
                           bucket=i))
    spans += [_span("plan.stage.gee_spmm_fused", base + 5, base + 4,
                    execute - 10.0, kind="compute"),
              _span("plan.execute", base + 4, base + 2, execute),
              _span("api.transform", base + 2, None, transform)]
    return spans


@pytest.fixture
def fresh_registry():
    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    try:
        yield reg
    finally:
        t_metrics.set_registry(prev)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_with_nothing_to_read_returns_nothing(name, fresh_registry):
    read = _reader(name)
    assert read({}) is None
    assert read({"spans": (), "profile": None, "host": {}}) is None
    # spans of a tree that has none of the new ones
    old = (SpanEvent("plan.execute", 0.0, 5.0, 1, 0, {}),
           SpanEvent("serve.query_flush", 0.0, 5.0, 1, 0, {"pending": 64}))
    assert read({"spans": old}) is None


def test_fit_api_self_ms_is_the_api_spans_own_time_a_fit():
    spans = _fit(100, api_fit=100.0, labels=30.0, transform=1000.0,
                 build=50.0, execute=900.0) + \
        _fit(200, api_fit=300.0, labels=100.0, transform=2000.0,
             build=100.0, execute=1800.0)
    # (100 - 30 + 1000 - 50 - 900) + (300 - 100 + 2000 - 100 - 1800) us
    assert _reader("fit_api_self_ms")({"spans": spans}) == \
        pytest.approx((120.0 + 300.0) / 2 / 1e3)


def test_fit_prep_readers_sum_the_prep_spans_a_fit():
    spans = _fit(100, 10.0, 1.0, 100.0, 1.0, 90.0,
                 prep=[(20.0, 25.0), (30.0, 40.0)]) + \
        _fit(200, 10.0, 1.0, 100.0, 1.0, 90.0, prep=[(10.0, 15.0)])
    ctx = {"spans": spans}
    assert _reader("fit_prep_host_ms")(ctx) == pytest.approx(60.0 / 2 / 1e3)
    assert _reader("fit_prep_device_ms")(ctx) == \
        pytest.approx(80.0 / 2 / 1e3)
    host_only = _fit(100, 10.0, 1.0, 100.0, 1.0, 90.0,
                     prep=[(20.0, None)])
    assert _reader("fit_prep_host_ms")({"spans": host_only}) == \
        pytest.approx(0.02)
    assert _reader("fit_prep_device_ms")({"spans": host_only}) is None


def test_flush_readers_average_over_flushes():
    spans = []
    for i, (rows, wait) in enumerate([(3000.0, 900.0), (4000.0, 1100.0),
                                      (5000.0, None)]):
        base = 10 * i
        spans.append(_span("serve.flush.rows", base + 1, base, rows,
                           tickets=64))
        tags = {"pending": 64}
        if wait is not None:
            tags["oldest_wait_us"] = wait
        spans.append(_span("serve.query_flush", base, None, rows + 1000.0,
                           **tags))
    ctx = {"spans": spans}
    assert _reader("flush_rows_ms")(ctx) == pytest.approx(4.0)
    # a flush opened with the tracer off at submit carries no wait
    assert _reader("query_queue_wait_ms")(ctx) == pytest.approx(1.0)


def test_pack_ms_sums_the_packings_of_the_run(fresh_registry):
    read = _reader("pack_ms")
    assert read({}) is None
    hist = fresh_registry.histogram("pack.bucketed_ell_ms")
    hist.observe(8123.5)
    hist.observe(12.5)
    assert read({}) == pytest.approx(8136.0)
