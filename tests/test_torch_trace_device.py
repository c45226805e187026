"""The port's span tracer (``repro_torch.obs.trace``): span ids, parents and
self times; device intervals resolved through two clock anchors, here from
an injected device clock, since the CPU has none; the disabled path; and
the spans of a fit (``core/api.py``, ``kernels/gee_fused.py``,
``kernels/ops.py``), of a query flush (``search/``) and of a packing
(``graph/ell.py``, with its always-on ``pack.bucketed_ell_ms`` histogram).

Tolerances: the injected host clock advances ``STEP_NS`` at every read,
so an anchor's event lies half a step after the anchor's midpoint, and a
mapped device time may be off by that much (``HALF_STEP_US``).
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.api import GEEEmbedder
from repro_torch.core.gee import GEEOptions
from repro_torch.core.plan import PreparedGraph
from repro_torch.graph.containers import edge_list_from_numpy, symmetrize
from repro_torch.graph.ell import edges_to_bucketed_ell
from repro_torch.kernels.gee_fused import gee_fused_from_bucketed
from repro_torch.kernels.ops import gee_cuda_from_bucketed
from repro_torch.obs import cli as obs_cli
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace
from repro_torch.search import ClassPartitionedIndex, GEEQueryService

STEP_NS = 1000
HALF_STEP_US = STEP_NS / 2e3
N, K = 60, 3


class StepClock:
    """A host clock in ns: each read returns ``now``, then advances it by
    ``STEP_NS``; a test moves ``now`` by hand to stand for host work."""

    def __init__(self, start: int = 10 ** 12):
        self.now = start
        self.reads = 0

    def __call__(self) -> int:
        self.reads += 1
        t = self.now
        self.now += STEP_NS
        return t


class FakeEvent:
    def __init__(self, us: float):
        self.us = us


class FakeDevice:
    """Device events stamped when recorded: the device clock runs at
    ``rate`` times the host's from ``offset_us``, and ``lag_us`` (host
    time) puts a record behind work already queued.  ``truth`` keeps
    each record's host time, in us."""

    def __init__(self, clock: StepClock, rate: float = 1.0,
                 offset_us: float = 7.5e6):
        self.clock, self.rate, self.offset_us = clock, rate, offset_us
        self.lag_us = 0.0
        self.truth: list = []
        self.syncs = 0
        self.released: list = []

    def record(self):
        host_us = self.clock.now / 1e3 + self.lag_us
        self.truth.append(host_us)
        return FakeEvent(host_us * self.rate + self.offset_us)

    def elapsed_us(self, a, b) -> float:
        return b.us - a.us

    def synchronize(self) -> None:
        self.syncs += 1

    def release(self, events) -> None:
        self.released.extend(events)


def _tracer(rate: float = 1.0, **kw):
    clock = StepClock()
    dev = FakeDevice(clock, rate=rate)
    tr = t_trace.Tracer(enabled=True, annotate_device=False,
                        device_events=dev, clock=clock, **kw)
    return tr, clock, dev


def _by_name(events) -> dict:
    return {e.name: e for e in events}


# ---------------------------------------------------------------------------
# ids, parents, self time
# ---------------------------------------------------------------------------

def test_span_ids_parents_and_self_time():
    clock = StepClock()
    tr = t_trace.Tracer(enabled=True, annotate_device=False,
                        device_events=False, clock=clock)
    with tr.span("a"):
        with tr.span("b"):
            clock.now += 5000
        with tr.span("c"):
            with tr.span("d"):
                clock.now += 7000
        clock.now += 3000
    with pytest.raises(RuntimeError):
        with tr.span("e"):
            with tr.span("f"):
                raise RuntimeError("boom")
    ev = _by_name(tr.events())
    assert len({e.span_id for e in ev.values()}) == 6
    assert ev["a"].parent_id is None and ev["e"].parent_id is None
    assert ev["b"].parent_id == ev["c"].parent_id == ev["a"].span_id
    assert ev["d"].parent_id == ev["c"].span_id
    assert ev["f"].parent_id == ev["e"].span_id
    assert ev["f"].args["error"] == "RuntimeError"
    own = t_trace.self_times(tr.events())
    assert own[ev["a"].span_id] == pytest.approx(
        ev["a"].dur_us - ev["b"].dur_us - ev["c"].dur_us)
    assert own[ev["c"].span_id] == pytest.approx(
        ev["c"].dur_us - ev["d"].dur_us)
    assert own[ev["b"].span_id] == ev["b"].dur_us
    assert own[ev["a"].span_id] >= 3.0        # the 3 us outside b and c
    chrome = tr.chrome_trace()
    args = {e["name"]: e["args"] for e in chrome["traceEvents"]
            if e["ph"] == "X"}
    assert args["d"]["parent_id"] == ev["c"].span_id
    assert all(e.dev_ts_us is None for e in ev.values())


def test_coverage_reads_the_direct_children_of_the_last_execute():
    clock = StepClock()
    tr = t_trace.Tracer(enabled=True, annotate_device=False,
                        device_events=False, clock=clock)
    with tr.span("plan.execute"):
        with tr.span("plan.stage.prep"):
            clock.now += 10_000
        clock.now += 20_000                 # between the stages
        with tr.span("plan.stage.compute"):
            with tr.span("prep.planes"):    # a grandchild counts once
                clock.now += 30_000
    ev = _by_name(tr.events())
    want = (ev["plan.stage.prep"].dur_us + ev["plan.stage.compute"].dur_us) \
        / ev["plan.execute"].dur_us
    assert obs_cli.plan_span_coverage(tr) == pytest.approx(want)
    assert 0.6 < want < 0.8
    assert obs_cli.device_clock_line(tr) is None


# ---------------------------------------------------------------------------
# device intervals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [1.0, 1 + 50e-6, 1 - 200e-6])
def test_device_intervals_map_through_two_anchors(rate):
    """Each span's events land on the tracer's epoch within half a clock
    step, across 10 s of host time in which the device clock drifts by up
    to 2 ms; the anchors' widths and the drift are in the metadata."""
    tr, clock, dev = _tracer(rate)
    epoch_us = (clock.now - STEP_NS) / 1e3     # the constructor's read
    with tr.span("outer"):
        clock.now += 2_000_000
        dev.lag_us = 300.0                     # the card runs behind
        with tr.span("inner"):
            clock.now += 10_000_000_000
        dev.lag_us = 0.0
    syncs = 1 + t_trace.ANCHOR_TRIES           # one anchor's
    assert dev.syncs == syncs                  # the first anchor only
    ev = _by_name(tr.events())
    assert dev.syncs == 2 * syncs              # and the second
    # records: the first anchor's tries (equal brackets: the first kept),
    # outer enter, inner enter, inner exit, outer exit, the second's
    truth = [t - epoch_us for t in dev.truth]
    tries = t_trace.ANCHOR_TRIES
    assert len(truth) == 4 + 2 * tries
    for name, (lo, hi) in (("outer", (tries, tries + 3)),
                           ("inner", (tries + 1, tries + 2))):
        e = ev[name]
        assert abs(e.dev_ts_us - truth[lo]) <= HALF_STEP_US + 1e-3
        assert abs(e.dev_ts_us + e.dev_dur_us - truth[hi]) \
            <= HALF_STEP_US + 1e-3
    inner = ev["inner"]
    assert inner.dev_ts_us >= inner.ts_us + 300.0 - HALF_STEP_US
    meta = tr.metadata()
    assert meta["clock"] == "CLOCK_MONOTONIC"
    assert meta["epoch_monotonic_ns"] > 0 and meta["epoch_wall_ns"] > 0
    dev_meta = meta["device"]
    assert dev_meta["anchor_width_us"] == [STEP_NS / 1e3] * 2
    assert dev_meta["drift_ppm"] == pytest.approx((1 / rate - 1) * 1e6,
                                                  abs=0.05)
    for e in ev.values():                      # the criterion on the card
        assert e.dev_ts_us >= e.ts_us - max(dev_meta["anchor_width_us"])
    assert "drift" in obs_cli.device_clock_line(tr)


def test_events_resolve_once_and_go_back_to_the_pool():
    tr, clock, dev = _tracer()
    for _ in range(3):
        with tr.span("x"):
            clock.now += 1000
    syncs, spare = 1 + t_trace.ANCHOR_TRIES, t_trace.ANCHOR_TRIES - 1
    first = tr.events()
    assert len(dev.released) == 6 + 2 * spare and dev.syncs == 2 * syncs
    assert tr.events() == first and dev.syncs == 2 * syncs  # none pending
    with tr.span("y"):
        pass
    assert tr.events()[-1].dev_dur_us is not None
    assert dev.syncs == 3 * syncs and len(dev.released) == 8 + 3 * spare
    tr.clear()
    assert tr.events() == ()


def test_spans_on_many_threads_keep_their_ids_parents_and_events():
    """More threads than cores open nested spans at a short switch
    interval: every span keeps a distinct id, its own thread's parent,
    and both of its device events, each given back once resolved."""
    tr, _, dev = _tracer()
    threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with tr.span("outer"):
                    with tr.span("inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    spans = tr.events()
    assert len(spans) == 2 * threads * per
    assert len({s.span_id for s in spans}) == len(spans)
    outer = {s.span_id: s.tid for s in spans if s.name == "outer"}
    assert all(outer[s.parent_id] == s.tid for s in spans
               if s.name == "inner")
    assert all(s.dev_dur_us is not None for s in spans)
    assert len(dev.released) == 2 * len(spans) + 2 * (
        t_trace.ANCHOR_TRIES - 1)


def test_the_chrome_export_has_a_device_track_a_thread():
    tr, clock, _ = _tracer()
    with tr.span("fit"):
        with tr.span("prep.planes", bucket=0):
            clock.now += 4000
    doc = json.loads(json.dumps(tr.chrome_trace()))
    assert sorted(doc) == ["displayTimeUnit", "metadata", "traceEvents"]
    host = [e for e in doc["traceEvents"] if e.get("cat") == "gee"]
    devs = [e for e in doc["traceEvents"] if e.get("cat") == "gee.device"]
    assert sorted(e["name"] for e in devs) == ["fit", "prep.planes"]
    assert {e["tid"] for e in devs} == {host[0]["tid"] | 0x80000000}
    names = [e for e in doc["traceEvents"] if e["name"] == "thread_name"]
    assert [e["tid"] for e in names] == [devs[0]["tid"]]
    assert doc["metadata"]["device"]["anchor_width_us"]


def test_no_device_intervals_without_cuda(monkeypatch):
    """Before the process initialises CUDA (always, on a CPU-only host) a
    span records no device event and creates no CUDA context."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    tr = t_trace.Tracer(enabled=True, annotate_device=False)
    with tr.span("a"):
        with tr.span("b"):
            pass
    assert all(e.dev_ts_us is None and e.dev_dur_us is None
               for e in tr.events())
    assert tr.metadata()["device"] is None
    assert not any(e.get("cat") == "gee.device"
                   for e in tr.chrome_trace()["traceEvents"])


def test_a_disabled_tracer_records_no_event_and_reads_no_clock():
    clock = StepClock()
    dev = FakeDevice(clock)
    tr = t_trace.Tracer(enabled=False, device_events=dev, clock=clock)
    reads = clock.reads
    prev = t_trace.set_tracer(tr)
    try:
        assert tr.span("a", x=1) is t_trace._NULL
        with tr.span("a", x=1) as sp:
            sp.tag(y=2)
            with t_trace.span("b"):
                pass
    finally:
        t_trace.set_tracer(prev)
    assert clock.reads == reads and dev.truth == [] and dev.syncs == 0
    assert tr.events() == () and dev.syncs == 0


# ---------------------------------------------------------------------------
# the spans of a fit, a flush and a packing
# ---------------------------------------------------------------------------

def _graph():
    """A fixed graph with degree-0 rows and four degree buckets."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, N - 8, 420).astype(np.int32)
    dst = rng.integers(0, N - 8, 420).astype(np.int32)
    hub = np.full(24, 3, np.int32)
    src = np.concatenate([src, hub])
    dst = np.concatenate([dst, np.arange(10, 34, dtype=np.int32)])
    edges = symmetrize(edge_list_from_numpy(src, dst, None, N, device="cpu"))
    labels = rng.integers(0, K, N).astype(np.int32)
    labels[::5] = -1
    return edges, torch.from_numpy(labels)


def _traced(fn):
    tr = t_trace.Tracer(enabled=True, annotate_device=False)
    prev = t_trace.set_tracer(tr)
    try:
        with t_trace.span("outer"):
            out = fn()
    finally:
        t_trace.set_tracer(prev)
    events = sorted(tr.events(), key=lambda e: e.span_id)
    return out, events[0], events[1:]


SETTINGS = [GEEOptions(lap, diag, cor) for lap in (False, True)
            for diag in (False, True) for cor in (False, True)]


@pytest.mark.parametrize("opts", SETTINGS, ids=lambda o: o.tag())
def test_fused_driver_spans(opts):
    edges, labels = _graph()
    bell = edges_to_bucketed_ell(edges)
    assert len(bell.buckets) == 4
    want_z = gee_fused_from_bucketed(bell, labels, K, opts)
    z, outer, spans = _traced(
        lambda: gee_fused_from_bucketed(bell, labels, K, opts))
    torch.testing.assert_close(z, want_z, rtol=0, atol=0)
    want = ["prep.class_weights", "prep.degrees"]
    if opts.diag_aug or opts.correlation:
        want.append("prep.residual_fixup")
    want += ["kernel.gee_fused"] * len(bell.buckets)
    assert [s.name for s in spans] == want
    assert all(s.parent_id == outer.span_id for s in spans)
    per_bucket = [s.args["bucket"] for s in spans if "bucket" in s.args]
    assert per_bucket == sorted(per_bucket) and set(per_bucket) == {0, 1, 2, 3}


@pytest.mark.parametrize("opts", [o for o in SETTINGS if not o.diag_aug],
                         ids=lambda o: o.tag())
def test_staged_driver_spans(opts):
    edges, labels = _graph()
    bell = edges_to_bucketed_ell(edges)
    want_z = gee_cuda_from_bucketed(bell, labels, K, opts)
    z, outer, spans = _traced(
        lambda: gee_cuda_from_bucketed(bell, labels, K, opts))
    torch.testing.assert_close(z, want_z, rtol=0, atol=0)
    want = ["prep.class_weights"] + (["prep.degrees"] if opts.laplacian
                                     else [])
    want += ["kernel.gee_spmm"] * len(bell.buckets)
    assert [s.name for s in spans] == want
    per_bucket = [s.args["bucket"] for s in spans if "bucket" in s.args]
    assert per_bucket == [0, 1, 2, 3]
    assert all(s.parent_id == outer.span_id for s in spans)


def test_a_warm_fit_opens_a_fixed_number_of_spans(monkeypatch):
    """Default options on the fused path, four buckets: 20 spans would
    be a fit of cl-100k's ten; no span is opened per edge or per row."""
    monkeypatch.setenv("REPRO_GEE_FUSED", "1")
    edges, labels = _graph()
    prepared = PreparedGraph(edges)
    emb = GEEEmbedder(num_classes=K, backend="cuda", device="cpu")
    emb.fit_transform(prepared, labels.numpy())          # packs
    tr = t_trace.Tracer(enabled=True, annotate_device=False)
    prev = t_trace.set_tracer(tr)
    try:
        emb.fit_transform(prepared, labels.numpy())
    finally:
        t_trace.set_tracer(prev)
    spans = tr.events()
    assert len(spans) == 5 + 2 + 2 + 1 + 4 == 14
    byid = {s.span_id: s for s in spans}

    def parent(name):
        (s,) = [s for s in spans if s.name == name]
        return byid[s.parent_id].name if s.parent_id else None

    assert parent("api.fit") is None and parent("api.transform") is None
    assert parent("api.labels") == "api.fit"
    assert parent("plan.build") == parent("plan.execute") == "api.transform"
    assert parent("prep.degrees") == "plan.stage.gee_spmm_fused"
    assert not any(s.name == "pack.bucketed_ell" for s in spans)


def test_a_flush_spans_its_rows_search_and_answers():
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.standard_normal((200, K)).astype(np.float32))
    labels = rng.integers(0, K, 200).astype(np.int32)
    index = ClassPartitionedIndex.build(z, labels, K)
    svc = GEEQueryService(index, flush_every=1 << 20)
    untraced = svc.submit_rows([7])
    svc.flush()
    assert untraced.submitted_ns is None

    tr, clock, _ = _tracer()
    prev = t_trace.set_tracer(tr)
    try:
        first = svc.submit_rows([1, 2])
        clock.now += 4_000_000                      # 4 ms in the queue
        svc.submit(np.ones(K, np.float32))
        svc.flush()
        svc.close()
    finally:
        t_trace.set_tracer(prev)
    assert first.done and first.submitted_ns is not None
    spans = sorted(tr.events(), key=lambda e: e.span_id)
    assert [s.name for s in spans] == [
        "serve.query_flush", "serve.query_repair", "serve.flush.rows",
        "index.search", "index.upload", "index.probe", "index.candidates",
        "index.topk", "serve.flush.answers"]
    byid = {s.span_id: s.name for s in spans}
    parents = [byid.get(s.parent_id) for s in spans]
    assert parents == [None] + ["serve.query_flush"] * 3 + \
        ["index.search"] * 4 + ["serve.query_flush"]
    wait = spans[0].args["oldest_wait_us"]
    assert isinstance(wait, int)                    # a host int, no device
    assert 4000 <= wait <= 4000.0 + 10 * STEP_NS / 1e3
    assert spans[2].args["tickets"] == 2
    assert all(s.dev_dur_us is not None for s in spans)


def test_one_pack_observation_a_packing():
    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    try:
        edges, _ = _graph()
        edges_to_bucketed_ell(edges)
        prepared = PreparedGraph(edges)
        for _ in range(3):                          # memoized: one packing
            prepared.bucketed_ell(False)
        tr = t_trace.Tracer(enabled=True, annotate_device=False)
        prev_tr = t_trace.set_tracer(tr)
        try:
            edges_to_bucketed_ell(edges)
        finally:
            t_trace.set_tracer(prev_tr)
    finally:
        t_metrics.set_registry(prev)
    hist = reg.snapshot()["histograms"]["pack.bucketed_ell_ms"]
    assert hist["count"] == 3 and hist["sum"] > 0
    (span,) = tr.events()
    assert span.name == "pack.bucketed_ell" and span.args["nodes"] == N
    assert span.dur_us * 1e-3 <= hist["max"]
