"""The port's out-of-core streaming -- ``repro_torch.graph.io``,
``graph.prefetch``, ``core.fold``, ``core.chunked``, the ``chunked`` plan
backend and ``GEEEmbedder.fit_transform_file`` -- held against the JAX
reference on the CPU, with inputs made from a numpy seed.

Files cross between the packages both ways, byte for byte and window for
window.  Streamed embeddings are held to the row-scaled tolerance
1e-5·|want| + 1e-5·min(1, max |want row|): windows reorder the f32 sums,
and a flat 1e-5 would fail hub rows from summation order alone.
"""

import importlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.chunked import gee_chunked as j_gee_chunked
from repro.core.fold import stream_fold as j_stream_fold
from repro.graph import io as jio
from repro.graph.containers import edge_list_from_numpy as j_edge_list
from repro.obs import metrics as j_metrics

from repro_torch.core.api import GEEEmbedder
from repro_torch.core.chunked import gee_chunked, gee_chunked_from_file
from repro_torch.core.fold import both_directions, scatter_partial, stream_fold
from repro_torch.core.gee import (ALL_OPTION_SETTINGS, GEEOptions, gee,
                                  gee_sparse_torch)
from repro_torch.core.plan import (ENV_MEMORY_BUDGET, GEEPlan, PreparedGraph,
                                   memory_budget_bytes, select_backend)
from repro_torch.graph import io as tio
from repro_torch.graph.containers import edge_list_from_numpy, symmetrize
from repro_torch.graph.prefetch import (DEFAULT_PREFETCH_DEPTH,
                                        ENV_PREFETCH_WINDOWS,
                                        PrefetchingWindowSource,
                                        ThrottledWindowSource,
                                        prefetch_windows,
                                        resolve_prefetch_depth)
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace

jgee = importlib.import_module("repro.core.gee")

RTOL = ATOL = 1e-5
OPT_IDS = [o.tag() for o in ALL_OPTION_SETTINGS]
DEFAULT = GEEOptions(laplacian=True, diag_aug=True, correlation=True)
N, E, K = 40, 157, 3            # 157 entries: 7 does not divide it
WINDOWS = (1, 7, 50)            # 50 does not divide 157 either


def _jopts(o):
    return jgee.GEEOptions(laplacian=o.laplacian, diag_aug=o.diag_aug,
                           correlation=o.correlation)


def _arrays(seed=0, n=N, e=E, loops=True):
    """Weighted entries with duplicates, a hub, self loops (when
    ``loops``) and a zero weight; labels with -1s."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[: e // 5] = 0                           # node 0 is a hub
    if not loops:
        dst[src == dst] = (src[src == dst] + 1) % n
    w = (rng.random(e) + 0.25).astype(np.float32)
    w[3] = 0.0
    labels = rng.integers(0, K, n).astype(np.int32)
    labels[rng.random(n) < 0.2] = -1
    return src, dst, w, labels


def assert_rows(got, want):
    """Each entry within RTOL·|want| + ATOL·min(1, max |want row|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.minimum(np.abs(want).max(axis=1, keepdims=True), 1.0)
    bad = ~(np.abs(got - want) <= RTOL * np.abs(want) + ATOL * scale)
    assert not bad.any(), (int(bad.sum()), np.argwhere(bad)[:5])


def _write(tmp_path, writer, undirected, name="g.geeb", seed=0):
    src, dst, w, labels = _arrays(seed)
    path = str(tmp_path / name)
    mod = jio if writer == "ref" else tio
    mod.write_binary(path, src, dst, w, N, undirected=undirected)
    mod.save_labels(path, labels)
    return path, labels


def _windows(ch):
    return [(w.num_edges, np.asarray(w.src), np.asarray(w.dst),
             np.asarray(w.weight)) for w in ch.windows()]


def _same_windows(a, b):
    assert len(a) == len(b)
    for (ea, *xa), (eb, *xb) in zip(a, b):
        assert ea == eb
        for u, v in zip(xa, xb):
            np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------------------
# files cross between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("undirected", [True, False])
def test_geeb_reads_the_same_in_both_packages(tmp_path, writer, undirected):
    path, _ = _write(tmp_path, writer, undirected)
    other, _ = _write(tmp_path, "port" if writer == "ref" else "ref",
                      undirected, name="h.geeb")
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    assert tio.read_binary_header(path) == jio.read_binary_header(path) \
        == (N, E, undirected)
    for c in WINDOWS:
        t = tio.open_edge_list(path, chunk_edges=c)
        j = jio.open_edge_list(path, chunk_edges=c)
        assert (t.num_windows, t.window_edges, t.undirected) == \
            (j.num_windows, j.window_edges, j.undirected)
        assert t.device is None            # host until staged
        _same_windows(_windows(t), _windows(j))
    np.testing.assert_array_equal(tio.load_labels(path),
                                  jio.load_labels(path))


def test_text_and_npz_read_the_same_in_both_packages(tmp_path):
    src, dst, w, _ = _arrays(1)
    base = jio.ChunkedEdgeList(src=src, dst=dst, weight=w, num_nodes=N + 3,
                               chunk_edges=11, undirected=True)
    tbase = tio.ChunkedEdgeList(src=src, dst=dst, weight=w, num_nodes=N + 3,
                                chunk_edges=11, undirected=True)
    for suffix in (".txt", ".npz", ".geeb"):
        jp = str(tmp_path / f"j{suffix}")
        tp = str(tmp_path / f"t{suffix}")
        jio.save_edge_list(jp, base)
        tio.save_edge_list(tp, tbase)
        if suffix != ".npz":                  # zip members carry times
            with open(jp, "rb") as f, open(tp, "rb") as g:
                assert f.read() == g.read(), suffix
        for cache in (True, False):
            t = tio.open_edge_list(tp, chunk_edges=9, cache_binary=cache)
            j = jio.open_edge_list(jp, chunk_edges=9, cache_binary=cache)
            assert (t.num_nodes, t.num_edges, t.undirected) == \
                (j.num_nodes, j.num_edges, j.undirected) == (N + 3, E, True)
            _same_windows(_windows(t), _windows(j))
    # a foreign SNAP file: comments, 1-indexed, commas, a weight column
    p = tmp_path / "snap.edges"
    p.write_text("% header\n# c\n\n1 2\n2,3,0.5\n4 1 2\n")
    t = tio.open_edge_list(str(p), index_base=1, cache_binary=False)
    j = jio.open_edge_list(str(p), index_base=1, cache_binary=False)
    _same_windows(_windows(t), _windows(j))
    assert tio.scan_text(str(p), 1) == jio.scan_text(str(p), 1) == (3, 3)
    # convert() between every pair of formats keeps the entries
    tio.convert(str(tmp_path / "t.txt"), str(tmp_path / "c.npz"))
    tio.convert(str(tmp_path / "c.npz"), str(tmp_path / "c.geeb"))
    _same_windows(_windows(tio.open_edge_list(str(tmp_path / "c.geeb"))),
                  _windows(jio.open_edge_list(str(tmp_path / "j.geeb"))))


def test_io_refusals(tmp_path):
    with pytest.raises(ValueError, match="unsupported edge-file suffix"):
        tio.open_edge_list(str(tmp_path / "g.csv"))
    with pytest.raises(ValueError, match="sized for"):
        with tio.BinaryEdgeWriter(str(tmp_path / "a.geeb"), 3, 1) as wr:
            wr.append([0, 1], [1, 2])
    with pytest.raises(ValueError, match="wrote 0 of 2"):
        tio.BinaryEdgeWriter(str(tmp_path / "b.geeb"), 3, 2).close()
    (tmp_path / "bad.geeb").write_bytes(b"NOPE" + bytes(28))
    with pytest.raises(ValueError, match="not a .geeb file"):
        tio.open_edge_list(str(tmp_path / "bad.geeb"))
    path, _ = _write(tmp_path, "port", True)
    assert tio.open_window_parallel(path, 1, chunk_edges=7).window_edges == 7
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tio.open_window_parallel(path, 2)
    with pytest.raises(TypeError, match="cannot stream"):
        tio.as_window_source(object())


def test_empty_and_all_padding_windows(tmp_path):
    path = str(tmp_path / "e.geeb")
    tio.write_binary(path, [], [], [], 5)
    jpath = str(tmp_path / "je.geeb")
    jio.write_binary(jpath, [], [], [], 5)
    _same_windows(_windows(tio.open_edge_list(path)),
                  _windows(jio.open_edge_list(jpath)))
    w = np.array([1, 0, 0, 0, 0, 2], np.float32)    # window 2 all padding
    ch = tio.ChunkedEdgeList(np.arange(6, dtype=np.int32),
                             np.arange(6, dtype=np.int32)[::-1].copy(), w,
                             6, chunk_edges=2)
    jch = jio.ChunkedEdgeList(np.arange(6, dtype=np.int32),
                              np.arange(6, dtype=np.int32)[::-1].copy(), w,
                              6, chunk_edges=2)
    _same_windows(_windows(ch), _windows(jch))
    assert len(_windows(ch)) == 2
    _same_windows(list(_windows(PrefetchingWindowSource(ch, 2,
                                                        device="cpu"))),
                  _windows(ch))


def test_in_memory_manifest_windows_device_slices():
    """``PreparedGraph.chunked`` windows the list's own tensors: full
    windows are views of its storage, nothing goes through numpy."""
    src, dst, w, _ = _arrays(2)
    w[w == 0] = 1.0              # no entry to drop: the windows are views
    edges = edge_list_from_numpy(src, dst, w, N, device="cpu")
    ch = PreparedGraph(edges).chunked(16)
    assert ch.device == edges.device and isinstance(ch.src, torch.Tensor)
    ws = list(ch.windows())
    base = edges.src.untyped_storage().data_ptr()
    assert ws[1].src.untyped_storage().data_ptr() == base   # a view
    jch = jio.ChunkedEdgeList.from_edge_list(
        j_edge_list(src, dst, w, N), 16)
    _same_windows([(x.num_edges, x.src.numpy(), x.dst.numpy(),
                    x.weight.numpy()) for x in ws], _windows(jch))
    # a source already on the device is not wrapped for prefetch
    assert prefetch_windows(ch, 2, device="cpu") is ch
    back = ch.to_edge_list()
    np.testing.assert_array_equal(back.src.numpy(),
                                  np.asarray(jch.to_edge_list().src))


# ---------------------------------------------------------------------------
# the streamed embedding against the reference's gee_chunked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("undirected", [True, False])
@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_streamed_matches_reference_gee_chunked(tmp_path, opts, undirected):
    path, labels = _write(tmp_path, "ref", undirected)
    for c in WINDOWS:
        want = np.asarray(j_gee_chunked(
            jio.open_edge_list(path, chunk_edges=c), labels, K,
            _jopts(opts)))
        for depth in (0, 2):
            got = gee_chunked(tio.open_edge_list(path, chunk_edges=c),
                              labels, K, opts, prefetch_windows=depth,
                              device="cpu")
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            assert_rows(got.numpy(), want)
        emb = GEEEmbedder(num_classes=K, options=opts, device="cpu",
                          chunk_edges=c, prefetch_windows=2)
        assert_rows(emb.fit_transform_file(path).numpy(), want)
    got = gee_chunked_from_file(path, opts=opts, chunk_edges=7,
                                device="cpu")
    assert got.shape == (N, K)
    assert_rows(got.numpy(), want)
    # a slow source behind the pipeline keeps the order and the answer
    slow = ThrottledWindowSource(tio.open_edge_list(path, chunk_edges=7),
                                 delay_s=0.0005, jitter_s=0.001, seed=1)
    assert_rows(gee_chunked(slow, labels, K, opts, prefetch_windows=2,
                            device="cpu").numpy(), want)


@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_chunked_plan_matches_in_memory_backends(opts):
    src, dst, w, labels = _arrays(3)
    edges = symmetrize(edge_list_from_numpy(src, dst, w, N, device="cpu"))
    prep = PreparedGraph(edges)
    want = gee_sparse_torch(edges, labels, K, opts).numpy()
    for c in WINDOWS:
        plan = GEEPlan.build(prep, K, opts, backend="chunked",
                             chunk_edges=c, prefetch_windows=2)
        assert plan.prefetch_windows == 2
        assert_rows(plan.execute(labels).numpy(), want)
        assert prep.is_cached(("chunked", c))
    assert_rows(gee(prep, labels, K, opts, backend="chunked").numpy(), want)
    assert_rows(gee(prep, labels, K, opts, backend="cuda").numpy(), want)
    assert_rows(gee(prep, labels, K, opts, backend="dense_torch").numpy(),
                want)
    emb = GEEEmbedder(num_classes=K, options=opts, backend="chunked",
                      device="cpu", chunk_edges=7)
    assert_rows(emb.fit_transform(prep, labels).numpy(), want)


def test_select_backend_routes_past_the_budget(monkeypatch):
    src, dst, w, labels = _arrays(4)
    prep = PreparedGraph(symmetrize(edge_list_from_numpy(src, dst, w, N,
                                                         device="cpu")))
    monkeypatch.delenv(ENV_MEMORY_BUDGET, raising=False)
    assert memory_budget_bytes() == 16 << 30
    assert select_backend(prep, K) == "sparse_torch"
    assert select_backend(prep, K, budget_bytes=64) == "chunked"
    assert select_backend(prep, K, device="cuda", budget_bytes=64) \
        == "chunked"
    plan = GEEPlan.build(prep, K, DEFAULT, budget_bytes=64)
    assert plan.backend == "chunked" and plan.prefetch_windows == \
        DEFAULT_PREFETCH_DEPTH
    assert [s.name for s in plan.stages] == ["chunk_manifest",
                                             "two_pass_stream"]
    assert_rows(plan.execute(labels).numpy(),
                gee_sparse_torch(prep.base, labels, K, DEFAULT).numpy())
    monkeypatch.setenv(ENV_MEMORY_BUDGET, "64")
    assert GEEPlan.build(prep, K, DEFAULT).backend == "chunked"
    assert GEEPlan.build(prep, K, DEFAULT, backend="sparse_torch") \
        .prefetch_windows is None


def test_fold_primitives_match_reference():
    src, dst, w, labels = _arrays(5)
    jf = importlib.import_module("repro.core.fold")
    t = [torch.from_numpy(a) for a in (src, dst, w)]
    for got, want in zip(both_directions(*t), jf.both_directions(src, dst,
                                                                 w)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(5)
    winv = rng.random(K).astype(np.float32)
    dinv = rng.random(N).astype(np.float32)
    got = scatter_partial(*t, torch.from_numpy(labels),
                          torch.from_numpy(winv), torch.from_numpy(dinv),
                          N, K)
    want = jf.scatter_partial(src, dst, w, labels, winv, dinv, N, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fold_counters_match_reference_registry(tmp_path):
    path, labels = _write(tmp_path, "ref", True)
    jprev = j_metrics.set_registry(j_metrics.MetricsRegistry())
    tprev = t_metrics.set_registry(t_metrics.MetricsRegistry())
    try:
        for opts in (DEFAULT, GEEOptions()):
            j_stream_fold(jio.open_edge_list(path, chunk_edges=7), labels,
                          K, _jopts(opts), prefetch_windows=2)
            stream_fold(tio.open_edge_list(path, chunk_edges=7), labels, K,
                        opts, prefetch_windows=2, device="cpu")
        jsnap = j_metrics.get_registry().snapshot()
        tsnap = t_metrics.get_registry().snapshot()
        names = ("fold.windows", "fold.windows.scatter",
                 "fold.windows.degrees", "fold.edges")
        for name in names:
            assert tsnap["counters"][name] == jsnap["counters"][name], name
        assert tsnap["counters"]["fold.windows"] == 2 * 23   # ceil(157/7)
        assert tsnap["counters"]["fold.windows.degrees"] == 23
        assert tsnap["gauges"]["fold.edges_per_sec"] > 0
        assert tsnap["histograms"]["fold.prefetch_stall_ms"]["count"] == \
            jsnap["histograms"]["fold.prefetch_stall_ms"]["count"]
    finally:
        j_metrics.set_registry(jprev)
        t_metrics.set_registry(tprev)


def test_fold_spans_and_overlap(tmp_path):
    path, labels = _write(tmp_path, "port", True)
    tracer = t_trace.Tracer(enabled=True, annotate_device=False)
    prev = t_trace.set_tracer(tracer)
    try:
        slow = ThrottledWindowSource(tio.open_edge_list(path, chunk_edges=7),
                                     delay_s=0.002)
        gee_chunked(slow, labels, K, DEFAULT, prefetch_windows=2,
                    device="cpu")
    finally:
        t_trace.set_tracer(prev)
    names = {e.name for e in tracer.events()}
    assert {"fold.prefetch_wait", "fold.prefetch_fill", "fold.prefetch_stage",
            "fold.window"} <= names
    fills = [e for e in tracer.events() if e.name == "fold.prefetch_fill"]
    folds = [e for e in tracer.events() if e.name == "fold.window"]
    assert any(f.tid != w.tid and f.ts_us < w.ts_us + w.dur_us
               and w.ts_us < f.ts_us + f.dur_us for f in fills for w in folds)


# ---------------------------------------------------------------------------
# the prefetch pipeline
# ---------------------------------------------------------------------------

def _no_prefetch_threads():
    return not any(t.name.startswith("gee-prefetch")
                   for t in threading.enumerate())


class _BoomSource:
    """A WindowSource whose iterator dies mid-stream."""

    def __init__(self, inner, after: int):
        self.inner, self.after = inner, after

    num_nodes = property(lambda self: self.inner.num_nodes)
    undirected = property(lambda self: self.inner.undirected)
    num_edges = property(lambda self: self.inner.num_edges)
    window_edges = property(lambda self: self.inner.window_edges)
    num_windows = property(lambda self: self.inner.num_windows)

    def windows(self, pad_to=None):
        for i, w in enumerate(self.inner.windows(pad_to=pad_to)):
            if i == self.after:
                raise RuntimeError("disk went away")
            yield w


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_ring_windows_own_their_memory(tmp_path, depth):
    """Staged windows never alias a reused ring slot: all of them, held at
    once, equal the source's windows."""
    path, _ = _write(tmp_path, "port", False)
    ch = tio.open_edge_list(path, chunk_edges=7)
    got = list(PrefetchingWindowSource(ch, depth, device="cpu").windows())
    _same_windows([(w.num_edges, w.src.numpy(), w.dst.numpy(),
                    w.weight.numpy()) for w in got], _windows(ch))


def test_ring_under_many_workers_and_fast_switching(tmp_path):
    """More workers than cores, fills racing for ring slots under a short
    switch interval: every window still arrives whole and in order."""
    import sys

    path, _ = _write(tmp_path, "port", True)
    ch = tio.open_edge_list(path, chunk_edges=3)
    want = _windows(ch)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (2, 3 * (os.cpu_count() or 1)):
            got = list(PrefetchingWindowSource(ch, depth,
                                               device="cpu").windows())
            _same_windows([(w.num_edges, w.src.numpy(), w.dst.numpy(),
                            w.weight.numpy()) for w in got], want)
    finally:
        sys.setswitchinterval(prev)
    deadline = time.monotonic() + 10.0
    while not _no_prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _no_prefetch_threads()


def test_pipeline_failures_and_shutdown(tmp_path):
    path, _ = _write(tmp_path, "port", True)
    ch = tio.open_edge_list(path, chunk_edges=7)
    with pytest.raises(RuntimeError, match="disk went away"):
        list(PrefetchingWindowSource(_BoomSource(ch, 2), 2,
                                     device="cpu").windows())

    def bad_stage(w):
        raise ValueError("copy failed")

    with pytest.raises(ValueError, match="copy failed"):
        list(PrefetchingWindowSource(ch, 2, stage=bad_stage,
                                     device="cpu").windows())
    it = PrefetchingWindowSource(ch, 2, device="cpu").windows()
    next(it)
    next(it)
    it.close()                       # the consumer leaves mid-stream
    deadline = time.monotonic() + 10.0
    while not _no_prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _no_prefetch_threads()


def test_depth_resolution_and_passthrough(monkeypatch, tmp_path):
    monkeypatch.delenv(ENV_PREFETCH_WINDOWS, raising=False)
    assert resolve_prefetch_depth() == DEFAULT_PREFETCH_DEPTH == 2
    assert resolve_prefetch_depth(-3) == 0
    monkeypatch.setenv(ENV_PREFETCH_WINDOWS, "5")
    assert resolve_prefetch_depth() == 5
    assert resolve_prefetch_depth(1) == 1
    monkeypatch.setenv(ENV_PREFETCH_WINDOWS, "x")
    with pytest.raises(ValueError, match="not an integer"):
        resolve_prefetch_depth()
    path, _ = _write(tmp_path, "port", True)
    ch = tio.open_edge_list(path, chunk_edges=7)
    assert prefetch_windows(ch, 0, device="cpu") is ch
    pf = prefetch_windows(ch, 2, device="cpu")
    assert isinstance(pf, PrefetchingWindowSource)
    assert prefetch_windows(pf, 3, device="cpu") is pf
    sync = PrefetchingWindowSource(ch, 0, device="cpu")
    _same_windows([(w.num_edges, w.src.numpy(), w.dst.numpy(),
                    w.weight.numpy()) for w in sync.windows()], _windows(ch))
    assert (pf.num_nodes, pf.num_edges, pf.window_edges, pf.num_windows,
            pf.undirected) == (N, E, 7, 23, True)


def test_streaming_defaults_to_the_card():
    """No device given means the card: without one, streaming raises
    instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    ch = tio.ChunkedEdgeList(np.zeros(1, np.int32), np.ones(1, np.int32),
                             np.ones(1, np.float32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gee_chunked(ch, [0, 1], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GEEEmbedder(num_classes=2).fit_file("unused.geeb", [0, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [DEFAULT, GEEOptions()], ids=lambda o: o.tag())
def test_streaming_on_card(tmp_path, opts):
    """The pinned ring on the card: depths 0, 2 and 5 give the reference's
    embedding, over a file and over an in-memory manifest on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned staging and the card)")
    path, labels = _write(tmp_path, "port", True)
    want = np.asarray(j_gee_chunked(jio.open_edge_list(path, chunk_edges=7),
                                    labels, K, _jopts(opts)))
    for depth in (0, 2, 5):
        got = gee_chunked(tio.open_edge_list(path, chunk_edges=7), labels, K,
                          opts, prefetch_windows=depth)
        assert got.is_cuda
        assert_rows(got.cpu().numpy(), want)
    edges = tio.open_edge_list(path).to_edge_list()
    assert edges.device.type == "cuda"
    got = gee(PreparedGraph(edges), labels, K, opts, backend="chunked")
    assert_rows(got.cpu().numpy(), want)


def test_hub_row_accumulates_in_float64():
    """A star's hub row of 20,307 unit terms: an f32 running sum (what
    ``index_add_`` into an f32 accumulator does) drifts past the row
    tolerance, while the fold and ``sparse_torch``, which accumulate in
    float64 and round once, stay within an f32 rounding of the exact sum."""
    leaves = 20_307
    n = leaves + 1
    src = np.zeros(leaves, np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    labels = np.random.default_rng(0).integers(0, 5, n).astype(np.int32)
    nk = np.bincount(labels, minlength=5)
    terms = (np.float32(1) / nk.astype(np.float32))[labels[dst]]
    exact = np.bincount(labels[dst], weights=terms.astype(np.float64),
                        minlength=5)
    running = torch.zeros(5, dtype=torch.float32).index_add_(
        0, torch.from_numpy(labels[dst].astype(np.int64)),
        torch.from_numpy(terms))
    drift = np.abs(running.numpy() - exact).max() / exact.max()
    assert drift > RTOL                      # 3.9e-5 on this row
    edges = edge_list_from_numpy(src, dst, None, n, device="cpu")
    for z in (gee_sparse_torch(edges, labels, 5, GEEOptions()),
              gee_chunked(tio.ChunkedEdgeList(src, dst,
                                              np.ones(leaves, np.float32), n,
                                              chunk_edges=4096),
                          labels, 5, GEEOptions(), device="cpu")):
        assert np.abs(z[0].numpy() - exact).max() / exact.max() < 1e-7


def test_depth_tool_runs_on_the_host(tmp_path):
    """``tools/stream_depth.py`` still drives the port: on the host at a
    tiny size it runs one fresh process a depth, A B B A, and reports each
    process's fit and pipeline times and the summary by depth."""
    import json
    import subprocess
    import sys

    tool = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "stream_depth.py")
    out = tmp_path / "stream_depth.json"
    proc = subprocess.run(
        [sys.executable, tool, "--device", "cpu", "--nodes", "300",
         "--edges", "2000", "--classes", "3", "--rounds", "1",
         "--repeats", "1", "--out", str(out)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["order"] == [0, 2, 2, 0]
    assert [r["depth"] for r in report["runs"]] == [0, 2, 2, 0]
    assert set(report["summary"]) == {"0", "2"}
    for run in report["runs"]:
        assert len(run["no_options_ms"]) == 1 and run["all_on_ms"][0] > 0
