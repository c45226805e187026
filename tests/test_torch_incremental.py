"""The port's incremental updates -- ``repro_torch.graph.delta``,
``core.incremental.IncrementalGEE``, ``GEEEmbedder.partial_fit``,
``GEEDeltaServer``, the query service's index repair and the
``gee_stream`` CLI -- held against the JAX reference on the CPU, with
inputs made from a numpy seed and fed to both packages.

The host accumulators (``S``, ``nk``, ``deg``, ``_dinv``, ``labels``) are
updated by the same numpy code in the same order in both packages, so they
are held bit for bit (``assert_array_equal``), with the adjacency dicts,
the watermark and every stats counter.  Z is normalized in float32 on the
port's device and in float64 by the reference, so it is held to the
row-scaled tolerance 1e-5·|want| + 1e-5·min(1, max |want row|).
"""

import importlib

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.incremental import IncrementalGEE as JInc
from repro.graph import delta as jdelta
from repro.graph.containers import edge_list_from_numpy as j_edge_list
from repro.graph.containers import symmetrize as j_symmetrize
from repro.launch import gee_stream as j_gee_stream
from repro.search.index import ClassPartitionedIndex as JIndex
from repro.search.service import GEEDeltaServer as JDeltaServer
from repro.search.service import GEEQueryService as JService

from repro_torch.core.api import GEEEmbedder
from repro_torch.core.gee import ALL_OPTION_SETTINGS, GEEOptions, gee
from repro_torch.core.incremental import DirtyRowTracker, IncrementalGEE
from repro_torch.graph import delta as tdelta
from repro_torch.graph.containers import edge_list_from_numpy, symmetrize
from repro_torch.graph.datasets import DatasetSpec, synth_to_disk
from repro_torch.launch import gee_stream
from repro_torch.search import (ClassPartitionedIndex, GEEDeltaServer,
                                GEEQueryService)

jgee = importlib.import_module("repro.core.gee")

RTOL = ATOL = 1e-5
OPT_IDS = [o.tag() for o in ALL_OPTION_SETTINGS]
DEFAULT = GEEOptions(laplacian=True, diag_aug=True, correlation=True)


def _jopts(o):
    return jgee.GEEOptions(laplacian=o.laplacian, diag_aug=o.diag_aug,
                           correlation=o.correlation)


def assert_rows(got, want):
    """Each entry within RTOL·|want| + ATOL·min(1, max |want row|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.minimum(np.abs(want).max(axis=1, keepdims=True), 1.0)
    bad = ~(np.abs(got - want) <= RTOL * np.abs(want) + ATOL * scale)
    assert not bad.any(), (int(bad.sum()), np.argwhere(bad)[:5])


def _random_graph(rng, n, e):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (src + 1 + rng.integers(0, n - 1, e)).astype(np.int32) % n
    w = (rng.random(e) + 0.1).astype(np.float32)
    return src, dst, w


def _both(src, dst, w, labels, k, opts, n):
    """The same symmetrized graph promoted by both packages."""
    t = IncrementalGEE.from_graph(
        symmetrize(edge_list_from_numpy(src, dst, w, n, device="cpu")),
        labels, k, opts)
    j = JInc.from_graph(j_symmetrize(j_edge_list(src, dst, w, n)), labels,
                        k, _jopts(opts))
    return t, j


def assert_same_state(t, j):
    """Accumulators bit for bit, adjacency, watermark, stats; Z to the row
    tolerance."""
    np.testing.assert_array_equal(t.S, j.S)
    np.testing.assert_array_equal(t.nk, j.nk)
    np.testing.assert_array_equal(t.deg, j.deg)
    np.testing.assert_array_equal(t._dinv, j._dinv)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.labels.dtype == np.int32
    assert t.out_nbrs == j.out_nbrs and t.in_nbrs == j.in_nbrs
    assert t.applied_seq == j.applied_seq
    assert t.num_pending_rows == j.num_pending_rows
    zt, zj = t.embedding(), np.asarray(j.embedding())
    assert isinstance(zt, torch.Tensor) and zt.dtype == torch.float32
    assert zt.device.type == "cpu"
    assert_rows(zt.numpy(), zj)
    assert t.stats == j.stats


@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_random_deltas_match_reference_bit_for_bit(opts):
    """Inserts, weight bumps, removals, label flips (to and from unknown)
    and sequenced batches, interleaved; after each round the state equals
    the reference's and Z is within the row tolerance of a fresh
    ``sparse_torch`` fit of the mutated graph."""
    rng = np.random.default_rng(7)
    n, e, k = 50, 120, 4
    src, dst, w = _random_graph(rng, n, e)
    labels = rng.integers(-1, k, n).astype(np.int32)
    t, j = _both(src, dst, w, labels, k, opts, n)
    assert_same_state(t, j)
    seq = 0
    for _ in range(5):
        ns, nd, nw = _random_graph(rng, n, 8)
        t.apply(tdelta.symmetrize_delta(
            tdelta.edge_delta_from_numpy(ns, nd, nw, pad_to=64, seq=seq)))
        j.apply(jdelta.symmetrize_delta(
            jdelta.edge_delta_from_numpy(ns, nd, nw, pad_to=64, seq=seq)))
        seq += 1
        cur = t.to_edge_list()
        jcur = j.to_edge_list()
        for a, b in ((cur.src, jcur.src), (cur.dst, jcur.dst),
                     (cur.weight, jcur.weight)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pick = rng.choice(cur.num_edges, size=min(5, cur.num_edges),
                          replace=False)
        rs, rd = cur.src.numpy()[pick], cur.dst.numpy()[pick]
        rw = -cur.weight.numpy()[pick]
        t.apply(tdelta.edge_delta_from_numpy(rs, rd, rw, pad_to=64))
        j.apply(jdelta.edge_delta_from_numpy(rs, rd, rw, pad_to=64))
        nodes = rng.integers(0, n, 4)
        newl = rng.integers(-1, k, 4).astype(np.int32)
        t.apply(tdelta.label_delta_from_numpy(nodes, newl, pad_to=16))
        j.apply(jdelta.label_delta_from_numpy(nodes, newl, pad_to=16))
        # a replayed duplicate below the watermark is skipped by both
        t.apply(tdelta.edge_delta_from_numpy([0], [1], [5.0], seq=seq - 1))
        j.apply(jdelta.edge_delta_from_numpy([0], [1], [5.0], seq=seq - 1))
        assert_same_state(t, j)
        fresh = gee(t.to_edge_list(pad_to=512), t.labels, k, opts,
                    backend="sparse_torch")
        assert_rows(t.embedding().numpy(), fresh.numpy())
    assert t.stats["skipped_replays"] == 5


def test_from_empty_graph_and_row_reads():
    """Streaming from an empty graph (a cold start) and partial row reads
    match the reference."""
    rng = np.random.default_rng(3)
    n, k = 30, 3
    labels = rng.integers(0, k, n).astype(np.int32)
    empty = np.empty(0, np.int32)
    t, j = _both(empty, empty, None, labels, k, DEFAULT, n)
    src, dst, w = _random_graph(rng, n, 40)
    t.apply(tdelta.symmetrize_delta(tdelta.edge_delta_from_numpy(src, dst,
                                                                 w)))
    j.apply(jdelta.symmetrize_delta(jdelta.edge_delta_from_numpy(src, dst,
                                                                 w)))
    rows = np.array([5, 0, 29, 5])
    assert_rows(t.embedding(rows).numpy(), np.asarray(j.embedding(rows)))
    assert_same_state(t, j)


def test_padding_slots_are_noops():
    rng = np.random.default_rng(5)
    n, k = 20, 3
    src, dst, w = _random_graph(rng, n, 30)
    labels = rng.integers(0, k, n).astype(np.int32)
    opts = GEEOptions(laplacian=True, diag_aug=True)
    edges = symmetrize(edge_list_from_numpy(src, dst, w, n, device="cpu"))
    a = IncrementalGEE.from_graph(edges, labels, k, opts)
    b = IncrementalGEE.from_graph(edges, labels, k, opts)
    ns, nd, nw = _random_graph(rng, n, 6)
    a.apply(tdelta.edge_delta_from_numpy(ns, nd, nw))
    padded = tdelta.edge_delta_from_numpy(ns, nd, nw, pad_to=512)
    assert padded.padded_size == 512 and padded.num_deltas == 6
    b.apply(padded)
    np.testing.assert_array_equal(a.S, b.S)
    lb = tdelta.label_delta_from_numpy(np.array([3, 4]), np.array([1, 2]))
    a.apply(lb)
    b.apply(lb.with_padding(128))
    np.testing.assert_array_equal(a.S, b.S)
    assert torch.equal(a.embedding(), b.embedding())


def test_out_of_range_deltas_leave_the_state_untouched():
    """Bad ids raise before anything mutates, in both appliers and in both
    packages alike."""
    for pkg, mod in (("port", tdelta), ("ref", jdelta)):
        inc = (IncrementalGEE(5, 2, device="cpu") if pkg == "port"
               else JInc(5, 2))
        inc.apply(mod.label_delta_from_numpy(np.arange(5),
                                             np.zeros(5, np.int32)))
        inc.apply(mod.edge_delta_from_numpy([0, 1], [1, 2], [1.0, 2.0]))
        before = (inc.S.copy(), inc.nk.copy(), inc.labels.copy(),
                  inc.deg.copy(), [dict(d) for d in inc.out_nbrs])
        bad = [mod.edge_delta_from_numpy([0], [9], [1.0]),
               mod.edge_delta_from_numpy([-1], [2], [1.0]),
               mod.label_delta_from_numpy([7], [0]),
               mod.label_delta_from_numpy([0, 9], [1, 0]),
               mod.label_delta_from_numpy([1], [2])]
        for d in bad:
            with pytest.raises(ValueError):
                inc.apply(d)
        after = (inc.S, inc.nk, inc.labels, inc.deg,
                 [dict(d) for d in inc.out_nbrs])
        for x, y in zip(before[:4], after[:4]):
            np.testing.assert_array_equal(x, y)
        assert before[4] == after[4]


def test_embedding_cache_is_read_only():
    """A caller writing to what ``embedding()`` returned never reaches the
    cache: later reads are unchanged."""
    inc = IncrementalGEE(num_nodes=4, num_classes=2, device="cpu")
    inc.apply(tdelta.label_delta_from_numpy([0, 1], [0, 1]))
    inc.apply(tdelta.edge_delta_from_numpy([0, 1], [1, 0], [1.0, 2.0]))
    z = inc.embedding()
    want = z.clone()
    z[0, 0] = 99.0
    z[1].fill_(-1.0)
    assert torch.equal(inc.embedding(), want)
    inc.embedding(np.array([0, 1]))[:] = 7.0
    assert torch.equal(inc.embedding(), want)


def _edge_batches(rng, count=4):
    out = []
    for _ in range(count):
        m = int(rng.integers(0, 9))
        src = rng.integers(0, 6, m)
        dst = rng.integers(0, 6, m)
        w = rng.choice([-1.0, -0.5, 0.5, 1.0], m)
        out.append((src, dst, w, int(rng.integers(-1, 10))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_delta_helpers_match_reference(seed):
    """Constructors, ``with_padding``, ``symmetrize_delta`` and both
    coalescers give the reference's arrays, counts and seqs."""
    rng = np.random.default_rng(seed)
    batches = _edge_batches(rng)
    tb = [tdelta.edge_delta_from_numpy(s, d, w, seq=q)
          for s, d, w, q in batches]
    jb = [jdelta.edge_delta_from_numpy(s, d, w, seq=q)
          for s, d, w, q in batches]

    def same_edges(a, b):
        assert (a.num_deltas, a.seq, a.padded_size) == \
            (b.num_deltas, b.seq, b.padded_size)
        for x, y in ((a.src, b.src), (a.dst, b.dst), (a.weight, b.weight)):
            assert isinstance(x, np.ndarray) and x.dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, np.asarray(y))

    for a, b in zip(tb, jb):
        same_edges(tdelta.symmetrize_delta(a.with_padding(8)),
                   jdelta.symmetrize_delta(b.with_padding(8)))
    for pad in (None, 16):
        same_edges(tdelta.coalesce_edge_deltas(tb, pad_multiple=pad),
                   jdelta.coalesce_edge_deltas(jb, pad_multiple=pad))
    lbatches = [(rng.integers(0, 6, 3), rng.integers(-1, 3, 3),
                 int(rng.integers(-1, 5))) for _ in range(3)]
    tl = [tdelta.label_delta_from_numpy(nd, lb, pad_to=5, seq=q)
          for nd, lb, q in lbatches]
    jl = [jdelta.label_delta_from_numpy(nd, lb, pad_to=5, seq=q)
          for nd, lb, q in lbatches]
    for pad in (None, 8):
        a = tdelta.coalesce_label_deltas(tl, pad_multiple=pad)
        b = jdelta.coalesce_label_deltas(jl, pad_multiple=pad)
        assert (a.num_deltas, a.seq, a.padded_size) == \
            (b.num_deltas, b.seq, b.padded_size)
        np.testing.assert_array_equal(a.node, np.asarray(b.node))
        np.testing.assert_array_equal(a.new_label, np.asarray(b.new_label))
    assert tdelta.coalesce_edge_deltas([]).num_deltas == 0


def test_coalesce_edges_sums_and_cancels():
    d1 = tdelta.edge_delta_from_numpy([0, 1], [1, 2], [1.0, 2.0])
    d2 = tdelta.edge_delta_from_numpy([0, 1], [1, 2], [0.5, -2.0], seq=4)
    merged = tdelta.coalesce_edge_deltas([d1, d2])
    assert merged.num_deltas == 1 and merged.seq == 4
    assert (int(merged.src[0]), int(merged.dst[0])) == (0, 1)
    assert float(merged.weight[0]) == pytest.approx(1.5)


def test_partial_fit_matches_full_refit():
    rng = np.random.default_rng(11)
    n, k = 40, 3
    src, dst, w = _random_graph(rng, n, 80)
    labels = rng.integers(0, k, n).astype(np.int32)
    edges = symmetrize(edge_list_from_numpy(src, dst, w, n, device="cpu"))
    emb = GEEEmbedder(num_classes=k, device="cpu").fit(edges, labels)
    z0 = emb.transform().clone()
    assert emb.incremental is None
    idx = emb.build_index()
    ns, nd, nw = _random_graph(rng, n, 10)
    delta = tdelta.symmetrize_delta(tdelta.edge_delta_from_numpy(ns, nd, nw))
    ldelta = tdelta.label_delta_from_numpy([0, 1], [2, 0])
    emb.partial_fit(delta).partial_fit(ldelta)
    inc = emb.incremental
    assert isinstance(inc, IncrementalGEE) and inc.device.type == "cpu"
    z1 = emb.transform()
    assert emb.transform() is z1                  # no stale rows: cached
    assert not torch.allclose(z0, z1)
    y = labels.copy()
    y[[0, 1]] = [2, 0]
    np.testing.assert_array_equal(emb._labels.numpy(), y)
    fresh = GEEEmbedder(num_classes=k, device="cpu").fit(
        emb.current_edges(), y)
    assert_rows(z1.numpy(), fresh.transform().numpy())
    assert emb.predict().shape == (n,)
    # the reference's embedder after the same deltas
    jemb = japi.GEEEmbedder(num_classes=k).fit(
        j_symmetrize(j_edge_list(src, dst, w, n)), labels)
    jemb.partial_fit(jdelta.symmetrize_delta(
        jdelta.edge_delta_from_numpy(ns, nd, nw)))
    jemb.partial_fit(jdelta.label_delta_from_numpy([0, 1], [2, 0]))
    np.testing.assert_array_equal(inc.S, jemb.incremental.S)
    assert_rows(z1.numpy(), np.asarray(jemb.transform()))
    # the cached index is repaired, not rebuilt, and equals a fresh build
    ids, sc = emb.neighbors(np.arange(n), k=5, nprobe=idx.num_cells)
    assert emb.index is idx and idx.stats["builds"] == 1
    assert idx.stats["repaired_rows"] == n        # the label flip: all rows
    want_ids, want_sc = ClassPartitionedIndex.build(
        z1, y, k).search(z1, 5, brute_force=True)
    np.testing.assert_allclose(sc.numpy(), want_sc.numpy(), rtol=1e-6,
                               atol=1e-6)
    # a new fit gets a new tracker and drops the incremental state
    emb.fit(edges, labels)
    assert emb.incremental is None and emb._index_tracker is None
    assert emb.index is None


def test_partial_fit_needs_a_fit():
    with pytest.raises(RuntimeError, match="call fit"):
        GEEEmbedder(num_classes=2, device="cpu").partial_fit(
            tdelta.label_delta_from_numpy([0], [1]))


def test_partial_fit_refuses_file_backed_fits(tmp_path):
    path = str(tmp_path / "g.geeb")
    synth_to_disk(DatasetSpec("g", 60, 200, 3), path, seed=1)
    emb = GEEEmbedder(num_classes=3, device="cpu").fit_file(path)
    with pytest.raises(RuntimeError, match="in-memory path"):
        emb.partial_fit(tdelta.label_delta_from_numpy([0], [1]))


def _server_pair(opts=DEFAULT, n=30, k=3, seed=13, **kw):
    rng = np.random.default_rng(seed)
    src, dst, w = _random_graph(rng, n, 60)
    labels = rng.integers(0, k, n).astype(np.int32)
    t, j = _both(src, dst, w, labels, k, opts, n)
    return (t, GEEDeltaServer(t, **kw)), (j, JDeltaServer(j, **kw))


def test_delta_server_coalesces_and_serves_like_the_reference():
    (t, ts), (j, js) = _server_pair(flush_every=1000, pad_multiple=16)
    w_before = t.out_nbrs[2].get(5, 0.0)
    for server, mod in ((ts, tdelta), (js, jdelta)):
        for _ in range(4):                 # duplicates coalesce to one
            server.submit(mod.edge_delta_from_numpy([2], [5], [0.25]))
        server.submit(mod.label_delta_from_numpy([2, 2], [1, 0]))
        assert server.stats["flushes"] == 0
    z = ts.embed()                         # a read forces the flush
    zj = np.asarray(js.embed())
    assert isinstance(z, torch.Tensor)
    assert_rows(z.numpy(), zj)
    assert ts.stats["flushes"] == 1
    assert ts.stats["applied_deltas"] < ts.stats["submitted"]
    assert t.out_nbrs[2][5] == pytest.approx(w_before + 1.0)
    for server, mod in ((ts, tdelta), (js, jdelta)):
        server.submit(mod.edge_delta_from_numpy([1], [3], [1.0]))
        server.embed(max_staleness=None)   # monitoring read skips the flush
        assert server.stats["stale_reads"] == 1
        server.flush()
    assert dict(ts.stats) == dict(js.stats)
    assert_same_state(t, j)


def test_delta_server_autoflush_and_backpressure():
    (t, ts), (j, js) = _server_pair(flush_every=4)
    for server, mod in ((ts, tdelta), (js, jdelta)):
        for i in range(4):
            server.submit(mod.edge_delta_from_numpy([i], [i + 1], [1.0]))
        assert server.stats["flushes"] == 1 and server.stats["submitted"] == 4
    (t, ts), (j, js) = _server_pair(flush_every=10**9, max_backlog=20)
    rng = np.random.default_rng(6)
    for _ in range(5):
        s, d = rng.integers(0, 30, 16), rng.integers(0, 30, 16)
        ts.submit(tdelta.edge_delta_from_numpy(s, d, np.ones(16)))
        js.submit(jdelta.edge_delta_from_numpy(s, d, np.ones(16)))
    ts.flush()
    js.flush()
    assert ts.stats["backpressure_flushes"] >= 3
    assert (ts.stats["applied_deltas"] + ts.stats["coalesced_away"]) == 80
    assert dict(ts.stats) == dict(js.stats)
    assert_same_state(t, j)


def test_delta_server_survives_poisoned_batch():
    inc = IncrementalGEE(num_nodes=5, num_classes=2, device="cpu")
    server = GEEDeltaServer(inc, flush_every=1000)
    server.submit(tdelta.edge_delta_from_numpy([0], [9], [1.0]))
    with pytest.raises(ValueError):
        server.embed()
    assert server.stats["rejected_deltas"] == 1
    server.submit(tdelta.label_delta_from_numpy([1], [2]))
    with pytest.raises(ValueError, match="num_classes"):
        server.flush()
    server.submit(tdelta.edge_delta_from_numpy([0], [1], [1.0]))
    assert server.embed().shape == (5, 2)
    assert inc.stats["edge_deltas"] == 1
    with pytest.raises(TypeError):
        server.submit(object())


@pytest.mark.parametrize("opts", [GEEOptions(), DEFAULT], ids=lambda o:
                         o.tag())
def test_query_service_repair_matches_a_fresh_build(opts):
    """Deltas reach the index through the service's subscription; after
    its repair the top-k at full probe equals a fresh index's on the same
    Z, and the repair mirrors the reference's."""
    rng = np.random.default_rng(17)
    n, k = 120, 3
    src, dst, w = _random_graph(rng, n, 400)
    labels = rng.integers(0, k, n).astype(np.int32)
    t, j = _both(src, dst, w, labels, k, opts, n)
    tidx = ClassPartitionedIndex.build(t.embedding(), labels, k,
                                       pad_multiple=16)
    jidx = JIndex.build(j.embedding(), labels, k, pad_multiple=16)
    tsvc = GEEQueryService(tidx, t, flush_every=10**9)
    jsvc = JService(jidx, j, flush_every=10**9)
    tracker = DirtyRowTracker(n)
    t.add_dirty_listener(tracker)
    ns, nd, nw = _random_graph(rng, n, 12)
    for inc, mod in ((t, tdelta), (j, jdelta)):
        inc.apply(mod.symmetrize_delta(mod.edge_delta_from_numpy(ns, nd,
                                                                 nw)))
    assert tsvc.stale_rows == jsvc.stale_rows == tracker.pending > 0
    assert tsvc.repair() == jsvc.repair()
    assert tsvc.stale_rows == 0
    flips = (t.labels[[3, 4]] + 1) % k
    for inc, mod in ((t, tdelta), (j, jdelta)):
        inc.apply(mod.label_delta_from_numpy([3, 4], flips))
    assert tracker.full and tsvc.stale_rows == n
    rows = np.arange(0, n, 7)
    tt = tsvc.submit_rows(rows, k=5)
    jt = jsvc.submit_rows(rows, k=5)
    tsvc.flush()
    jsvc.flush()
    assert tsvc.stats["full_refreshes"] == 1
    assert {key: v for key, v in tsvc.stats.items() if key != "flush_ms"} \
        == {key: v for key, v in jsvc.stats.items() if key != "flush_ms"}
    np.testing.assert_array_equal(tidx._row_cell, jidx._row_cell)
    np.testing.assert_array_equal(tidx._table, jidx._table)
    z = t.embedding()
    assert torch.equal(tidx.z, z)
    ids, sc = tidx.search(z[rows], 5, nprobe=tidx.num_cells)
    fresh_ids, fresh_sc = ClassPartitionedIndex.build(
        z, t.labels, k, pad_multiple=16).search(z[rows], 5, brute_force=True)
    np.testing.assert_array_equal(sc.numpy(), fresh_sc.numpy())
    np.testing.assert_allclose(tt.scores, jt.scores, rtol=1e-5, atol=1e-5)
    tsvc.close()
    t.apply(tdelta.edge_delta_from_numpy([0], [1], [1.0]))
    assert tsvc.stale_rows == 0                  # unsubscribed
    assert len(t._dirty_listeners) == 1          # only the tracker left
    jsvc.close()


STREAM = ["--sbm", "300", "--stream-frac", "0.3", "--batch", "16",
          "--max-batches", "6", "--verify-every", "3", "--seed", "3"]


@pytest.mark.parametrize("flags", [[], ["--lap", "--diag", "--cor"]],
                         ids=["plain", "all-on"])
def test_gee_stream_matches_reference(flags, capsys):
    """The same seed draws the same stream in both packages; the port's
    CLI ends at the reference's watermark and statistics, its verify
    checks hold, and ``--queries`` serves from a live, repaired index."""
    args = gee_stream.parse_args(STREAM + flags + ["--device", "cpu"])
    st = gee_stream.prepare_stream(args)
    jst = j_gee_stream.prepare_stream(args)
    for key in ("su", "du", "wu"):
        np.testing.assert_array_equal(st[key], np.asarray(jst[key]))
    assert (st["n_stream"], st["n_base"], st["k"]) == \
        (jst["n_stream"], jst["n_base"], jst["k"])
    assert st["rng"].integers(0, 10**9) == jst["rng"].integers(0, 10**9)

    out = gee_stream.run(gee_stream.parse_args(
        STREAM + flags + ["--device", "cpu", "--queries", "8"]))
    ref = j_gee_stream.main(STREAM + flags)
    assert out["batches_run"] == ref["batches_run"] == 6
    assert out["watermark"] == ref["watermark"]
    assert out["max_err"] <= 1e-5
    assert len(out["query_ms"]) == len(out["repair_ms"]) == 6
    assert out["index"].stats["builds"] == 1
    assert sum(out["repair_rows"]) > 0
    text = capsys.readouterr().out
    assert "index repair" in text and "query flush of 8" in text
    inc = out["inc"]
    fresh = gee(inc.to_edge_list(), inc.labels, inc.k, inc.opts,
                backend="sparse_torch")
    assert_rows(inc.embedding().numpy(), fresh.numpy())
