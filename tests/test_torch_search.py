"""The port's retrieval path -- ``ClassPartitionedIndex``,
``GEEQueryService``, ``GEEEmbedder.build_index`` / ``neighbors`` and the
``gee_search`` CLI -- held against the JAX package on the CPU, on the same
embeddings (numpy in, numpy out).  The reference's search runs as its own
suite runs it here (``impl="auto"``: pure JAX); the port's kernel wrappers
take their plain versions on CPU tensors.  Also the port's copies of the
observability layer and ``datasets.load``.

Ids are compared slot by slot except inside near-ties (scores within
1e-5), where the reference's top-15 shows the tie; near-tied candidates
are interchangeable and the two packages sum in different orders.
"""

import numpy as np
import pytest
import torch

from repro.core.api import GEEEmbedder as JEmbedder
from repro.core.gee import GEEOptions as JOptions
from repro.core.gee import gee_sparse_jax
from repro.graph import datasets as jdatasets
from repro.graph.sbm import sample_sbm as j_sample_sbm
from repro.launch import gee_search as j_gee_search
from repro.obs import metrics as j_metrics
from repro.search.index import ClassPartitionedIndex as JIndex
from repro.search.service import GEEQueryService as JService
from repro.search.service import LoadShedError as JLoadShedError

from repro_torch.core.api import GEEEmbedder
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph.sbm import sample_sbm as t_sample_sbm
from repro_torch.launch import gee_search as t_gee_search
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace
from repro_torch.search import (ClassPartitionedIndex, GEEQueryService,
                                LoadShedError, default_nprobe)
from repro_torch.search.index import default_nprobe as t_default_nprobe

TOL = 1e-5
METRICS = ("l2", "cosine")


@pytest.fixture(scope="module")
def embedded():
    """A 900-vertex SBM embedded by the reference (default options), with a
    few unknown (-1) labels: z [N, 3] f32 and labels, as numpy."""
    s = j_sample_sbm(900, seed=21)
    z = np.asarray(gee_sparse_jax(s.edges, s.labels, s.num_classes,
                                  JOptions(True, True, True)))
    labels = s.labels.copy()
    labels[::37] = -1
    return z.astype(np.float32), labels, s.num_classes


def _indexes(embedded, metric, **kw):
    z, labels, k = embedded
    j = JIndex.build(z, labels, k, metric=metric, **kw)
    t = ClassPartitionedIndex.build(torch.from_numpy(z), labels, k,
                                    metric=metric, **kw)
    return j, t


def assert_same_topk(got, want_wide, k):
    """``got`` (ids, scores) of width k against the reference's wider
    top-k: scores within TOL slot by slot; ids equal wherever the
    reference's neighbouring scores (the (k+1)-th included) differ by more
    than TOL, and the same set inside a near-tie group."""
    gi, gs = (np.asarray(a) for a in got)
    wi, ws = (np.asarray(a) for a in want_wide)
    assert gi.shape == (wi.shape[0], k)
    np.testing.assert_array_equal(gi < 0, wi[:, :k] < 0)
    live = wi[:, :k] >= 0
    np.testing.assert_allclose(gs[live], ws[:, :k][live], atol=TOL,
                               rtol=TOL)
    for r in range(gi.shape[0]):
        j0 = 0
        while j0 < k:
            j1 = j0
            while j1 + 1 < ws.shape[1] and abs(ws[r, j1 + 1]
                                               - ws[r, j1]) <= TOL:
                j1 += 1
            if j1 < k:        # the group ends inside the top k
                assert set(gi[r, j0:j1 + 1]) == set(wi[r, j0:j1 + 1]), r
            else:             # cut by k: members of the wider group
                assert set(gi[r, j0:k]) <= set(wi[r, j0:j1 + 1]), r
            j0 = j1 + 1


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("pad_multiple", [128, 16])
def test_build_matches_reference(embedded, metric, pad_multiple):
    j, t = _indexes(embedded, metric, pad_multiple=pad_multiple)
    assert t.device == torch.device("cpu")
    np.testing.assert_allclose(t._centroids.numpy(), np.asarray(j._centroids),
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(t._active, j._active)
    np.testing.assert_array_equal(t._row_cell, j._row_cell)
    np.testing.assert_array_equal(t._row_slot, j._row_slot)
    np.testing.assert_array_equal(t._table, j._table)
    np.testing.assert_array_equal(t._cell_len, j._cell_len)
    assert (t.nprobe, t.num_cells, t.bucket_capacity, t.num_points, t.dim) \
        == (j.nprobe, j.num_cells, j.bucket_capacity, j.num_points, j.dim)
    assert t.padding_fraction() == j.padding_fraction()
    assert t.stats["builds"] == 1


def test_build_all_unknown_and_default_nprobe(embedded):
    z, labels, k = embedded
    none = np.full_like(labels, -1)
    j = JIndex.build(z, none, k)
    t = ClassPartitionedIndex.build(torch.from_numpy(z), none, k)
    np.testing.assert_allclose(t._centroids.numpy(), np.asarray(j._centroids),
                               atol=TOL)
    np.testing.assert_array_equal(t._table, j._table)
    assert t.num_cells == 1
    assert [t_default_nprobe(c) for c in range(12)] == [
        default_nprobe(c) for c in range(12)] == [1, 1, 2, 2, 2, 3, 3, 3, 3,
                                                 3, 4, 4]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("route", ["default", "full", "brute"])
def test_search_matches_reference(embedded, metric, route):
    z, _, _ = embedded
    j, t = _indexes(embedded, metric, pad_multiple=64)
    kw = {"default": {}, "full": {"nprobe": j.num_cells},
          "brute": {"brute_force": True}}[route]
    rows = np.random.default_rng(4).integers(0, z.shape[0], 40)
    assert_same_topk(t.search_rows(rows, 10, **kw),
                     j.search_rows(rows, 15, **kw), 10)
    assert_same_topk(t.search(z[rows], 10, **kw), j.search(z[rows], 15, **kw),
                     10)
    ids, sc = t.search(z[rows[0]], 10, **kw)       # a single [K] vector
    assert ids.shape == sc.shape == (10,)
    assert_same_topk((ids[None], sc[None]),
                     [a[None] for a in j.search(z[rows[0]], 15, **kw)], 10)
    for key in ("queries", "brute_force_queries", "cells_probed",
                "candidates_scored"):
        assert t.stats[key] == j.stats[key], key


def test_full_probe_equals_brute_force(embedded):
    z, _, _ = embedded
    _, t = _indexes(embedded, "l2")
    q = z[np.random.default_rng(5).integers(0, z.shape[0], 64)]
    ids_f, sc_f = t.search(q, 10, nprobe=t.num_cells)
    ids_b, sc_b = t.search(q, 10, brute_force=True)
    assert t_gee_search.recall_at_k(ids_f.numpy(), sc_f.numpy(),
                                    ids_b.numpy(), sc_b.numpy()) == 1.0
    torch.testing.assert_close(sc_f, sc_b, rtol=0, atol=0)


@pytest.mark.parametrize("metric", METRICS)
def test_update_rows_matches_reference(embedded, metric):
    z, labels, _ = embedded
    j, t = _indexes(embedded, metric, pad_multiple=16)
    rng = np.random.default_rng(6)
    # rows re-embedded as copies of rows of other cells (so they move)
    for _ in range(3):
        rows = rng.choice(z.shape[0], 30, replace=False)
        new = z[rng.integers(0, z.shape[0], rows.size)]
        assert t.update_rows(rows, torch.from_numpy(new)) \
            == j.update_rows(rows, new)
        np.testing.assert_array_equal(t._table, j._table)
        np.testing.assert_array_equal(t._cell_len, j._cell_len)
        np.testing.assert_array_equal(t._row_cell, j._row_cell)
        np.testing.assert_array_equal(t._row_slot, j._row_slot)
        np.testing.assert_array_equal(t.z.numpy(), np.asarray(j.z))
    assert t.update_rows(np.zeros(0, np.int64), np.zeros((0, 3))) == 0
    for key in ("repaired_rows", "bucket_moves", "table_grows"):
        assert t.stats[key] == j.stats[key], key
    q = np.asarray(j.z)[:20]
    assert_same_topk(t.search(q, 5, nprobe=t.num_cells),
                     j.search(q, 10, nprobe=j.num_cells), 5)


def test_update_rows_grows_full_bucket():
    """Two tight clusters, a tiny pad_multiple: moving every vertex into one
    bucket overflows it, in both packages alike."""
    rng = np.random.default_rng(5)
    z = np.concatenate([rng.normal(0, 0.05, (20, 2)),
                        rng.normal(5, 0.05, (20, 2))]).astype(np.float32)
    y = np.repeat([0, 1], 20).astype(np.int32)
    j = JIndex.build(z, y, 2, pad_multiple=8)
    t = ClassPartitionedIndex.build(torch.from_numpy(z), y, 2,
                                    pad_multiple=8)
    rows = np.arange(20, 40)
    new = rng.normal(0, 0.05, (20, 2)).astype(np.float32)
    assert t.update_rows(rows, new) == j.update_rows(rows, new) == 20
    assert t.stats["table_grows"] == j.stats["table_grows"] >= 1
    np.testing.assert_array_equal(t._table, j._table)
    assert t._table_dev is None                  # refreshed at next search


def test_update_rows_leaves_the_callers_tensor(embedded):
    z, labels, k = embedded
    zt = torch.from_numpy(z.copy())
    t = ClassPartitionedIndex.build(zt, labels, k)
    t.update_rows([0, 1], torch.zeros(2, 3))
    assert torch.equal(zt, torch.from_numpy(z))  # the index owns its copy
    assert torch.equal(t.z[:2], torch.zeros(2, 3))


# ---------------------------------------------------------------------------
# the query service
# ---------------------------------------------------------------------------

def _drive(service_cls, shed_cls, index, z):
    """One scripted session: row and vector tickets of several k, an
    auto-flush, an explicit flush, shedding and a synchronous search."""
    svc = service_cls(index, None, flush_every=16, pad_multiple=8,
                      default_k=5, max_pending=40)
    tickets = [svc.submit_rows(np.arange(i, i + 3)) for i in range(0, 9, 3)]
    tickets.append(svc.submit(z[10:14], k=7))
    tickets.append(svc.submit(z[20], k=3))
    assert svc.backlog == 14 and not any(t.done for t in tickets)
    tickets.append(svc.submit_rows(np.arange(30, 36)))   # 20 >= 16: flush
    assert all(t.done for t in tickets) and svc.backlog == 0
    late = [svc.submit_rows(np.arange(50, 60), k=4)]
    svc.flush()
    svc.flush()                                  # an empty flush
    svc.submit_rows(np.arange(0, 15))
    with pytest.raises(shed_cls):
        svc.submit_rows(np.arange(0, 30))        # 45 > max_pending = 40
    ids, scores = svc.search(z[70:72])
    return svc, tickets + late, (ids, scores)


def test_service_matches_reference(embedded):
    z, _, _ = embedded
    j, t = _indexes(embedded, "l2", pad_multiple=64)
    jsvc, jt, jres = _drive(JService, JLoadShedError, j, z)
    tsvc, tt, tres = _drive(GEEQueryService, LoadShedError, t, z)
    skip = ("flush_ms",)
    assert {k: v for k, v in tsvc.stats.items() if k not in skip} == \
        {k: v for k, v in jsvc.stats.items() if k not in skip}
    assert len(tsvc.stats["flush_ms"]) == len(jsvc.stats["flush_ms"]) == 3
    assert [(x.uid, x.k, x.done) for x in tt] == \
        [(x.uid, x.k, x.done) for x in jt]
    for a, b in zip(tt, jt):
        assert a.ids.shape == b.ids.shape and a.ids.dtype == np.int32
        assert isinstance(a.scores, np.ndarray)
        np.testing.assert_allclose(a.scores, b.scores, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tres[1], jres[1], atol=TOL, rtol=TOL)
    # each row ticket's first hit is the vertex itself
    assert [int(r) for r in tt[0].ids[:, 0]] == [0, 1, 2]
    tsvc.close()
    jsvc.close()


def test_service_rejects_incremental_state(embedded):
    _, t = _indexes(embedded, "l2")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        GEEQueryService(t, inc=object())
    svc = GEEQueryService(t)
    assert svc.repair() == 0


def test_service_spans_and_metrics(embedded):
    """The flush spans keep the reference's names and the service's stats
    live in the registry; a span also opens a torch.profiler range."""
    z, _, _ = embedded
    _, t = _indexes(embedded, "cosine")
    tracer = t_trace.Tracer(enabled=True)
    prev = t_trace.set_tracer(tracer)
    try:
        svc = GEEQueryService(t, flush_every=1 << 20)
        svc.submit_rows(np.arange(5))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            svc.flush()
    finally:
        t_trace.set_tracer(prev)
    names = [e.name for e in tracer.events()]
    assert names == ["serve.query_repair", "serve.query_flush"]
    assert tracer.events()[1].args["queries"] == 5
    assert "serve.query_flush" in {e.key for e in prof.key_averages()}
    snap = t_metrics.get_registry().snapshot()
    assert snap["counters"][f"{svc.stats.scope}.flushes"] == 1
    assert snap["histograms"][f"{svc.stats.scope}.flush_ms"]["count"] == 1
    svc.close()


@pytest.mark.parametrize("ops", [
    [("inc", "a", 3), ("append", "ms", 2.5), ("append", "ms", 1.0)],
    [("inc", "a", 1), ("set", "a", 7), ("clear", "ms", None)],
    [("append", "ms", float(i)) for i in range(1500)],    # past the cap
])
def test_metrics_copy_matches_reference(ops):
    """The port's copy of the metrics module behaves as the reference's."""
    snaps = []
    for mod in (j_metrics, t_metrics):
        reg = mod.MetricsRegistry()
        view = reg.stats_view("svc", {"a": 0, "ms": [], "nest": {"b": 0}})
        for op, key, val in ops:
            if op == "inc":
                view[key] += val
            elif op == "set":
                view[key] = val
            elif op == "append":
                view[key].append(val)
            else:
                view[key].clear()
        view["nest"]["b"] += 2
        snaps.append((reg.snapshot(), reg.to_prometheus(), view.to_dict()))
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# the embedder and the CLI (the slice as a whole)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_embedder_build_index_and_neighbors(metric):
    s = j_sample_sbm(700, seed=8)
    ts_ = t_sample_sbm(700, seed=8, device="cpu")
    jemb = JEmbedder(num_classes=s.num_classes, backend="sparse_jax").fit(
        s.edges, s.labels)
    temb = GEEEmbedder(num_classes=ts_.num_classes, device="cpu").fit(
        ts_.edges, ts_.labels)
    np.testing.assert_allclose(temb.transform().numpy(),
                               np.asarray(jemb.transform()), atol=TOL)
    assert temb.index is None
    jidx = jemb.build_index(metric=metric)
    tidx = temb.build_index(metric=metric)
    assert temb.index is tidx
    assert (tidx.num_cells, tidx.nprobe, tidx.bucket_capacity) == \
        (jidx.num_cells, jidx.nprobe, jidx.bucket_capacity)
    np.testing.assert_array_equal(tidx._table, jidx._table)
    rows = np.arange(0, 700, 23)
    assert_same_topk(temb.neighbors(rows, 10), jemb.neighbors(rows, 15), 10)
    z = np.asarray(jemb.transform())
    assert_same_topk(temb.neighbors(queries=z[rows], k=8, brute_force=True),
                     jemb.neighbors(queries=z[rows], k=12, brute_force=True),
                     8)
    with pytest.raises(ValueError, match="query_rows"):
        temb.neighbors()
    temb.fit(ts_.edges, ts_.labels)              # a refit drops the index
    assert temb.index is None
    ids, _ = temb.neighbors([3], 4)              # built on first use
    assert temb.index is not None and int(ids[0, 0]) == 3


def test_gee_search_cli_full_probe(tmp_path):
    args = ["--sbm", "600", "--queries", "256", "--nprobe", "3",
            "--recall-sample", "128"]
    port = t_gee_search.main(args + ["--device", "cpu", "--json",
                                     str(tmp_path / "r.json"), "--trace",
                                     str(tmp_path / "t.json"),
                                     "--metrics-out",
                                     str(tmp_path / "m.json")])
    want = j_gee_search.main(args)
    assert port["recall_at_k"] == want["recall_at_k"] == 1.0
    assert set(want) <= set(port) and port["device"] == "cpu"
    for key in ("graph", "nodes", "num_cells", "nprobe", "metric", "k"):
        assert port[key] == want[key], key
    for key in ("submitted", "flushes", "queries_scored", "pad_queries"):
        assert port["service_stats"][key] == want["service_stats"][key]
    assert (tmp_path / "r.json").exists() and (tmp_path / "t.json").exists()
    assert (tmp_path / "m.json").exists()
    t_trace.disable()


def test_gee_search_cli_refuses_unported_input(tmp_path):
    # edge files are ported now (tests/test_torch_leftovers.py runs one);
    # what is still refused is a file no reader takes
    path = tmp_path / "g.csv"
    path.write_text("0 1\n")
    np.save(str(path) + ".labels.npy", np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="unsupported edge-file suffix"):
        t_gee_search.main(["--edge-file", str(path), "--device", "cpu"])


def test_datasets_load(tmp_path):
    got = tdatasets.load("citeseer", seed=3, device="cpu")
    want = jdatasets.load("citeseer", seed=3)
    assert got.spec.name == want.spec.name == "citeseer"
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.edges.src.numpy(),
                                  np.asarray(want.edges.src))
    np.testing.assert_array_equal(got.edges.dst.numpy(),
                                  np.asarray(want.edges.dst))
    # an edge-file path loads through the ported reader now
    path = str(tmp_path / "big.geeb")
    tdatasets.synth_to_disk(tdatasets.DatasetSpec("big", 50, 120, 3), path)
    got = tdatasets.load(path, device="cpu")
    want = jdatasets.load(path)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.edges.src.numpy(),
                                  np.asarray(want.edges.src))
    with pytest.raises(FileNotFoundError):
        tdatasets.load(str(tmp_path / "missing.geeb"), device="cpu")
    with pytest.raises(KeyError, match="unknown dataset"):
        tdatasets.load("nope", device="cpu")
