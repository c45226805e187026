"""The main path's leftovers in the port -- ``finalize``, the dense oracle
``gee_dense_torch``, ``node_features``, the encoder ensemble and the
``gee_run`` / ``gee_search`` CLIs on edge files -- held against the JAX
reference on the CPU, with inputs made from a numpy seed.

``gee_cluster`` draws its restarts with ``jax.random`` in the reference and
from a ``torch.Generator`` in the port, so the two are compared through one
replicate fed the same initial labels (equal labels and iterations) and
through the reference's own recovery bound (ARI > 0.8).
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import ensemble as jens
from repro.core import epilogue as jepi
from repro.graph.containers import edge_list_from_numpy as j_edge_list
from repro.graph.sbm import sample_sbm as j_sample_sbm

from repro_torch.core import ensemble as tens
from repro_torch.core import epilogue as tepi
from repro_torch.core.api import GEEEmbedder, node_features
from repro_torch.core.gee import (ALL_OPTION_SETTINGS, GEEOptions,
                                  gee_dense_torch, weight_matrix_dense)
from repro_torch.core.plan import GEEPlan, PreparedGraph
from repro_torch.graph.containers import edge_list_from_numpy, to_dense
from repro_torch.graph.datasets import DatasetSpec, load, synth_to_disk
from repro_torch.graph.sbm import sample_sbm
from repro_torch.launch import gee_run, gee_search

jgee = importlib.import_module("repro.core.gee")
jds = importlib.import_module("repro.graph.datasets")

RTOL = ATOL = 1e-5
OPT_IDS = [o.tag() for o in ALL_OPTION_SETTINGS]
DEFAULT = GEEOptions(laplacian=True, diag_aug=True, correlation=True)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


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


def _weighted(seed=0, n=30, e=90, k=4):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)                 # duplicates and self loops
    w = (rng.random(e) + 0.1).astype(np.float32)
    labels = rng.integers(0, k, n).astype(np.int32)
    labels[rng.random(n) < 0.2] = -1
    labels[labels == 2] = 1                     # class 2 stays empty
    return src, dst, w, labels, n, k


@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_finalize_matches_reference(opts):
    rng = np.random.default_rng(1)
    n, k = 25, 4
    z = rng.standard_normal(n * k).astype(np.float32)
    z[:k] = 0.0                                 # a zero row stays zero
    labels = rng.integers(-1, k, n).astype(np.int32)
    winv = rng.random(k).astype(np.float32)
    dinv = rng.random(n).astype(np.float32)
    want = jepi.finalize(jnp.asarray(z), jnp.asarray(labels),
                         jnp.asarray(winv), jnp.asarray(dinv),
                         num_classes=k, opts=_jopts(opts))
    for impl in ("torch", "auto", "cuda"):      # cuda: the plain version
        got = tepi.finalize(torch.from_numpy(z), torch.from_numpy(labels),
                            torch.from_numpy(winv), torch.from_numpy(dinv),
                            num_classes=k, opts=opts, impl=impl)
        assert got.shape == (n, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        assert not got[0].any()


@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_dense_oracle_matches_reference(opts):
    src, dst, w, labels, n, k = _weighted(2)
    tedges = edge_list_from_numpy(src, dst, w, n, pad_to=128, device="cpu")
    jedges = j_edge_list(src, dst, w, n, pad_to=128)
    want = np.asarray(jgee.gee_dense_jax(jedges, jnp.asarray(labels), k,
                                         _jopts(opts)))
    got = gee_dense_torch(tedges, labels, k, opts)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    plan = GEEPlan.build(tedges, k, opts, backend="dense_torch")
    assert [s.name for s in plan.stages] == ["dense_matmul"]
    np.testing.assert_allclose(plan.execute(labels).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        to_dense(tedges).numpy(),
        np.asarray(importlib.import_module(
            "repro.graph.containers").to_dense(jedges)), rtol=0, atol=0)
    np.testing.assert_allclose(
        weight_matrix_dense(torch.from_numpy(labels), k).numpy(),
        np.asarray(jgee.weight_matrix_dense(jnp.asarray(labels), k)),
        rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["sparse_torch", "cuda", "chunked"])
def test_node_features_matches_reference(backend):
    s = sample_sbm(300, seed=4, device="cpu")
    j = j_sample_sbm(300, seed=4)
    want = np.asarray(japi.node_features(j.edges, j.labels, j.num_classes))
    got = node_features(s.edges, s.labels, s.num_classes, backend=backend,
                        device="cpu")
    assert got.device.type == "cpu"
    assert_rows(got.numpy(), want)
    opts = GEEOptions(laplacian=True)
    assert_rows(node_features(PreparedGraph(s.edges), s.labels,
                              s.num_classes, opts, device="cpu").numpy(),
                np.asarray(japi.node_features(j.edges, j.labels,
                                              j.num_classes, _jopts(opts))))


@pytest.mark.parametrize("opts", [DEFAULT, GEEOptions(correlation=True),
                                  GEEOptions()], ids=lambda o: o.tag())
def test_cluster_once_matches_reference_from_the_same_start(opts):
    s = sample_sbm(400, p_within=0.2, p_between=0.03, seed=5, device="cpu")
    j = j_sample_sbm(400, p_within=0.2, p_between=0.03, seed=5)
    init = np.random.default_rng(6).integers(0, 3, 400).astype(np.int32)
    want = jens.gee_cluster_once(j.edges, jnp.asarray(init), 3, 30,
                                 _jopts(opts))
    got = tens.gee_cluster_once(s.edges, init, 3, 30, opts)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert int(got.iters) == int(want.iters) > 1
    assert_rows(got.embedding.numpy(), np.asarray(want.embedding))
    np.testing.assert_allclose(float(got.score), float(want.score),
                               rtol=1e-4)
    # a PreparedGraph shared with the caller keeps its prep
    prep = PreparedGraph(s.edges)
    again = tens.gee_cluster_once(prep, init, 3, 30, opts)
    np.testing.assert_array_equal(again.labels.numpy(), got.labels.numpy())
    assert prep.is_cached(("eff", opts.diag_aug, opts.laplacian))


def test_cluster_recovers_easy_sbm():
    """The reference's own bound
    (``tests/test_ensemble_api.py::test_cluster_recovers_easy_sbm``), with
    restarts from a seeded ``torch.Generator``."""
    s = sample_sbm(800, p_within=0.20, p_between=0.02, seed=3, device="cpu")
    res = tens.gee_cluster(s.edges, 3, replicates=3,
                           generator=torch.Generator().manual_seed(0))
    ari = tens.adjusted_rand_index(res.labels.numpy(), s.labels)
    assert ari > 0.8, ari
    again = tens.gee_cluster(s.edges, 3, replicates=3, seed=0)
    np.testing.assert_array_equal(again.labels.numpy(), res.labels.numpy())
    with pytest.raises(ValueError, match="replicates"):
        tens.gee_cluster(s.edges, 3, replicates=0)


def test_adjusted_rand_index_matches_reference():
    rng = np.random.default_rng(7)
    for _ in range(20):
        n = int(rng.integers(2, 60))
        a = rng.integers(0, int(rng.integers(1, 6)), n)
        b = rng.integers(0, int(rng.integers(1, 6)), n)
        assert tens.adjusted_rand_index(a, b) == \
            jens.adjusted_rand_index(a, b)
        assert tens.adjusted_rand_index(a, a) == 1.0


def test_embedder_file_surface(tmp_path):
    path = str(tmp_path / "g.geeb")
    synth_to_disk(DatasetSpec("g", 200, 1500, 3), path, seed=1,
                  chunk_edges=400)
    jpath = str(tmp_path / "j.geeb")
    jds.synth_to_disk(jds.DatasetSpec("g", 200, 1500, 3), jpath, seed=1,
                      chunk_edges=400)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()             # the same rng calls
    emb = GEEEmbedder(num_classes=3, device="cpu", chunk_edges=333)
    z = emb.fit_transform_file(path)
    jemb = japi.GEEEmbedder(num_classes=3, chunk_edges=333)
    assert_rows(z.numpy(), np.asarray(jemb.fit_transform_file(jpath)))
    assert emb.prepared is None and emb._num_nodes() == 200
    np.testing.assert_array_equal(emb.predict().numpy(),
                                  np.asarray(jemb.predict()))
    cur = emb.current_edges()
    assert cur.num_edges == 3000 and cur.device.type == "cpu"
    ds = load(path, device="cpu")
    jds_ = jds.load(jpath)
    assert dataclasses.astuple(ds.spec) == ("g", 200, 1500, 3)
    assert dataclasses.astuple(jds_.spec) == ("j", 200, 1500, 3)
    np.testing.assert_array_equal(ds.edges.src.numpy(),
                                  np.asarray(jds_.edges.src))
    ids, _ = emb.neighbors([0, 5], k=4)
    assert ids.shape == (2, 4) and [int(i) for i in ids[:, 0]] == [0, 5]
    with pytest.raises(RuntimeError, match="in-memory path"):
        emb.partial_fit(None)
    os.remove(path + ".labels.npy")
    with pytest.raises(ValueError, match="no labels given"):
        GEEEmbedder(num_classes=3, device="cpu").fit_file(path)
    emb.fit(ds.edges, ds.labels)                # back to in memory
    assert emb.prepared is not None and emb.current_edges() is ds.edges


def test_gee_run_and_search_on_edge_files(tmp_path, capsys):
    path = str(tmp_path / "g.geeb")
    synth_to_disk(DatasetSpec("g", 300, 2500, 4), path, seed=2,
                  chunk_edges=1000)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gee_run", "--edge-file",
         path, "--chunk-edges", "777", "--lap", "--diag", "--cor",
         "--verify", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr
    assert "0 entries off the row tolerance: ok" in proc.stdout
    assert "windows=4x777" in proc.stdout
    report = gee_search.main(["--edge-file", path, "--chunk-edges", "500",
                              "--device", "cpu", "--queries", "128",
                              "--nprobe", "4", "--recall-sample", "64"])
    assert report["nodes"] == 300 and report["recall_at_k"] == 1.0
    assert gee_run.main(["--edge-file", path, "--prefetch-windows", "0",
                         "--device", "cpu"]) == 0
    assert gee_run.main(["--sbm", "300", "--backend", "chunked", "--plan",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "chunk_manifest" in out and "prefetch=2" in out
    # the multi-device fold in a world of one (no process group)
    assert gee_run.main(["--edge-file", path, "--backend",
                         "streamed_sharded", "--verify",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "streamed x1" in out and "0 entries off the row tolerance: ok" \
        in out
    with pytest.raises(SystemExit, match="labels sidecar"):
        os.remove(path + ".labels.npy")
        gee_search.main(["--edge-file", path, "--device", "cpu"])
