"""The port's main path -- ``GEEEmbedder`` on the ``cuda`` backend, fused and
staged -- held against the JAX reference on the CPU (where the kernel
wrappers take their plain versions): the JAX ``pallas`` plan (kernels in
interpret mode) and ``gee_scipy`` under all 8 option settings.  Also the
plan layer's choices, the staged drivers' refusal of ``diag_aug`` and the
``convert`` hand-over of the reference's artifacts.

The reference's staged ``gee_pallas_from_bucketed`` ignores ``diag_aug``
(fault R1 in ROADMAP.md), so nothing here compares against it with diag-aug
on: the JAX side runs through ``GEEPlan``, which packs the augmented graph.
"""

import importlib

import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.graph import ell as jell
from repro.graph.sbm import sample_sbm as j_sample_sbm

from repro_torch import convert
from repro_torch.core import gee as tgee
from repro_torch.core.api import GEEEmbedder
from repro_torch.core.plan import (KNOWN_BACKENDS, GEEPlan, PreparedGraph,
                                   estimate_working_set_bytes, select_backend,
                                   select_fused, sweep_options)
from repro_torch.graph import ell as tell
from repro_torch.graph.sbm import sample_sbm as t_sample_sbm
from repro_torch.kernels import gee_fused, ops

# ``repro.core`` re-exports the function ``gee`` under the module's name
jgee = importlib.import_module("repro.core.gee")

ATOL = 1e-5
OPT_IDS = [o.tag() for o in tgee.ALL_OPTION_SETTINGS]
DEFAULT = tgee.GEEOptions(laplacian=True, diag_aug=True, correlation=True)


def _jopts(o):
    return jgee.GEEOptions(laplacian=o.laplacian, diag_aug=o.diag_aug,
                           correlation=o.correlation)


@pytest.fixture(scope="module")
def graphs():
    """One SBM graph in both packages (same seed -> same edges), plus a
    graph with isolated labelled vertices (degree-0 rows in no bucket) and
    -1 labels."""
    ref, port = j_sample_sbm(64, seed=3), t_sample_sbm(64, seed=3,
                                                      device="cpu")
    labels = port.labels.copy()
    labels[::9] = -1
    src = np.array([0, 1, 2, 3, 3])
    dst = np.array([1, 2, 3, 4, 0])
    iso = PreparedGraph.from_arrays(src, dst, None, num_nodes=9,
                                    device="cpu")
    iso_labels = np.array([0, 1, 2, 0, -1, 1, 2, 0, -1], np.int32)
    return ref, port, labels, iso, iso_labels


EMPTY = (np.zeros(0, np.int64), np.zeros(0, np.int64))   # n=1, E=0


def _embed(edges, labels, k, opts, fused, monkeypatch):
    monkeypatch.setenv(gee_fused.ENV_FUSED, "1" if fused else "0")
    emb = GEEEmbedder(num_classes=k, options=opts, backend="cuda",
                      device="cpu")
    z = emb.fit_transform(edges, labels)
    assert GEEPlan.build(emb.prepared, k, opts, backend="cuda").fused is fused
    assert z.shape == (edges.num_nodes, k) and z.device.type == "cpu"
    return z.numpy()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("opts", [DEFAULT, tgee.GEEOptions(laplacian=True)],
                         ids=lambda o: o.tag())
def test_cuda_backend_matches_jax_pallas_plan(graphs, fused, opts,
                                              monkeypatch):
    ref, port, labels, _, _ = graphs
    got = _embed(port.edges, labels, 3, opts, fused, monkeypatch)
    # the same override routes the reference's plan (interpret mode here)
    plan = jplan.GEEPlan.build(ref.edges, 3, _jopts(opts), backend="pallas")
    assert plan.fused is fused
    np.testing.assert_allclose(got, np.asarray(plan.execute(labels)),
                               atol=ATOL)


@pytest.mark.parametrize("opts", tgee.ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_cuda_backend_matches_scipy_all_settings(graphs, opts, monkeypatch):
    _, port, labels, iso, iso_labels = graphs
    empty = PreparedGraph.from_arrays(*EMPTY, num_nodes=1, device="cpu")
    for edges, y, k in ((port.edges, labels, 3), (iso.base, iso_labels, 3),
                        (empty.base, np.array([0], np.int32), 1)):
        s, d, w = edges.valid_arrays()
        want = jgee.gee_scipy(s, d, w, y, k, _jopts(opts),
                              num_nodes=edges.num_nodes)
        for fused in (True, False):
            np.testing.assert_allclose(
                _embed(edges, y, k, opts, fused, monkeypatch), want,
                atol=ATOL, err_msg=f"fused={fused}")


def test_staged_drivers_refuse_diag_aug(graphs):
    _, port, labels, _, _ = graphs
    bell = tell.edges_to_bucketed_ell(port.edges)
    with pytest.raises(ValueError, match="diag_aug"):
        ops.gee_cuda_from_bucketed(bell, labels, 3, DEFAULT)
    with pytest.raises(ValueError, match="diag_aug"):
        ops.gee_cuda_from_ell(tell.edges_to_ell(port.edges), labels, 3,
                              DEFAULT)


@pytest.mark.parametrize("opts", tgee.ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_flat_and_end_to_end_drivers(graphs, opts):
    _, port, labels, _, _ = graphs
    want = tgee.gee_sparse_torch(port.edges, labels, 3, opts).numpy()
    for bucketed in (True, False):
        np.testing.assert_allclose(
            ops.gee_cuda(port.edges, labels, 3, opts,
                         bucketed=bucketed).numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        gee_fused.gee_fused_from_ell(tell.edges_to_ell(port.edges), labels,
                                     3, opts).numpy(), want, atol=ATOL)


def test_convert_hands_over_reference_artifacts(graphs):
    ref, port, labels, _, _ = graphs
    e = ref.edges
    edges = convert.edge_list_from_reference(
        np.asarray(e.src), np.asarray(e.dst), np.asarray(e.weight),
        e.num_nodes, e.num_edges, device="cpu")
    rb = jell.edges_to_bucketed_ell(e)
    bell = convert.bucketed_ell_from_reference(
        [(np.asarray(b.cols), np.asarray(b.vals), np.asarray(b.row_ids),
          b.num_rows, b.width) for b in rb.buckets], rb.num_nodes,
        device="cpu")
    own = GEEEmbedder(num_classes=3, backend="cuda", device="cpu")
    want = own.fit_transform(port.edges, labels).numpy()
    np.testing.assert_array_equal(
        GEEEmbedder(num_classes=3, backend="cuda",
                    device="cpu").fit_transform(edges, labels).numpy(), want)
    for opts in (DEFAULT, tgee.GEEOptions(correlation=True)):
        np.testing.assert_allclose(
            gee_fused.gee_fused_from_bucketed(bell, labels, 3, opts).numpy(),
            tgee.gee_sparse_torch(port.edges, labels, 3, opts).numpy(),
            atol=ATOL)
    with pytest.raises(ValueError, match="num_edges"):
        convert.edge_list_from_reference([0], [1], [1.0], 2, 3, device="cpu")


def test_backend_selection(monkeypatch):
    g = PreparedGraph.from_arrays([0, 1], [1, 2], None, device="cpu")
    assert select_backend(g, 3) == "sparse_torch"            # on the CPU
    assert select_backend(g, 3, device="cuda") == "cuda"
    assert select_backend(g, 64, device="cuda") == "cuda"
    # past the fused kernel's cap the card keeps the staged kernels
    big = gee_fused.MAX_CLASSES + 1
    assert select_backend(g, big, device="cuda") == "cuda"
    assert not select_fused("cuda", DEFAULT, device="cuda", num_classes=big)
    monkeypatch.setenv(gee_fused.ENV_FUSED, "1")       # the cap still holds
    plan = GEEPlan.build(g, big, DEFAULT, backend="cuda")
    assert plan.fused is False
    np.testing.assert_allclose(
        plan.execute([0, 1, 1]).numpy(),
        tgee.gee_sparse_torch(g.base, [0, 1, 1], big, DEFAULT).numpy(),
        atol=ATOL)
    monkeypatch.delenv(gee_fused.ENV_FUSED)
    assert estimate_working_set_bytes(g, 3, backend="cuda") > \
        estimate_working_set_bytes(g, 3)
    assert GEEPlan.build(g, 3).backend == "sparse_torch"
    # past the memory budget the card streams too
    assert select_backend(g, 3, device="cuda", budget_bytes=1) == "chunked"
    # past the budget across ranks: streamed_sharded (never distributed)
    assert select_backend(g, 3, device="cuda", budget_bytes=1,
                          num_devices=4) == "streamed_sharded"
    for name in ("streamed_sharded", "distributed"):
        assert GEEPlan.build(g, 3, backend=name).backend == name
    with pytest.raises(ValueError, match="is not one of"):
        GEEPlan.build(g, 3, backend="pallas")
    assert KNOWN_BACKENDS == ("sparse_torch", "cuda", "chunked",
                              "streamed_sharded", "distributed",
                              "dense_torch", "scipy", "python_loop")


def test_select_fused(monkeypatch):
    monkeypatch.delenv(gee_fused.ENV_FUSED, raising=False)
    assert select_fused("cuda", DEFAULT, device="cuda")
    assert select_fused("cuda", tgee.GEEOptions(correlation=True))
    assert not select_fused("cuda", tgee.GEEOptions(laplacian=True),
                            device="cuda")
    assert not select_fused("cuda", DEFAULT, device="cpu")
    assert not select_fused("sparse_torch", DEFAULT, device="cuda")
    monkeypatch.setenv(gee_fused.ENV_FUSED, "1")
    assert select_fused("cuda", tgee.GEEOptions(), device="cpu")
    assert not select_fused("sparse_torch", DEFAULT)
    monkeypatch.setenv(gee_fused.ENV_FUSED, "0")
    assert not select_fused("cuda", DEFAULT, device="cuda")
    assert gee_fused.fused_override() is False


def test_plan_stages_cache_and_sweep(graphs, monkeypatch):
    monkeypatch.delenv(gee_fused.ENV_FUSED, raising=False)
    _, port, labels, _, _ = graphs
    prep = PreparedGraph(port.edges)
    staged = GEEPlan.build(prep, 3, DEFAULT, backend="cuda")
    assert not staged.fused
    assert [s.name for s in staged.stages] == \
        ["bucketed_ell", "gee_spmm", "row_l2_normalize"]
    fused = GEEPlan.build(prep, 3, DEFAULT, backend="cuda", fused=True)
    assert [s.name for s in fused.stages] == ["bucketed_ell",
                                              "gee_spmm_fused"]
    z1 = fused.execute(labels)
    assert prep.is_cached(("bucketed_ell", False))
    misses = prep.cache_info()["misses"]
    z2 = fused.execute(labels)
    assert prep.cache_info()["misses"] == misses        # packing reused
    torch.testing.assert_close(z1, z2, rtol=0, atol=0)
    assert "gee_spmm_fused" in fused.describe()
    host = GEEPlan.build(prep, 3, DEFAULT, backend="scipy")
    assert [s.name for s in host.stages] == ["host_arrays", "scipy"]
    zs = sweep_options(prep, labels, 3, backend="cuda")
    assert len(zs) == 8
    for opts, z in zs.items():
        np.testing.assert_allclose(
            z.numpy(), tgee.gee(prep, labels, 3, opts,
                                backend="python_loop").numpy(), atol=ATOL)


def test_embedder_predict_and_class_means_match_reference(graphs):
    from repro.core.api import GEEEmbedder as JEmbedder

    ref, port, labels, _, _ = graphs
    mine = GEEEmbedder(num_classes=4, backend="cuda", device="cpu").fit(
        port.edges, labels)
    theirs = JEmbedder(num_classes=4, backend="sparse_jax").fit(ref.edges,
                                                                labels)
    np.testing.assert_allclose(mine.class_means().numpy(),
                               np.asarray(theirs.class_means()), atol=ATOL)
    np.testing.assert_array_equal(mine.predict().numpy(),
                                  np.asarray(theirs.predict()))
    np.testing.assert_array_equal(mine.predict([3]).numpy(),
                                  np.asarray(theirs.predict([3])))
    emb = GEEEmbedder.from_arrays([0, 1, 3, 4], [1, 2, 4, 5], None,
                                  np.array([0, 0, 0, 1, 1, 1], np.int32),
                                  num_classes=2, device="cpu")
    assert emb.predict().tolist() == [0, 0, 0, 1, 1, 1]
    with pytest.raises(RuntimeError, match="fit"):
        GEEEmbedder(num_classes=2, device="cpu").transform()
