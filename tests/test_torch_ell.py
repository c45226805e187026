"""ELL packing and the graph generators held against the JAX reference:
the packings must be identical arrays, and one seed must give one graph in
both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import containers as jcont
from repro.graph import datasets as jds
from repro.graph import ell as jell
from repro.graph.sbm import sample_sbm as j_sample_sbm

from repro_torch.graph import containers as tcont
from repro_torch.graph import datasets as tds
from repro_torch.graph import ell as tell
from repro_torch.graph.sbm import sample_sbm as t_sample_sbm

SMALL_SPEC = ("small-skewed", 300, 2_000, 4)


def _graphs():
    """(name, reference EdgeList, port EdgeList) over the packers' corners:
    SBM, a skewed power-law stand-in, isolated vertices + a hub + self loops
    + a padded tail, and the n=1, E=0 graph."""
    rng = np.random.default_rng(3)
    src = np.concatenate([rng.integers(0, 20, 50), np.zeros(40, np.int64),
                          [5, 6]])
    dst = np.concatenate([rng.integers(0, 20, 50), rng.integers(1, 25, 40),
                          [5, 6]])
    w = rng.uniform(0.2, 2.0, src.shape[0]).astype(np.float32)
    hub_ref = jcont.symmetrize(
        jcont.edge_list_from_numpy(src, dst, w, 30)).with_padding(64)
    hub_port = tcont.symmetrize(tcont.edge_list_from_numpy(
        src, dst, w, 30, device="cpu")).with_padding(64)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), None, 1)
    spec_j, spec_t = jds.DatasetSpec(*SMALL_SPEC), tds.DatasetSpec(*SMALL_SPEC)
    return [
        ("sbm", j_sample_sbm(200, seed=4).edges,
         t_sample_sbm(200, seed=4, device="cpu").edges),
        ("skewed", jds.synth_like(spec_j, seed=5).edges,
         tds.synth_like(spec_t, seed=5, device="cpu").edges),
        ("hub_loops_padded", hub_ref, hub_port),
        ("n1_e0", jcont.edge_list_from_numpy(*empty),
         tcont.edge_list_from_numpy(*empty, device="cpu")),
    ]


GRAPHS = {name: (r, p) for name, r, p in _graphs()}


def _eq(a, b):
    np.testing.assert_array_equal(
        a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
        np.asarray(b))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("diag_aug", [False, True])
def test_bucketed_packing_identical(name, diag_aug):
    ref, port = GRAPHS[name]
    if diag_aug:
        ref, port = jcont.add_self_loops(ref), tcont.add_self_loops(port)
    rb, pb = jell.edges_to_bucketed_ell(ref), tell.edges_to_bucketed_ell(port)
    assert pb.num_nodes == rb.num_nodes
    assert [b.width for b in pb.buckets] == [b.width for b in rb.buckets]
    assert [b.num_rows for b in pb.buckets] == \
        [b.num_rows for b in rb.buckets]
    for b_port, b_ref in zip(pb.buckets, rb.buckets):
        _eq(b_port.cols, b_ref.cols)
        _eq(b_port.vals, b_ref.vals)
        _eq(b_port.row_ids, b_ref.row_ids)
        assert b_port.cols.dtype == torch.int32
        assert b_port.row_ids.dtype == torch.int32
    assert pb.total_slots == rb.total_slots


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_flat_packing_and_stats_identical(name):
    ref, port = GRAPHS[name]
    re_, pe = jell.edges_to_ell(ref), tell.edges_to_ell(port)
    assert pe.num_nodes == re_.num_nodes
    _eq(pe.cols, re_.cols)
    _eq(pe.vals, re_.vals)
    assert tell.ell_stats(port) == jell.ell_stats(ref)


@pytest.mark.parametrize("name", ["hub_loops_padded", "n1_e0"])
def test_ell_planes_identical(name):
    ref, port = GRAPHS[name]
    n = ref.num_nodes
    labels = np.random.default_rng(n).integers(-1, 4, n).astype(np.int32)
    winv = np.random.default_rng(1).uniform(0, 1, 4).astype(np.float32)
    # the flat plane plus the buckets: -1 labels, padding slots, the
    # clipped dump-row neighbours of row padding
    ref_planes = [jell.edges_to_ell(ref)] + list(
        jell.edges_to_bucketed_ell(ref).buckets)
    port_planes = [tell.edges_to_ell(port)] + list(
        tell.edges_to_bucketed_ell(port).buckets)
    for rb, pb in zip(ref_planes, port_planes):
        jy, jc = jell.ell_planes(rb.cols, rb.vals, jnp.asarray(labels),
                                 jnp.asarray(winv))
        ty, tc = tell.ell_planes(pb.cols, pb.vals, torch.from_numpy(labels),
                                 torch.from_numpy(winv))
        _eq(ty, jy)
        _eq(tc, jc)
        assert ty.dtype == torch.int32 and tc.dtype == torch.float32


def test_width_ladder_and_explicit_widths():
    for d in (1, 8, 9, 100, 65_536):
        assert tell.bucket_widths(d) == jell.bucket_widths(d)
    ref, port = GRAPHS["skewed"]
    rb = jell.edges_to_bucketed_ell(ref, widths=(16, 64, 4096))
    pb = tell.edges_to_bucketed_ell(port, widths=(16, 64, 4096))
    assert [b.width for b in pb.buckets] == [b.width for b in rb.buckets]
    with pytest.raises(ValueError, match="do not cover"):
        tell.edges_to_bucketed_ell(port, widths=(8,))


def test_packing_lands_on_requested_device():
    _, port = GRAPHS["sbm"]
    pb = tell.edges_to_bucketed_ell(port, device="cpu")
    assert all(b.cols.device.type == "cpu" for b in pb.buckets)


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_sbm_same_graph_as_reference(seed):
    ref, port = j_sample_sbm(250, seed=seed), t_sample_sbm(250, seed=seed,
                                                           device="cpu")
    _eq(port.labels, ref.labels)
    assert port.num_classes == ref.num_classes
    assert port.edges.num_edges == ref.edges.num_edges
    for a, b in zip(port.edges.valid_arrays(), ref.edges.valid_arrays()):
        _eq(a, b)


@pytest.mark.parametrize("seed", [0, 2])
def test_synth_like_same_graph_as_reference(seed):
    ref = jds.synth_like(jds.DatasetSpec(*SMALL_SPEC), seed=seed, pad_to=5000)
    port = tds.synth_like(tds.DatasetSpec(*SMALL_SPEC), seed=seed,
                          pad_to=5000, device="cpu")
    _eq(port.labels, ref.labels)
    assert port.edges.padded_size == ref.edges.padded_size == 5000
    for name in ("src", "dst", "weight"):
        _eq(getattr(port.edges, name), getattr(ref.edges, name))


def test_table2_mirrors_reference():
    assert {k: (s.num_nodes, s.num_edges, s.num_classes)
            for k, s in tds.TABLE2.items()} == \
        {k: (s.num_nodes, s.num_edges, s.num_classes)
         for k, s in jds.TABLE2.items()}
    assert tds.TABLE2["cora"].density == jds.TABLE2["cora"].density
