"""The port's edge partitioning (``repro_torch.graph.partition``) held
against the reference's (``repro/graph/partition.py``) on the CPU.

Every output here is integer or a copied weight, so the tolerance is none:
``shard_edges``, ``shard_edges_to_ell`` and ``stable_plane_width`` must
equal the reference's bit for bit, for P in {1, 2, 3, 4, 8}, on graphs with
duplicate edges, self loops, an isolated row and a hub.
"""

import numpy as np
import pytest
import torch

from repro.graph import partition as jpart
from repro.graph.containers import edge_list_from_numpy as j_edge_list

from repro_torch.graph import partition as tpart
from repro_torch.graph.containers import edge_list_from_numpy
from repro_torch.obs import trace as t_trace

SHARDS = (1, 2, 3, 4, 8)


def _graph(kind: str):
    """(src, dst, weight, n) of one of the test graphs, from a numpy seed."""
    rng = np.random.default_rng({"dup": 1, "loops": 2, "isolated": 3,
                                 "hub": 4}[kind])
    n, e = 37, 211
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) + 0.25).astype(np.float32)
    if kind == "dup":                  # the first 40 entries again
        src, dst = np.concatenate([src, src[:40]]), np.concatenate(
            [dst, dst[:40]])
        w = np.concatenate([w, w[:40]])
    elif kind == "loops":              # every fifth entry a self loop
        dst[::5] = src[::5]
    elif kind == "isolated":           # row 7 has no edge either way
        src[src == 7], dst[dst == 7] = 8, 9
    else:                              # row 0 holds half the entries
        src[: e // 2] = 0
    w[3] = 0.0                         # a zero weight is padding
    return src, dst, w, n


def _both(kind: str):
    src, dst, w, n = _graph(kind)
    return (edge_list_from_numpy(src, dst, w, n, device="cpu"),
            j_edge_list(src, dst, w, n))


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("kind", ["dup", "loops", "isolated", "hub"])
def test_partition_equals_reference(kind, p):
    te, je = _both(kind)
    got = tpart.shard_edges(te, p, device="cpu")
    want = jpart.shard_edges(je, p)
    assert (got.num_edges, got.padded_size) == (want.num_edges,
                                                int(want.src.shape[0]))
    assert got.padded_size % (p * 8) == 0
    for a, b in ((got.src, want.src), (got.dst, want.dst),
                 (got.weight, want.weight)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    n_pad = -(-te.num_nodes // p) * p
    cols, vals = tpart.shard_edges_to_ell(te, p, n_pad, device="cpu")
    jcols, jvals = jpart.shard_edges_to_ell(je, p, num_rows=n_pad)
    assert cols.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    # one rank's plane alone is its block of the stacked planes
    for r in range(p):
        c, v = tpart.shard_plane(te, p, r, n_pad, device="cpu")
        np.testing.assert_array_equal(c.numpy(),
                                      cols[r * n_pad:(r + 1) * n_pad])
        np.testing.assert_array_equal(v.numpy(),
                                      vals[r * n_pad:(r + 1) * n_pad])


@pytest.mark.parametrize("kind", ["dup", "hub"])
def test_pinned_width(kind):
    """A pinned width packs at that width as the reference does; one too
    small for the densest row raises in both packages."""
    te, je = _both(kind)
    src, _, w, n = _graph(kind)
    maxdeg = int(np.bincount(src[w != 0], minlength=n).max())
    for p in SHARDS:
        width = tpart.stable_plane_width(maxdeg, p)
        assert width == jpart.stable_plane_width(maxdeg, p)
        cols, vals = tpart.shard_edges_to_ell(te, p, n, width=width,
                                              device="cpu")
        jcols, jvals = jpart.shard_edges_to_ell(je, p, num_rows=n,
                                                width=width)
        assert cols.shape == (p * n, width)
        np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        need = -(-maxdeg // p)
        for fn in (lambda: tpart.shard_edges_to_ell(te, p, n, width=need - 1,
                                                    device="cpu"),
                   lambda: tpart.shard_plane(te, p, 0, n, width=need - 1,
                                             device="cpu"),
                   lambda: jpart.shard_edges_to_ell(je, p, num_rows=n,
                                                    width=need - 1)):
            with pytest.raises(ValueError, match="cannot hold the densest"):
                fn()
    with pytest.raises(ValueError, match="out of range"):
        tpart.shard_plane(te, 2, 2, n, device="cpu")


def test_stable_plane_width_equals_reference():
    for deg in (0, 1, 7, 8, 9, 100, 1023, 1024, 1025, 65_536):
        for p in SHARDS + (128,):
            assert tpart.stable_plane_width(deg, p) == \
                jpart.stable_plane_width(deg, p)
    assert tpart.stable_plane_width(100, 4, base=2) == 32


def test_pack_span_and_empty_graph():
    """The packer emits the reference's ``pack.shard_ell`` span with its
    width; an edgeless graph packs at width 1 (all padding)."""
    tracer = t_trace.Tracer(enabled=True)
    prev = t_trace.set_tracer(tracer)
    try:
        te, _ = _both("hub")
        cols, _ = tpart.shard_edges_to_ell(te, 4, 40, device="cpu")
        ev = [e for e in tracer.events() if e.name == "pack.shard_ell"]
        assert ev and ev[-1].args["width"] == cols.shape[1]
        assert ev[-1].args["shards"] == 4
    finally:
        t_trace.set_tracer(prev)
    empty = edge_list_from_numpy(np.empty(0, np.int32), np.empty(0, np.int32),
                                 None, 5, device="cpu")
    cols, vals = tpart.shard_edges_to_ell(empty, 2, 6, device="cpu")
    assert cols.shape == (12, 1) and not vals.any()
    jcols, _ = jpart.shard_edges_to_ell(
        j_edge_list(np.empty(0, np.int32), np.empty(0, np.int32), None, 5),
        2, num_rows=6)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    sh = tpart.shard_edges(empty, 3, device="cpu")
    assert (sh.num_edges, sh.padded_size) == (0, 0)


def test_partition_defaults_to_the_card():
    """No device given means the card: without one, the packers raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    te, _ = _both("dup")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpart.shard_edges_to_ell(te, 2, 38)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpart.shard_edges(te, 2)
