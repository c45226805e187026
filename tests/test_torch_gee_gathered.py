"""The gathered launch (``gee_spmm_gathered``) and the bucketed drivers that
make one a bucket.

* The wrapper's plain version equals, bit for bit, the plane composition it
  stands for -- ``laplacian_vals``, ``ell_planes``, ``diag_addend``, then
  ``gee_spmm_fused`` -- scattered into Z, under all 8 option settings, on a
  power-law graph whose buckets hold padding rows and padding slots, with
  degree-0 rows and unlabeled vertices; it writes its bucket's rows of Z in
  place and leaves every other row as it was.
* Both drivers equal, bit for bit, the plane drivers they replace (the
  per-bucket passes, the scatter back, the covered mask and ``where``).
* The launch counts and the registry counters of gathered and plane
  contractions count what ran.

The CUDA kernel runs only on the card: ``chip_smoke.py`` holds it against
the plane kernel there with ``torch.equal``.  The drivers' agreement with
``gee_scipy`` and the JAX reference is ``tests/test_torch_gee_split.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.epilogue import (apply_epilogue, inv_sqrt_degrees,
                                       row_l2_normalize)
from repro_torch.core.gee import ALL_OPTION_SETTINGS, class_weight_inv
from repro_torch.graph import containers as tcont
from repro_torch.graph.ell import (bucketed_degrees, edges_to_bucketed_ell,
                                   ell_planes, laplacian_vals)
from repro_torch.kernels import gee_fused, ops
from repro_torch.kernels.gee_fused import (MAX_CLASSES, gee_spmm_fused,
                                           gee_spmm_gathered, vertex_records)
from repro_torch.kernels.gee_spmm import (GATHERED_COUNTER, PLANES_COUNTER,
                                          gee_spmm)
from repro_torch.kernels.ref import diag_addend
from repro_torch.obs import metrics as t_metrics

OPT_IDS = [o.tag() for o in ALL_OPTION_SETTINGS]
SENTINEL = -7.25


def _power_law(k: int, seed: int = 11):
    """Hubs of out-degree 300, 150 and 70 among 400 vertices with Zipf-like
    degrees, ~10 % isolated (degree-0) vertices and ~15 % unlabeled ones;
    weighted, some weights negative.  The hubs' buckets hold one real row
    and 7 padding rows each; every bucket has padding slots."""
    rng = np.random.default_rng(seed)
    n = 400
    deg = np.minimum(rng.zipf(2.0, n), 40)
    deg[rng.random(n) < 0.1] = 0
    deg[:3] = (300, 150, 70)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    w = rng.uniform(0.2, 2.0, src.size).astype(np.float32)
    w[rng.random(src.size) < 0.1] *= -1.0
    labels = rng.integers(0, k, n).astype(np.int32)
    labels[rng.random(n) < 0.15] = -1
    edges = tcont.edge_list_from_numpy(src, dst, w, n, device="cpu")
    return edges, torch.from_numpy(labels)


@pytest.fixture(scope="module")
def graph4():
    return _power_law(4)


def _fit_vectors(bell, labels, k, opts):
    """The fused driver's ``winv`` and ``dinv`` (None without the
    Laplacian)."""
    winv = class_weight_inv(labels, k)
    dinv = None
    if opts.laplacian:
        deg = bucketed_degrees(bell, labels.device)
        dinv = inv_sqrt_degrees(deg + 1.0 if opts.diag_aug else deg)
    return winv, dinv


def _planes_into(z, b, labels, winv, dinv, k, opts):
    """One bucket through the plane passes the gathered launch replaces,
    scattered into ``z``."""
    n = labels.shape[0]
    vals = laplacian_vals(b, dinv) if dinv is not None else b.vals
    ylab, contrib = ell_planes(b.cols, vals, labels, winv)
    rows = b.row_ids.long()
    drow = dinv[rows] if dinv is not None else torch.ones(
        rows.shape[0], dtype=torch.float32)
    rowlab, dadd = diag_addend(labels[rows], winv, drow, opts.diag_aug)
    assert bool((rows < n).all())
    z[rows] = gee_spmm_fused(ylab, contrib, rowlab, dadd, k,
                             correlation=opts.correlation)


def test_graph_has_what_the_checks_need(graph4):
    edges, labels = graph4
    bell = edges_to_bucketed_ell(edges)
    packed = torch.cat([b.real_rows().row_ids for b in bell.buckets])
    assert packed.numel() < edges.num_nodes            # degree-0 rows
    assert bool((labels < 0).any())                    # unlabeled vertices
    assert any(b.cols.shape[0] > b.num_rows for b in bell.buckets)
    assert all(bool((b.real_rows().vals == 0).any())  # padding slots
               for b in bell.buckets if b.width > 8)
    assert len(bell.buckets) >= 6


def test_vertex_records_hold_labels_and_dinv_bits():
    labels = torch.tensor([3, -1, 0, 2], dtype=torch.int32)
    dinv = torch.tensor([0.5, 0.0, 1e-30, 7.25])
    rec = vertex_records(labels, dinv)
    assert rec.dtype == torch.int32 and rec.shape == (4, 2)
    assert rec.is_contiguous()
    assert torch.equal(rec[:, 0], labels)
    assert torch.equal(rec[:, 1].contiguous().view(torch.float32), dinv)
    assert not bool(vertex_records(labels)[:, 1].any())


@pytest.mark.parametrize("k", [1, 4, 12])
@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_gathered_equals_the_plane_passes_bit_for_bit(opts, k):
    edges, labels = _power_law(k, seed=k)
    bell = edges_to_bucketed_ell(edges)
    n = edges.num_nodes
    winv, dinv = _fit_vectors(bell, labels, k, opts)
    verts = vertex_records(labels, dinv)
    for b in bell.buckets:
        real = b.real_rows()
        want = torch.full((n, k), SENTINEL)
        _planes_into(want, real, labels, winv, dinv, k, opts)
        for launched in (real, b):          # the whole bucket: padding rows
            got = torch.full((n, k), SENTINEL)   # are skipped
            out = gee_spmm_gathered(launched.cols, launched.vals,
                                    launched.row_ids, verts, winv, got, k,
                                    laplacian=opts.laplacian,
                                    diag_aug=opts.diag_aug,
                                    correlation=opts.correlation)
            assert out is got
            assert torch.equal(got, want)
        untouched = torch.ones(n, dtype=torch.bool)
        untouched[real.row_ids.long()] = False
        assert bool((got[untouched] == SENTINEL).all())
        assert not bool((got[~untouched] == SENTINEL).any())


def _plane_fused_driver(bell, labels, k, opts):
    """``gee_fused_from_bucketed`` as the plane passes made it: each
    bucket's planes and diag addend, a launch scattered back, then the
    degree-0 rows' epilogue through the covered mask."""
    n = bell.num_nodes
    winv, dinv = _fit_vectors(bell, labels, k, opts)
    z = torch.zeros((n, k), dtype=torch.float32)
    covered = torch.zeros(n, dtype=torch.bool)
    for b in bell.buckets:
        b = b.real_rows()
        _planes_into(z, b, labels, winv, dinv, k, opts)
        covered[b.row_ids.long()] = True
    if opts.diag_aug or opts.correlation:
        ones = torch.ones(n, dtype=torch.float32)
        z_res = apply_epilogue(torch.zeros((n, k), dtype=torch.float32),
                               labels, winv, ones if dinv is None else dinv,
                               opts=opts, impl="torch")
        z = torch.where(covered[:, None], z, z_res)
    return z


def _plane_staged_driver(bell, labels, k, opts):
    """``gee_cuda_from_bucketed`` as the plane passes made it."""
    winv = class_weight_inv(labels, k)
    dinv = (inv_sqrt_degrees(bucketed_degrees(bell, labels.device))
            if opts.laplacian else None)
    z = torch.zeros((bell.num_nodes, k), dtype=torch.float32)
    for b in bell.buckets:
        b = b.real_rows()
        vals = laplacian_vals(b, dinv) if dinv is not None else b.vals
        ylab, contrib = ell_planes(b.cols, vals, labels, winv)
        z[b.row_ids.long()] = gee_spmm(ylab, contrib, k)
    if opts.correlation:
        z = row_l2_normalize(z.contiguous(), impl="cuda")
    return z


@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_drivers_equal_the_plane_drivers_bit_for_bit(graph4, opts):
    edges, labels = graph4
    bell = edges_to_bucketed_ell(edges)
    got = gee_fused.gee_fused_from_bucketed(bell, labels, 4, opts)
    assert torch.equal(got, _plane_fused_driver(bell, labels, 4, opts))
    # the staged driver takes the packing of A + I in place of diag-aug
    if opts.diag_aug:
        bell = edges_to_bucketed_ell(tcont.add_self_loops(edges))
        opts = dataclasses.replace(opts, diag_aug=False)
    got = ops.gee_cuda_from_bucketed(bell, labels, 4, opts)
    assert torch.equal(got, _plane_staged_driver(bell, labels, 4, opts))


@pytest.fixture
def registry():
    """A fresh process-global metrics registry for the test."""
    reg = t_metrics.MetricsRegistry()
    prev = t_metrics.set_registry(reg)
    yield reg
    t_metrics.set_registry(prev)


def _counts(reg):
    return (reg.counter(GATHERED_COUNTER).value,
            reg.counter(PLANES_COUNTER).value)


@pytest.mark.parametrize("opts", ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_drivers_count_one_gathered_launch_a_bucket(graph4, registry, opts):
    edges, labels = graph4
    bell = edges_to_bucketed_ell(edges)
    launches = gee_spmm_gathered.launches
    gee_fused.gee_fused_from_bucketed(bell, labels, 4, opts)
    assert _counts(registry) == (len(bell.buckets), 0)
    if not opts.diag_aug:
        ops.gee_cuda_from_bucketed(bell, labels, 4, opts)
        assert _counts(registry) == (2 * len(bell.buckets), 0)
    # the plain route launches nothing, so ``launches`` counts nothing
    assert gee_spmm_gathered.launches == launches


def test_counters_count_each_route(registry):
    edges, labels = _power_law(3)
    b = edges_to_bucketed_ell(edges).buckets[0].real_rows()
    winv = class_weight_inv(labels, 3)
    ylab, contrib = ell_planes(b.cols, b.vals, labels, winv)
    no = torch.zeros(0, dtype=torch.int32), torch.zeros(0)
    gee_spmm(ylab, contrib, 3)
    gee_spmm_fused(ylab, contrib, *no, 3)
    assert _counts(registry) == (0, 2)
    verts = vertex_records(labels)
    gee_spmm_gathered(b.cols, b.vals, b.row_ids, verts, winv,
                      torch.zeros((edges.num_nodes, 3)), 3)
    assert _counts(registry) == (1, 2)
    # empty calls count nothing
    gee_spmm(ylab[:0], contrib[:0], 3)
    gee_spmm_gathered(b.cols[:0], b.vals[:0], b.row_ids[:0], verts, winv,
                      torch.zeros((edges.num_nodes, 3)), 3)
    assert _counts(registry) == (1, 2)


def test_gathered_wrapper_checks_its_inputs():
    edges, labels = _power_law(3)
    b = edges_to_bucketed_ell(edges).buckets[0].real_rows()
    n = edges.num_nodes
    winv = class_weight_inv(labels, 3)
    verts = vertex_records(labels)
    out = torch.zeros((n, 3))
    args = (b.cols, b.vals, b.row_ids, verts, winv, out, 3)
    with pytest.raises(ValueError, match="cols must be torch.int32"):
        gee_spmm_gathered(b.cols.long(), *args[1:])
    with pytest.raises(ValueError, match="row_ids"):
        gee_spmm_gathered(b.cols, b.vals, b.row_ids[1:], *args[3:])
    with pytest.raises(ValueError, match="verts must be torch.int32"):
        gee_spmm_gathered(*args[:3], verts.float(), *args[4:])
    with pytest.raises(ValueError, match="must be \\[N, 2\\], \\[N, K\\]"):
        gee_spmm_gathered(*args[:3], labels[:, None], *args[4:])
    with pytest.raises(ValueError, match="must be \\[N, 2\\], \\[N, K\\]"):
        gee_spmm_gathered(*args[:5], torch.zeros((n, 4)), 3)
    with pytest.raises(ValueError, match="must be contiguous"):
        gee_spmm_gathered(*args[:5], torch.zeros((3, n)).T, 3)
    # K past MAX_CLASSES only without an epilogue
    k = MAX_CLASSES + 1
    wide = (*args[:4], torch.zeros(k), torch.zeros((n, k)), k)
    gee_spmm_gathered(*wide)
    for flags in ({"diag_aug": True}, {"correlation": True}):
        with pytest.raises(ValueError, match="num_classes"):
            gee_spmm_gathered(*wide, **flags)
