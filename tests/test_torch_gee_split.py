"""The redesigned contraction's launch geometry and the bucketed drivers
that launch it on real rows only.

* ``launch_geometry`` (``repro_torch/kernels/gee_spmm.py``) picks, for a
  width D, the lanes a row (a segment of a warp) or the threads a span and
  the spans a row (blocks of ``gee_span_kernel``); a model of the slots each
  lane of ``csrc/gee_kernels.cu``'s ``lane_sums`` walks must cover every
  slot of a row exactly once, the spans in ascending order.
* ``gee_fused_from_bucketed`` and ``gee_cuda_from_bucketed`` launch each
  bucket's leading ``num_rows`` rows (one gathered launch a bucket), never
  its padding rows, on a
  power-law graph whose wide buckets hold padding rows, and agree with the
  reference's ``GEEPlan`` and ``gee_scipy`` under all 8 option settings.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds them against
their plain versions at these geometries there.
"""

import dataclasses
import importlib
import importlib.util

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import plan as jplan
from repro.graph import containers as jcont

from repro_torch.core import gee as tgee
from repro_torch.graph import containers as tcont
from repro_torch.graph import ell as tell
from repro_torch.kernels import gee_fused, gee_spmm, ops

jgee = importlib.import_module("repro.core.gee")

ATOL = 1e-5
OPT_IDS = [o.tag() for o in tgee.ALL_OPTION_SETTINGS]


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

def _lane_slots(d: int, lanes: int, spans: int, span: int, vec: bool):
    """The slots each lane adds, in its order, span by span: a model of
    ``lane_sums`` as the two kernels call it.  A segment lane j of L takes
    loads j, j + L, ...; a span thread t of T takes loads first + t,
    first + t + T, ... below the span's end; a load is 4 slots (16-byte
    loads) or 1.  Returns [span][lane] -> slot array."""
    unit = 4 if vec else 1
    loads = d // unit
    if lanes <= 32:
        bounds = [(0, loads)]
    else:
        per = span // unit
        bounds = [(s * per, min(loads, (s + 1) * per)) for s in range(spans)]
    out = []
    for first, end in bounds:
        out.append([
            (np.arange(first + t, end, lanes)[:, None] * unit
             + np.arange(unit)[None, :]).reshape(-1)
            for t in range(lanes)])
    return out


@settings(max_examples=80, deadline=None)
@given(d=st.integers(0, 40_000), k=st.sampled_from([1, 5, 8, 9, 33, 1500]),
       vec=st.booleans(), lane_loads=st.sampled_from([1, 2, 4, 8]),
       seg_loads=st.sampled_from([8, 16, 32]),
       span=st.sampled_from([128, 1024, 2048, 4096, 8192]))
def test_launch_geometry_covers_every_slot_once_in_span_order(
        d, k, vec, lane_loads, seg_loads, span):
    if vec:
        d -= d % 4
    lanes, span_, spans = gee_spmm.launch_geometry(d, k, vec, lane_loads,
                                                   seg_loads, span)
    assert span_ == span
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 256
    unit = 4 if vec else 1
    per_lane = -(-(d // unit) // lanes)
    if lanes <= 32:                   # a segment of a warp, one span
        assert spans == 1
        assert d // unit <= 32 * seg_loads and per_lane <= seg_loads
        if k > 8:
            assert lanes == 32        # class tiles take a whole warp
        elif lanes < 32:              # fewer lanes only while each has
            assert per_lane <= lane_loads    # lane_loads or fewer
    else:                             # blocks of 64-256 threads a span
        assert lanes >= 64 and d // unit > 32 * seg_loads
        assert spans == -(-d // span)
    model = _lane_slots(d, lanes, spans, span, vec)
    assert len(model) == spans
    got = []
    for s, lanes_slots in enumerate(model):
        flat = np.sort(np.concatenate(lanes_slots))
        lo = s * span if lanes > 32 else 0
        hi = min(d, lo + span) if lanes > 32 else d
        np.testing.assert_array_equal(flat, np.arange(lo, hi))
        for slots in lanes_slots:     # each lane adds in ascending order
            assert np.all(np.diff(slots) > 0)
        got.append(flat)
    # every slot once, the spans in ascending order
    np.testing.assert_array_equal(np.concatenate(got), np.arange(d))


@pytest.mark.parametrize("d,k,vec,want", [
    (128, 5, True, (8, 1)), (256, 5, True, (16, 1)), (512, 5, True, (32, 1)),
    (1024, 5, True, (32, 1)), (2048, 3, True, (32, 1)),
    (4096, 5, True, (256, 1)), (8192, 5, True, (256, 2)),
    (65536, 5, True, (256, 16)), (4097, 5, False, (256, 2)),
    (8, 9, True, (32, 1)), (0, 5, True, (1, 1)), (500, 5, False, (32, 1)),
    (2052, 5, True, (256, 1))])
def test_launch_geometry_at_the_bucket_widths(d, k, vec, want):
    """The geometry of the main path's buckets at the defaults (4 to 16
    loads a lane, spans of 4,096 slots): 128-2,048 slots a segment of 8-32
    lanes, 4,096 one block, the hub row 16 blocks."""
    lanes, span, spans = gee_spmm.launch_geometry(d, k, vec)
    assert (lanes, spans) == want and span == gee_spmm.SPAN


def test_launch_geometry_rejects_bad_knobs():
    with pytest.raises(ValueError, match="span"):
        gee_spmm.launch_geometry(100, 5, True, span=6)
    with pytest.raises(ValueError, match="lane_loads"):
        gee_spmm.launch_geometry(100, 5, True, lane_loads=0)
    with pytest.raises(ValueError, match="seg_loads"):
        gee_spmm.launch_geometry(100, 5, True, lane_loads=8, seg_loads=4)


def test_tickets_are_zeroed_once_and_grow():
    dev = torch.device("cpu")
    gee_spmm._TICKETS.clear()
    t = gee_spmm._tickets(dev, 7, 10)
    assert t.dtype == torch.int32 and t.numel() >= 10
    assert not bool(t.any())
    assert gee_spmm._tickets(dev, 7, t.numel()) is t        # reused
    assert gee_spmm._tickets(dev, 8, 10) is not t           # a stream each
    bigger = gee_spmm._tickets(dev, 7, t.numel() + 1)
    assert bigger.numel() > t.numel() and not bool(bigger.any())
    gee_spmm._TICKETS.clear()


# ---------------------------------------------------------------------------
# the bucketed drivers on real rows
# ---------------------------------------------------------------------------

def _power_law_graph():
    """Three hubs of out-degree 300, 150 and 70 among 400 vertices with
    Zipf-like degrees and isolated vertices, weighted; labels in 4 classes
    with -1s.  The hubs' buckets (widths 512, 256, 128) hold one real row
    each and 7 padding rows."""
    rng = np.random.default_rng(11)
    n = 400
    deg = np.minimum(rng.zipf(2.0, n), 40)
    deg[rng.random(n) < 0.1] = 0                   # isolated rows
    deg[:3] = (300, 150, 70)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    w = rng.uniform(0.2, 2.0, src.size).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    labels[rng.random(n) < 0.15] = -1
    ref = jcont.edge_list_from_numpy(src, dst, w, n)
    port = tcont.edge_list_from_numpy(src, dst, w, n, device="cpu")
    return ref, port, labels


@pytest.fixture(scope="module")
def power_law():
    return _power_law_graph()


def _jopts(o):
    return jgee.GEEOptions(laplacian=o.laplacian, diag_aug=o.diag_aug,
                           correlation=o.correlation)


def _launched_rows(monkeypatch, module, name):
    """Record the row count of every launch of ``module.name``."""
    rows, real = [], getattr(module, name)

    def shim(ylab, *args, **kwargs):
        rows.append(int(ylab.shape[0]))
        return real(ylab, *args, **kwargs)

    monkeypatch.setattr(module, name, shim)
    return rows


def test_power_law_buckets_hold_padding_rows(power_law):
    _, port, _ = power_law
    bell = tell.edges_to_bucketed_ell(port)
    wide = [b for b in bell.buckets if b.width >= 128]
    assert len(wide) == 3
    assert all(b.num_rows == 1 and b.cols.shape[0] == 8 for b in wide)
    for b in bell.buckets:
        real = b.real_rows()
        assert real.cols.shape == (b.num_rows, b.width)
        assert real.cols.is_contiguous() and real.vals.is_contiguous()
        assert real.cols.data_ptr() == b.cols.data_ptr()
        assert bool((real.row_ids < bell.num_nodes).all())
        assert bool((b.row_ids[b.num_rows:] == bell.num_nodes).all())


@pytest.mark.parametrize("opts", tgee.ALL_OPTION_SETTINGS, ids=OPT_IDS)
def test_bucketed_drivers_launch_real_rows_and_match_reference(
        power_law, opts, monkeypatch):
    ref, port, labels = power_law
    k = 4
    s, d, w = ref.valid_arrays()
    want_scipy = jgee.gee_scipy(s, d, w, labels, k, _jopts(opts),
                                num_nodes=ref.num_nodes)
    want_plan = np.asarray(jplan.GEEPlan.build(
        ref, k, _jopts(opts), backend="sparse_jax").execute(labels))
    np.testing.assert_allclose(want_plan, want_scipy, atol=ATOL)

    # fused: the base packing, diag-aug folded in
    bell = tell.edges_to_bucketed_ell(port)
    rows = _launched_rows(monkeypatch, gee_fused, "gee_spmm_gathered")
    z = gee_fused.gee_fused_from_bucketed(bell, labels, k, opts).numpy()
    assert rows == [b.num_rows for b in bell.buckets]
    np.testing.assert_allclose(z, want_scipy, atol=ATOL)
    np.testing.assert_allclose(z, want_plan, atol=ATOL)

    # staged: refuses diag-aug, takes the packing of A + I instead
    if opts.diag_aug:
        with pytest.raises(ValueError, match="diag_aug"):
            ops.gee_cuda_from_bucketed(bell, labels, k, opts)
        bell = tell.edges_to_bucketed_ell(tcont.add_self_loops(port))
        opts = dataclasses.replace(opts, diag_aug=False)
    rows = _launched_rows(monkeypatch, ops, "gee_spmm_gathered")
    z = ops.gee_cuda_from_bucketed(bell, labels, k, opts).numpy()
    assert rows == [b.num_rows for b in bell.buckets]
    np.testing.assert_allclose(z, want_scipy, atol=ATOL)
    np.testing.assert_allclose(z, want_plan, atol=ATOL)


@pytest.mark.parametrize("variant", ["kvec2", "kvec8", "second_pass"])
def test_gee_variants_swaps_still_apply(variant):
    """``tools/gee_variants.py`` builds each design it times against the
    kernels by swapping exact text of ``gee_kernels.cu``: every swap still
    finds its text in the source, once."""
    from pathlib import Path

    from repro_torch.kernels import build

    path = Path(__file__).resolve().parents[1] / "tools" / "gee_variants.py"
    spec = importlib.util.spec_from_file_location("gee_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = (build.CSRC / "gee_kernels.cu").read_text()
    text = tool.variant_source(variant)
    assert text != source
    for _, new in tool.VARIANTS[variant]:
        assert new in text
    assert ("variant_combine_launch" in text) == (variant == "second_pass")
    assert all(ll <= sl for ll, sl, _ in tool.SWEEP)
