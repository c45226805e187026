"""The retrieval kernels' plain versions held against the JAX Pallas kernels
of ``repro/kernels/topk_score.py``, run in interpret mode as
``tests/test_search.py`` runs them, plus ``masked_topk``, the wrappers' CPU
route, the fused/staged routing, the input checks, and the text swaps by
which ``tools/topk_variants.py`` builds the designs it times.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each one against its plain version there (and ``test_kernels_on_card``
below, on a machine with a GPU).
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk_score as jts

from repro_torch.kernels import build, ref
from repro_torch.kernels import topk_score as ts

ATOL = RTOL = 1e-5
METRICS = ("l2", "cosine")


def _inputs(seed, q, m, k, *, integer=False, live=0.8):
    """Queries, a database, per-query candidates, masks and candidate ids;
    row 0 of each is all zeros (zero norm)."""
    rng = np.random.default_rng(seed)

    def gen(shape):
        if integer:
            return rng.integers(-2, 3, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    qv, x, cand = gen((q, k)), gen((m, k)), gen((q, m, k))
    qv[0], x[0], cand[:, 0] = 0.0, 0.0, 0.0
    valid = (rng.random(m) < live).astype(np.float32)
    mask = (rng.random((q, m)) < live).astype(np.float32)
    ids = np.stack([rng.permutation(10 * m)[:m] for _ in range(q)]).astype(
        np.int32)
    return qv, x, cand, valid, mask, ids


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_scores(got, want):
    """NEG_INF entries equal exactly; the rest within rtol = atol = 1e-5
    (the same f32 sums in another order)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got == ref.NEG_INF, want == ts.NEG_INF)
    live = want != ts.NEG_INF
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL, atol=ATOL)


# (Q, M, K, live share): Q = 1, M = 1, K = 1, K = 200, all masked; then
# centroid-like databases (M of 1 to 10 with invalid rows) against Q off the
# kernels' blocks of query rows (128) and query tiles (8), K = 1, 8, 9, 12
SHAPES = [(1, 1, 1, 0.8), (4, 7, 3, 0.8), (9, 130, 5, 0.8),
          (3, 40, 200, 0.8), (5, 33, 4, 0.0),
          (129, 1, 1, 0.8), (130, 5, 8, 0.6), (9, 10, 9, 0.6),
          (17, 7, 12, 0.5), (7, 3, 5, 0.5), (257, 10, 3, 0.7)]


def test_neg_inf_is_the_reference_sentinel():
    assert ref.NEG_INF == jts.NEG_INF == ts.NEG_INF
    assert ts.METRICS == jts.METRICS


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,m,k,live", SHAPES)
def test_pairwise_scores_plain_matches_pallas(q, m, k, live, metric):
    qv, x, _, valid, _, _ = _inputs(q * m + k, q, m, k, live=live)
    want = jts.pairwise_scores(jnp.asarray(qv), jnp.asarray(x),
                               jnp.asarray(valid), metric=metric,
                               impl="pallas", interpret=True)
    got = ref.pairwise_scores_ref(*_t(qv, x, valid), metric)
    assert got.shape == (q, m) and got.dtype == torch.float32
    _assert_scores(got.numpy(), want)
    # valid=None: every row live
    want = jts.pairwise_scores(jnp.asarray(qv), jnp.asarray(x), None,
                               metric=metric, impl="pallas", interpret=True)
    _assert_scores(ref.pairwise_scores_ref(*_t(qv, x), None, metric).numpy(),
                   want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,m,k,live", SHAPES)
def test_gathered_scores_plain_matches_pallas(q, m, k, live, metric):
    qv, _, cand, _, mask, _ = _inputs(q + m * k, q, m, k, live=live)
    want = jts.gathered_scores(jnp.asarray(qv), jnp.asarray(cand),
                               jnp.asarray(mask), metric=metric,
                               impl="pallas", interpret=True)
    got = ref.gathered_scores_ref(*_t(qv, cand, mask), metric)
    assert got.shape == (q, m)
    _assert_scores(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 4, 9, 40])
@pytest.mark.parametrize("with_ids", [False, True])
def test_masked_topk_matches_reference_tie_order(k, with_ids):
    """Integer scores with many exact ties and masked slots: ids, their
    order among equal scores, the -1 slots and the k > M padding equal the
    reference's exactly."""
    rng = np.random.default_rng(k)
    scores = rng.integers(-3, 3, (6, 9)).astype(np.float32)
    scores[rng.random((6, 9)) < 0.3] = ts.NEG_INF
    scores[5] = ts.NEG_INF                     # an all-masked row
    ids = rng.integers(0, 1000, (6, 9)).astype(np.int32) if with_ids \
        else None
    want_i, want_s = jts.masked_topk(
        jnp.asarray(scores), None if ids is None else jnp.asarray(ids), k)
    got_i, got_s = ref.masked_topk(
        torch.from_numpy(scores),
        None if ids is None else torch.from_numpy(ids), k)
    assert got_i.dtype == torch.int32 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _assert_topk(got, want, exact):
    got_i, got_s = (t.numpy() for t in got)
    want_i, want_s = (np.asarray(t) for t in want)
    _assert_scores(got_s, want_s)
    if exact:
        np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)


# (Q, M, K, k, integer-valued, live share)
TOPK_CASES = [(1, 1, 1, 1, False, 0.8), (3, 5, 3, 8, False, 0.8),
              (6, 70, 5, 10, False, 0.8), (4, 21, 2, 6, False, 0.0),
              (7, 90, 3, 12, True, 0.8), (2, 40, 1, ts.MAX_TOPK, True, 0.9)]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,m,k,topk,integer,live", TOPK_CASES)
def test_scored_topk_plain_matches_fused_pallas(q, m, k, topk, integer, live,
                                                metric):
    """The fused JAX kernel in interpret mode against the plain version.
    Integer-valued inputs make every sum exact in any order, so ids and
    scores match bit for bit, tie order included."""
    qv, x, _, valid, _, _ = _inputs(q * 7 + m, q, m, k, integer=integer,
                                    live=live)
    want = jts.scored_topk(jnp.asarray(qv), jnp.asarray(x),
                           jnp.asarray(valid), topk, metric=metric,
                           impl="pallas", fused=True, interpret=True)
    got = ref.scored_topk_ref(*_t(qv, x, valid), topk, metric)
    _assert_topk(got, want, integer)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,m,k,topk,integer,live", TOPK_CASES)
def test_scored_topk_gathered_plain_matches_fused_pallas(q, m, k, topk,
                                                         integer, live,
                                                         metric):
    qv, _, cand, _, mask, ids = _inputs(q * 11 + m, q, m, k,
                                        integer=integer, live=live)
    want = jts.scored_topk_gathered(
        jnp.asarray(qv), jnp.asarray(cand), jnp.asarray(mask),
        jnp.asarray(ids), topk, metric=metric, impl="pallas", fused=True,
        interpret=True)
    got = ref.scored_topk_gathered_ref(*_t(qv, cand, mask, ids), topk,
                                       metric)
    _assert_topk(got, want, integer)


@pytest.mark.parametrize("metric", METRICS)
def test_wrappers_take_plain_version_on_cpu(metric):
    qv, x, cand, valid, mask, ids = _inputs(3, 5, 60, 4)
    q_t, x_t, c_t, v_t, m_t, i_t = _t(qv, x, cand, valid, mask, ids)
    counts = [f.launches for f in (ts.pairwise_scores, ts.gathered_scores,
                                   ts.scored_topk, ts.scored_topk_gathered)]
    torch.testing.assert_close(
        ts.pairwise_scores(q_t, x_t, v_t, metric=metric),
        ref.pairwise_scores_ref(q_t, x_t, v_t, metric), rtol=0, atol=0)
    torch.testing.assert_close(
        ts.gathered_scores(q_t, c_t, m_t, metric=metric),
        ref.gathered_scores_ref(q_t, c_t, m_t, metric), rtol=0, atol=0)
    for fused in (True, False, None):
        for got, want in (
                (ts.scored_topk(q_t, x_t, v_t, 7, metric=metric,
                                fused=fused),
                 ref.scored_topk_ref(q_t, x_t, v_t, 7, metric)),
                (ts.scored_topk_gathered(q_t, c_t, m_t, i_t, 7,
                                         metric=metric, fused=fused),
                 ref.scored_topk_gathered_ref(q_t, c_t, m_t, i_t, 7,
                                              metric))):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    # bool masks are taken as live = nonzero
    torch.testing.assert_close(
        ts.pairwise_scores(q_t, x_t, v_t > 0, metric=metric),
        ref.pairwise_scores_ref(q_t, x_t, v_t, metric), rtol=0, atol=0)
    # the plain route launches nothing, so it counts nothing
    assert [f.launches for f in (ts.pairwise_scores, ts.gathered_scores,
                                 ts.scored_topk,
                                 ts.scored_topk_gathered)] == counts


@pytest.mark.parametrize("k,m,fused,route", [
    (ts.MAX_TOPK, 100, True, "fused"),
    (ts.MAX_TOPK + 1, 100, True, "staged"),     # wider than the kernels
    (ts.MAX_TOPK + 8, 20, True, "fused"),       # min(k, M) <= MAX_TOPK
    (5, 100, False, "staged")])
def test_topk_route(monkeypatch, k, m, fused, route):
    """A top-k wider than MAX_TOPK (min(k, M) > MAX_TOPK), or fused=False,
    takes the staged kernels: the score kernel, then masked_topk."""
    staged = []
    for name in ("pairwise_scores", "gathered_scores"):
        real = getattr(ts, name)

        def spy(*a, _real=real, _name=name, **kw):
            staged.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(ts, name, spy)
    qv, x, cand, valid, mask, ids = _inputs(k + m, 3, m, 4)
    q_t, x_t, c_t, v_t, m_t, i_t = _t(qv, x, cand, valid, mask, ids)
    got = ts.scored_topk(q_t, x_t, v_t, k, fused=fused)
    got_g = ts.scored_topk_gathered(q_t, c_t, m_t, i_t, k, fused=fused)
    want = ["pairwise_scores", "gathered_scores"] if route == "staged" \
        else []
    assert staged == want
    for g, w in ((got, ref.scored_topk_ref(q_t, x_t, v_t, k)),
                 (got_g, ref.scored_topk_gathered_ref(q_t, c_t, m_t, i_t,
                                                      k))):
        assert g[0].shape == (3, k)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("env,device,want", [
    (None, "cpu", False), (None, "cuda", True), ("1", "cpu", True),
    ("0", "cuda", False), ("false", "cuda", False), ("", "cuda", True)])
def test_fused_topk_enabled(monkeypatch, env, device, want):
    """REPRO_GEE_FUSED wins when set; otherwise fused iff the device is
    the card (nothing here needs a GPU: only the device type is read)."""
    if env is None:
        monkeypatch.delenv("REPRO_GEE_FUSED", raising=False)
    else:
        monkeypatch.setenv("REPRO_GEE_FUSED", env)
    assert ts.fused_topk_enabled(torch.device(device)) is want
    assert ts.fused_topk_enabled(device) is want


def test_wrappers_check_their_inputs():
    qv, x, cand, valid, mask, ids = _inputs(0, 4, 9, 3)
    q_t, x_t, c_t, v_t, m_t, i_t = _t(qv, x, cand, valid, mask, ids)
    with pytest.raises(ValueError, match="unknown metric"):
        ts.pairwise_scores(q_t, x_t, metric="dot")
    with pytest.raises(ValueError, match="float32"):
        ts.pairwise_scores(q_t.double(), x_t)
    with pytest.raises(ValueError, match="K="):
        ts.pairwise_scores(q_t, x_t[:, :2])
    with pytest.raises(ValueError, match="valid"):
        ts.pairwise_scores(q_t, x_t, v_t[:4])
    with pytest.raises(ValueError, match="rows"):
        ts.gathered_scores(q_t[:2], c_t, m_t)
    with pytest.raises(ValueError, match="mask"):
        ts.gathered_scores(q_t, c_t, m_t[:, :3])
    with pytest.raises(ValueError, match="k must be"):
        ts.scored_topk(q_t, x_t, None, 0)
    with pytest.raises(ValueError, match="int32"):
        ts.scored_topk_gathered(q_t, c_t, m_t, i_t.long(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        ts.scored_topk(q_t.t().contiguous().t(), x_t, None, 3)


def test_build_compiles_every_source_and_caps_agree():
    """Both kernel files build into the one library, each launcher is
    declared, and MAX_TOPK is the kernels' kMaxTopK."""
    assert [s.name for s in build.sources()] == ["gee_kernels.cu",
                                                 "topk_kernels.cu"]
    src = (build.CSRC / "topk_kernels.cu").read_text()
    cap = re.search(r"constexpr int kMaxTopK = (\d+);", src)
    assert cap and int(cap.group(1)) == ts.MAX_TOPK
    for name in ("topk_kernels_max_topk", "pairwise_scores_launch",
                 "gathered_scores_launch", "scored_topk_launch",
                 "scored_topk_gathered_launch"):
        assert name in build._SIGNATURES
        assert f"int {name}(" in src
    assert "-shared" not in build.NVCC_FLAGS     # compile with -c, then link


@pytest.mark.parametrize("variant", ["no_prefetch", "lockstep", "offer_n1"])
def test_variant_tool_matches_the_source(variant):
    """``tools/topk_variants.py`` builds each design it times against the
    kernels by swapping exact text of ``topk_kernels.cu``: every swap still
    finds its text in the source, once."""
    path = Path(__file__).resolve().parents[1] / "tools" / "topk_variants.py"
    spec = importlib.util.spec_from_file_location("topk_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    as_built = tool.variant_source(tool.VARIANTS["as_built"])
    assert as_built.startswith((build.CSRC / "topk_kernels.cu").read_text())
    assert "variant_pairwise_launch" in as_built
    assert tool.variant_source(tool.VARIANTS[variant]) != as_built


def test_gathered_chunk_policy_and_shared_memory(monkeypatch):
    """``scored_topk_gathered`` splits a flush's M into chunks by its own
    policy (at most ``_GATHER_BLOCKS_PER_SM`` blocks an SM in all, chunks
    of at least ``_GATHER_MIN_CHUNK`` candidates, one chunk below that),
    and the gathered pass-1 block's
    dynamic shared memory, one (score, position) entry per warp and list
    slot, stays within the 48 KiB a block gets without opting in, at the
    widest top-k."""
    monkeypatch.setattr(ts, "_sm_count", lambda device: 132)
    dev = torch.device("cuda")               # only the SM count is read
    # the flush shapes of chip_smoke.py: 64 queries of 58,752 (10,240)
    assert ts._gathered_chunks(dev, 64, 58752) == 8
    assert ts._gathered_chunks(dev, 64, 10240) == 5
    assert ts._gathered_chunks(dev, 64, ts._GATHER_MIN_CHUNK) == 1
    assert ts._gathered_chunks(dev, 64, ts._GATHER_MIN_CHUNK + 1) == 2
    assert ts._gathered_chunks(dev, 1, 70001) == 35
    assert ts._gathered_chunks(dev, 4096, 10 ** 6) == 1
    for q, m in ((64, 58752), (64, 10240), (1, 70001), (7, 3000)):
        chunks = ts._gathered_chunks(dev, q, m)
        # one wave of blocks, no chunk left empty
        assert q * chunks <= ts._GATHER_BLOCKS_PER_SM * 132
        assert (chunks - 1) * -(-m // chunks) < m
    src = (build.CSRC / "topk_kernels.cu").read_text()
    warps = int(re.search(r"constexpr int kGatherWarps = (\d+);",
                          src).group(1))
    resident = re.search(r"constexpr int kGatherBlocksPerSm = (\d+);", src)
    assert int(resident.group(1)) == ts._GATHER_BLOCKS_PER_SM
    assert "__launch_bounds__(kGatherWarps * kWarp, kGatherBlocksPerSm)" in src
    assert "(sizeof(float) + sizeof(int)) * kGatherWarps * kk" in src
    assert 8 * warps * ts.MAX_TOPK <= 48 * 1024


def test_scored_topk_chunk_policy_and_resources(monkeypatch):
    """``scored_topk`` splits M into chunks by its own policy: ceil(Q /
    ``_QUERY_TILE``) query tiles times the chunks fit in one wave of
    ``_BLOCKS_PER_SM`` blocks an SM, chunks of at least ``_MIN_CHUNK``
    candidates, one chunk below that.  The tiles and chunks cover every
    query and candidate once, for Q = 1, Q = QT +- 1 and M below one chunk
    too; the wrapper's constants are the source's, the launch bounds pin
    the blocks an SM, and the pass-1 block's dynamic shared memory (one
    (score, position) entry per query of the tile, warp and list slot)
    fits in the 48 KiB a block gets without opting in at the widest top-k.
    """
    monkeypatch.setattr(ts, "_sm_count", lambda device: 132)
    dev = torch.device("cuda")               # only the SM count is read
    qt = ts._QUERY_TILE
    # the brute-force batches of chip_smoke.py: 64 queries of 92,482 rows
    # (cl-100k-1d8-l5) and of 10,000 (sbm-10k)
    assert ts._num_chunks(dev, 64, 92482) == 8
    assert ts._num_chunks(dev, 64, 10000) == 5
    assert ts._num_chunks(dev, 64, ts._MIN_CHUNK) == 1
    assert ts._num_chunks(dev, 64, ts._MIN_CHUNK + 1) == 2
    assert ts._num_chunks(dev, 1, 92482) == 46
    assert ts._num_chunks(dev, 4096, 92482) == 1
    for q in (1, qt - 1, qt, qt + 1, 64, 65, 4096):
        for m in (1, 31, ts._MIN_CHUNK - 1, 10000, 92482):
            chunks = ts._num_chunks(dev, q, m)
            tiles = -(-q // qt)
            if tiles <= ts._BLOCKS_PER_SM * 132:
                assert tiles * chunks <= ts._BLOCKS_PER_SM * 132  # one wave
            if m < ts._MIN_CHUNK:
                assert chunks == 1
            # every (query, candidate) in exactly one (tile, chunk) block
            chunk_len = -(-m // chunks)
            assert (chunks - 1) * chunk_len < m <= chunks * chunk_len
            covered = [min(qt, q - t * qt) for t in range(tiles)]
            assert min(covered) >= 1 and sum(covered) == q
    src = (build.CSRC / "topk_kernels.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("kQueryTile") == ts._QUERY_TILE
    assert const("kTopkBlocksPerSm") == ts._BLOCKS_PER_SM
    assert const("kQueryTile") <= const("kTopkWarps")  # warp i merges query i
    assert "__launch_bounds__(kTopkWarps * kWarp, kTopkBlocksPerSm)" in src
    assert ("(sizeof(float) + sizeof(int)) * kQueryTile * kTopkWarps * kk"
            in src)
    assert 8 * const("kQueryTile") * const("kTopkWarps") * ts.MAX_TOPK \
        <= 48 * 1024
    # Q = 1, Q = QT +- 1 and M below one chunk on the wrappers' CPU route
    for q, m in ((1, 5), (qt - 1, 100), (qt + 1, 31), (65, 40)):
        qv, x, _, valid, _, _ = _inputs(q + m, q, m, 3, integer=True)
        got = ts.scored_topk(*_t(qv, x, valid), 10, fused=True)
        want = ref.scored_topk_ref(*_t(qv, x, valid), 10)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("metric", METRICS)
def test_valid_dtypes_give_identical_results(metric):
    """A bool, uint8 or f32 ``valid`` (and any other dtype, cast to f32)
    gives identical scores and top-k; the first three reach the kernels as
    they are, with their element size, so a call launches no cast."""
    qv, x, _, valid, _, _ = _inputs(5, 9, 10, 5, live=0.6)
    q_t, x_t, v_t = _t(qv, x, valid)
    want = ref.pairwise_scores_ref(q_t, x_t, v_t, metric)
    want_k = ref.scored_topk_ref(q_t, x_t, v_t, 4, metric)
    for v, size in ((v_t, 4), (v_t > 0, 1), ((v_t > 0).to(torch.uint8), 1),
                    ((v_t > 0).to(torch.int64), 4)):
        operand, nbytes = ts._valid_operand(v, 10, v.device)
        assert nbytes == size
        if size == 1 or v.dtype == torch.float32:
            assert operand.data_ptr() == v.data_ptr()          # no copy
        torch.testing.assert_close(
            ts.pairwise_scores(q_t, x_t, v, metric=metric), want, rtol=0,
            atol=0)
        for fused in (True, False):
            torch.testing.assert_close(
                ts.scored_topk(q_t, x_t, v, 4, metric=metric, fused=fused),
                want_k, rtol=0, atol=0)
    assert ts._valid_operand(None, 10, q_t.device) == (None, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("q", [1, 64, 65])
def test_kernels_on_card(metric, k, q):
    """The four kernels against their plain versions on the card, with
    Q = 1 and Q off a query tile, and ``pairwise_scores`` also at a
    centroid shape (M = 5) with a bool ``valid``, as the index passes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    qv, x, cand, valid, mask, ids = _inputs(7, q, 3000, 5, integer=True)
    q_t, x_t, c_t, v_t, m_t, i_t = (t.cuda() for t in _t(
        qv, x, cand, valid, mask, ids))
    cen, active = x_t[:5], v_t[:5] > 0
    for got, want in (
            (ts.pairwise_scores(q_t, x_t, v_t, metric=metric),
             ref.pairwise_scores_ref(q_t, x_t, v_t, metric)),
            (ts.pairwise_scores(q_t, cen, active, metric=metric),
             ref.pairwise_scores_ref(q_t, cen, active, metric)),
            (ts.gathered_scores(q_t, c_t, m_t, metric=metric),
             ref.gathered_scores_ref(q_t, c_t, m_t, metric)),
            (ts.scored_topk(q_t, x_t, v_t, k, metric=metric, fused=True),
             ref.scored_topk_ref(q_t, x_t, v_t, k, metric)),
            (ts.scored_topk_gathered(q_t, c_t, m_t, i_t, k, metric=metric,
                                     fused=True),
             ref.scored_topk_gathered_ref(q_t, c_t, m_t, i_t, k, metric))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
