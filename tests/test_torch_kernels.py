"""The kernels' plain versions held against the JAX Pallas kernels, run in
interpret mode as ``tests/test_kernels.py`` runs them, and the wrappers'
CPU route and input checks.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each one against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gee_fused import gee_spmm_fused as j_gee_spmm_fused
from repro.kernels.gee_spmm import gee_spmm as j_gee_spmm
from repro.kernels.row_norm import row_norm as j_row_norm

from repro_torch.kernels import ref
from repro_torch.kernels.gee_fused import MAX_CLASSES, gee_spmm_fused
from repro_torch.kernels.gee_spmm import gee_spmm
from repro_torch.kernels.row_norm import row_norm

ATOL = 1e-5


def _planes(seed, n, d, k, pad_frac=0.3):
    rng = np.random.default_rng(seed)
    ylab = rng.integers(0, k, (n, d)).astype(np.int32)
    contrib = rng.uniform(0.1, 1.0, (n, d)).astype(np.float32)
    pad = rng.random((n, d)) < pad_frac
    ylab[pad], contrib[pad] = -1, 0.0
    ylab[0], contrib[0] = -1, 0.0              # an all-padding row
    rowlab = rng.integers(-1, k, n).astype(np.int32)
    dadd = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return ylab, contrib, rowlab, dadd


SHAPES = [(1, 1, 1), (7, 5, 3), (13, 8, 1), (64, 130, 9), (37, 20, 40)]


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_gee_spmm_plain_matches_pallas(n, d, k):
    ylab, contrib, _, _ = _planes(n + d + k, n, d, k)
    want = j_gee_spmm(jnp.asarray(ylab), jnp.asarray(contrib), k,
                      interpret=True)
    got = ref.gee_spmm_ref(torch.from_numpy(ylab), torch.from_numpy(contrib),
                           k)
    assert got.shape == (n, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("n,k", [(1, 1), (5, 3), (100, 7), (513, 200)])
def test_row_norm_plain_matches_pallas(n, k):
    rng = np.random.default_rng(n + k)
    z = rng.standard_normal((n, k)).astype(np.float32)
    z[rng.random(n) < 0.2] = 0.0               # zero rows stay zero
    want = j_row_norm(jnp.asarray(z), interpret=True)
    got = ref.row_norm_ref(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("with_rowlab", [True, False])
@pytest.mark.parametrize("correlation", [True, False])
def test_gee_spmm_fused_plain_matches_pallas(n, d, k, with_rowlab,
                                             correlation):
    ylab, contrib, rowlab, dadd = _planes(n * d + k, n, d, k)
    if not with_rowlab:
        rowlab, dadd = np.zeros(0, np.int32), np.zeros(0, np.float32)
    want = j_gee_spmm_fused(jnp.asarray(ylab), jnp.asarray(contrib),
                            jnp.asarray(rowlab), jnp.asarray(dadd), k,
                            correlation=correlation, interpret=True)
    got = ref.gee_spmm_fused_ref(
        torch.from_numpy(ylab), torch.from_numpy(contrib),
        torch.from_numpy(rowlab), torch.from_numpy(dadd), k,
        correlation=correlation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


def test_wrappers_take_plain_version_on_cpu():
    ylab, contrib, rowlab, dadd = _planes(0, 37, 20, 6)
    y, c = torch.from_numpy(ylab), torch.from_numpy(contrib)
    rl, da = torch.from_numpy(rowlab), torch.from_numpy(dadd)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (37, 6)).astype(np.float32))
    counts = (gee_spmm.launches, row_norm.launches, gee_spmm_fused.launches)
    torch.testing.assert_close(gee_spmm(y, c, 6), ref.gee_spmm_ref(y, c, 6),
                               rtol=0, atol=0)
    torch.testing.assert_close(row_norm(z), ref.row_norm_ref(z), rtol=0,
                               atol=0)
    for cor in (True, False):
        torch.testing.assert_close(
            gee_spmm_fused(y, c, rl, da, 6, correlation=cor),
            ref.gee_spmm_fused_ref(y, c, rl, da, 6, correlation=cor),
            rtol=0, atol=0)
    # the plain route launches nothing, so it counts nothing
    assert (gee_spmm.launches, row_norm.launches,
            gee_spmm_fused.launches) == counts


def test_wrappers_check_their_inputs():
    ylab, contrib, rowlab, dadd = _planes(0, 8, 8, 3)
    y, c = torch.from_numpy(ylab), torch.from_numpy(contrib)
    rl, da = torch.from_numpy(rowlab), torch.from_numpy(dadd)
    with pytest.raises(ValueError, match="int32"):
        gee_spmm(y.long(), c, 3)
    with pytest.raises(ValueError, match="float32"):
        gee_spmm(y, c.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        gee_spmm(y.t(), c.t(), 3)
    with pytest.raises(ValueError, match="shape"):
        gee_spmm(y, c[:4], 3)
    with pytest.raises(ValueError, match="num_classes"):
        gee_spmm(y, c, 0)
    with pytest.raises(ValueError, match="2-D"):
        row_norm(c[0])
    with pytest.raises(ValueError, match="shape"):
        gee_spmm_fused(y, c, rl[:5], da[:5], 3)
    with pytest.raises(ValueError, match="without rowlab"):
        gee_spmm_fused(y, c, rl[:0], da, 3)
    with pytest.raises(ValueError, match="num_classes"):
        gee_spmm_fused(y, c, rl, da, MAX_CLASSES + 1)


def test_wrappers_do_not_build_on_import():
    from repro_torch.kernels import build

    assert build.load_library.cache_info().currsize == 0
    assert build.library_path().name.startswith("libgee_kernels_")
    assert [s.name for s in build.sources()] == ["gee_kernels.cu",
                                                 "topk_kernels.cu"]
