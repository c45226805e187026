"""The frozen reference against the paper's dense formula ``Z = A W`` on
tiny graphs, under all 8 option settings, and the class-partitioned probe
against brute force; the port's plain backend beside it on the CPU."""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.reference import gee as ref  # noqa: E402
from perfbench.reference import ivf  # noqa: E402

SETTINGS = list(itertools.product((True, False), repeat=3))


def _graph(seed, n=12, e=30, k=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[:3], dst[:3] = 0, 1                      # a repeated edge
    src[3], dst[3] = 2, 2                        # a self loop
    keep = (src != n - 1) & (dst != n - 1)       # an isolated vertex
    labels = rng.integers(-1, k - 1, n)          # class k-1 empty, some -1
    return src[keep], dst[keep], labels


def _dense(src, dst, labels, n, k, lap, diag, cor):
    s, d = ref.symmetrize(src, dst)
    a = np.zeros((n, n))
    np.add.at(a, (s, d), 1.0)
    if diag:
        a += np.eye(n)
    if lap:
        deg = a.sum(1)
        dinv = np.where(deg > 0, 1 / np.sqrt(np.maximum(deg, 1e-300)), 0.0)
        a = dinv[:, None] * a * dinv[None, :]
    w = np.zeros((n, k))
    for j, y in enumerate(labels):
        if y >= 0:
            w[j, y] = 1.0 / (labels == y).sum()
    z = a @ w
    if cor:
        nrm = np.linalg.norm(z, axis=1, keepdims=True)
        z = np.where(nrm > 0, z / np.maximum(nrm, 1e-300), 0.0)
    return z


@pytest.mark.parametrize("lap,diag,cor", SETTINGS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_the_dense_formula(seed, lap, diag, cor):
    n, k = 12, 3
    src, dst, labels = _graph(seed, n=n, k=k)
    s, d = ref.symmetrize(src, dst)
    got = ref.embed(ref.prepare(s, d, n, laplacian=lap, diag_aug=diag),
                    labels, k, correlation=cor)
    want = _dense(src, dst, labels, n, k, lap, diag, cor)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert not got[n - 1].any() or diag   # isolated: zero unless A + I


@pytest.mark.parametrize("lap,diag,cor", SETTINGS)
def test_reference_agrees_with_the_ports_plain_backend(lap, diag, cor):
    import torch
    from repro_torch.core.gee import GEEOptions, gee_sparse_torch
    from repro_torch.graph.containers import edge_list_from_numpy, symmetrize

    n, k = 200, 4
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
    labels = rng.integers(-1, k, n).astype(np.int32)
    edges = symmetrize(edge_list_from_numpy(src, dst, None, n, device="cpu"))
    port = gee_sparse_torch(edges, torch.from_numpy(labels), k,
                            GEEOptions(lap, diag, cor)).numpy()
    s, d = ref.symmetrize(src, dst)
    want = ref.embed(ref.prepare(s, d, n, laplacian=lap, diag_aug=diag),
                     labels, k, correlation=cor)
    assert ref.z_err(port, want) < 1e-6


def test_z_err_reads_rows_against_their_own_scale():
    want = np.array([[1.0, 0.0], [1e-6, 2e-6], [0.0, 0.0]])
    assert ref.z_err(want, want) == 0.0
    got = want.copy()
    got[1, 0] += 2e-12
    assert ref.z_err(got, want) == pytest.approx(1e-6)
    got = want.copy()
    got[2, 1] = 1e-20
    assert ref.z_err(got, want) > 1e9          # a zero row that is not
    assert ref.z_err(want[:2], want) == float("inf")


def _clusters(seed, n=60, k=3):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    z = np.eye(k)[labels] + 0.3 * rng.standard_normal((n, k))
    return z, labels


def test_full_probe_is_brute_force():
    z, labels = _clusters(3)
    index = ivf.build(z, labels, 3)
    rows = np.arange(z.shape[0])
    ids, scores = ivf.search(index, z, rows, 5, nprobe=3)
    d = ((z[:, None, :] - z[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(scores, -np.sort(d, axis=1)[:, :5],
                               atol=1e-12)
    assert (ids[:, 0] == rows).all()


def test_judge_passes_the_reference_and_catches_faults():
    z, labels = _clusters(4)
    index = ivf.build(z, labels, 3)
    rows = np.arange(0, z.shape[0], 3)
    ids, scores = ivf.search(index, z, rows, 4)
    ok = ivf.judge(index, rows, ids, scores)
    assert ok["score_gap"] < 1e-12 and ok["foreign"] == 0
    assert ok["repeats"] == 0
    twice = ids.copy(), scores.copy()
    twice[0][3, 1:] = twice[0][3, 0]                       # the best, again
    twice[1][3, 1:] = twice[1][3, 0]
    again = ivf.judge(index, rows, *twice)
    assert again["repeats"] == ids.shape[1] - 1
    assert again["foreign"] == 0
    bad = scores.copy()
    bad[0, 1] -= 0.1                                       # a wrong score
    assert ivf.judge(index, rows, ids, bad)["score_gap"] > 0.01
    gone = ids.copy()
    gone[1, 0] = -1                                        # a lost answer
    assert ivf.judge(index, rows, gone, scores)["foreign"] == 1
    worse = ids.copy(), scores.copy()
    worse[0][2, :-1] = worse[0][2, 1:].copy()              # the best dropped
    worse[1][2, :-1] = worse[1][2, 1:].copy()
    assert ivf.judge(index, rows, *worse)["score_gap"] > 1e-3


def test_judge_counts_unreachable_ids_as_foreign():
    z, labels = _clusters(5)
    index = ivf.build(z, labels, 3)
    rows = np.arange(10)
    ids, scores = ivf.search(index, z, rows, 3, nprobe=1)
    far = [int(np.flatnonzero((index["cell"] != index["cell"][r])
                              & (index["cell2"] != index["cell"][r]))[0])
           for r in rows]
    ids[:, -1] = far
    assert ivf.judge(index, rows, ids, scores, nprobe=1)["foreign"] > 0
