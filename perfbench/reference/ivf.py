"""The class-partitioned probe and its top-k in NumPy float64, and the
judge of a served answer.

Semantics (the port's ``ClassPartitionedIndex``, as its docstring states
them): the cells are the classes; a centroid is the mean of Z over the
class's labelled vertices (a class with none is no cell); every vertex
lies in the cell of its nearest centroid (l2, the first on a tie); a query
scores the centroids, takes the ``nprobe`` best cells (equal scores in
ascending cell order), and answers the ``k`` best members of those cells
by ``-||q - x||^2`` (higher is closer).  The default ``nprobe`` is
``ceil(sqrt(cells))``.

Near ties are decided by rounding, not by the semantics: a vertex whose
two nearest centroids lie within ``tau`` of each other may sit in either
cell, and a cell whose score lies within ``tau`` of the last one probed
may or may not be probed.  ``tau = TIE_REL * T``, with ``T`` the score
scale ``||q||^2 + max ||x||^2``.  The judge therefore asks of an answer
that every id is a member the probe *may* reach, that no id is served
twice in one answer, that each score is the true score of its id, and
that no member the probe *must* reach, and better, is missing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.gee import rounded

TIE_REL = 1e-4
_CHUNK = 256


def default_nprobe(num_cells: int) -> int:
    return max(1, int(math.ceil(math.sqrt(max(num_cells, 1)))))


def _scores(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """[Q, M] ``-||q - x||^2`` in float64."""
    qn = (q * q).sum(axis=1)[:, None]
    xn = (x * x).sum(axis=1)[None, :]
    return -np.maximum(qn + xn - 2.0 * (q @ x.T), 0.0)


def build(z: np.ndarray, labels: np.ndarray, num_classes: int) -> dict:
    """Centroids, each vertex's cell, its second cell where the two lie
    within ``tau`` (else its cell again)."""
    z = np.asarray(z, np.float64)
    y = np.asarray(labels, np.int64)
    k = int(num_classes)
    known = y >= 0
    counts = np.bincount(y[known], minlength=k)
    active = counts > 0
    if not active.any():
        raise ValueError("no labelled vertex: the index is one cell")
    sums = np.zeros((k, z.shape[1]))
    np.add.at(sums, y[known], z[known])
    cent = sums / np.maximum(counts, 1)[:, None]
    s = np.where(active[None, :], _scores(z, cent), -np.inf)
    order = np.argsort(-s, axis=1, kind="stable")
    cell = order[:, 0]
    second = order[:, 1] if k > 1 else cell
    rows = np.arange(z.shape[0])
    tau = TIE_REL * ((z * z).sum(axis=1).max() + (cent * cent).sum(axis=1)
                     [active].max())
    near = (s[rows, cell] - s[rows, second]) < tau
    return {"z": z, "cent": cent, "active": active, "cell": cell,
            "cell2": np.where(near & np.isfinite(s[rows, second]), second,
                              cell),
            "xmax": float((z * z).sum(axis=1).max()),
            "nprobe": default_nprobe(int(active.sum()))}


def _probe(index: dict, q: np.ndarray, nprobe: int):
    """The cells each query must and may probe ([Q, C] bool each), and its
    ``nprobe`` best cells as ranked ([Q, nprobe])."""
    act = index["active"]
    s = np.where(act[None, :], _scores(q, index["cent"]), -np.inf)
    order = np.argsort(-s, axis=1, kind="stable")
    srt = np.take_along_axis(s, order, axis=1)
    c = s.shape[1]
    p = min(nprobe, c)
    last = srt[:, p - 1:p]
    nxt = srt[:, p:p + 1] if p < c else np.full_like(last, -np.inf)
    tau = TIE_REL * ((q * q).sum(axis=1)[:, None] + index["xmax"])
    must = act[None, :] & (s > nxt + tau)
    may = act[None, :] & (s >= last - tau)
    return must, may, order[:, :p]


def _query_scores(q: np.ndarray, zt: torch.Tensor, xn: torch.Tensor):
    """[Q, N] ``-||q - x||^2`` in float64 torch on the CPU (threads), the
    matmul form with the temporaries done in place."""
    qt = torch.from_numpy(q)
    s = torch.mm(qt, zt).mul_(2.0)
    s.sub_((qt * qt).sum(1, keepdim=True)).sub_(xn[None, :])
    return s.clamp_(max=0.0)


def judge(index: dict, rows: np.ndarray, ids: np.ndarray,
          scores: np.ndarray, nprobe: int | None = None) -> dict:
    """Judge served answers: ``rows`` [Q] vertex-id queries, ``ids`` and
    ``scores`` [Q, k] as served.

    ``score_gap``: the widest of (a) a served score's distance from the
    true score of its id and (b) the distance by which the r-th served
    score lies below the r-th best member the probe must reach, both over
    ``T``.  ``foreign``: served ids the probe cannot reach (or -1 where
    such a member exists).  ``repeats``: served ids that an earlier
    position of the same answer already holds (an answer that repeats its
    best id passes the two scores' tests).  ``pairs`` and
    ``distinct_rows``: the work of the probes as ranked (for the
    roofline).
    """
    z = index["z"]
    n = z.shape[0]
    nprobe = index["nprobe"] if nprobe is None else int(nprobe)
    rows = np.asarray(rows, np.int64)
    ids = np.asarray(ids, np.int64)
    scores = np.asarray(scores, np.float64)
    k = ids.shape[1]
    zt = torch.from_numpy(z).T.contiguous()
    xn = torch.from_numpy((z * z).sum(axis=1))
    cell = torch.from_numpy(index["cell"])
    sure = torch.from_numpy(index["cell"] == index["cell2"])
    gap, foreign, repeats, pairs = 0.0, 0, 0, 0
    sizes = np.bincount(index["cell"], minlength=index["cent"].shape[0])
    probed_cells = np.zeros(index["cent"].shape[0], bool)
    for c0 in range(0, rows.size, _CHUNK):
        q = z[rows[c0:c0 + _CHUNK]]
        qi, qs = ids[c0:c0 + _CHUNK], scores[c0:c0 + _CHUNK]
        must_c, may_c, ranked = _probe(index, q, nprobe)
        pairs += int(sizes[ranked].sum())
        probed_cells[np.unique(ranked)] = True
        t = (q * q).sum(axis=1) + index["xmax"]
        s = _query_scores(q, zt, xn)                           # [q, N]
        must = torch.from_numpy(must_c)[:, cell] & sure[None, :]
        want = torch.topk(s.masked_fill(~must, -np.inf), k,
                          dim=1).values.numpy()
        real = (qi >= 0) & (qi < n)
        safe = np.where(real, qi, 0)
        true = torch.gather(s, 1, torch.from_numpy(safe)).numpy()
        reach = (np.take_along_axis(may_c, index["cell"][safe], axis=1)
                 | np.take_along_axis(may_c, index["cell2"][safe], axis=1))
        foreign += int((real & ~reach).sum())
        foreign += int((~real & np.isfinite(want)).sum())
        srt = np.sort(np.where(real, qi, -1), axis=1)
        repeats += int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0))
                       .sum())
        g1 = np.where(real, np.abs(qs - true), 0.0) / t[:, None]
        g2 = np.where(np.isfinite(want),
                      np.maximum(want - np.where(real, qs, -np.inf), 0.0),
                      0.0) / t[:, None]
        gap = max(gap, float(g1.max(initial=0.0)), float(g2.max(initial=0.0)))
    return {"score_gap": gap, "foreign": foreign, "repeats": repeats,
            "pairs": pairs,
            "distinct_rows": int(sizes[probed_cells].sum())}


def search(index: dict, z: np.ndarray, rows: np.ndarray, k: int,
           nprobe: int | None = None, dtype=None):
    """The plain search over ``z`` (``index``'s cells), vertex-id queries:
    ``(ids [Q, k], scores [Q, k])``.  ``dtype="bfloat16"`` is the control:
    Z and the scores rounded to bfloat16, the step below float32."""
    z = rounded(np.asarray(z, np.float64), dtype)
    nprobe = index["nprobe"] if nprobe is None else int(nprobe)
    rows = np.asarray(rows, np.int64)
    zt = torch.from_numpy(z).T.contiguous()
    xn = torch.from_numpy((z * z).sum(axis=1))
    cell = torch.from_numpy(index["cell"])
    out_i = np.full((rows.size, k), -1, np.int64)
    out_s = np.full((rows.size, k), -np.inf)
    for c0 in range(0, rows.size, _CHUNK):
        q = z[rows[c0:c0 + _CHUNK]]
        _, _, ranked = _probe(index, q, nprobe)
        s = _query_scores(q, zt, xn)
        if dtype is not None:
            s = s.to(getattr(torch, dtype)).to(torch.float64)
        inside = (torch.from_numpy(ranked)[:, :, None]
                  == cell[None, None, :]).any(1)
        top = torch.topk(s.masked_fill_(~inside, -np.inf), k, dim=1)
        val = top.values.numpy()
        out_i[c0:c0 + _CHUNK] = np.where(np.isfinite(val),
                                         top.indices.numpy(), -1)
        out_s[c0:c0 + _CHUNK] = val
    return out_i, out_s


__all__ = ["TIE_REL", "default_nprobe", "build", "judge", "search"]
