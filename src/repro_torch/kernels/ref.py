"""Plain PyTorch versions of the CUDA kernels (port of
``repro/kernels/ref.py``).

Each kernel wrapper uses its plain version for a tensor on the CPU, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
They are written for clarity, not speed.
"""

from __future__ import annotations

import torch


def gee_spmm_ref(ylab: torch.Tensor, contrib: torch.Tensor,
                 num_classes: int) -> torch.Tensor:
    """Plain ELL GEE contraction.

    ylab:    [N, D] int32 class of each neighbor slot; -1 = padding.
    contrib: [N, D] float32 per-slot contribution w_ij / n_k (0 in padding).
    returns  [N, K] float32: z[r, k] = sum_d contrib[r, d] * (ylab[r, d] == k)
    """
    cols = [torch.where(ylab == k, contrib, 0.0).sum(dim=1)
            for k in range(num_classes)]
    return torch.stack(cols, dim=1).to(torch.float32)


def row_norm_ref(z: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Row-wise L2 normalization; zero rows stay zero."""
    z = z.to(torch.float32)
    norm = torch.sqrt(torch.sum(z * z, dim=-1, keepdim=True))
    return torch.where(norm > 0, z / torch.clamp(norm, min=eps), 0.0)


def gee_spmm_fused_ref(ylab: torch.Tensor, contrib: torch.Tensor,
                       rowlab: torch.Tensor, dadd: torch.Tensor,
                       num_classes: int, correlation: bool = True,
                       eps: float = 1e-30) -> torch.Tensor:
    """Plain fused GEE: the contraction, then ``z[r, rowlab_r] += dadd_r``
    (skipped where ``rowlab`` is -1; all of it off when ``rowlab`` is
    empty), then the row norm when ``correlation``."""
    z = gee_spmm_ref(ylab, contrib, num_classes)
    if rowlab.numel():
        rows = torch.nonzero((rowlab >= 0) & (rowlab < num_classes))[:, 0]
        z[rows, rowlab[rows].long()] += dadd[rows]
    if correlation:
        z = row_norm_ref(z, eps)
    return z


# -- retrieval scoring (port of the plain formulas in
# ``repro/kernels/topk_score.py``) ------------------------------------------

NEG_INF = float(torch.finfo(torch.float32).min)   # masked-slot score
_COS_EPS = 1e-30


def _scores_from_parts(dot, qn2, xn2, metric: str) -> torch.Tensor:
    """l2: ``(2·dot − qn2) − xn2`` = −‖q − x‖²; cosine:
    ``dot / (‖q‖‖x‖)``, 0 when ``sqrt(qn2)·sqrt(xn2)`` is 0."""
    if metric == "l2":
        return 2.0 * dot - qn2 - xn2
    if metric != "cosine":
        raise ValueError(f"unknown metric {metric!r}; pick one of "
                         f"('l2', 'cosine')")
    denom = torch.sqrt(qn2) * torch.sqrt(xn2)
    return torch.where(denom > 0, dot / torch.clamp(denom, min=_COS_EPS),
                       0.0)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``fmaf(a, b, c)``: the product of two f32 values is exact in f64,
    so the sum is rounded once to f64 and then to f32 (twice only where the
    f64 sum lands on an f32 midpoint)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _score_sums(q: torch.Tensor, x: torch.Tensor):
    """``dot``, ``qn2`` and ``xn2`` over the last axis of broadcastable
    ``q`` and ``x``, one fma a term for k = 0, 1, ..., K - 1 in that order:
    the kernels' ``score_of`` chain, shared by both plain scorers so that
    one query and one row score the same bits on either route."""
    shape = torch.broadcast_shapes(q.shape[:-1], x.shape[:-1])
    dot = torch.zeros(shape, dtype=torch.float32, device=q.device)
    qn2 = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    xn2 = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for k in range(q.shape[-1]):
        a, b = q[..., k], x[..., k]
        dot = _fma(a, b, dot)
        qn2 = _fma(a, a, qn2)
        xn2 = _fma(b, b, xn2)
    return dot, qn2, xn2


def pairwise_scores_ref(queries: torch.Tensor, database: torch.Tensor,
                        valid: torch.Tensor | None = None,
                        metric: str = "l2") -> torch.Tensor:
    """Masked [Q, M] scores of ``queries`` [Q, K] against a shared
    ``database`` [M, K]; rows with ``valid == 0`` score ``NEG_INF``
    (``None``: all live)."""
    q = queries.to(torch.float32)
    x = database.to(torch.float32)
    dot, qn2, xn2 = _score_sums(q[:, None, :], x[None, :, :])
    s = _scores_from_parts(dot, qn2, xn2, metric)
    if valid is None:
        return s
    return torch.where(valid.to(torch.float32)[None, :] > 0, s, NEG_INF)


def gathered_scores_ref(queries: torch.Tensor, cand: torch.Tensor,
                        mask: torch.Tensor, metric: str = "l2"
                        ) -> torch.Tensor:
    """Masked [Q, M] scores of ``queries`` [Q, K] against per-query
    candidates ``cand`` [Q, M, K]; ``mask == 0`` slots score ``NEG_INF``."""
    q = queries.to(torch.float32)
    c = cand.to(torch.float32)
    dot, qn2, cn2 = _score_sums(q[:, None, :], c)
    s = _scores_from_parts(dot, qn2, cn2, metric)
    return torch.where(mask.to(torch.float32) > 0, s, NEG_INF)


def masked_topk(scores: torch.Tensor, ids: torch.Tensor | None,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis of a masked score matrix.

    Returns ``(ids [Q, k] int32, scores [Q, k] f32)``.  Equal scores keep
    ascending m, as the reference's stable ``lax.top_k`` does
    (``torch.topk`` defines no order among equal values, so this sorts
    stably).  Slots whose score is the mask sentinel get id ``-1``; k > M
    pads with (``-1``, ``NEG_INF``).  ``ids=None`` means candidate m is
    database row m.
    """
    q, m = scores.shape
    kk = min(int(k), m)
    top, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    top, pos = top[:, :kk], pos[:, :kk]
    out_ids = pos if ids is None else torch.gather(ids, 1, pos)
    out_ids = torch.where(top > NEG_INF / 2, out_ids.to(torch.int32), -1)
    if kk < k:
        pad_i = torch.full((q, k - kk), -1, dtype=torch.int32,
                           device=scores.device)
        pad_s = torch.full((q, k - kk), NEG_INF, dtype=torch.float32,
                           device=scores.device)
        out_ids = torch.cat([out_ids, pad_i], dim=1)
        top = torch.cat([top, pad_s], dim=1)
    return out_ids.to(torch.int32), top.to(torch.float32)


def scored_topk_ref(queries: torch.Tensor, database: torch.Tensor,
                    valid: torch.Tensor | None, k: int,
                    metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """``masked_topk(pairwise_scores_ref(...), None, k)``."""
    return masked_topk(pairwise_scores_ref(queries, database, valid, metric),
                       None, k)


def scored_topk_gathered_ref(queries: torch.Tensor, cand: torch.Tensor,
                             mask: torch.Tensor, ids: torch.Tensor, k: int,
                             metric: str = "l2"
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``masked_topk(gathered_scores_ref(...), ids, k)``."""
    return masked_topk(gathered_scores_ref(queries, cand, mask, metric),
                       ids, k)


__all__ = ["gee_spmm_ref", "row_norm_ref", "gee_spmm_fused_ref", "NEG_INF",
           "pairwise_scores_ref", "gathered_scores_ref", "masked_topk",
           "scored_topk_ref", "scored_topk_gathered_ref"]
