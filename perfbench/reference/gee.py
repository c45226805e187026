"""Sparse GEE in NumPy float64: the paper's ``Z = A_hat W``.

Semantics (the paper's, as the port states them): labels ``-1`` are
unknown (a zero row of W, still a row of Z); diagonal augmentation first
(A <- A + I), then the Laplacian scaling ``D^-1/2 A D^-1/2`` with the
degrees of the augmented graph (a zero degree scales by 0), then
``Z = A_hat W`` with ``W[j, y_j] = 1 / n_{y_j}``, then, under
"correlation", each row divided by its L2 norm (zero rows stay zero; a
norm is clamped at 1e-30).

``prepare`` does what does not depend on the labels once per option
setting; ``embed`` does the rest for one label vector.  ``dtype=None`` is
the reference (float64 throughout).  ``dtype="bfloat16"`` is the control:
the same arithmetic with the edge weights, the class weights, each edge's
contribution and Z rounded to bfloat16 (sums kept wider, as a bf16 kernel
accumulates), the step below the float32 the configuration states.
"""

from __future__ import annotations

import numpy as np

EPS_NORM = 1e-30


def rounded(x: np.ndarray, dtype) -> np.ndarray:
    """``x`` rounded to ``dtype`` and back to float64 (``None``: as is)."""
    if dtype is None:
        return x
    import torch

    t = torch.from_numpy(np.ascontiguousarray(x, np.float64))
    return t.to(getattr(torch, dtype)).to(torch.float64).numpy()


def symmetrize(src: np.ndarray, dst: np.ndarray):
    """One entry per undirected edge -> both directions (self loops
    once)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    off = src != dst
    return (np.concatenate([src, dst[off]]),
            np.concatenate([dst, src[off]]))


def prepare(src: np.ndarray, dst: np.ndarray, num_nodes: int, *,
            laplacian: bool, diag_aug: bool, dtype=None) -> dict:
    """The directed edges of A (+ I) and their (scaled) weights."""
    n = int(num_nodes)
    s, d = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    if diag_aug:
        loop = np.arange(n, dtype=np.int64)
        s, d = np.concatenate([s, loop]), np.concatenate([d, loop])
    w = np.ones(s.shape[0], np.float64)
    if laplacian:
        deg = np.bincount(s, weights=w, minlength=n)
        dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, EPS_NORM)),
                        0.0)
        dinv = rounded(dinv, dtype)
        w = w * dinv[s] * dinv[d]
    return {"src": s, "dst": d, "w": rounded(w, dtype), "num_nodes": n,
            "dtype": dtype}


def embed(prep: dict, labels: np.ndarray, num_classes: int, *,
          correlation: bool) -> np.ndarray:
    """Z [N, K] float64 for one label vector."""
    n, k, dtype = prep["num_nodes"], int(num_classes), prep["dtype"]
    y = np.asarray(labels, np.int64)
    known = y >= 0
    nk = np.bincount(y[known], minlength=k).astype(np.float64)
    winv = rounded(np.where(nk > 0, 1.0 / np.maximum(nk, 1.0), 0.0), dtype)
    # an unknown neighbour (-1) takes the leading 0 weight
    yd = y[prep["dst"]]
    contrib = rounded(prep["w"] * np.concatenate([[0.0], winv])[yd + 1],
                     dtype)
    z = np.bincount(prep["src"] * k + np.maximum(yd, 0), weights=contrib,
                    minlength=n * k).reshape(n, k)
    if correlation:
        norm = np.sqrt((z * z).sum(axis=1, keepdims=True))
        z = np.divide(z, np.maximum(norm, EPS_NORM), out=np.zeros_like(z),
                      where=norm > 0)
    return rounded(z, dtype)


def z_err(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap between two embeddings, each row's measured against
    that row's largest entry of ``want``: max over rows of
    ``max|got - want| / max|want|``.  A row that should be all zero and is
    not reads as its largest entry over 1e-30."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = np.maximum(np.abs(want).max(axis=1), EPS_NORM)
    return float((np.abs(got - want).max(axis=1) / scale).max(initial=0.0))


__all__ = ["EPS_NORM", "rounded", "symmetrize", "prepare", "embed", "z_err"]
