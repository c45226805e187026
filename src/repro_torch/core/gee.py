"""Graph Encoder Embedding: options, host references and the torch
segment-sum backend (port of ``repro/core/gee.py``).

Backends:

  gee_python_loop   the original GEE: a pure-Python loop over the edge list
                    (host numpy; a copy of the reference's).
  gee_scipy         the paper's SciPy DOK -> CSR pipeline, faithful to the
                    Table 1 formulas (host numpy; a copy of the reference's).
  gee_sparse_torch  the port's plain reference backend (``sparse_torch``,
                    the counterpart of ``sparse_jax``): an O(E)
                    ``index_add_`` over ``src*K + y``, on CPU or CUDA.

The kernel backend ``cuda`` lives in ``repro_torch.kernels``; ``gee``
dispatches to all of them through ``repro_torch.core.plan.GEEPlan``.

Shared semantics (the reference's):

* labels: int32 [N], -1 = unknown (zero W row, still gets a Z row).
* option order: diagonal augmentation first (A <- A + I), then Laplacian
  normalization with the degrees of the *augmented* graph, then
  Z = A_hat @ W, then optional row L2 normalization ("correlation").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.epilogue import (EPS_NORM, inv_sqrt_degrees,
                                       row_l2_normalize_np,
                                       row_l2_normalize_torch)
from repro_torch.graph.containers import EdgeList, add_self_loops, degrees


@dataclasses.dataclass(frozen=True)
class GEEOptions:
    laplacian: bool = False
    diag_aug: bool = False
    correlation: bool = False

    def tag(self) -> str:
        return (f"Lap={'T' if self.laplacian else 'F'},"
                f"Diag={'T' if self.diag_aug else 'F'},"
                f"Cor={'T' if self.correlation else 'F'}")


ALL_OPTION_SETTINGS = tuple(
    GEEOptions(laplacian=l, diag_aug=d, correlation=c)
    for l in (True, False) for d in (True, False) for c in (True, False)
)


# ---------------------------------------------------------------------------
# shared small pieces
# ---------------------------------------------------------------------------

def class_counts(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """n_k for k in [0, K); unknown (-1) labels are not counted."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    counts = torch.zeros(num_classes, dtype=torch.float32,
                         device=labels.device)
    return counts.index_add_(0, safe, valid.to(torch.float32))


def class_weight_inv(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """1/n_k per class (0 for empty classes): the W-matrix row scaling."""
    nk = class_counts(labels, num_classes)
    return torch.where(nk > 0, 1.0 / torch.clamp(nk, min=1.0),
                       torch.zeros_like(nk))


# ---------------------------------------------------------------------------
# host reference 1: original GEE (pure-Python edge loop)
# ---------------------------------------------------------------------------

def gee_python_loop(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                    labels: np.ndarray, num_classes: int,
                    opts: GEEOptions = GEEOptions(),
                    num_nodes: int | None = None) -> np.ndarray:
    """Reference original-GEE: per-edge Python loop.  O(E), host only."""
    n = int(num_nodes if num_nodes is not None else labels.shape[0])
    k = int(num_classes)
    src = [int(x) for x in src]
    dst = [int(x) for x in dst]
    weight = [float(x) for x in weight]
    y = [int(x) for x in labels]

    if opts.diag_aug:
        src = src + list(range(n))
        dst = dst + list(range(n))
        weight = weight + [1.0] * n

    nk = [0] * k
    for yj in y:
        if yj >= 0:
            nk[yj] += 1
    winv = [1.0 / c if c > 0 else 0.0 for c in nk]

    if opts.laplacian:
        deg = [0.0] * n
        for s, w in zip(src, weight):
            deg[s] += w
        dinv = [d ** -0.5 if d > 0 else 0.0 for d in deg]
        weight = [w * dinv[s] * dinv[d]
                  for s, d, w in zip(src, dst, weight)]

    z = [[0.0] * k for _ in range(n)]
    for s, d, w in zip(src, dst, weight):
        yd = y[d]
        if yd >= 0 and w != 0.0:
            z[s][yd] += w * winv[yd]

    out = np.asarray(z, np.float64)
    if opts.correlation:
        out = row_l2_normalize_np(out)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# host reference 2: sparse GEE (SciPy CSR), the paper's method
# ---------------------------------------------------------------------------

def gee_scipy(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
              labels: np.ndarray, num_classes: int,
              opts: GEEOptions = GEEOptions(),
              num_nodes: int | None = None,
              return_sparse: bool = False):
    """Paper-faithful sparse GEE: DOK-style construction, CSR compute,
    Table 1 formulas (explicit I_s and D_s^{-1/2} diagonal matrices)."""
    import scipy.sparse as sp

    n = int(num_nodes if num_nodes is not None else labels.shape[0])
    k = int(num_classes)
    a = sp.csr_array((weight.astype(np.float64),
                      (src.astype(np.int64), dst.astype(np.int64))),
                     shape=(n, n))
    if opts.diag_aug:
        a = a + sp.identity(n, format="csr")
    if opts.laplacian:
        deg = np.asarray(a.sum(axis=1)).ravel()
        with np.errstate(divide="ignore"):
            dinv = np.where(deg > 0, deg ** -0.5, 0.0)
        d_s = sp.diags_array(dinv, format="csr")   # D_s^{-1/2}, as in Table 1
        a = d_s @ a @ d_s

    y = labels.astype(np.int64)
    valid = y >= 0
    nk = np.bincount(y[valid], minlength=k).astype(np.float64)
    winv = np.where(nk > 0, 1.0 / np.maximum(nk, 1.0), 0.0)
    rows = np.nonzero(valid)[0]
    w_s = sp.csr_array((winv[y[valid]], (rows, y[valid])), shape=(n, k))

    z = a @ w_s                                    # CSR x CSR -> CSR
    if opts.correlation:
        # rows with norm > 0 divide by max(norm, EPS_NORM), as every other
        # backend does (float64 here, so the clamp keeps denormal-scale
        # float32 rows in agreement)
        nrm = sp.linalg.norm(z, axis=1)
        inv = np.where(nrm > 0, 1.0 / np.maximum(nrm, EPS_NORM), 0.0)
        z = sp.diags_array(inv, format="csr") @ z
    if return_sparse:
        return z
    return np.asarray(z.todense(), np.float32)


# ---------------------------------------------------------------------------
# the torch segment-sum backend: the port's plain reference path
# ---------------------------------------------------------------------------

def laplacian_edge_weights(edges: EdgeList) -> torch.Tensor:
    """w_ij <- w_ij * d_i^{-1/2} * d_j^{-1/2} without materializing D."""
    dinv = inv_sqrt_degrees(degrees(edges))
    return edges.weight * dinv[edges.src.long()] * dinv[edges.dst.long()]


def gee_sparse_torch(edges: EdgeList, labels: torch.Tensor,
                     num_classes: int,
                     opts: GEEOptions = GEEOptions()) -> torch.Tensor:
    """O(E) ``index_add_`` GEE on the edges' device.  Padding edges
    (weight 0) are exact no-ops."""
    labels = torch.as_tensor(labels).to(device=edges.device,
                                        dtype=torch.int32)
    if opts.diag_aug:
        edges = add_self_loops(edges)
    w = laplacian_edge_weights(edges) if opts.laplacian else edges.weight

    n, k = edges.num_nodes, num_classes
    winv = class_weight_inv(labels, k)

    yd = labels[edges.dst.long()]                 # class of each neighbor
    valid = yd >= 0
    yd_safe = torch.where(valid, yd, torch.zeros_like(yd)).long()
    contrib = torch.where(valid, w * winv[yd_safe], torch.zeros_like(w))
    flat_idx = edges.src.long() * k + yd_safe     # scatter target in [0, N*K)
    z = torch.zeros(n * k, dtype=torch.float32, device=edges.device)
    z.index_add_(0, flat_idx, contrib)
    z = z.reshape(n, k)
    if opts.correlation:
        z = row_l2_normalize_torch(z)
    return z


def gee(edges, labels, num_classes: int, opts: GEEOptions = GEEOptions(),
        backend: str = "sparse_torch") -> torch.Tensor:
    """Dispatch front-end: a thin consumer of
    ``repro_torch.core.plan.GEEPlan`` on the graph's own device.

    ``edges`` is an ``EdgeList`` or a ``PreparedGraph``; backends are
    ``sparse_torch``, ``cuda`` (the hand-written kernels), ``scipy``,
    ``python_loop`` and ``auto``.
    """
    from repro_torch.core.plan import GEEPlan   # deferred: plan builds on gee

    return GEEPlan.build(edges, num_classes, opts,
                         backend=backend).execute(labels)


__all__ = ["GEEOptions", "ALL_OPTION_SETTINGS", "class_counts",
           "class_weight_inv", "gee_python_loop", "gee_scipy",
           "laplacian_edge_weights", "gee_sparse_torch", "gee"]
