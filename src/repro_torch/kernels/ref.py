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


__all__ = ["gee_spmm_ref", "row_norm_ref", "gee_spmm_fused_ref"]
