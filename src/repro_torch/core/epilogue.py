"""The GEE epilogue: one numerics source of truth (port of
``repro/core/epilogue.py``).

Every backend ends the same way: fold the diagonal-augmentation term, apply
the Laplacian degree scaling, row-L2-normalize under the "correlation"
option.  The conventions are the reference's, unchanged:

* ``EPS_NORM = 1e-30``: a row with norm > 0 is divided by
  ``max(norm, EPS_NORM)``; exact-zero rows stay exactly zero.
* Degrees invert the same way: ``d > 0 -> rsqrt(max(d, EPS_NORM))``,
  0 otherwise.
* ``impl="auto"`` routes the row normalization to the CUDA ``row_norm``
  kernel for a tensor on the card and to the plain torch form otherwise.
  The CUDA kernel (``repro_torch/kernels/csrc/gee_kernels.cu``) computes
  the same arithmetic: IEEE ``sqrtf`` and division, no flushed denormals.
"""

from __future__ import annotations

import numpy as np
import torch

# float32 cannot represent a nonzero norm below ~1e-38, so 1e-30 only
# engages on denormal-scale rows, where it caps the blow-up instead of
# dividing by a denormal.
EPS_NORM = 1e-30

ROW_NORM_IMPLS = ("auto", "torch", "cuda")


def _resolve_impl(impl: str, z: torch.Tensor) -> str:
    if impl == "auto":
        return "cuda" if z.is_cuda else "torch"
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}; pick one of "
                         f"{ROW_NORM_IMPLS}")
    return impl


# ---------------------------------------------------------------------------
# row L2 normalization (the "correlation" option)
# ---------------------------------------------------------------------------

def row_l2_normalize_torch(z: torch.Tensor,
                           eps: float = EPS_NORM) -> torch.Tensor:
    """Plain torch row normalization on any device."""
    norm = torch.sqrt(torch.sum(z * z, dim=-1, keepdim=True))
    return torch.where(norm > 0, z / torch.clamp(norm, min=eps),
                       torch.zeros_like(z))


def row_l2_normalize(z: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Row-L2-normalize [N, K]; zero rows stay zero.

    ``impl="cuda"`` calls the ``row_norm`` kernel wrapper, which launches
    the kernel for a CUDA tensor and uses its plain version for a CPU one.
    """
    if _resolve_impl(impl, z) == "cuda":
        from repro_torch.kernels.row_norm import row_norm  # deferred: no cycle

        return row_norm(z, eps=EPS_NORM)
    return row_l2_normalize_torch(z)


def row_l2_normalize_np(z: np.ndarray, eps: float = EPS_NORM) -> np.ndarray:
    """Host-side (numpy, any float dtype) twin of ``row_l2_normalize``."""
    z = np.asarray(z)
    norm = np.sqrt((z * z).sum(axis=-1, keepdims=True))
    out = np.zeros_like(z)
    np.divide(z, np.maximum(norm, eps), out=out, where=norm > 0)
    return out


# ---------------------------------------------------------------------------
# degree inversion (the Laplacian scaling)
# ---------------------------------------------------------------------------

def inv_sqrt_degrees(deg: torch.Tensor,
                     eps: float = EPS_NORM) -> torch.Tensor:
    """d -> d^{-1/2} with the shared zero-degree convention (0 -> 0)."""
    return torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=eps)),
                       torch.zeros_like(deg))


def inv_sqrt_degrees_np(deg: np.ndarray,
                        eps: float = EPS_NORM) -> np.ndarray:
    """Host-side twin of ``inv_sqrt_degrees`` (float64 accumulators)."""
    deg = np.asarray(deg)
    return np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, eps)), 0.0)


# ---------------------------------------------------------------------------
# the full O(N*K) epilogue (diag-aug term + correlation)
# ---------------------------------------------------------------------------

def diag_aug_epilogue(z: torch.Tensor, labels: torch.Tensor,
                      winv: torch.Tensor, dinv: torch.Tensor) -> torch.Tensor:
    """Fold the self-loop term ``Z[i, y_i] += dinv_i^2 * w / n_{y_i}``.

    ``dinv`` already holds ``d_aug^{-1/2}`` (all-ones when Laplacian is
    off).  Unlabeled rows (-1) are untouched.  Returns a new tensor.
    """
    n = z.shape[0]
    valid = labels >= 0
    ys = torch.where(valid, labels, torch.zeros_like(labels)).long()
    add = torch.where(valid, dinv * dinv * winv[ys], torch.zeros_like(dinv))
    out = z.clone()
    out[torch.arange(n, device=z.device), ys] += add
    return out


def apply_epilogue(z: torch.Tensor, labels: torch.Tensor, winv: torch.Tensor,
                   dinv: torch.Tensor, *, opts,
                   impl: str = "torch") -> torch.Tensor:
    """The whole O(rows*K) epilogue on an already-shaped [rows, K] block:
    diag-aug, then correlation.  ``opts`` is any object with the three
    ``GEEOptions`` flags."""
    if opts.diag_aug:
        z = diag_aug_epilogue(z, labels, winv, dinv)
    if opts.correlation:
        z = row_l2_normalize(z, impl=impl)
    return z


def finalize(z_flat: torch.Tensor, labels: torch.Tensor, winv: torch.Tensor,
             dinv: torch.Tensor, *, num_classes: int, opts,
             impl: str = "torch") -> torch.Tensor:
    """Apply the O(N*K) epilogue once to a streamed accumulator.

    ``z_flat`` is the [N*K] (or [N, K]) pre-epilogue sum; ``dinv`` is all
    ones when Laplacian normalization is off.  ``impl="auto"`` runs the
    correlation row norm through the ``row_norm`` kernel on the card.
    """
    n = dinv.shape[0]
    z = z_flat.reshape(n, num_classes)
    return apply_epilogue(z, labels, winv, dinv, opts=opts, impl=impl)


__all__ = ["EPS_NORM", "ROW_NORM_IMPLS", "row_l2_normalize",
           "row_l2_normalize_torch", "row_l2_normalize_np",
           "inv_sqrt_degrees", "inv_sqrt_degrees_np", "diag_aug_epilogue",
           "apply_epilogue", "finalize"]
