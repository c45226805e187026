"""``row_norm``: row-wise L2 normalization, GEE's correlation option (port
of ``repro/kernels/row_norm.py``).

Replaces the TPU kernel ``src/repro/kernels/row_norm.py::_row_norm_kernel``
with the CUDA kernels ``row_norm_seg_kernel`` (K <= 32) and
``row_norm_kernel`` (K > 32) in ``csrc/gee_kernels.cu``.  Rows with norm 0
stay exactly 0; the others are divided by ``max(norm, eps)``.

Bound on the H100: bytes, 4*N*K B read and as many written, at 3.35 TB/s;
at GEE's K of a few classes that is microseconds, so the kernel is built to
keep many rows in flight: for K <= 32 a row takes the next power of two
>= K lanes, a warp holds several contiguous rows, and a resident grid
strides over them with the next rows' load issued before the current
reduction.  Its sums give the bits of the full-warp routine that the fused
kernel's epilogue (and K > 32) uses.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_launch, check_tensor,
                                      load_library, stream_of)
from repro_torch.kernels.ref import row_norm_ref


def row_norm(z: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Row-wise L2 normalize [N, K] f32 -> [N, K] f32; zero rows stay zero.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream (or raises).
    """
    check_tensor(z, "z", torch.float32, 2)
    if z.device.type == "cpu":
        return row_norm_ref(z, eps)
    n, k = z.shape
    out = torch.empty_like(z)
    if n == 0 or k == 0:
        return out
    lib = load_library()
    rc = lib.row_norm_launch(z.data_ptr(), out.data_ptr(), n, k, eps,
                             stream_of(z))
    check_launch(lib, rc, "row_norm")
    row_norm.launches += 1
    return out


row_norm.launches = 0

__all__ = ["row_norm"]
