"""``gee_spmm``: the ELL GEE contraction (port of
``repro/kernels/gee_spmm.py``).

Replaces the TPU kernel ``src/repro/kernels/gee_spmm.py::_gee_spmm_kernel``
with the CUDA kernel ``gee_spmm_kernel`` in ``csrc/gee_kernels.cu``:

    z[r, k] = sum_d contrib[r, d] * [ylab[r, d] == k]

Bound on the H100: bytes.  It reads 8 B per ELL slot and writes 4*R*K B, at
3.35 TB/s.  The kernel reduces each row's whole degree inside one block (a
group of 1-8 warps a row, chosen from the width), with lane-private sums
for a tile of classes in registers: one read of each slot for K <= 32, one
write of each output, no atomics.  See the source for the sum order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_launch, check_tensor,
                                      load_library, stream_of)
from repro_torch.kernels.ref import gee_spmm_ref


def gee_spmm(ylab: torch.Tensor, contrib: torch.Tensor,
             num_classes: int) -> torch.Tensor:
    """ELL GEE contraction: ylab [R, D] int32 (-1 pad), contrib [R, D] f32
    -> [R, num_classes] f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream (or raises).
    """
    check_tensor(ylab, "ylab", torch.int32, 2)
    check_tensor(contrib, "contrib", torch.float32, 2, like=ylab)
    if num_classes < 1:
        raise ValueError(f"num_classes must be >= 1, got {num_classes}")
    if ylab.device.type == "cpu":
        return gee_spmm_ref(ylab, contrib, num_classes)
    r, d = ylab.shape
    out = torch.empty((r, num_classes), dtype=torch.float32,
                      device=ylab.device)
    if r == 0:
        return out
    lib = load_library()
    rc = lib.gee_spmm_launch(ylab.data_ptr(), contrib.data_ptr(),
                             out.data_ptr(), r, d, num_classes,
                             stream_of(ylab))
    check_launch(lib, rc, "gee_spmm")
    gee_spmm.launches += 1
    return out


gee_spmm.launches = 0

__all__ = ["gee_spmm"]
