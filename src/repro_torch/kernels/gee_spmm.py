"""``gee_spmm``: the ELL GEE contraction (port of
``repro/kernels/gee_spmm.py``), and the launch both contraction kernels share.

Replaces the TPU kernel ``src/repro/kernels/gee_spmm.py::_gee_spmm_kernel``
with the CUDA kernels ``gee_seg_kernel`` and ``gee_span_kernel`` in
``csrc/gee_kernels.cu``:

    z[r, k] = sum_d contrib[r, d] * [ylab[r, d] == k]

Bound on the H100: bytes.  It reads 8 B per ELL slot and writes 4*R*K B, at
3.35 TB/s.  The work is cut by slots, not rows (``launch_geometry``): a
narrow row takes a segment of 1-32 lanes of a warp, a wide row a block a span
of ``SPAN`` slots, a row wider than that several blocks whose partial sums the
last one to arrive adds in span order (a workspace and a per-row ticket).
Loads are 16 B (``int4``/``float4``) where the width and the bases allow; K
<= 8 is exact.  See the source for the sum order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_launch, check_tensor,
                                      load_library, stream_of)
from repro_torch.kernels.ref import gee_spmm_ref

# Loads of each plane a lane takes (a load is 16 B, 4 slots, where the planes
# allow): a row of D slots gets the power of two of lanes nearest above
# D / (4 * LANE_LOADS), up to a warp (narrow rows) or a block (wide rows).
LANE_LOADS = 4
# The most loads a lane of a warp-held row takes: rows of more than
# 32 * SEG_LOADS loads (2,048 slots) go to blocks.
SEG_LOADS = 16
# Slots of one row a block takes; wider rows are split across blocks.
SPAN = 4096
_WARP, _BLOCK = 32, 256


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def launch_geometry(d: int, num_classes: int, vec: bool,
                    lane_loads: int = LANE_LOADS, seg_loads: int = SEG_LOADS,
                    span: int = SPAN) -> tuple[int, int, int]:
    """``(lanes, span, spans)`` of a launch on [R, d] planes.

    ``lanes`` <= 32: a segment of that many lanes a row (32 for class tiles,
    K > 8), one span.  ``lanes`` in (64, 128, 256): a block of that many
    threads a span of ``span`` slots, ``spans`` = ceil(d / span) blocks a row.
    ``vec``: 16-byte loads (d % 4 == 0 and aligned bases).
    """
    if not 1 <= lane_loads <= seg_loads or span < 4 or span % 4:
        raise ValueError(f"lane_loads {lane_loads}, seg_loads {seg_loads} "
                         f"and span {span}: need 1 <= lane_loads <= "
                         f"seg_loads and span a positive multiple of 4")
    unit = 4 if vec else 1
    loads = d // unit
    if loads <= _WARP * seg_loads:
        lanes = min(_pow2_at_least(-(-loads // lane_loads)), _WARP)
        return (_WARP if num_classes > 8 else lanes), span, 1
    per_span = min(loads, span // unit)
    lanes = min(max(_pow2_at_least(-(-per_span // lane_loads)), 2 * _WARP),
                _BLOCK)
    return lanes, span, max(-(-d // span), 1)


# Ticket counters of split rows, one buffer a (device, stream): zeroed when
# made, and every launch that takes a ticket puts it back to 0, so the
# launches of one stream, which run in order, share it.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, rows: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < rows:
        size = max(rows, 2 * (0 if t is None else t.numel()), 1024)
        t = _TICKETS[key] = torch.zeros(size, dtype=torch.int32,
                                        device=device)
    return t


def launch_contraction(ylab: torch.Tensor, contrib: torch.Tensor,
                       rowlab: torch.Tensor | None, dadd: torch.Tensor | None,
                       num_classes: int, *, correlation: bool = False,
                       eps: float = 0.0) -> torch.Tensor:
    """Launch the contraction kernels on checked CUDA planes: ``gee_spmm``
    when ``rowlab`` is None, else ``gee_spmm_fused`` (an empty ``rowlab``:
    no diag term).  Counts nothing; the wrappers do."""
    r, d = ylab.shape
    dev = ylab.device
    out = torch.empty((r, num_classes), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    vec = (d % 4 == 0 and ylab.data_ptr() % 16 == 0
           and contrib.data_ptr() % 16 == 0)
    lanes, span, spans = launch_geometry(d, num_classes, vec)
    stream = stream_of(ylab)
    ws = tickets = None
    if spans > 1:           # the spans' partial sums, and the row tickets
        ws = torch.empty(r * spans * num_classes, dtype=torch.float32,
                         device=dev)
        tickets = _tickets(dev, stream, r)
    ptrs = (None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr())
    lib = load_library()
    if rowlab is None:
        rc = lib.gee_spmm_launch(ylab.data_ptr(), contrib.data_ptr(),
                                 out.data_ptr(), *ptrs, r, d, num_classes,
                                 int(vec), lanes, span, stream)
        check_launch(lib, rc, "gee_spmm")
        return out
    diag = rowlab.numel() > 0
    rc = lib.gee_spmm_fused_launch(
        ylab.data_ptr(), contrib.data_ptr(),
        rowlab.data_ptr() if diag else None, dadd.data_ptr() if diag else None,
        out.data_ptr(), *ptrs, r, d, num_classes, int(bool(correlation)), eps,
        int(vec), lanes, span, stream)
    check_launch(lib, rc, "gee_spmm_fused")
    return out


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
    out = launch_contraction(ylab, contrib, None, None, num_classes)
    if out.shape[0]:
        gee_spmm.launches += 1
    return out


gee_spmm.launches = 0

__all__ = ["LANE_LOADS", "SEG_LOADS", "SPAN", "launch_geometry",
           "launch_contraction", "gee_spmm"]
