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

The same kernels take a second source, ``launch_gathered``: a degree
bucket's packing as it is (``cols``, ``vals``) and the fit's per-vertex
records (label and d^-1/2 in 8 bytes), each slot's label, class weight and
Laplacian scale gathered in the kernel, each row written in place to its row
of the fit's [N, K] output (``csrc/gee_kernels.cu``, ``Gathered``).  Its
wrapper is ``repro_torch.kernels.gee_fused.gee_spmm_gathered``.

A launch resolves its geometry through ``autotune.REGISTRY`` (kernels
``cuda.gee_spmm``, ``cuda.gee_spmm_fused`` and ``cuda.gee_spmm_gathered``,
key ``(D, K, vec)``), whose fallback is ``launch_geometry``: with nothing
recorded it is exactly that policy.  ``measured_geometry_search`` times the
knobs' other geometries on a launch's planes, ``measured_gathered_search`` on
a gathered launch's operands, and records the fastest under its own kernel's
name, so a geometry measured for one source is never taken by the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.autotune import REGISTRY, measure_enabled
from repro_torch.kernels.build import (check_launch, check_tensor,
                                      load_library, stream_of)
from repro_torch.kernels.ref import gee_spmm_ref
from repro_torch.obs import metrics as obs_metrics

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


KERNEL_NAME = "cuda.gee_spmm"
FUSED_KERNEL_NAME = "cuda.gee_spmm_fused"
GATHERED_KERNEL_NAME = "cuda.gee_spmm_gathered"

# Registry counters of contractions by source, one a non-empty call of a
# wrapper (a kernel launch on a CUDA tensor, the plain version on a CPU one):
# ``gee_spmm`` and ``gee_spmm_fused`` count planes, ``gee_spmm_gathered``
# gathered, so a run reads the share of its launches that gathered.
PLANES_COUNTER = "gee.launches.planes"
GATHERED_COUNTER = "gee.launches.gathered"


def _geometry_policy(key: tuple[int, ...]) -> tuple[int, int, int]:
    """The registry's fallback: ``launch_geometry`` at key ``(D, K, vec)``
    with the default knobs."""
    d, num_classes, vec = key
    return launch_geometry(d, num_classes, bool(vec))


for _kernel in (KERNEL_NAME, FUSED_KERNEL_NAME, GATHERED_KERNEL_NAME):
    REGISTRY.register(_kernel, fallback=_geometry_policy)


def geometry_key(d: int, num_classes: int, vec: bool) -> tuple[int, ...]:
    return (int(d), int(num_classes), int(bool(vec)))


def check_geometry(geometry, d: int, num_classes: int) -> tuple[int, ...]:
    """``geometry`` as ``(lanes, span, spans)`` if the kernels take it for
    [R, d] planes of ``num_classes`` classes (a recorded entry may come from
    a file); raises ``ValueError`` otherwise."""
    g = tuple(int(v) for v in geometry)
    ok = len(g) == 3 and g[0] >= 1 and g[0] & (g[0] - 1) == 0
    if ok:
        lanes, span, spans = g
        if lanes <= _WARP:
            ok = spans == 1 and (num_classes <= 8 or lanes == _WARP)
        else:
            ok = (2 * _WARP <= lanes <= _BLOCK and span >= 4
                  and span % 4 == 0 and spans == max(-(-d // span), 1))
    if not ok:
        raise ValueError(f"geometry {geometry} is not one the contraction "
                         f"kernels take at D={d}, K={num_classes}")
    return g


def resolve_geometry(kernel: str, d: int, num_classes: int,
                     vec: bool) -> tuple[int, ...]:
    """``(lanes, span, spans)`` of a launch of ``kernel`` (``KERNEL_NAME``,
    ``FUSED_KERNEL_NAME`` or ``GATHERED_KERNEL_NAME``) through
    ``REGISTRY``."""
    return check_geometry(
        REGISTRY.lookup(kernel, geometry_key(d, num_classes, vec)), d,
        num_classes)


# the knobs the measured search sweeps: (lane_loads, seg_loads, span)
_KNOB_LADDER = tuple((ll, sl, sp) for ll in (1, 2, 4, 8, 16)
                     for sl in (8, 16, 32) for sp in (2048, 4096, 8192)
                     if ll <= sl)


def geometry_candidates(kernel: str, d: int, num_classes: int,
                        vec: bool) -> list[tuple[int, ...]]:
    """The measured search's candidates: the current resolution first (so
    a recorded winner can only match or beat it), then every geometry the
    knob ladder gives, without repeats."""
    out = [resolve_geometry(kernel, d, num_classes, vec)]
    for knobs in _KNOB_LADDER:
        g = launch_geometry(d, num_classes, vec, *knobs)
        if g not in out:
            out.append(g)
    return out


def _search(kernel: str, d: int, num_classes: int, vec: bool, launch,
            repeats: int, persist: bool):
    """Time ``launch(geometry)`` at each of ``kernel``'s candidate
    geometries by CUDA events and record the fastest under the key of
    ``(d, num_classes, vec)``.  Returns ``(winner, {geometry: seconds})``;
    a key already recorded returns at once with no timings."""
    return REGISTRY.measured_search(
        kernel, geometry_key(d, num_classes, vec),
        geometry_candidates(kernel, d, num_classes, vec),
        lambda g: launch(check_geometry(g, d, num_classes)),
        repeats=repeats, persist=persist)


def measured_geometry_search(ylab: torch.Tensor, contrib: torch.Tensor,
                             num_classes: int,
                             rowlab: torch.Tensor | None = None,
                             dadd: torch.Tensor | None = None, *,
                             correlation: bool = False, eps: float = 0.0,
                             repeats: int = 3, persist: bool = True):
    """``_search`` on these CUDA planes: ``gee_spmm`` when ``rowlab`` is
    None, else ``gee_spmm_fused``."""
    return _search(
        KERNEL_NAME if rowlab is None else FUSED_KERNEL_NAME, ylab.shape[1],
        num_classes, _vec(ylab, contrib),
        lambda g: launch_contraction(ylab, contrib, rowlab, dadd,
                                     num_classes, correlation=correlation,
                                     eps=eps, geometry=g), repeats, persist)


def measured_gathered_search(cols: torch.Tensor, vals: torch.Tensor,
                             row_ids: torch.Tensor, verts: torch.Tensor,
                             winv: torch.Tensor, out: torch.Tensor,
                             num_classes: int, *, laplacian: bool = False,
                             diag_aug: bool = False,
                             correlation: bool = False, eps: float = 0.0,
                             repeats: int = 3, persist: bool = True):
    """``_search`` for a gathered launch on these CUDA operands (each run
    rewrites the same rows of ``out``), under ``GATHERED_KERNEL_NAME``."""
    return _search(
        GATHERED_KERNEL_NAME, cols.shape[1], num_classes, _vec(cols, vals),
        lambda g: launch_gathered(cols, vals, row_ids, verts, winv, out,
                                  num_classes, laplacian=laplacian,
                                  diag_aug=diag_aug, correlation=correlation,
                                  eps=eps, geometry=g), repeats, persist)


def _vec(ylab: torch.Tensor, contrib: torch.Tensor) -> bool:
    """16-byte loads: d % 4 == 0 and both bases aligned."""
    return (ylab.shape[1] % 4 == 0 and ylab.data_ptr() % 16 == 0
            and contrib.data_ptr() % 16 == 0)


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
                       eps: float = 0.0,
                       geometry: tuple[int, ...] | None = None
                       ) -> torch.Tensor:
    """Launch the contraction kernels on checked CUDA planes: ``gee_spmm``
    when ``rowlab`` is None, else ``gee_spmm_fused`` (an empty ``rowlab``:
    no diag term).  ``geometry`` (``(lanes, span, spans)``, checked by the
    caller) overrides the registry's.  Counts nothing; the wrappers do."""
    r, d = ylab.shape
    dev = ylab.device
    out = torch.empty((r, num_classes), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    vec = _vec(ylab, contrib)
    if geometry is None:
        kernel = KERNEL_NAME if rowlab is None else FUSED_KERNEL_NAME
        if measure_enabled() and geometry_key(d, num_classes, vec) \
                not in REGISTRY.recorded(kernel):
            measured_geometry_search(ylab, contrib, num_classes, rowlab, dadd,
                                     correlation=correlation, eps=eps)
        geometry = resolve_geometry(kernel, d, num_classes, vec)
    lanes, span, spans = geometry
    stream = stream_of(ylab)
    ws, tickets = _split_buffers(dev, stream, r, spans, num_classes)
    ptrs = (_ptr(ws), _ptr(tickets))
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


def _split_buffers(device: torch.device, stream: int, rows: int, spans: int,
                   num_classes: int) -> tuple:
    """The spans' partial sums and the row tickets of a launch whose rows
    are split (``spans`` > 1), else (None, None)."""
    if spans <= 1:
        return None, None
    return (torch.empty(rows * spans * num_classes, dtype=torch.float32,
                        device=device), _tickets(device, stream, rows))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch_gathered(cols: torch.Tensor, vals: torch.Tensor,
                    row_ids: torch.Tensor, verts: torch.Tensor,
                    winv: torch.Tensor, out: torch.Tensor, num_classes: int,
                    *, laplacian: bool = False, diag_aug: bool = False,
                    correlation: bool = False, eps: float = 0.0,
                    geometry: tuple[int, ...] | None = None) -> torch.Tensor:
    """Launch the contraction kernels with the gathered source on checked
    CUDA operands: row r of ``cols``/``vals`` [R, D], scaled by the
    Laplacian when ``laplacian``, finished (diag term with ``diag_aug``, row
    norm with ``correlation``) into row ``row_ids[r]`` of ``out`` [N, K], in
    place; ``verts`` [N, 2] int32 holds each vertex's label and the bits of
    its d^-1/2.  The gathered source takes 16-byte loads only (``_vec``:
    D % 4 == 0, both bases aligned); other operands raise.  ``geometry``
    overrides the registry's.  Counts nothing; the wrapper does."""
    r, d = cols.shape
    if r == 0:
        return out
    if not _vec(cols, vals):
        raise ValueError(f"the gathered launch takes 16-byte loads: width "
                         f"{d} must be a multiple of 4 and cols, vals "
                         f"16-byte aligned")
    vec = True
    if geometry is None:
        if measure_enabled() and geometry_key(d, num_classes, vec) \
                not in REGISTRY.recorded(GATHERED_KERNEL_NAME):
            measured_gathered_search(cols, vals, row_ids, verts, winv, out,
                                     num_classes, laplacian=laplacian,
                                     diag_aug=diag_aug,
                                     correlation=correlation, eps=eps)
        geometry = resolve_geometry(GATHERED_KERNEL_NAME, d, num_classes, vec)
    lanes, span, spans = geometry
    stream = stream_of(cols)
    ws, tickets = _split_buffers(cols.device, stream, r, spans, num_classes)
    lib = load_library()
    rc = lib.gee_gathered_launch(
        cols.data_ptr(), vals.data_ptr(), row_ids.data_ptr(),
        verts.data_ptr(), winv.data_ptr(), out.data_ptr(), _ptr(ws),
        _ptr(tickets), r, d, verts.shape[0], num_classes,
        int(bool(laplacian)), int(bool(diag_aug)), int(bool(correlation)),
        eps, int(vec), lanes, span, stream)
    check_launch(lib, rc, "gee_spmm_gathered")
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
    if ylab.shape[0]:
        obs_metrics.get_registry().counter(PLANES_COUNTER).inc()
    if ylab.device.type == "cpu":
        return gee_spmm_ref(ylab, contrib, num_classes)
    out = launch_contraction(ylab, contrib, None, None, num_classes)
    if out.shape[0]:
        gee_spmm.launches += 1
    return out


gee_spmm.launches = 0

__all__ = ["LANE_LOADS", "SEG_LOADS", "SPAN", "KERNEL_NAME",
           "FUSED_KERNEL_NAME", "GATHERED_KERNEL_NAME", "PLANES_COUNTER",
           "GATHERED_COUNTER", "launch_geometry",
           "geometry_key", "check_geometry", "resolve_geometry",
           "geometry_candidates", "measured_geometry_search",
           "measured_gathered_search", "launch_contraction",
           "launch_gathered", "gee_spmm"]
