"""``gee_spmm_fused``: contraction, diag-aug and row norm in one kernel, and
the fused drivers (port of ``repro/kernels/gee_fused.py``).

Replaces the TPU kernel ``src/repro/kernels/gee_fused.py::_gee_fused_kernel``
with the contraction kernels of ``gee_spmm`` (``csrc/gee_kernels.cu``, the
same launch geometry) and their epilogue: the contraction, then
``z[r, rowlab_r] += dadd_r`` (skipped at ``rowlab = -1``; all of it off when
``rowlab`` is empty), then the ``row_norm`` arithmetic when ``correlation``.

Bound on the H100: bytes.  It reads 8 B per ELL slot (+ 8 B per row of
``rowlab``/``dadd``) and writes 4*R*K B, at 3.35 TB/s.  The K-wide row stays
in registers or shared memory from the contraction until it is normalized
(a split row: in the block that finishes it), so the staged path's extra
[N, K] write and read (the separate ``row_norm``) disappear.

The drivers pack the *base* graph: diagonal augmentation folds in as
degrees + 1 and the in-kernel addend ``dinv^2 * winv[y]``, so no self-loop
edge is ever packed.  Degree-0 rows sit in no bucket, so
``gee_fused_from_bucketed`` starts Z as the shared epilogue of zero rows (a
residual fixup) and each bucket's launch overwrites its rows in place.

``gee_spmm_gathered`` is the contraction with the gathered source: a
bucket's packing as it is and the fit's per-vertex records in, each slot's
label, class weight and Laplacian scale gathered in the kernel, each row
written in place into Z, so the bucketed drivers run no [R, D] prep pass.

``REPRO_GEE_FUSED=0/1`` overrides the plan layer's choice
(``repro_torch.core.plan.select_fused``); unset defers to it.
"""

from __future__ import annotations

import os

import torch

from repro_torch.core.epilogue import (EPS_NORM, apply_epilogue,
                                       inv_sqrt_degrees)
from repro_torch.core.gee import GEEOptions, class_weight_inv
from repro_torch.graph.containers import ELL
from repro_torch.graph.ell import BucketedELL, bucketed_degrees, ell_planes
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.gee_spmm import (GATHERED_COUNTER, PLANES_COUNTER,
                                          _vec, launch_contraction,
                                          launch_gathered)
from repro_torch.kernels.ref import (diag_addend, gathered_planes,
                                     gee_spmm_fused_ref,
                                     gee_spmm_gathered_ref)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

ENV_FUSED = "REPRO_GEE_FUSED"

# The largest K the fused kernel takes: a warp-a-row block keeps up to 8 rows
# of K floats in shared memory, 32 KiB at K = 1024, inside the 48 KiB a block
# gets without opting in (``kMaxClasses`` in csrc/gee_kernels.cu).
MAX_CLASSES = 1024


def fused_override() -> bool | None:
    """The ``REPRO_GEE_FUSED`` env override: True/False when set, None
    when unset (defer to the cost model)."""
    raw = os.environ.get(ENV_FUSED)
    if raw is None or raw == "":
        return None
    return raw not in ("0", "false", "False", "no")


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

def gee_spmm_fused(ylab: torch.Tensor, contrib: torch.Tensor,
                   rowlab: torch.Tensor, dadd: torch.Tensor,
                   num_classes: int, *,
                   correlation: bool = True) -> torch.Tensor:
    """ELL contraction with the epilogue fused in.

    ``ylab``/``contrib`` are the [R, D] planes of ``ell_planes``;
    ``rowlab`` [R] int32 is each row's own label (-1 = no diag term) and
    ``dadd`` [R] f32 the per-row addend ``dinv^2 * winv[y]``; pass empty
    tensors for both to disable diagonal augmentation.  Returns
    [R, num_classes] f32, row-normalized when ``correlation``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream (or raises).
    """
    check_tensor(ylab, "ylab", torch.int32, 2)
    check_tensor(contrib, "contrib", torch.float32, 2, like=ylab)
    diag = rowlab.numel() > 0
    if diag:
        check_tensor(rowlab, "rowlab", torch.int32, 1, like=ylab)
        check_tensor(dadd, "dadd", torch.float32, 1, like=rowlab)
    elif dadd.numel():
        raise ValueError("dadd given without rowlab")
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}], got "
                         f"{num_classes}")
    if ylab.shape[0]:
        obs_metrics.get_registry().counter(PLANES_COUNTER).inc()
    if ylab.device.type == "cpu":
        return gee_spmm_fused_ref(ylab, contrib, rowlab, dadd, num_classes,
                                  correlation=correlation, eps=EPS_NORM)
    out = launch_contraction(ylab, contrib, rowlab, dadd, num_classes,
                             correlation=correlation, eps=EPS_NORM)
    if out.shape[0]:
        gee_spmm_fused.launches += 1
    return out


gee_spmm_fused.launches = 0


def vertex_records(labels: torch.Tensor,
                   dinv: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 2] int32: each vertex's label and the bits of its d^-1/2 (0
    without the Laplacian), one 8-byte record a vertex, so a gathered slot
    reads both with one load.  Made once a fit."""
    bits = torch.zeros_like(labels) if dinv is None \
        else dinv.view(torch.int32)
    return torch.stack((labels, bits), dim=1)


def gee_spmm_gathered(cols: torch.Tensor, vals: torch.Tensor,
                      row_ids: torch.Tensor, verts: torch.Tensor,
                      winv: torch.Tensor, out: torch.Tensor,
                      num_classes: int, *, laplacian: bool = False,
                      diag_aug: bool = False,
                      correlation: bool = False) -> torch.Tensor:
    """One degree bucket's contraction from its packing as it is, finished
    in place into the fit's Z.

    ``cols`` [R, D] int32 and ``vals`` [R, D] f32 are the bucket's packing,
    ``row_ids`` [R] int32 its rows' vertex ids (a row whose id lies outside
    [0, N), as a padding row's dump row N does, is skipped); ``verts`` [N,
    2] int32 (``vertex_records``: label, -1 = unknown, and the bits of
    d^-1/2) and ``winv`` [K] f32 (``class_weight_inv``) are the fit's.
    Row r -- its slots scaled by d^-1/2 of both ends when ``laplacian``,
    with its diag term when ``diag_aug`` and its row norm when
    ``correlation`` -- is written to ``out[row_ids[r]]``, ``out`` [N, K]
    f32; every other row of ``out`` is left as it is.  The bits are those
    of ``gee_spmm_fused`` on the planes ``laplacian_vals``, ``ell_planes``
    and ``diag_addend`` would make.  Returns ``out``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream (or raises), or, where ``cols`` and ``vals`` do
    not take 16-byte loads (a width not a multiple of 4), the plane kernel
    on the planes it stands for (``gathered_planes``), counted as a plane
    launch and not in ``.launches``.
    """
    check_tensor(cols, "cols", torch.int32, 2)
    check_tensor(vals, "vals", torch.float32, 2, like=cols)
    check_tensor(row_ids, "row_ids", torch.int32, 1, like=cols)
    check_tensor(verts, "verts", torch.int32, 2)
    check_tensor(winv, "winv", torch.float32, 1)
    check_tensor(out, "out", torch.float32, 2)
    if any(t.device != cols.device for t in (verts, winv, out)):
        raise ValueError(f"verts, winv and out must be on {cols.device}, "
                         f"like cols")
    n = verts.shape[0]
    if verts.shape[1] != 2 or tuple(out.shape) != (n, num_classes) \
            or winv.shape[0] != num_classes:
        raise ValueError(f"verts {tuple(verts.shape)}, out "
                         f"{tuple(out.shape)} and winv {tuple(winv.shape)} "
                         f"must be [N, 2], [N, K] and [K] for K="
                         f"{num_classes}")
    most = MAX_CLASSES if diag_aug or correlation else None
    if num_classes < 1 or (most is not None and num_classes > most):
        raise ValueError(f"num_classes must be in [1, {most}] with an "
                         f"epilogue, >= 1 without, got {num_classes}")
    flags = {"laplacian": laplacian, "diag_aug": diag_aug,
             "correlation": correlation}
    if cols.shape[0] == 0:
        return out
    registry = obs_metrics.get_registry()
    if cols.device.type == "cpu":
        registry.counter(GATHERED_COUNTER).inc()
        return gee_spmm_gathered_ref(cols, vals, row_ids, verts, winv, out,
                                     num_classes, **flags, eps=EPS_NORM)
    if not _vec(cols, vals):
        # The kernels gather with 16-byte loads only; a width off them (a
        # width ladder the plan never packs) takes the planes it stands for.
        registry.counter(PLANES_COUNTER).inc()
        rows, ylab, contrib, rowlab, dadd = gathered_planes(
            cols, vals, row_ids, verts, winv, laplacian=laplacian,
            diag_aug=diag_aug)
        out[rows] = launch_contraction(
            ylab, contrib, rowlab if diag_aug or correlation else None, dadd,
            num_classes, correlation=correlation, eps=EPS_NORM)
        return out
    registry.counter(GATHERED_COUNTER).inc()
    launch_gathered(cols, vals, row_ids, verts, winv, out, num_classes,
                    **flags, eps=EPS_NORM)
    gee_spmm_gathered.launches += 1
    return out


gee_spmm_gathered.launches = 0


# ---------------------------------------------------------------------------
# full-pipeline drivers (what the plan layer executes)
# ---------------------------------------------------------------------------

def gee_fused_from_ell(ell: ELL, labels: torch.Tensor, num_classes: int,
                       opts: GEEOptions = GEEOptions()) -> torch.Tensor:
    """Fused GEE from a flat ELL packing of the *base* graph."""
    dev = ell.cols.device
    labels = torch.as_tensor(labels).to(device=dev, dtype=torch.int32)
    n = ell.num_nodes
    vals, cols = ell.vals, ell.cols
    n_rows = vals.shape[0]                 # row-padded plane height
    winv = class_weight_inv(labels, num_classes)
    labels_rows = torch.full((n_rows,), -1, dtype=torch.int32, device=dev)
    labels_rows[:n] = labels

    if opts.laplacian:
        deg = vals.sum(dim=1)              # padding rows -> 0
        if opts.diag_aug:
            deg = deg + 1.0                # the un-packed self loop
        dinv = inv_sqrt_degrees(deg)
        vals = vals * dinv[:, None] * dinv[cols.clamp(0, n_rows - 1).long()]
    else:
        dinv = torch.ones(n_rows, dtype=torch.float32, device=dev)

    ylab, contrib = ell_planes(cols, vals, labels, winv)
    rowlab, dadd = diag_addend(labels_rows, winv, dinv, opts.diag_aug)
    z = gee_spmm_fused(ylab, contrib, rowlab, dadd, num_classes,
                       correlation=opts.correlation)
    return z[:n]


def gee_fused_from_bucketed(bell: BucketedELL, labels: torch.Tensor,
                            num_classes: int,
                            opts: GEEOptions = GEEOptions()) -> torch.Tensor:
    """Fused GEE from a degree-bucketed packing of the *base* graph.

    Z starts as the residual fixup: degree-0 rows live in no bucket and
    still owe the diag-aug term and the row norm, so Z is the shared
    epilogue applied to zero rows (zeros when neither option is on).  Then
    one gathered launch per bucket, on its real rows only (the bucket's
    padding rows are its trailing ones), overwrites that bucket's rows of Z
    in place: rows are disjoint across buckets, so each row's whole
    contraction and epilogue complete inside one launch.  Spans:
    ``prep.class_weights``, ``prep.degrees``, ``prep.residual_fixup``
    (with diag-aug or correlation), and per bucket (tag ``bucket``)
    ``kernel.gee_fused`` (the launch and its in-place write).
    """
    n = bell.num_nodes
    dev = bell.buckets[0].cols.device if bell.buckets else (
        torch.as_tensor(labels).device)
    labels = torch.as_tensor(labels).to(device=dev, dtype=torch.int32)
    span = obs_trace.span
    with span("prep.class_weights"):
        winv = class_weight_inv(labels, num_classes)

    with span("prep.degrees"):
        dinv = None
        if opts.laplacian:
            deg = bucketed_degrees(bell, dev)
            if opts.diag_aug:
                deg = deg + 1.0                # the un-packed self loop
            dinv = inv_sqrt_degrees(deg)

    z = torch.zeros((n, num_classes), dtype=torch.float32, device=dev)
    if opts.diag_aug or opts.correlation:
        with span("prep.residual_fixup"):
            dz = dinv if dinv is not None else torch.ones(
                n, dtype=torch.float32, device=dev)
            z = apply_epilogue(z, labels, winv, dz, opts=opts,
                               impl="torch").contiguous()
    verts = vertex_records(labels, dinv)
    for i, b in enumerate(bell.buckets):
        b = b.real_rows()
        with span("kernel.gee_fused", bucket=i):
            gee_spmm_gathered(b.cols, b.vals, b.row_ids, verts, winv, z,
                              num_classes, laplacian=opts.laplacian,
                              diag_aug=opts.diag_aug,
                              correlation=opts.correlation)
    return z


__all__ = ["ENV_FUSED", "MAX_CLASSES", "fused_override", "gee_spmm_fused",
           "vertex_records", "gee_spmm_gathered", "gee_fused_from_ell",
           "gee_fused_from_bucketed"]
