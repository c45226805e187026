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
``gee_fused_from_bucketed`` applies the shared epilogue to them as a
residual fixup.

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
from repro_torch.graph.ell import (BucketedELL, bucketed_degrees,
                                   ell_planes, laplacian_vals)
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.gee_spmm import launch_contraction
from repro_torch.kernels.ref import gee_spmm_fused_ref
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
    if ylab.device.type == "cpu":
        return gee_spmm_fused_ref(ylab, contrib, rowlab, dadd, num_classes,
                                  correlation=correlation, eps=EPS_NORM)
    out = launch_contraction(ylab, contrib, rowlab, dadd, num_classes,
                             correlation=correlation, eps=EPS_NORM)
    if out.shape[0]:
        gee_spmm_fused.launches += 1
    return out


gee_spmm_fused.launches = 0


# ---------------------------------------------------------------------------
# full-pipeline drivers (what the plan layer executes)
# ---------------------------------------------------------------------------

def _diag_addend(labels: torch.Tensor, winv: torch.Tensor,
                 dinv: torch.Tensor, diag_aug: bool):
    """Per-row (rowlab, dadd) epilogue operands; disabled -> empty."""
    if not diag_aug:
        return (torch.zeros(0, dtype=torch.int32, device=labels.device),
                torch.zeros(0, dtype=torch.float32, device=labels.device))
    valid = labels >= 0
    ys = torch.where(valid, labels, torch.zeros_like(labels)).long()
    dadd = torch.where(valid, dinv * dinv * winv[ys], torch.zeros_like(dinv))
    return labels.to(torch.int32).contiguous(), dadd.to(torch.float32)


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
    rowlab, dadd = _diag_addend(labels_rows, winv, dinv, opts.diag_aug)
    z = gee_spmm_fused(ylab, contrib, rowlab, dadd, num_classes,
                       correlation=opts.correlation)
    return z[:n]


def gee_fused_from_bucketed(bell: BucketedELL, labels: torch.Tensor,
                            num_classes: int,
                            opts: GEEOptions = GEEOptions()) -> torch.Tensor:
    """Fused GEE from a degree-bucketed packing of the *base* graph.

    One fused launch per bucket, on its real rows only (the bucket's
    padding rows are its trailing ones): rows are disjoint across buckets,
    so each row's whole contraction and epilogue complete inside one
    launch, and results scatter back by assignment (never addition).
    Degree-0 rows live in no bucket; the residual fixup applies the shared
    epilogue to them.  Spans: ``prep.class_weights``, ``prep.degrees``;
    per bucket (tag ``bucket``) ``prep.laplacian_vals``, ``prep.planes``,
    ``prep.diag_addend`` and ``kernel.gee_fused`` (the launch and the
    scatter back); ``prep.residual_fixup``.
    """
    n = bell.num_nodes
    dev = bell.buckets[0].cols.device if bell.buckets else (
        torch.as_tensor(labels).device)
    labels = torch.as_tensor(labels).to(device=dev, dtype=torch.int32)
    span = obs_trace.span
    with span("prep.class_weights"):
        winv = class_weight_inv(labels, num_classes)

    with span("prep.degrees"):
        if opts.laplacian:
            deg = bucketed_degrees(bell, dev)
            if opts.diag_aug:
                deg = deg + 1.0                # the un-packed self loop
            dinv = inv_sqrt_degrees(deg)
        else:
            dinv = torch.ones(n, dtype=torch.float32, device=dev)

    z = torch.zeros((n, num_classes), dtype=torch.float32, device=dev)
    covered = torch.zeros(n, dtype=torch.bool, device=dev)
    for i, b in enumerate(bell.buckets):
        b = b.real_rows()
        if opts.laplacian:
            with span("prep.laplacian_vals", bucket=i):
                vals = laplacian_vals(b, dinv)
        else:
            vals = b.vals
        with span("prep.planes", bucket=i):
            ylab, contrib = ell_planes(b.cols, vals, labels, winv)
        with span("prep.diag_addend", bucket=i):
            rows = b.row_ids.long()
            rowlab, dadd = _diag_addend(labels[rows], winv, dinv[rows],
                                        opts.diag_aug)
        with span("kernel.gee_fused", bucket=i):
            z[rows] = gee_spmm_fused(ylab, contrib, rowlab, dadd,
                                     num_classes,
                                     correlation=opts.correlation)
            covered[rows] = True

    # Residual fixup: degree-0 rows (no bucket) still owe the diag-aug
    # term and the row norm -- the identical shared-epilogue arithmetic.
    if opts.diag_aug or opts.correlation:
        with span("prep.residual_fixup"):
            z_res = apply_epilogue(
                torch.zeros((n, num_classes), dtype=torch.float32,
                            device=dev),
                labels, winv, dinv, opts=opts, impl="torch")
            z = torch.where(covered[:, None], z, z_res)
    return z


__all__ = ["ENV_FUSED", "MAX_CLASSES", "fused_override", "gee_spmm_fused",
           "gee_fused_from_ell", "gee_fused_from_bucketed"]
