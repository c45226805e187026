"""The staged ``cuda`` backend: the drivers that assemble ``gee_spmm`` and
``row_norm`` into the full GEE pipeline (port of ``repro/kernels/ops.py``;
``cuda`` is the counterpart of the reference's ``pallas`` backend).

Two packings feed the contraction: one flat [N_pad, D_max] plane
(``gee_cuda_from_ell``) or the degree buckets (``gee_cuda_from_bucketed``,
one gathered launch per bucket on its real rows, each writing its rows of Z
in place).  Correlation then runs the ``row_norm`` kernel.

Diagonal augmentation is never silently dropped: the ``*_from_*`` drivers
take a packing of the graph as it is and raise ``ValueError`` when
``opts.diag_aug`` is set -- the caller packs the self-loop-augmented graph
(``gee_cuda`` and the plan layer do) and passes ``diag_aug=False``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.epilogue import inv_sqrt_degrees, row_l2_normalize
from repro_torch.core.gee import GEEOptions, class_weight_inv
from repro_torch.graph.containers import ELL, EdgeList, add_self_loops
from repro_torch.graph.ell import (BucketedELL, bucketed_degrees,
                                   edges_to_bucketed_ell, edges_to_ell,
                                   ell_planes)
from repro_torch.kernels.gee_fused import gee_spmm_gathered, vertex_records
from repro_torch.kernels.gee_spmm import gee_spmm
from repro_torch.obs import trace as obs_trace


def _reject_diag_aug(opts: GEEOptions) -> None:
    if opts.diag_aug:
        raise ValueError(
            "the staged drivers take the self-loop-augmented packing and "
            "diag_aug=False; pack add_self_loops(edges) (as gee_cuda and "
            "GEEPlan do) or use the fused drivers")


def gee_cuda_from_ell(ell: ELL, labels: torch.Tensor, num_classes: int,
                      opts: GEEOptions = GEEOptions()) -> torch.Tensor:
    """GEE from a flat ELL tiling (device-side math only)."""
    _reject_diag_aug(opts)
    dev = ell.cols.device
    labels = torch.as_tensor(labels).to(device=dev, dtype=torch.int32)
    n = ell.num_nodes
    vals, cols = ell.vals, ell.cols

    if opts.laplacian:
        dinv = inv_sqrt_degrees(vals.sum(dim=1))           # padded rows -> 0
        vals = vals * dinv[:, None] * dinv[cols.clamp(0, n - 1).long()]

    ylab, contrib = ell_planes(cols, vals, labels,
                               class_weight_inv(labels, num_classes))
    z = gee_spmm(ylab, contrib, num_classes)[:n]
    if opts.correlation:
        z = row_l2_normalize(z.contiguous(), impl="cuda")
    return z


def gee_cuda_from_bucketed(bell: BucketedELL, labels: torch.Tensor,
                           num_classes: int,
                           opts: GEEOptions = GEEOptions()) -> torch.Tensor:
    """GEE from a degree-bucketed ELL tiling: one gathered launch
    (``gee_spmm_gathered``, no epilogue) per bucket on its real rows (the
    bucket's padding rows are its trailing ones), each writing its rows of
    Z in place; rows are disjoint across buckets, and degree-0 rows stay
    zero.  Spans: ``prep.class_weights``, ``prep.degrees`` (with the
    Laplacian); per bucket (tag ``bucket``) ``kernel.gee_spmm`` (the
    launch and its in-place write)."""
    _reject_diag_aug(opts)
    n = bell.num_nodes
    dev = bell.buckets[0].cols.device if bell.buckets else (
        torch.as_tensor(labels).device)
    labels = torch.as_tensor(labels).to(device=dev, dtype=torch.int32)
    span = obs_trace.span
    with span("prep.class_weights"):
        winv = class_weight_inv(labels, num_classes)

    dinv = None
    if opts.laplacian:
        with span("prep.degrees"):
            dinv = inv_sqrt_degrees(bucketed_degrees(bell, dev))

    z = torch.zeros((n, num_classes), dtype=torch.float32, device=dev)
    verts = vertex_records(labels, dinv)
    for i, b in enumerate(bell.buckets):
        b = b.real_rows()
        with span("kernel.gee_spmm", bucket=i):
            gee_spmm_gathered(b.cols, b.vals, b.row_ids, verts, winv, z,
                              num_classes, laplacian=opts.laplacian)
    if opts.correlation:
        z = row_l2_normalize(z.contiguous(), impl="cuda")
    return z


def gee_cuda(edges: EdgeList, labels, num_classes: int,
             opts: GEEOptions = GEEOptions(), *,
             bucketed: bool = True) -> torch.Tensor:
    """Full staged pipeline: edge list -> (bucketed) ELL (host) -> kernels,
    on the edges' device.  Diagonal augmentation packs A + I."""
    if opts.diag_aug:
        edges = add_self_loops(edges)
        opts = dataclasses.replace(opts, diag_aug=False)
    if bucketed:
        return gee_cuda_from_bucketed(edges_to_bucketed_ell(edges), labels,
                                      num_classes, opts)
    return gee_cuda_from_ell(edges_to_ell(edges), labels, num_classes, opts)


__all__ = ["gee_cuda_from_ell", "gee_cuda_from_bucketed", "gee_cuda"]
