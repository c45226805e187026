"""Multi-device sparse GEE over a ``torch.distributed`` process group (port
of ``repro/core/distributed.py``).

The reference runs one ``shard_map`` body per device of a mesh; here every
rank of a process group runs that body on its own shard (SPMD):

* the edge list is 1-D sharded across the ranks (each holds E/P edges;
  padding edges weigh 0 and are exact no-ops), sliced on the host before
  the copy to the rank's device;
* each rank computes a *partial* [N_pad, K] embedding of its shard: the
  scatter (``segment_sum``, an ``index_add_`` into float64) or, with
  ``local_backend="cuda"``, its rank-interleaved ELL plane contracted by
  the ``gee_spmm`` kernel;
* one ``reduce_scatter`` leaves each rank its row block [N_pad/P, K], and
  the epilogue finishes it row-locally (``core.fold.combine_partials``):
  only O(N*K) bytes cross between devices, whatever E is;
* Laplacian degrees take one more ``all_reduce``, of [N_pad] float64.

The per-rank steps (:func:`local_shard`, :func:`local_degrees`,
:func:`local_partial`) are public, and :func:`replay_ranks` runs P ranks'
steps one after another on one device, summing what the collectives would
sum: the check of a P-rank split on a machine with one card (NCCL takes
one rank a card).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.fold import (LOCAL_BACKENDS, _group_of,
                                   all_reduce_degrees, combine_partials,
                                   degrees_to_dinv, finish_row_block,
                                   fold_z, pad_labels, pad_nodes,
                                   plane_partial)
from repro_torch.core.gee import GEEOptions, class_weight_inv
from repro_torch.graph.containers import EdgeList
from repro_torch.graph.partition import shard_edges, shard_plane


def local_shard(edges, num_shards: int, shard: int, *, local_backend: str,
                num_rows: int, pre_sharded: bool = False, device=None):
    """Rank ``shard``'s input on ``device`` (``None``: the card).

    ``segment_sum``: its block of the shuffled, padded edge arrays
    (``shard_edges``; with ``pre_sharded=True`` the arrays are taken as
    already shuffled and padded to a multiple of P), an ``EdgeList``.
    ``cuda``: its ELL plane ``(cols, vals)`` [num_rows, width].
    """
    if not isinstance(edges, EdgeList):
        edges = edges.base             # PreparedGraph (duck-typed: no cycle)
    device = resolve_device(device)
    if local_backend == "cuda":
        return shard_plane(edges, num_shards, shard, num_rows, device=device)
    sharded = edges if pre_sharded else shard_edges(edges, num_shards,
                                                    device="cpu")
    size = sharded.padded_size
    if size % num_shards:
        raise ValueError(f"pre-sharded arrays of {size} entries do not "
                         f"split into {num_shards} shards")
    per = size // num_shards
    lo, hi = shard * per, (shard + 1) * per
    return EdgeList(src=sharded.src[lo:hi].to(device),
                    dst=sharded.dst[lo:hi].to(device),
                    weight=sharded.weight[lo:hi].to(device),
                    num_nodes=edges.num_nodes,
                    num_edges=min(max(sharded.num_edges - lo, 0), per))


def local_degrees(local, num_rows: int) -> torch.Tensor:
    """A rank's partial weighted degrees [num_rows], float64."""
    if isinstance(local, EdgeList):
        deg = torch.zeros(num_rows, dtype=torch.float64,
                          device=local.device)
        return deg.index_add_(0, local.src.long(), local.weight.double())
    _, vals = local
    return vals.double().sum(dim=1)


def local_partial(local, labels: torch.Tensor, winv: torch.Tensor,
                  dinv: torch.Tensor | None,
                  num_classes: int) -> torch.Tensor:
    """A rank's partial [num_rows, K] embedding of its shard, before the
    reduce-scatter: float64 from the scatter, f32 from the kernel.
    ``dinv=None`` when Laplacian normalization is off."""
    n_rows = labels.shape[0]
    if isinstance(local, EdgeList):
        if dinv is None:
            dinv = torch.ones(n_rows, dtype=torch.float32,
                              device=labels.device)
        z = torch.zeros(n_rows * num_classes, dtype=torch.float64,
                        device=labels.device)
        fold_z(z, local.src, local.dst, local.weight, labels, winv, dinv,
               num_classes=num_classes, undirected=False)
        return z.reshape(n_rows, num_classes)
    cols, vals = local
    return plane_partial(cols, vals, labels, winv, dinv, num_classes)


def gee_distributed(edges, labels, num_classes: int,
                    opts: GEEOptions = GEEOptions(), *, group=None,
                    pre_sharded: bool = False,
                    local_backend: str = "segment_sum") -> torch.Tensor:
    """Distributed sparse GEE over ``group``: this rank's row block.

    The one-window multi-device instance of the fold: this rank's partial
    over its edge shard, then the shared ``combine_partials``
    reduce-scatter and row-local epilogue.  Diagonal augmentation lives in
    the epilogue (degrees get the +1; no self-loop edges are appended).

    ``edges`` is an ``EdgeList`` or a ``PreparedGraph``, the same on every
    rank, on the device the rank computes on.  ``local_backend`` is
    ``"segment_sum"`` (the O(E/P) scatter) or ``"cuda"`` (each rank packs
    its ELL plane and runs the ``gee_spmm`` kernel; same collectives).
    ``pre_sharded=True`` takes the edge arrays as already shuffled and
    padded (``shard_edges``); it cannot feed the plane.  Returns
    [pad_nodes(N, P)/P, K]; ``core.fold.gather_rows`` assembles [N, K].
    """
    if local_backend not in LOCAL_BACKENDS:
        raise ValueError(f"unknown local_backend {local_backend!r}")
    if local_backend == "cuda" and pre_sharded:
        raise ValueError(
            "pre_sharded edge arrays cannot feed local_backend='cuda' "
            "(the ELL planes are packed from the unsharded edge list)")
    if not isinstance(edges, EdgeList):
        edges = edges.base
    device = resolve_device(edges.device)
    p, r, _ = _group_of(group)
    n_pad = pad_nodes(edges.num_nodes, p)
    k = int(num_classes)
    labels = pad_labels(labels, n_pad, device)
    winv = class_weight_inv(labels, k)
    local = local_shard(edges, p, r, local_backend=local_backend,
                        num_rows=n_pad, pre_sharded=pre_sharded,
                        device=device)
    if opts.laplacian:
        dinv = degrees_to_dinv(
            all_reduce_degrees(local_degrees(local, n_pad), group=group),
            opts.diag_aug)
    else:
        dinv = torch.ones(n_pad, dtype=torch.float32, device=device)
    z = local_partial(local, labels, winv,
                      dinv if opts.laplacian else None, k)
    return combine_partials(z, labels, winv, dinv, group=group, opts=opts)


def replay_ranks(shards, labels, num_classes: int,
                 opts: GEEOptions = GEEOptions(), *,
                 num_nodes: int) -> torch.Tensor:
    """P ranks of ``gee_distributed`` replayed on one device, one after
    another: ``shards`` holds each rank's :func:`local_shard` output, in
    rank order.  Their degrees and partials are summed (the all-reduce and
    the reduce-scatter), and each rank's row block is finished by the
    tail a real rank runs (``core.fold.finish_row_block``).  Returns the whole [num_nodes, K]."""
    p = len(shards)
    first = shards[0]
    device = first.device if isinstance(first, EdgeList) else first[0].device
    n_pad = pad_nodes(num_nodes, p)
    k = int(num_classes)
    labels = pad_labels(labels, n_pad, device)
    winv = class_weight_inv(labels, k)
    if opts.laplacian:
        dinv = degrees_to_dinv(sum(local_degrees(s, n_pad) for s in shards),
                               opts.diag_aug)
    else:
        dinv = torch.ones(n_pad, dtype=torch.float32, device=device)
    z = sum(local_partial(s, labels, winv, dinv if opts.laplacian else None,
                          k) for s in shards)
    rows = n_pad // p
    blocks = [finish_row_block(z[r * rows:(r + 1) * rows], r, labels, winv,
                               dinv, opts=opts) for r in range(p)]
    return torch.cat(blocks)[:num_nodes]


def lower_gee_distributed(mesh, axes, num_nodes: int, num_edges: int,
                          num_classes: int, opts: GEEOptions = GEEOptions()
                          ) -> dict:
    """The dry-run's view of one rank of :func:`gee_distributed`
    (``local_backend="segment_sum"``, the reference's
    ``_gee_distributed_jit`` body), the counterpart of the reference's
    abstract lowering: traced on fake edge arrays of the padded sizes, so
    nothing is allocated.  ``mesh``: a ``DeviceMesh`` over a fake process
    group (``repro_torch.launch.dryrun.fake_world``); ``axes``: the mesh
    axes the edges split over (one axis, or all of them).

    -> ``{"collectives": census, "records", "num_shards", "n_pad",
    "e_pad", "bytes_per_rank": {"edges", "labels", "output"}}``: the
    census priced by ``dryrun.census``; the rank's shard of the edge
    arrays (int32 src and dst, f32 weight), the labels it holds whole, and
    its [N_pad / P, K] f32 row block.  The port sums its partials in
    float64 (ROADMAP F2), so its reduce-scatter and degree all-reduce
    carry twice the reference's f32 bytes."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import (CollectiveRecorder, census,
                                           trace_device)

    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    elif set(axes) == set(names) and mesh.mesh.numel() == \
            dist.get_world_size():
        group = None
    else:
        raise ValueError(f"axes {axes}: one mesh axis or all of {names}")
    p = dist.get_world_size(group)
    e_pad = ((num_edges + p - 1) // p) * p
    n_pad = pad_nodes(num_nodes, p)
    dev = torch.device(trace_device())
    recorder = CollectiveRecorder()
    with FakeTensorMode(allow_non_fake_inputs=True):
        edges = EdgeList(
            src=torch.zeros(e_pad, dtype=torch.int32, device=dev),
            dst=torch.zeros(e_pad, dtype=torch.int32, device=dev),
            weight=torch.zeros(e_pad, dtype=torch.float32, device=dev),
            num_nodes=num_nodes, num_edges=num_edges)
        labels = torch.zeros(n_pad, dtype=torch.int32, device=dev)
        with recorder:
            gee_distributed(edges, labels, num_classes, opts, group=group,
                            pre_sharded=True, local_backend="segment_sum")
    return {"collectives": census(recorder.records),
            "records": recorder.records, "num_shards": p, "n_pad": n_pad,
            "e_pad": e_pad,
            "bytes_per_rank": {"edges": (e_pad // p) * 12,
                               "labels": n_pad * 4,
                               "output": (n_pad // p) * num_classes * 4}}


__all__ = ["gee_distributed", "local_shard", "local_degrees",
           "local_partial", "replay_ranks", "lower_gee_distributed"]
