"""Collectives along one mesh axis, by dimension: the building blocks of
``sharding.gather_leaf``, the tensor-parallel step and the compressed
all-reduce.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes
(``launch.mesh.make_mesh_for``); ``group(mesh, axis)`` is the process group
of the ranks that differ only along ``axis``.  An axis of size 1 needs no
call, and none is made.  NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

# torch >= 2.12 renames the *_tensor collectives; the names used here exist
# in every version this port runs on
warnings.filterwarnings("ignore", category=FutureWarning,
                        message=r".*_tensor` is deprecated.*")


def axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return int(mesh.mesh.shape[names.index(axis)]) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 when the mesh lacks it)."""
    names = mesh.mesh_dim_names
    return int(mesh.get_local_rank(axis)) if axis in names else 0


def group(mesh, axis: str):
    return mesh.get_group(axis)


def all_gather_dim(x: torch.Tensor, dim: int, mesh, axis: str
                   ) -> torch.Tensor:
    """The blocks of every rank along ``axis`` concatenated along ``dim``,
    in coordinate order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    # the output as the blocks stacked along dim 0 (what gloo and NCCL take)
    dist.all_gather_into_tensor(out.flatten(0, 1), x,
                                group=group(mesh, axis))
    shape = list(x.shape)
    shape[dim] *= n
    return out.movedim(0, dim).reshape(shape)


def reduce_scatter_dim(x: torch.Tensor, dim: int, mesh, axis: str
                       ) -> torch.Tensor:
    """The sum over the ranks along ``axis`` of ``x``, each keeping its
    coordinate's block of ``dim`` (the backward of ``all_gather_dim``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    shape = list(x.shape)
    chunk = shape[dim] // n
    parts = x.reshape(shape[:dim] + [n, chunk] + shape[dim + 1:])
    parts = parts.movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1),
                               group=group(mesh, axis))
    return out


def own_block(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's block of ``dim`` along ``axis``, without communication."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    chunk = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axis) * chunk, chunk)


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced in place over every axis of ``axes`` in turn (over
    their product); returns ``x``."""
    for axis in ((axes,) if isinstance(axes, str) else axes):
        if axis_size(mesh, axis) > 1:
            dist.all_reduce(x, op=op, group=group(mesh, axis))
    return x


__all__ = ["axis_size", "axis_index", "group", "all_gather_dim",
           "reduce_scatter_dim", "own_block", "all_reduce"]
