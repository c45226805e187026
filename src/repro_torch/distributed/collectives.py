"""Collectives along one mesh axis, by dimension: the building blocks of
``sharding.gather_leaf``, the tensor-parallel step, the expert-parallel
dispatch and the compressed all-reduce.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes
(``launch.mesh.make_mesh_for``); ``group(mesh, axis)`` is the process group
of the ranks that differ only along ``axis``.  An axis of size 1 needs no
call, and none is made.  NCCL on the card, gloo on the CPU.

The autograd functions at the end carry these collectives through the
backward: ``Gather`` (all-gather; a reduce-scatter or this rank's block
back), ``Enter`` / ``Leave`` (the boundaries of a tensor-parallel region:
identity one way, an all-reduce the other), ``AllReduce`` (a sum both
ways), ``AllToAll`` (its own backward) and ``GradScale``.
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


def all_to_all_dim(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` [n, ...] with block i of dim 0 sent to coordinate i along
    ``axis``: -> [n, ...] with block j the one coordinate j sent here
    (``lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
    if axis_size(mesh, axis) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group(mesh, axis))
    return out


# ---------------------------------------------------------------------------
# collectives as autograd functions
# ---------------------------------------------------------------------------

class Gather(torch.autograd.Function):
    """Forward: all-gather ``x`` along each ``(dim, axis)`` of ``plan`` in
    turn.  Backward, in reverse: a reduce-scatter where the step sums
    contributions over the axis (``reduce``), else this rank's block."""

    @staticmethod
    def forward(ctx, x, mesh, plan):
        ctx.mesh, ctx.plan = mesh, plan
        for dim, axis, _ in plan:
            x = all_gather_dim(x, dim, mesh, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        for dim, axis, reduce in reversed(ctx.plan):
            g = reduce_scatter_dim(g, dim, ctx.mesh, axis) if reduce \
                else own_block(g, dim, ctx.mesh, axis)
        return g.contiguous(), None, None


class Enter(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes="model"):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes), \
            None, None


class Leave(torch.autograd.Function):
    """All-reduce over ``axes`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes="model"):
        return all_reduce(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllReduce(torch.autograd.Function):
    """All-reduce over ``axes`` forward and backward (``lax.psum``, whose
    transpose is itself)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes), \
            None, None


class AllToAll(torch.autograd.Function):
    """``all_to_all_dim`` along ``axis``; its backward is the same
    exchange of the gradient (the exchange is its own inverse)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all_dim(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim(g, ctx.mesh, ctx.axis), None, None


class GradScale(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


__all__ = ["axis_size", "axis_index", "group", "all_gather_dim",
           "reduce_scatter_dim", "own_block", "all_reduce", "all_to_all_dim",
           "Gather", "Enter", "Leave", "AllReduce", "AllToAll", "GradScale"]
