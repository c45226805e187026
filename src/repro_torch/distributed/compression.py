"""Int8 gradient compression with error feedback (port of
``repro/distributed/compression.py``) over ``torch.distributed``.

Before the cross-replica all-reduce, each replica adds its kept residual
to its gradient, quantizes the sum to int8 at a scale shared by all
replicas (one all-reduce MAX of a scalar: int8 payloads quantized at
different scales would sum to a biased mean), sums the payload, dequantizes
and keeps the new quantization residual locally ("error feedback").

What crosses the wire: the reference sums the int8 payload in int32
(``psum`` of ``q.astype(int32)``: int8 sums overflow), and so does this
port, so the payload all-reduce moves 4 bytes an element, as an f32 one
would; ``wire_bytes_int8`` counts the 1 byte an element that an int8
payload would take (the reference's formula, kept; ROADMAP.md section 3,
R7).  The function computed is the reference's.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_all_reduce_mean(x: torch.Tensor, group, error: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce mean of ``x`` over ``group`` (the
    counterpart of the reference's ``compressed_psum_mean``; every rank of
    the group calls it).  -> (the mean f32, this rank's new error)."""
    corrected = x.to(torch.float32) + error
    peak = corrected.abs().max()
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(peak / 127.0, min=1e-12)
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_error = corrected - dequantize_int8(q, scale)
    summed = q.to(torch.int32)                 # int8 sums overflow
    dist.all_reduce(summed, group=group)
    n = float(dist.get_world_size(group))
    return summed.to(torch.float32) * scale / n, new_error


def make_compressed_allreduce(mesh, axis: str = "data"):
    """-> ``f(grads_tree, error_tree) = (mean_grads, new_error)``: each
    leaf's compressed mean over the mesh's ``axis`` (every rank holding
    its own local gradient, as the reference's shard_map data-parallel
    setup)."""
    grp = mesh.get_group(axis)

    def allreduce(grads, error):
        outs = [compressed_all_reduce_mean(g, grp, e) for g, e in
                zip(tree_leaves(grads), tree_leaves(error))]
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(error, [o[1] for o in outs]))

    return allreduce


def wire_bytes_f32(tree: Any) -> int:
    return sum(math.prod(leaf.shape) * 4 for leaf in tree_leaves(tree))


def wire_bytes_int8(tree: Any) -> int:
    return sum(math.prod(leaf.shape) + 4 for leaf in tree_leaves(tree))


__all__ = ["quantize_int8", "dequantize_int8", "compressed_all_reduce_mean",
           "make_compressed_allreduce", "wire_bytes_f32", "wire_bytes_int8"]
