"""Logical-axis sharding rules (port of ``repro/distributed/sharding.py``).

Every parameter / activation dimension carries a *logical* name; this module
maps logical names to physical mesh axes with a **divisibility fallback**:
a dimension is only sharded if its size divides by the mesh-axis product,
otherwise the annotation is dropped (replicated).  The same rule set serves
the 10 architectures without per-arch special-casing.

Rule set (the reference's, unchanged):

  batch       -> ("pod", "data")   data parallel over both pod and data axes
  vocab       -> model             embedding/logits vocab-sharded
  fsdp        -> data              weight d_model dim: ZeRO-3 style FSDP
  heads_flat  -> model             fused H*hd projections: tensor parallel
  mlp         -> model             FFN hidden
  experts     -> model             expert parallelism
  kv_heads    -> model             KV cache heads (falls back to replicate)
  seq         -> None

A spec is a tuple like the reference's ``PartitionSpec``: one entry per
dim, each ``None``, an axis name, or a tuple of axis names (the dim split
over their product, the first axis outermost).  The rule functions read
only the mesh's ``{axis: size}``: ``mesh`` is a mapping or a
``DeviceMesh``.  ``param_shardings`` / ``cache_shardings`` /
``batch_shardings`` return ``{leaf path: spec}`` (paths as
``repro_torch.tree.flatten_with_paths`` names them, the reference's
``path_to_str``).

``shard_leaf`` cuts this rank's block of a full leaf and ``gather_leaf``
all-gathers a block back into the full leaf, over a ``DeviceMesh``.  The
reference's ``make_constrainer`` hints GSPMD where activations live; here
the tensor-parallel step's explicit collectives
(``repro_torch.distributed.tensor_parallel``) take that role, and
``make_constrainer`` keeps only the hook's attributes.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.distributed.collectives import all_gather_dim, axis_index
from repro_torch.tree import flatten_with_paths

LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "vocab": ("model",),
    "fsdp": ("data",),
    "heads_flat": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "kv_heads": ("model",),
    "kv_seq": ("model",),
    "lru": ("model",),
    # expert FFN hidden dim: E takes model, D takes data -- the pod axis is
    # the only one left (ZeRO-3 over pods for the 1T MoE)
    "expert_ff": ("pod",),
}

# Serving (decode) layout: weight-stationary pure tensor parallelism; every
# weight dim shards across BOTH mesh axes where divisible and nothing is
# ever gathered.
SERVING_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "vocab": ("model", "data"),
    "fsdp": (),
    "heads_flat": ("model", "data"),
    "mlp": ("model", "data"),
    "lru": ("model", "data"),
    "experts": ("model",),
    "kv_heads": ("model",),
    "kv_seq": ("model",),
    "expert_ff": ("data",),
}

BATCH_AXES = ("pod", "data")


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a mapping or a ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {name: int(n) for name, n in zip(mesh.mesh_dim_names,
                                            mesh.mesh.shape)}


def _mesh_axes_for(logical: Optional[str], sizes: dict,
                   rules=None) -> tuple[str, ...]:
    if logical is None:
        return ()
    axes = (rules or LOGICAL_RULES).get(logical, ())
    return tuple(a for a in axes if a in sizes)


def spec_for_shape(shape, logical_axes, mesh, rules=None) -> tuple:
    """The spec of ``shape`` given logical axis names (right-aligned:
    ``logical_axes`` may be shorter than the rank; leading dims replicate).
    Divisibility fallback, prefix cut and no-axis-reuse as the reference's."""
    sizes = axis_sizes(mesh)
    rank = len(shape)
    names: list = [None] * rank
    offset = rank - len(logical_axes)
    used: set[str] = set()
    for i, logical in enumerate(logical_axes):
        dim = offset + i
        axes = _mesh_axes_for(logical, sizes, rules)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            continue
        total = int(np.prod([sizes[a] for a in axes]))
        if total > 1 and shape[dim] % total == 0:
            names[dim] = axes if len(axes) > 1 else axes[0]
            used.update(axes)
        else:
            # a prefix of the axis tuple (batch on ("pod", "data") where
            # only "pod" divides)
            for cut in range(len(axes) - 1, 0, -1):
                sub = axes[:cut]
                tot = int(np.prod([sizes[a] for a in sub]))
                if tot > 1 and shape[dim] % tot == 0:
                    names[dim] = sub if len(sub) > 1 else sub[0]
                    used.update(sub)
                    break
    return tuple(names)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis a spec splits some dim over, in dim order."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def make_constrainer(mesh=None, moe_impl: str = "ep", rules=None):
    """The reference's activation-constraint hook, as the identity: the
    port places activations by the tensor-parallel step's collectives.
    It keeps ``mesh``, ``moe_impl`` and ``serving`` for the modules that
    read them."""
    def constrain(x, *names):
        return x

    constrain.mesh = mesh
    constrain.moe_impl = moe_impl
    constrain.serving = rules is SERVING_RULES
    return constrain


# ---------------------------------------------------------------------------
# parameter logical axes (path-pattern -> logical names of trailing dims)
# ---------------------------------------------------------------------------

_PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    # order matters: first match wins
    ("embed", ("vocab", "fsdp")),
    ("head", ("fsdp", "vocab")),
    ("frontend", (None, "fsdp")),
    ("router", ("fsdp", "experts")),
    ("w_gate", ("fsdp", "mlp")),        # dense mlp [D, F]
    ("w_up", ("fsdp", "mlp")),
    ("w_down", ("mlp", "fsdp")),
    ("wq", ("fsdp", "heads_flat")),
    ("wk", ("fsdp", "heads_flat")),
    ("wv", ("fsdp", "heads_flat")),
    ("wo", ("heads_flat", "fsdp")),
    ("bq", ("heads_flat",)),
    ("bk", ("heads_flat",)),
    ("bv", ("heads_flat",)),
    ("w_in", ("fsdp", "heads_flat")),   # ssm fused in-proj
    ("w_x_branch", ("fsdp", "lru")),
    ("w_gate_branch", ("fsdp", "lru")),
    ("w_out", ("lru", "fsdp")),         # ssm/rglru out-proj
    ("conv_w", (None, "lru")),
)

_MOE_EXPERT = {"we_gate": ("experts", "fsdp", "expert_ff"),
               "we_up": ("experts", "fsdp", "expert_ff"),
               "we_down": ("experts", "expert_ff", "fsdp")}


def _leaf_logical(path_str: str, ndim: int) -> tuple:
    parts = path_str.split("/")
    last = parts[-1]
    # optimizer-state leaves inherit the parent param's logical axes:
    # mu/nu mirror the param tree (same leaf name); adafactor's factored
    # moments drop one trailing dim each
    if last in ("vr", "vc", "v") and len(parts) >= 2:
        base = _leaf_logical("/".join(parts[:-1]), ndim + 1)
        if not base:
            return ()
        if last == "vr":                      # param.shape[:-1]
            return base[:-1]
        if last == "vc":                      # param.shape[:-2] + [-1]
            return base[:-2] + base[-1:] if len(base) >= 2 else base
        return base                           # unfactored: same shape
    if last in _MOE_EXPERT:
        return _MOE_EXPERT[last]
    for name, logical in _PARAM_RULES:
        if last == name:
            return logical
    return ()


def param_shardings(abstract_params, mesh, rules=None) -> dict:
    """``{path: spec}`` for every leaf of a parameter (or optimizer-state)
    tree; its leaves need only ``.shape`` (``meta`` tensors will do)."""
    return {path: spec_for_shape(tuple(x.shape),
                                 _leaf_logical(path, len(x.shape)), mesh,
                                 rules)
            for path, x in flatten_with_paths(abstract_params).items()}


def cache_shardings(abstract_caches, mesh) -> dict:
    """KV caches: batch on (pod, data); heads on model when divisible,
    otherwise the *sequence* dim on model (decode context parallelism);
    SSM / RG-LRU states and conv tails by their own logical dims."""
    model_size = axis_sizes(mesh).get("model", 1)

    def kv_spec(shape):
        lead = (None,) * (len(shape) - 4)
        kv_heads = shape[-2]
        if model_size > 1 and kv_heads % model_size == 0:
            return lead + ("batch", None, "kv_heads", None)
        if model_size > 1 and shape[-3] % model_size == 0:
            return lead + ("batch", "kv_seq", None, None)
        return lead + ("batch", None, None, None)

    def leaf(path, x):
        last = path.rsplit("/", 1)[-1]
        shape = tuple(x.shape)
        if last in ("k", "v"):
            return spec_for_shape(shape, kv_spec(shape), mesh)
        if last == "pos":
            return spec_for_shape(shape, kv_spec(shape + (1, 1))[:-2], mesh)
        if last == "h":      # ssm [B,H,P,N] / rglru [B,W]
            if len(shape) >= 4:
                return spec_for_shape(shape, (None,) * (len(shape) - 4)
                                      + ("batch", "heads_flat", None, None),
                                      mesh)
            return spec_for_shape(shape, (None,) * (len(shape) - 2)
                                  + ("batch", "lru"), mesh)
        if last == "conv":
            return spec_for_shape(shape, (None,) * (len(shape) - 3)
                                  + ("batch", None, "lru"), mesh)
        return spec_for_shape(shape, (), mesh)

    return {path: leaf(path, x)
            for path, x in flatten_with_paths(abstract_caches).items()}


def batch_shardings(abstract_batch, mesh) -> dict:
    """Input batches: the leading dim is the batch -> (pod, data)."""
    return {path: spec_for_shape(tuple(x.shape),
                                 ("batch",) + (None,) * (len(x.shape) - 1),
                                 mesh)
            for path, x in flatten_with_paths(abstract_batch).items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(entry, sizes: dict, coords: dict) -> tuple[int, int]:
    """-> (this rank's block index along a dim split by ``entry``, the
    number of blocks): row-major over the entry's axes, the first
    outermost."""
    idx, n = 0, 1
    for axis in entry_axes(entry):
        idx = idx * sizes[axis] + coords[axis]
        n *= sizes[axis]
    return idx, n


def take_block(x: torch.Tensor, dim: int, entry, mesh,
              coords=None) -> torch.Tensor:
    """This rank's block (a view) of ``x`` along ``dim`` split by the spec
    entry ``entry``.  ``coords``: ``{axis: index}`` of the block (default:
    this rank's on the ``DeviceMesh``)."""
    sizes = axis_sizes(mesh)
    if coords is None:
        coords = {a: axis_index(mesh, a) for a in sizes}
    idx, n = block_index(entry, sizes, coords)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    chunk = x.shape[dim] // n
    return x.narrow(dim, idx * chunk, chunk)


def gather_block(x: torch.Tensor, dim: int, entry, mesh) -> torch.Tensor:
    """Every rank's block along the axes of ``entry`` concatenated along
    ``dim`` (the inverse of ``take_block``; a collective), the innermost
    axis first."""
    dim = dim % x.dim()
    for axis in reversed(entry_axes(entry)):
        x = all_gather_dim(x, dim, mesh, axis)
    return x


def shard_leaf(full: torch.Tensor, spec, mesh, coords=None) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a new contiguous
    tensor: the full leaf may be freed).  ``coords``: ``{axis: index}`` of
    the block to cut (default: this rank's on the ``DeviceMesh``)."""
    if coords is None:
        coords = {a: axis_index(mesh, a) for a in axis_sizes(mesh)}
    out = full
    for dim, entry in enumerate(spec):
        out = take_block(out, dim, entry, mesh, coords)
    return out.clone(memory_format=torch.contiguous_format)


def block_shape(shape, spec, sizes: dict) -> tuple:
    """The shape of one rank's block of a leaf of ``shape`` under
    ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways")
        out[dim] //= n
    return tuple(out)


def block_bytes(tree, specs: dict, sizes: dict) -> int:
    """One rank's bytes of a tree of (meta) tensors under ``specs``."""
    total = 0
    for path, x in flatten_with_paths(tree).items():
        total += math.prod(block_shape(tuple(x.shape), specs[path], sizes)) \
            * x.element_size()
    return total


def batch_index(mesh, axes=BATCH_AXES) -> tuple[int, int]:
    """-> (this rank's index among the ranks of the batch axes ``axes``,
    their count): row-major, the first axis (the pod) outermost; which
    block of a global batch's rows a rank holds where the rows split over
    ``axes`` (``tensor_parallel.ShardedLM.local_batch``)."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in axes:
        if sizes.get(a, 1) > 1:
            idx = idx * sizes[a] + axis_index(mesh, a)
            n *= sizes[a]
    return idx, n


def gather_leaf(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's block under ``spec``: an all-gather
    over each axis the spec splits a dim over (a collective: every rank of
    the mesh calls it with its own block)."""
    out = block
    for dim, entry in enumerate(spec):
        out = gather_block(out, dim, entry, mesh)
    return out


__all__ = ["LOGICAL_RULES", "SERVING_RULES", "BATCH_AXES", "axis_sizes",
           "spec_for_shape", "spec_axes", "make_constrainer",
           "param_shardings", "cache_shardings", "batch_shardings",
           "entry_axes", "block_index", "block_shape", "block_bytes",
           "take_block", "gather_block",
           "shard_leaf", "batch_index", "gather_leaf"]
