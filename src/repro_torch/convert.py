"""Carry state from the reference package into the port.

Every function takes plain numpy arrays (what ``np.asarray`` gives for the
reference's arrays), so this module needs nothing of the reference:

* ``edge_list_from_reference``: an ``EdgeList``'s ``src``/``dst``/``weight``
  (padding tail included) with its ``num_nodes``/``num_edges``.
* ``bucketed_ell_from_reference``: a ``BucketedELL``'s per-bucket
  ``(cols, vals, row_ids, num_rows, width)``.
* ``lm_params_from_reference``: an LM's parameter tree (a patch or frame
  frontend's ``frontend/proj`` leaf included), or a tree shaped like it
  such as AdamW's moments.

and back: ``lm_params_to_reference`` stacks the port's per-layer tree into
the reference's layout, the one training keeps (``repro_torch.train``).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.containers import EdgeList
from repro_torch.graph.ell import BucketedELL, ELLBucket


def edge_list_from_reference(src, dst, weight, num_nodes: int,
                             num_edges: int, device=None) -> EdgeList:
    """The reference's edge-list arrays -> ``EdgeList`` on ``device``
    (``None``: the card), padding tail and ``num_edges`` kept as given."""
    device = resolve_device(device)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    weight = np.asarray(weight, np.float32)
    if not src.shape == dst.shape == weight.shape or src.ndim != 1:
        raise ValueError("src, dst and weight must be 1-D of one length")
    if not 0 <= num_edges <= src.shape[0]:
        raise ValueError(f"num_edges {num_edges} outside [0, "
                         f"{src.shape[0]}]")
    return EdgeList(src=torch.from_numpy(src.copy()).to(device),
                    dst=torch.from_numpy(dst.copy()).to(device),
                    weight=torch.from_numpy(weight.copy()).to(device),
                    num_nodes=int(num_nodes), num_edges=int(num_edges))


def bucketed_ell_from_reference(
        buckets: Iterable[Sequence], num_nodes: int,
        device=None) -> BucketedELL:
    """The reference's ``BucketedELL`` -> the port's, on ``device``.

    ``buckets`` yields ``(cols, vals, row_ids, num_rows, width)`` per
    bucket, the arrays as numpy.
    """
    device = resolve_device(device)
    out = []
    for cols, vals, row_ids, num_rows, width in buckets:
        cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals, np.float32)
        row_ids = np.asarray(row_ids, np.int32)
        if cols.shape != vals.shape or cols.ndim != 2 \
                or cols.shape[1] != width or row_ids.shape != cols.shape[:1]:
            raise ValueError(f"bucket of width {width} has inconsistent "
                             f"shapes {cols.shape}, {vals.shape}, "
                             f"{row_ids.shape}")
        out.append(ELLBucket(
            cols=torch.from_numpy(cols.copy()).to(device),
            vals=torch.from_numpy(vals.copy()).to(device),
            row_ids=torch.from_numpy(row_ids.copy()).to(device),
            num_rows=int(num_rows), width=int(width)))
    return BucketedELL(buckets=tuple(out), num_nodes=int(num_nodes))


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` too) as a tensor of the
    same dtype and bits on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tree_from_flat(flat: Mapping, prefix: str = "") -> dict:
    """Nest the entries of ``flat`` whose keys start with ``prefix``
    (``"param/layers/mixer/wq"`` -> ``tree["layers"]["mixer"]["wq"]``), as
    a parameter tree saved flat (``np.savez``) is read back.  A node whose
    keys are ``"0"`` .. ``"n-1"`` becomes a list (the reference's tuples
    and lists, e.g. a hybrid's ``"layers/period/0/..."``)."""
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def _stack_layers(layers):
    """One tree shaped like ``layers[0]`` whose leaves are that leaf's
    layers stacked."""
    first = layers[0]
    if isinstance(first, Mapping):
        return {k: _stack_layers([layer[k] for layer in layers])
                for k in first}
    return torch.stack(list(layers))


def unstack_layers(params: Mapping, cfg) -> dict:
    """The reference's layout -> the port's: the same leaves (numpy arrays
    or tensors, split along the first dim as views, not copied) with
    ``params["layers"]`` a list of one dict a layer.  A tensor is split by
    ``unbind``, whose backward stacks the layers' gradients into one
    tensor.  No checks; see ``lm_params_from_reference``."""
    def leaf_map(tree, fn):
        if isinstance(tree, Mapping):
            return {k: leaf_map(v, fn) for k, v in tree.items()}
        return fn(tree)

    def unstack(stack, n):
        split = leaf_map(stack, list)    # a tensor iterates by ``unbind``
        return [leaf_map(split, lambda parts, i=i: parts[i])
                for i in range(n)]

    layers = params["layers"]
    if isinstance(layers, Mapping) and set(layers) == {"period", "tail"}:
        period, n_per, tail = cfg.period_info
        if len(layers["period"]) != len(period) \
                or len(layers["tail"]) != len(tail):
            raise ValueError(f"period layout of {len(layers['period'])} "
                             f"positions and a tail of "
                             f"{len(layers['tail'])}, expected "
                             f"{len(period)} and {len(tail)}")
        by_pos = [unstack(stack, n_per) for stack in layers["period"]]
        layers = [by_pos[j][i] for i in range(n_per)
                  for j in range(len(period))] + list(layers["tail"])
    elif isinstance(layers, Mapping):             # stacked [L, ...]
        layers = unstack(layers, cfg.num_layers)
    tree = {k: v for k, v in params.items() if k != "layers"}
    tree["layers"] = list(layers)
    return tree


def lm_params_to_reference(params: Mapping, cfg) -> dict:
    """The port's LM tree (``repro_torch.models.lm``'s parameters, or a
    tree shaped like them such as their gradients) -> the reference's
    layout, the inverse of ``lm_params_from_reference``'s unstacking: a
    scanned stack's layers stacked ``[L, ...]`` under ``"layers"``, a
    period-scanned hybrid's as ``{"period": (stack_j [n_per, ...] for each
    pattern position j), "tail": [...]}``, any other per-layer list kept.
    Leaves stay tensors on their device, each stack a new one."""
    from repro_torch.models.lm import stacked

    layers = list(params["layers"])
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers, expected {cfg.num_layers}")
    tree = {k: v for k, v in params.items() if k != "layers"}
    if stacked(cfg):
        tree["layers"] = _stack_layers(layers)
    elif cfg.use_period_scan:
        period, n_per, _ = cfg.period_info
        plen = len(period)
        tree["layers"] = {
            "period": tuple(_stack_layers(layers[j:n_per * plen:plen])
                            for j in range(plen)),
            "tail": layers[n_per * plen:]}
    else:
        tree["layers"] = layers
    return tree


def lm_params_from_reference(params: Mapping, cfg, device=None) -> dict:
    """The reference's LM parameter tree (``repro.models.lm.init_params``;
    its leaves as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``)
    -> the port's (``repro_torch.models.lm``), on ``device``
    (``None``: the card), bit for bit.

    The reference stacks a scanned stack's layers ``[L, ...]`` under
    ``params["layers"]`` (an MoE layer's experts ``[L, E, D, F]``), and a
    period-scanned hybrid's as ``{"period": (stack_j [n_per, ...] for each
    pattern position j), "tail": [...]}``, where layer ``i * len(period) +
    j`` is ``period[j][i]`` and the tail follows the periods.  The port
    keeps one dict a layer, so the stacks are split in that order (a list
    of per-layer dicts is taken as it is).  Every leaf must have the port's
    shape and dtype (the router and the SSM and RG-LRU gates are f32 beside
    bf16 weights).  Both packages keep every matrix ``[d_in, d_out]`` and apply it as
    ``x @ W``, so nothing is transposed.  A tied head is the embedding's
    transpose in both and has no ``head`` entry; an untied one must have
    it.
    """
    from repro_torch.models.lm import abstract_params

    device = resolve_device(device)
    want = abstract_params(cfg)
    if cfg.tie_embeddings and "head" in params:
        raise ValueError(f"{cfg.name} ties its head to the embedding, but "
                         f"the tree has a 'head' entry")
    if set(params) != set(want):
        raise ValueError(f"parameter tree keys {sorted(params)}, expected "
                         f"{sorted(want)}")
    tree = unstack_layers(params, cfg)
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(tree['layers'])} layers, expected "
                         f"{cfg.num_layers}")

    def convert(got, shape_of):
        if isinstance(shape_of, torch.Tensor):
            t = _tensor(got, device)
            if tuple(t.shape) != tuple(shape_of.shape) \
                    or t.dtype != shape_of.dtype:
                raise ValueError(f"leaf {tuple(t.shape)} {t.dtype}, "
                                 f"expected {tuple(shape_of.shape)} "
                                 f"{shape_of.dtype}")
            return t
        if isinstance(shape_of, dict):
            if set(got) != set(shape_of):
                raise ValueError(f"keys {sorted(got)}, expected "
                                 f"{sorted(shape_of)}")
            return {k: convert(got[k], shape_of[k]) for k in shape_of}
        return [convert(g, w) for g, w in zip(got, shape_of)]

    return convert(tree, want)


__all__ = ["edge_list_from_reference", "bucketed_ell_from_reference",
           "tree_from_flat", "unstack_layers",
           "lm_params_to_reference", "lm_params_from_reference"]
