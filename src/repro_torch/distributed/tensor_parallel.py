"""The LM's train step on a (data, model) mesh: every leaf of the
parameters, gradients and optimizer state held as this rank's block under
``sharding.param_shardings`` (the placement the reference ``device_put``s
in ``repro/launch/train.py``), and the forward and backward computed with
explicit collectives where the reference leaves them to GSPMD.

Over ``model`` (Megatron-style tensor parallelism):

* attention, when the heads split evenly (``H % model == 0``): ``wq`` /
  ``bq`` column-parallel over whole heads, ``wo`` row-parallel; ``wk`` /
  ``wv`` / ``bk`` / ``bv`` column-parallel too when the KV heads split
  evenly, else gathered over ``model`` at use (the spec may cut a head:
  ``heads_flat`` of ``KV * hd``) with each rank taking the KV head of each
  of its query heads;
* the MLP, when ``d_ff % model == 0``: ``w_gate`` / ``w_up``
  column-parallel, ``w_down`` row-parallel;
* a region's input passes ``enter`` (identity forward, all-reduce of the
  gradient backward) and its partial output ``leave`` (all-reduce forward,
  identity backward); a replicated leaf used inside a region (``q_norm``,
  ``k_norm``, a gathered ``wk``) has its gradient summed over ``model``;
* the embedding vocab-parallel (each rank looks up its own rows, zeros
  elsewhere, then an all-reduce) and the head vocab-parallel, with a
  vocab-parallel cross entropy: max and sum-exp all-reduced over
  ``model``, the label logit from the rank that owns it;
* everything else -- the SSM and RG-LRU mixers, a layer whose heads or
  FFN do not split, norms, the frontend projection -- runs replicated on
  every model rank, its leaves gathered over ``model`` at use and the
  gradient cut back to the block (the ranks compute the same gradient).

Over ``data`` (and ``pod``): the global batch is split over the ranks of
``(pod, data)``; a leaf's ``fsdp`` dim is all-gathered at its use (inside a
remat group, so gathered again when the group recomputes) and its gradient
reduce-scattered in the backward; a leaf not split over a batch axis has
its gradient all-reduced over it after the backward.  The loss of a rank
is its share of the global mean (its positions' sum over the global
count), so the sums over ranks are the reference's gradient.

An MoE layer's FFN takes the dispatch the reference takes on the same
mesh (``repro/models/lm.py:155-169``): with ``model > 1`` and the experts
dividing it, the expert-parallel all-to-all (``moe_ep.moe_forward_ep``)
on the blocks as they are split (the router gathered whole, its gradient
summed over ``model``: each model peer routes its own tokens); otherwise
the global dispatch (``moe_ep.moe_forward_global``: all global tokens
under one capacity, as the reference's GSPMD ``moe_forward`` sorts them),
its leaves gathered and computed alike on every model peer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.convert import lm_params_to_reference, tree_from_flat
from repro_torch.distributed import moe_ep
from repro_torch.distributed.collectives import (Enter, Gather, Leave,
                                                 all_reduce, axis_index)
from repro_torch.distributed.sharding import (BATCH_AXES, axis_sizes,
                                              cache_shardings, entry_axes,
                                              gather_block, param_shardings,
                                              shard_leaf, spec_axes,
                                              spec_for_shape, take_block)
from repro_torch.models import frontends, lm
from repro_torch.models.config import ModelConfig
from repro_torch.tree import (flatten_with_paths, tree_leaves, tree_paths,
                              tree_unflatten)

NEG = -1e30


# ---------------------------------------------------------------------------
# the vocab-parallel loss
# ---------------------------------------------------------------------------

class _VocabParallelLogLik(torch.autograd.Function):
    """Per-position log-likelihood of ``labels`` from this rank's vocabulary
    columns ``[lo, lo + V_local)`` of f32 logits: the padded columns
    (id >= ``vocab_size``) at -1e30 as the reference fills them, the max
    and the sum of exponentials all-reduced over ``model``, the label logit
    from its owner (a masked sum, all-reduced).  Backward: softmax minus
    one-hot on the local columns."""

    @staticmethod
    def forward(ctx, logits, labels, lo, vocab_size, mesh):
        ids = lo + torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(ids >= vocab_size, NEG, logits)
        peak = logits.amax(dim=-1)
        all_reduce(peak, mesh, "model", dist.ReduceOp.MAX)
        e = torch.exp(logits - peak[..., None])
        total = e.sum(dim=-1)
        all_reduce(total, mesh, "model")
        sel = ids == labels[..., None].long()
        label = torch.where(sel, logits, 0.0).sum(dim=-1)
        all_reduce(label, mesh, "model")
        ctx.save_for_backward(e / total[..., None], sel)
        return label - (peak + torch.log(total))

    @staticmethod
    def backward(ctx, g):
        soft, sel = ctx.saved_tensors
        return (sel.to(soft.dtype) - soft) * g[..., None], None, None, None, \
            None


def log_lik(logits: torch.Tensor, labels: torch.Tensor,
            vocab_size: int) -> torch.Tensor:
    """Per-position log-likelihood over the whole vocabulary, as the
    reference's ``cross_entropy`` computes it (the padded columns at
    -1e30, the label logit by a masked sum)."""
    v_pad = logits.shape[-1]
    logits = logits.to(torch.float32)
    vocab_ids = torch.arange(v_pad, device=logits.device)
    if v_pad > vocab_size:
        logits = torch.where(vocab_ids >= vocab_size, NEG, logits)
    lse = torch.logsumexp(logits, dim=-1)
    sel = vocab_ids == labels[..., None].long()
    return torch.sum(torch.where(sel, logits, 0.0), dim=-1) - lse


# ---------------------------------------------------------------------------
# blocks: reductions over split leaves
# ---------------------------------------------------------------------------

class Blocks:
    """A tree's leaves held as blocks under ``specs`` (``{path: spec}``)
    on ``mesh``: the reductions the optimizers need over leaves they see
    only in part."""

    def __init__(self, mesh, specs: dict):
        self.mesh, self.specs = mesh, specs
        self.sizes = axis_sizes(mesh)

    def flat_specs(self, tree) -> list:
        return [self.specs[p] for p in tree_paths(tree)]

    def _split(self, entry) -> int:
        return math.prod(self.sizes[a] for a in entry_axes(entry))

    def global_norm(self, leaves, specs) -> torch.Tensor:
        """The L2 norm of the whole tree: each block's sum of squares,
        summed over the ranks holding distinct blocks of its leaf (a leaf
        replicated over an axis counts once)."""
        groups: dict = {}
        for x, spec in zip(leaves, specs):
            key = tuple(sorted(spec_axes(spec)))
            ss = torch.sum(torch.square(x.to(torch.float32)))
            groups[key] = groups[key] + ss if key in groups else ss
        total = None
        for key in sorted(groups):
            part = all_reduce(groups[key].clone(), self.mesh, key)
            total = part if total is None else total + part
        return torch.sqrt(total)

    def mean_dim(self, x: torch.Tensor, dim: int, entry,
                 keepdim: bool = False) -> torch.Tensor:
        """``x.mean(dim)`` of the full leaf, ``dim`` split by ``entry``."""
        n = x.shape[dim] * self._split(entry)
        s = x.sum(dim=dim, keepdim=keepdim)
        return all_reduce(s, self.mesh, entry_axes(entry)) / n

    def mean_all(self, x: torch.Tensor, spec) -> torch.Tensor:
        n = x.numel() * math.prod(self._split(e) for e in spec)
        return all_reduce(x.sum(), self.mesh, spec_axes(spec)) / n


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerRegions:
    """Which of a layer's mixer and FFN run tensor-parallel, the two
    boundary functions of a region, and an MoE layer's FFN on the mesh
    (``moe(ffn_params, h) -> (y, aux)``; None without MoE)."""
    mixer: bool
    ffn: bool
    enter: Callable
    leave: Callable
    moe: Optional[Callable] = None


# a leaf's role where it is used: its model dim kept split, used whole
# inside a region (gradient summed over model), gathered for replicated
# compute, or handed on as the block it is (the expert-parallel leaves,
# which moe_ep gathers itself)
_KEPT, _PARTIAL, _GATHER, _BLOCK = "kept", "partial", "gather", "block"


class ShardedLM:
    """The hooks ``lm.forward(shard=...)`` and the train step call to run
    ``cfg`` on this rank's blocks of ``mesh`` (module docstring).
    ``param_specs``: ``{path: spec}`` of the parameters in the reference's
    stacked layout, the one the train step keeps; ``layout``: those specs
    with their reductions (``Blocks``), for the optimizers."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.sizes = axis_sizes(mesh)
        m = self.sizes.get("model", 1)
        self.model = m
        self.rank_in_model = axis_index(mesh, "model")
        # the batch axes the rows of the last ``local_batch`` split over
        self.row_axes = self.batch_axes()
        abstract = lm.abstract_params(cfg)
        self.top_specs = param_shardings(
            {k: v for k, v in abstract.items() if k != "layers"}, mesh)
        self.param_specs = param_shardings(
            lm_params_to_reference(abstract, cfg), mesh)
        self.layout = Blocks(mesh, self.param_specs)

        h, kv = cfg.num_heads, cfg.num_kv_heads
        self.attn_tp = m > 1 and h > 0 and h % m == 0
        self.kv_whole = self.attn_tp and kv % m == 0
        self.ffn_tp = m > 1 and cfg.moe is None and cfg.d_ff > 0 \
            and cfg.d_ff % m == 0
        self.vocab_tp = m > 1 and cfg.vocab_size > 0 \
            and cfg.padded_vocab % m == 0
        self.expert_parallel = cfg.moe is not None \
            and moe_ep.applicable(cfg.moe, self.sizes)
        if self.expert_parallel:
            self.ep_specs = {"ffn/" + k: v for k, v in
                             moe_ep.param_specs(cfg.moe, self.sizes).items()}
        self.layer_specs, self.roles, self.local_cfg = {}, {}, {}
        for i, t in enumerate(cfg.layer_pattern):
            if t not in self.layer_specs:
                specs = param_shardings(abstract["layers"][i], mesh)
                self.layer_specs[t] = specs
                self.roles[t] = {sub: self._role(t, sub, specs[sub])
                                 for sub in specs}
        if self.attn_tp:
            self.local_cfg["attn"] = dataclasses.replace(
                cfg, num_heads=h // m,
                num_kv_heads=kv // m if self.kv_whole else h // m)
            if not self.kv_whole:
                hl, g = h // m, h // kv
                self.kv_index = torch.tensor(
                    [(self.rank_in_model * hl + j) // g for j in range(hl)])
        for name in ("embed", "head"):
            if self.vocab_tp and name in self.top_specs:
                dim = 0 if name == "embed" else 1
                assert self.top_specs[name][dim] == "model", \
                    (name, self.top_specs[name])

    def _role(self, layer_type: str, sub: str, spec) -> str:
        part, name = sub.split("/")[0], sub.split("/")[-1]
        role = _GATHER
        if part == "mixer" and layer_type == "attn" and self.attn_tp:
            if name in ("wq", "bq", "wo") or (
                    name in ("wk", "wv", "bk", "bv") and self.kv_whole):
                role = _KEPT
            else:
                role = _PARTIAL
        elif part == "ffn" and self.ffn_tp:
            role = _KEPT
        elif part == "ffn" and self.expert_parallel:
            if name == "router":
                role = _PARTIAL
            else:
                role = _BLOCK
                want = tuple(self.ep_specs[sub])
                have = tuple(spec) + (None,) * (len(want) - len(spec))
                if have != want:
                    raise ValueError(
                        f"{self.cfg.name}: {sub} is split {spec} on this "
                        f"mesh, but the expert-parallel dispatch takes "
                        f"{want} (a width does not divide its axis)")
        if role == _KEPT:
            dim = 0 if name in ("wo", "w_down", "bq", "bk", "bv") else 1
            assert spec[dim] == "model", (sub, spec)
        return role

    # -- leaves at their use --------------------------------------------------
    def use(self, block: torch.Tensor, spec, role: str = _GATHER
            ) -> torch.Tensor:
        """The tensor a leaf's block stands for where it is used: gathered
        over every axis its spec splits, but ``model`` for a leaf kept
        split (``role`` "kept"); a "partial" leaf (used inside a
        tensor-parallel region, whole) has its gradient summed over
        ``model``; a "block" leaf is returned as it is."""
        if role == _BLOCK:
            return block
        plan = []
        for dim, entry in enumerate(spec):
            for axis in reversed(entry_axes(entry)):
                if (axis == "model" and role == _KEPT) \
                        or self.sizes[axis] == 1:
                    continue
                reduce = axis in BATCH_AXES or (axis == "model"
                                                and role == _PARTIAL)
                plan.append((dim, axis, reduce))
        x = Gather.apply(block, self.mesh, tuple(plan)) if plan else block
        if role == _PARTIAL and "model" not in spec_axes(spec):
            x = Enter.apply(x, self.mesh)
        return x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return Enter.apply(x, self.mesh)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return Leave.apply(x, self.mesh)

    def layer(self, lp: dict, layer_type: str):
        """A layer's blocks -> (its leaves as the layer computes with
        them, the config it computes under, its ``LayerRegions``)."""
        specs, roles = self.layer_specs[layer_type], self.roles[layer_type]
        flat = {sub: self.use(blk, specs[sub], roles[sub])
                for sub, blk in flatten_with_paths(lp).items()}
        cfg = self.cfg
        mixer_tp = layer_type == "attn" and self.attn_tp
        if mixer_tp and not self.kv_whole:
            hd = cfg.resolved_head_dim
            idx = self.kv_index.to(next(iter(flat.values())).device)
            for name in ("wk", "wv", "bk", "bv"):
                sub = "mixer/" + name
                if sub in flat:
                    w = flat[sub]
                    w = w.unflatten(-1, (cfg.num_kv_heads, hd))
                    flat[sub] = w.index_select(w.dim() - 2, idx).flatten(-2)
        moe = None
        if cfg.moe is not None and "ffn" in lp:
            moe = self._moe_ep if self.expert_parallel else self._moe_global
        regions = LayerRegions(mixer=mixer_tp,
                               ffn=self.ffn_tp and "ffn" in lp,
                               enter=self.enter, leave=self.leave, moe=moe)
        lcfg = self.local_cfg.get("attn", cfg) if mixer_tp else cfg
        return tree_from_flat(flat), lcfg, regions

    def _moe_ep(self, p: dict, h: torch.Tensor):
        flat = flatten_with_paths(p)
        return moe_ep.moe_forward_ep(flat, h, self.cfg.moe, self.mesh)

    def _moe_global(self, p: dict, h: torch.Tensor):
        return moe_ep.moe_forward_global(p, h, self.cfg.moe, self.mesh,
                                         self.row_axes)

    # -- embedding, head, loss ------------------------------------------------
    def _vocab_lookup(self, table: torch.Tensor, tokens: torch.Tensor):
        vl = table.shape[0]
        t = tokens.long() - self.rank_in_model * vl
        ok = (t >= 0) & (t < vl)
        x = table[t.clamp(0, vl - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        return self.leave(x)

    def embed_inputs(self, params: dict, batch: dict):
        cfg, p, table, lookup = self.cfg, {}, None, None
        if "frontend" in params:
            p["frontend"] = {"proj": self.use(
                params["frontend"]["proj"], self.top_specs["frontend/proj"])}
        if cfg.frontend != "frame":
            spec = self.top_specs["embed"]
            if self.vocab_tp:
                table = self.use(params["embed"], spec, _KEPT)
                lookup = self._vocab_lookup
            else:
                table = self.use(params["embed"], spec)
        return frontends.embed_inputs(p, batch, cfg, table, lookup)

    def head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """f32 logits: this rank's vocabulary columns when vocab-parallel,
        else all of them."""
        cfg = self.cfg
        if not cfg.vocab_size:
            return x.to(torch.float32)
        role = _KEPT if self.vocab_tp else _GATHER
        if cfg.tie_embeddings:
            w = self.use(params["embed"], self.top_specs["embed"], role).T
        else:
            w = self.use(params["head"], self.top_specs["head"], role)
        if self.vocab_tp:
            x = self.enter(x)
        return (x @ w).to(torch.float32)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None):
        """-> (this rank's share of the global mean CE: its positions' sum
        over the count of valid positions on every batch rank, the global
        batch's count of valid positions).  Where ranks hold the same rows
        (``local_batch``) the first count holds them as often, so the
        shares still sum to the mean, and their gradients to its."""
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        mask = mask.to(torch.float32)
        denom = all_reduce(mask.sum().detach().clone(), self.mesh,
                           self.batch_axes())
        if self.vocab_tp:
            ll = _VocabParallelLogLik.apply(
                logits, labels, self.rank_in_model * logits.shape[-1],
                self.cfg.vocab_size, self.mesh)
        else:
            ll = log_lik(logits, labels, self.cfg.vocab_size)
        copies = math.prod(self.sizes[a] for a in self.batch_axes()
                           if a not in self.row_axes)
        return -(ll * mask).sum() / torch.clamp(denom, min=1.0), \
            denom / copies

    # -- batches and gradients ------------------------------------------------
    def batch_axes(self) -> tuple:
        return tuple(a for a in BATCH_AXES if self.sizes.get(a, 1) > 1)

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch: the batch split over the
        ranks of (pod, data), the first axis outermost.  Where the rows do
        not divide over both, they split over the pods alone (where those
        divide them) or not at all, and the ranks of the other axes run
        the same rows (a microbatch of 16 rows over 2 x 16 ranks).  The
        axes split over are kept (``row_axes``) for the forward that
        follows: the loss and the global MoE dispatch count each row once
        (``cross_entropy``, ``moe_ep.moe_forward_global``)."""
        n_rows = next(iter(batch.values())).shape[0]
        rows = spec_for_shape((n_rows,), ("batch",), self.mesh)[0]
        self.row_axes = entry_axes(rows)
        return {k: take_block(v, 0, rows, self.mesh)
                for k, v in batch.items()}

    def sum_over_batch(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x.detach().clone(), self.mesh, self.batch_axes())

    # -- prefill --------------------------------------------------------------
    def prefill(self, params: dict, batch: dict, *, cache_len: int,
                attn_impl: str = "auto", chunk: int = 512):
        """The prompt's forward under the training layout (``params``:
        this rank's blocks in the port's layout, ``lm.init_params``'s,
        under ``param_shardings(..., rules=None)``; ``batch``: the global
        batch) -> (the last position's logits [B, 1, V_pad] f32, whole on
        every rank; this rank's blocks of the caches under
        ``cache_shardings`` of ``lm.init_caches(cfg, B, cache_len)``, whose
        windowed layers keep ``min(cache_len, window)`` slots).
        The batch is split over (pod, data) where it divides them (where
        it does not, those ranks run every row)."""
        cfg = self.cfg
        b = next(iter(batch.values())).shape[0]
        rows = spec_for_shape((b,), ("batch",), self.mesh)[0]
        local = self.local_batch(batch)
        if cfg.sliding_window is not None:
            # a windowed layer keeps the window (a ring once it is full),
            # the slots lm.init_caches gives it
            cache_len = min(cache_len, cfg.sliding_window)
        with torch.no_grad():
            logits, caches, _ = lm.forward(
                params, local, cfg, mode="prefill", attn_impl=attn_impl,
                chunk=chunk, cache_len=cache_len, shard=self)
        last = logits[:, -1:]
        if self.vocab_tp:
            last = gather_block(last, 2, "model", self.mesh)
        last = gather_block(last, 0, rows, self.mesh)
        specs = cache_shardings(lm.init_caches(cfg, b, cache_len,
                                               device="meta"), self.mesh)
        if isinstance(caches, dict):          # stacked: a layer at a time
            caches = {n: torch.stack([
                self._cache_block(n, layer, specs[n][1:],
                                  cfg.layer_pattern[0])
                for layer in leaf.unbind(0)]) for n, leaf in caches.items()}
        else:
            caches = [{n: self._cache_block(n, leaf, specs[f"{i}/{n}"], t)
                       for n, leaf in c.items()}
                      for i, (c, t) in enumerate(zip(caches,
                                                     cfg.layer_pattern))]
        return last, caches

    def _cache_block(self, name: str, leaf: torch.Tensor, spec,
                     layer_type: str) -> torch.Tensor:
        """A layer's prefill cache leaf [B_rows, ...] of this rank's rows
        -> its block under ``spec``.  K/V of a
        tensor-parallel attention layer hold the KV head of each of this
        rank's query heads: where the KV heads did not split they are
        gathered over ``model`` and one head of each group kept; where
        they split, the K/V are the KV-head block the spec names."""
        tp = layer_type == "attn" and self.attn_tp
        kv_dim = leaf.dim() - 2
        if name in ("k", "v") and tp and not self.kv_whole:
            g = self.cfg.num_heads // self.cfg.num_kv_heads
            leaf = gather_block(leaf, kv_dim, "model",
                                self.mesh)[..., ::g, :]
        out = leaf
        for dim, entry in enumerate(spec):
            if dim == 0 or (name in ("k", "v") and tp and self.kv_whole
                            and dim == kv_dim):
                continue
            out = take_block(out, dim, entry, self.mesh)
        return out.contiguous()

    def finish_grads(self, grads: list, params) -> list:
        """Sum each block's gradient over the batch axes its leaf is not
        split over (the split ones were reduce-scattered in the
        backward); in place, in ``tree_leaves`` order."""
        for g, spec in zip(grads, self.layout.flat_specs(params)):
            axes = [a for a in self.batch_axes() if a not in spec_axes(spec)]
            all_reduce(g, self.mesh, axes)
        return grads


def shard_tree(tree, specs: dict, mesh):
    """Every leaf of a full tree cut to this rank's block (``specs``:
    ``{path: spec}`` by the tree's paths)."""
    return tree_unflatten(tree, [
        shard_leaf(x, specs[p], mesh)
        for x, p in zip(tree_leaves(tree), tree_paths(tree))])


__all__ = ["LayerRegions", "Blocks", "ShardedLM", "log_lik", "shard_tree"]
