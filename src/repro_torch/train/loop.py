"""The training step: loss, gradient, optimizer update (port of
``repro/train/loop.py``).

``make_train_step(cfg, optimizer)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``: the gradient by ``torch.autograd`` over the
port's ``lm.forward(mode="train")`` (which honours ``cfg.remat``), then
``optimizer.update``.

The parameters, their gradients and the optimizer's state are kept in the
reference's layout, layers stacked (``convert.lm_params_to_reference``),
as the reference's step keeps them: Adafactor factors and clips each
stacked leaf as the reference does, and a checkpoint is the state as it
is.  ``loss_fn`` alone splits the stacks into the per-layer views
``lm.forward`` reads (``convert.unstack_layers``, by ``unbind``, so
autograd returns each stack's gradient as one tensor).

With ``microbatches`` > 1 the batch is split along its first dim and the
gradients accumulated in order, as the reference's scan does: microbatch
0's gradient cast to ``accum_dtype``, each later one added, the sum
divided by the count; the metrics are averaged.

On a (data, model) mesh (``shard=``, ``repro_torch.distributed.
tensor_parallel``) the same step runs on this rank's blocks: the forward
gathers and splits as the mesh says, the gradients are summed over the
ranks, and the optimizer reduces over the split leaves
(``optimizers``' ``layout=``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.convert import unstack_layers
from repro_torch.distributed.tensor_parallel import log_lik
from repro_torch.models import lm
from repro_torch.models.attention import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_unflatten

MOE_LB_COEF = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, mask: Optional[torch.Tensor] = None):
    """-> (mean CE over the valid positions, their count), both 0-d f32.

    As the reference: the padded-vocab columns are filled with -1e30
    before the log-sum-exp, and the label logit is taken by a masked sum
    over the vocabulary (the one selected entry plus zeros, so the same
    value a gather gives)."""
    ll = log_lik(logits, labels, vocab_size)                   # [B, S]
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    mask = mask.to(torch.float32)
    denom = mask.sum()
    return -(ll * mask).sum() / torch.clamp(denom, min=1.0), denom


def loss_fn(params, batch, cfg: ModelConfig, *, attn_impl: str = "auto",
            chunk: int = 512, shard=None):
    """-> (the loss autograd differentiates, metrics): the next-token CE
    (a per-position CE for an encoder-only config) plus, with MoE,
    ``MOE_LB_COEF`` times the load-balance loss averaged over the layers
    and the router z-loss.  ``params`` in the reference's layout.  With
    ``shard`` (``tensor_parallel.ShardedLM``), ``params`` are this rank's
    blocks, ``batch`` its rows, and the CE this rank's share of the global
    mean (``ShardedLM.cross_entropy``)."""
    logits, _, aux = lm.forward(unstack_layers(params, cfg), batch, cfg,
                                mode="train", attn_impl=attn_impl,
                                chunk=chunk, shard=shard)
    if shard is None:
        ce_of = lambda lg, lab, mask: cross_entropy(lg, lab, cfg.vocab_size,
                                                    mask)
    else:
        ce_of = shard.cross_entropy
    if cfg.causal:
        tokens = batch["tokens"]
        text_logits = logits[:, -tokens.shape[1]:]       # skip patch slots
        ce, denom = ce_of(text_logits[:, :-1], tokens[:, 1:],
                          batch.get("mask"))
    else:
        ce, denom = ce_of(logits, batch["labels"], batch.get("mask"))
    total = ce
    metrics = {"loss": ce, "tokens": denom}
    if cfg.moe is not None:
        lb = aux["load_balance_loss"] / cfg.num_layers
        total = total + MOE_LB_COEF * lb + aux["router_z_loss"]
        metrics.update(load_balance=lb, drop_fraction=aux["drop_fraction"]
                       / cfg.num_layers)
    return total, metrics


def grad_and_metrics(params, batch, cfg: ModelConfig, *,
                     attn_impl: str = "auto", chunk: int = 512, shard=None):
    """-> (metrics, gradient tree shaped like ``params``, the reference's
    layout, each leaf in its parameter's dtype).  ``params`` is not
    changed.  With ``shard``: ``params`` this rank's blocks and ``batch``
    its rows; the gradient is each block's, summed over the ranks, and the
    metrics the global ones."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        total, metrics = loss_fn(tree_unflatten(params, live), batch, cfg,
                                 attn_impl=attn_impl, chunk=chunk,
                                 shard=shard)
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    if shard is not None:
        shard.finish_grads(grads, params)
        metrics["loss"] = shard.sum_over_batch(metrics["loss"])
    return metrics, tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    microbatches: int = 1, attn_impl: str = "auto",
                    chunk: int = 512, accum_dtype=None, shard=None):
    """``accum_dtype``: the gradient accumulator's dtype with microbatches
    (default f32; each microbatch's gradient is still computed in the
    parameters' dtype, only the running sum is stored in this one).
    ``shard`` (``tensor_parallel.ShardedLM``): the step runs on this
    rank's blocks of the parameters and state (the optimizer built with
    ``layout=shard.layout``) and takes the global batch, each microbatch's
    rows split over the data ranks."""
    acc_dt = torch_dtype(accum_dtype) if isinstance(accum_dtype, str) \
        else (accum_dtype or torch.float32)

    def grads_of(params, batch):
        if shard is not None:
            batch = shard.local_batch(batch)
        return grad_and_metrics(params, batch, cfg, attn_impl=attn_impl,
                                chunk=chunk, shard=shard)

    def single(params, opt_state, batch):
        metrics, grads = grads_of(params, batch)
        params, opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                          params)
        return params, opt_state, {**metrics, **opt_metrics}

    if microbatches == 1:
        return single

    def accumulated(params, opt_state, batch):
        def micro(i):
            def part(x):
                per = x.shape[0] // microbatches
                if per * microbatches != x.shape[0]:
                    raise ValueError(f"batch of {x.shape[0]} does not split "
                                     f"into {microbatches} microbatches")
                return x[i * per:(i + 1) * per]
            return {k: part(v) for k, v in batch.items()}

        msum, g0 = grads_of(params, micro(0))
        acc = [g.to(acc_dt) for g in tree_leaves(g0)]
        del g0
        for i in range(1, microbatches):
            m, g = grads_of(params, micro(i))
            for a, gg in zip(acc, tree_leaves(g)):
                a.add_(gg.to(acc_dt))
            del g
            msum = {k: msum[k] + m[k] for k in msum}
        grads = tree_unflatten(params, [a / microbatches for a in acc])
        metrics = {k: v / microbatches for k, v in msum.items()}
        params, opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                          params)
        return params, opt_state, {**metrics, **opt_metrics}

    return accumulated


__all__ = ["MOE_LB_COEF", "cross_entropy", "loss_fn", "grad_and_metrics",
           "make_train_step"]
