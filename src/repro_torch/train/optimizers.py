"""Optimizers as pure functions over tensor trees (port of
``repro/train/optimizers.py``).

``adamw``      -- the standard choice for the dense archs.
``adafactor``  -- factored second moments: optimizer state ~1.02x the
                  parameter count instead of AdamW's 2x.

Both return ``Optimizer(init, update)``: ``update(grads, state, params) ->
(params, state, metrics)`` builds new trees and changes nothing it is
given.  A tree is a nested dict / list / tuple of tensors
(``repro_torch.tree``).  Each parameter's new value is computed in f32 and
cast to its dtype once, as the reference does (``torch.optim.AdamW``
instead applies the decay and the step as two in-place updates of a bf16
parameter, which rounds twice).

An LM's trees are given in the reference's layout (layers stacked,
``repro_torch.train.loop``): Adafactor decides what to factor by a leaf's
shape and clips each update by the RMS of the whole leaf, so a stacked
``[L, d]`` norm scale is factored into ``vr [L]`` and ``vc [d]`` as the
reference factors it.

``adamw_step_bound`` and ``adafactor_step_bound`` say how far two first
steps from the same weights may land apart given their gradients: what a
check holding one run against another allows.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
U32 = 2.0 ** -24                       # f32 unit roundoff


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params)


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=F32, device=step.device)


def _global_norm(leaves) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(F32))) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most ``max_norm``, in f32
    as the reference's product with its f32 scale is; the norm before)."""
    norm = _global_norm(tree_leaves(grads))
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(F32) * scale, grads), norm


def _step_of(state) -> torch.Tensor:
    return state["step"] + 1


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _norm_fn(layout):
    """The global norm of a list of gradient leaves: over whole leaves, or
    over blocks (``layout``: ``tensor_parallel.Blocks``)."""
    if layout is None:
        return lambda leaves, tree: _global_norm(leaves)
    return lambda leaves, tree: layout.global_norm(
        leaves, layout.flat_specs(tree))


INPLACE_CHUNK = 1 << 26                # elements of a leaf updated at once


def _chunks(x: torch.Tensor):
    """Slices of ``x``'s leading dim of about ``INPLACE_CHUNK`` elements
    each (the whole of a 0-d or small leaf)."""
    if x.dim() == 0 or x.numel() <= INPLACE_CHUNK:
        yield ...
        return
    rows = max(1, INPLACE_CHUNK // max(1, x[0].numel()))
    for lo in range(0, x.shape[0], rows):
        yield slice(lo, lo + rows)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0,
          layout=None, inplace: bool = False) -> Optimizer:
    """``layout``: the trees are blocks on a mesh
    (``tensor_parallel.Blocks``); only the clip's global norm reduces over
    the ranks, the rest is elementwise.  ``inplace``: the caller gives up
    the parameters and the state it passes (as a jitted step donates
    them): the update writes the new values into them, a slice of a
    leaf's leading dim at a time (``_chunks``), and returns the same
    trees.  The numbers are the pure update's, elementwise the same ops;
    the peak loses a second copy of the moments and the whole-leaf f32
    temporaries (deepseek-moe-16b's stacked experts on four cards: 34 GB
    of moments and ~5 GB a temporary a rank)."""
    lr_fn = _lr_fn(lr)
    norm_of = _norm_fn(layout)

    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def update(grads, state, params):
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        flat_m = tree_leaves(state["mu"])
        flat_v = tree_leaves(state["nu"])
        gnorm = norm_of(flat_g, params)
        scale = _clip_scale(gnorm, max_grad_norm)
        step = _step_of(state)
        t = step.to(F32)
        lr_t = lr_fn(step)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        def leaf(g, m, v, p):
            g = g.to(F32) * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + eps)
            delta = delta + weight_decay * p.to(F32)
            return (p.to(F32) - lr_t * delta).to(p.dtype), m, v

        metrics = {"grad_norm": gnorm, "lr": lr_t}
        if inplace:
            for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
                for sl in _chunks(p):
                    p1, m1, v1 = leaf(g[sl], m[sl], v[sl], p[sl])
                    m[sl].copy_(m1)
                    v[sl].copy_(v1)
                    p[sl].copy_(p1)
            state["step"].copy_(step)
            return params, state, metrics
        new_p, new_m, new_v = zip(*[leaf(*a) for a in zip(
            flat_g, flat_m, flat_v, flat_p)])
        new_state = {"step": step,
                     "mu": tree_unflatten(state["mu"], list(new_m)),
                     "nu": tree_unflatten(state["nu"], list(new_v))}
        return tree_unflatten(params, list(new_p)), new_state, metrics

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------

def adafactor(lr=1e-3, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              max_grad_norm: float = 1.0, layout=None) -> Optimizer:
    """``layout``: the trees are blocks on a mesh
    (``tensor_parallel.Blocks``): the factored moments' row and column
    means, their normalizer and the update's RMS clip are taken over the
    whole leaf (all-reduced over the axes the leaf is split on), and the
    state's blocks are those of ``param_shardings`` of the state."""
    lr_fn = _lr_fn(lr)
    norm_of = _norm_fn(layout)

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def mean_dim(x, dim, spec, keepdim=False):
        if layout is None:
            return x.mean(dim=dim, keepdim=keepdim)
        return layout.mean_dim(x, dim, spec[dim], keepdim)

    def mean_all(x, spec):
        return torch.mean(x) if layout is None else layout.mean_all(x, spec)

    def init(params):
        def leaf(p):
            shape = tuple(p.shape)
            f32 = dict(dtype=F32, device=p.device)
            if _factored(shape):
                return {"vr": torch.zeros(shape[:-1], **f32),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], **f32)}
            return {"v": torch.zeros(shape, **f32)}

        dev = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "v": tree_map(leaf, params)}

    def update(grads, state, params):
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        gnorm = norm_of(flat_g, params)
        scale = _clip_scale(gnorm, max_grad_norm)
        step = _step_of(state)
        t = step.to(F32)
        beta = 1.0 - t ** -decay
        lr_t = lr_fn(step)
        # one state entry ({vr, vc} or {v}) per parameter
        flat_v = tree_leaves(state["v"], up_to=params)
        specs = layout.flat_specs(params) if layout is not None \
            else [None] * len(flat_p)
        new_p, new_v = [], []
        for g, v, p, spec in zip(flat_g, flat_v, flat_p, specs):
            g = g.to(F32) * scale
            g2 = g * g + eps
            if _factored(p.shape):
                vr = beta * v["vr"] + (1 - beta) * mean_dim(g2, -1, spec)
                vc = beta * v["vc"] + (1 - beta) * mean_dim(g2, -2, spec)
                # vr's last dim is the parameter's dim -2
                denom_r = vr / torch.clamp(
                    mean_dim(vr, -1, spec and spec[:-1], keepdim=True),
                    min=eps)
                pre = (torch.rsqrt(denom_r)[..., None]
                       * torch.rsqrt(vc)[..., None, :])
                u = g * pre
                nv = {"vr": vr, "vc": vc}
            else:
                vv = beta * v["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(vv)
                nv = {"v": vv}
            # update clipping by RMS
            rms_u = torch.sqrt(mean_all(u * u, spec) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            u = u + weight_decay * p.to(F32)
            new_p.append((p.to(F32) - lr_t * u).to(p.dtype))
            new_v.append(nv)
        return (tree_unflatten(params, new_p),
                {"step": step, "v": tree_unflatten(params, new_v)},
                {"grad_norm": gnorm, "lr": lr_t})

    return Optimizer(init, update)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """lr(step): linear warmup to ``peak``, then a cosine to
    ``floor * peak`` at ``total``; f32 on the step's device."""
    def lr(step):
        s = step.to(F32)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)

    return lr


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


# ---------------------------------------------------------------------------
# how far two first steps from the same weights may land apart
# ---------------------------------------------------------------------------

def adamw_step_bound(g_a, g_b, p1_a, p1_b, lr, round_to=U32,
                     eps: float = 1e-8) -> torch.Tensor:
    """Elementwise bound on ``|p1_a - p1_b|`` after AdamW's first step from
    the same weights, each run from its own clipped gradient (``g_a``,
    ``g_b``: the gradients times their clip scales).

    At step 1 the moments are (1-b1) g and (1-b2) g^2, so after the bias
    corrections delta = f(g) + wd * p0 with f(x) = x / (|x| + eps): the
    update is lr * sign(g) wherever |g| >> eps, whatever g's size.  f
    moves at most 2 between two gradients of opposite signs, and between
    two of one sign, both at least a in size, by at most eps * |dg| /
    (a + eps)^2 (its slope on [a, inf)).  The ~16 f32 roundings a run puts
    on delta (the clip, the moments, the bias corrections, the root, eps,
    the quotient, the decay), each at most u32 of a value below 1.1, add
    32 u32 for the two runs; each p1 is rounded to its parameter's dtype
    once, ``round_to`` of its size."""
    g_a, g_b = g_a.double(), g_b.double()
    a = torch.minimum(g_a.abs(), g_b.abs())
    dg = (g_a - g_b).abs()
    same = torch.sign(g_a) == torch.sign(g_b)
    move = torch.where(same, eps * dg / (a + eps) ** 2,
                       torch.full_like(dg, 2.0))
    return lr * (torch.clamp(move, max=2.0) + 32 * U32) \
        + round_to * (p1_a.double().abs() + p1_b.double().abs()) + 1e-12


def adafactor_step_bound(d_b, p0, rel: float) -> torch.Tensor:
    """Bound on ``|p1_a - p1_b|`` after Adafactor's first step from the
    same ``p0`` (``d_b = p1_b - p0``), where the gradients agree within
    ``rel * max|g|``: at step 1 the update is g times rsqrt of its row and
    column mean squares (beta = 0), clipped by its RMS, so it is scale-free
    in g, and a relative change ``rel`` of the gradient moves it by at most
    ``rel`` through g itself and ``rel`` through each of the two
    square-rooted factors: 3 * rel of the largest update, plus each p1's
    f32 rounding."""
    return 3 * rel * float(d_b.double().abs().max()) \
        + 2 * U32 * p0.double().abs() + 1e-12


__all__ = ["Optimizer", "clip_by_global_norm", "adamw", "adafactor",
           "cosine_schedule", "get_optimizer", "adamw_step_bound",
           "adafactor_step_bound"]
