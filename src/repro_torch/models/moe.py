"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``).

  1. router top-k per token (f32),
  2. stable-sort the T*k (token, expert) choices by expert,
  3. position-in-expert = rank within expert; drop beyond capacity C,
  4. scatter tokens into an [E, C, D] buffer,
  5. batched per-expert GLU over the E axis,
  6. gather outputs back and combine weighted by the router's probabilities.

Dropped choices contribute zero; the residual stream carries the token.

The integer planes are the reference's exactly: top-k in ``lax.top_k``'s
order (descending, the lower expert first on a tie), a stable sort, so a
drop keeps the lower-indexed (token, choice) pairs, and overflow slots at
``e * c``.  The reference drops those on scatter (``mode="drop"``) and reads
them as 0 on gather (``mode="fill"``); here the buffer has one trash row past
``e * c`` and the expert outputs one zero row there.  Every shape is static
and nothing is read on the host (the counts are a ``scatter_add_`` into
[E], not a ``bincount``), so a decode step through this layer can be
captured in a CUDA graph.  The reference's segment sum over the sorted
choices is a fixed-order sum over each token's k choices here, in f32.

Plain torch, as the reference is plain jnp: no kernel stands behind it.
On a mesh, ``repro_torch/distributed/moe_ep.py`` dispatches across the
ranks; on one device the reference takes this path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import truncated_normal_init
from repro_torch.models.mlp import init_mlp, mlp_forward


def init_moe(gen: torch.Generator, d_model: int, moe: MoEConfig, dtype,
             device=None) -> dict:
    e, f = moe.num_experts, moe.d_expert
    p = {
        "router": truncated_normal_init(gen, (d_model, e), 1.0,
                                        torch.float32, device),
        "we_gate": truncated_normal_init(gen, (e, d_model, f), 1.0, dtype,
                                         device),
        "we_up": truncated_normal_init(gen, (e, d_model, f), 1.0, dtype,
                                       device),
        "we_down": truncated_normal_init(gen, (e, f, d_model), 1.0, dtype,
                                         device),
    }
    if moe.num_shared:
        p["shared"] = init_mlp(gen, d_model, moe.num_shared * f, dtype,
                               device)
    return p


def capacity(tokens: int, moe: MoEConfig) -> int:
    c = int(tokens * moe.top_k * moe.capacity_factor / moe.num_experts) + 1
    return max(4, ((c + 3) // 4) * 4)


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: descending, the lower index first
    among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, moe: MoEConfig, c: int) -> dict:
    """The dispatch of T tokens from the router's f32 logits [T, E]: the
    softmax ``probs``, the normalized top-k ``top_p`` / ``top_e`` [T, k],
    the stable sort of the T*k choices by expert (``sort_idx``,
    ``sorted_e``, the source token ``token_of``), the per-expert ``counts``
    [E], and for each sorted choice its rank in its expert ``pos``,
    ``keep`` (within capacity ``c``) and its buffer row ``slot`` (``e * c``
    when dropped)."""
    t = logits.shape[0]
    k, e = moe.top_k, moe.num_experts
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(t * k)
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=logits.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=logits.device) - starts[sorted_e]
    keep = pos_in_e < c
    slot = torch.where(keep, sorted_e * c + pos_in_e,
                       torch.full_like(pos_in_e, e * c))
    return {"probs": probs, "top_p": top_p, "top_e": top_e,
            "sort_idx": sort_idx, "sorted_e": sorted_e,
            "token_of": sort_idx // k, "counts": counts, "pos": pos_in_e,
            "keep": keep, "slot": slot}


def moe_forward(params: dict, x: torch.Tensor, moe: MoEConfig):
    """x [B, S, D] -> (y [B, S, D], aux dict of 0-d f32 tensors:
    ``load_balance_loss``, ``router_z_loss``, ``drop_fraction``)."""
    b, s, d = x.shape
    t = b * s
    k, e = moe.top_k, moe.num_experts
    c = capacity(t, moe)
    xf = x.reshape(t, d)

    # --- router (f32 for numerics) ---
    logits = xf.to(torch.float32) @ params["router"]           # [T, E]
    r = route(logits, moe, c)
    y = routed_experts(params, xf, r, c, moe).to(x.dtype).reshape(b, s, d)

    if moe.num_shared:
        y = y + mlp_forward(params["shared"], x)

    # --- aux losses / metrics ---
    f_e = r["counts"].to(torch.float32) / max(t * k, 1)
    p_e = r["probs"].mean(dim=0)
    aux = {
        "load_balance_loss": e * torch.sum(f_e * p_e),
        "router_z_loss": moe.router_z_loss * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2),
        "drop_fraction": 1.0 - r["keep"].to(torch.float32).mean(),
    }
    return y, aux


def routed_experts(params: dict, xf: torch.Tensor, r: dict, c: int,
                   moe: MoEConfig, glu=None) -> torch.Tensor:
    """The routed experts' output [T, D] in f32 for the tokens ``xf``
    [T, D] dispatched by ``r`` (``route``) into ``c`` rows an expert.
    ``glu(expert_in [E, C, D]) -> [E, C, D]``: the experts' GLU, when the
    caller computes it on blocks of the expert weights (default: the
    batched GLU on ``params``' whole ``we_*``)."""
    t, d = xf.shape
    k, e = moe.top_k, moe.num_experts

    # --- sort-based dispatch: row e * c is the trash row of the drops ---
    buf = xf.new_zeros((e * c + 1, d))
    buf.index_copy_(0, r["slot"], xf[r["token_of"]])
    expert_in = buf[:e * c].view(e, c, d)

    # --- batched per-expert GLU ---
    if glu is not None:
        out = glu(expert_in)
    else:
        gate = torch.bmm(expert_in, params["we_gate"])
        up = torch.bmm(expert_in, params["we_up"])
        out = torch.bmm(F.silu(gate) * up, params["we_down"])   # [E, C, D]

    # --- combine: back to (token, choice) order, weighted, summed ---
    out_flat = torch.cat([out.reshape(e * c, d), out.new_zeros((1, d))])
    sorted_p = r["top_p"].reshape(t * k)[r["sort_idx"]].to(out.dtype)
    contrib = out_flat[r["slot"]] * sorted_p[:, None]
    unsorted = torch.empty_like(contrib).index_copy_(0, r["sort_idx"],
                                                     contrib)
    return unsorted.view(t, k, d).to(torch.float32).sum(1)


__all__ = ["init_moe", "capacity", "top_k", "route", "moe_forward",
           "routed_experts"]
