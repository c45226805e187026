"""Expert parallelism on a (data, model) mesh (port of
``repro/distributed/moe_ep.py``), and the global dispatch a mesh takes
where it does not apply.

``moe_forward_ep`` is the body of the reference's ``shard_map`` as plain
tensor code on this rank's blocks.  Per rank (pod p, data d, model m), the
experts split E_loc = E / M over ``model`` and the tokens over (pod, data):

  1. routing on the whole f32 router (gathered: the reference's
     ``P(None, None)``),
  2. first-stage dispatch: the T_loc * k choices stable-sorted by
     destination model shard (expert // E_loc), ``c_send`` a shard, the
     overflow into a trash row past ``M * c_send``,
  3. an all-to-all over ``model`` ships the [M, c_send, D] payloads,
  4. second-stage local dispatch: the received rows stable-sorted by local
     expert, ``c_loc`` an expert, the overflow and the empty slots into a
     trash row past ``E_loc * c_loc``; the batched GLU on [E_loc, c_loc, D]
     (the expert leaves all-gathered over ``data``, and over ``pod`` when
     the FFN width splits over it, their gradients reduce-scattered),
  5. the all-to-all back, and the combine in f32, a fixed-order sum over
     each token's k choices.

Where the rank's token count divides by M, each model peer routes its own
1/M of the tokens ("sliced") and the outputs are all-gathered over
``model``; otherwise every peer routes all of them ("duplicate").  The
shared experts run Megatron-style over ``model``.  ``serving=True`` keeps
the experts weight-stationary (``SERVING_RULES``: E over ``model``, F over
``data``): the tokens are all-gathered over ``data``, nothing is gathered
and the down projection is summed over ``data``.

The integer planes (top-k in ``lax.top_k``'s order, the stable sorts, the
positions, the drops) are the reference's exactly, so ``drop_fraction``
is equal, bit for bit.  Gradients follow the tensor-parallel step's
convention (``tensor_parallel``): ``x``'s gradient arrives whole on every
model peer and leaves whole; a parameter's gradient is this rank's share,
and its sum over the mesh axes the parameter's block does not split is the
whole gradient (the sum the reference's ``shard_map`` transpose makes;
``ShardedLM``'s ``use`` and ``finish_grads`` make it).  The aux values
are global, reduced before any product; their gradient on each rank is
that of its own tokens (a forward sum, an identity backward), so the
gradient summed over ranks is the reference's, not the world times it.

``moe_forward_global`` is the reference's GSPMD ``moe_forward`` on a mesh
whose experts do not split over ``model`` (``model == 1``, or E not
divisible): one stable sort of every global token's choices under one
capacity, ``capacity(B_global * S)``.  A rank's choice keeps its global
position (its expert's count on the ranks before it plus its own rank
within them), so the drops are the one-device drops; only the per-expert
counts cross the ranks, and each rank runs the GLU on its own kept
choices (the GLU is row-wise).

Plain PyTorch and ``torch.distributed``: the reference computes all of
this in jnp, no Pallas kernel stands behind it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (AllReduce, AllToAll, Enter,
                                                 Gather, GradScale, Leave,
                                                 all_gather_dim, all_reduce,
                                                 all_to_all_dim, axis_index)
from repro_torch.distributed.sharding import (BATCH_AXES, axis_sizes,
                                              batch_index)
from repro_torch.models.config import MoEConfig
from repro_torch.models.mlp import mlp_forward
from repro_torch.models.moe import (capacity, moe_forward, route,
                                    routed_experts, top_k)


def _round4(x: int) -> int:
    return max(4, ((x + 3) // 4) * 4)


def applicable(moe: MoEConfig, mesh) -> bool:
    """The reference's test: a ``model`` axis above 1 that the experts
    divide.  ``mesh``: a ``DeviceMesh``, a ``{axis: size}`` mapping, or
    None."""
    if mesh is None:
        return False
    m = axis_sizes(mesh).get("model", 1)
    return m > 1 and moe.num_experts % m == 0


def _dp_axes(sizes: dict) -> tuple:
    return tuple(a for a in BATCH_AXES if a in sizes)


def _live(sizes: dict, axes) -> tuple:
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def _axis(sizes: dict, axis: str):
    """``axis`` where the mesh splits over it, else None."""
    return axis if sizes.get(axis, 1) > 1 else None


def pod_fsdp(moe: MoEConfig, sizes: dict) -> bool:
    """Whether the experts' FFN width splits over ``pod`` (training)."""
    return sizes.get("pod", 1) > 1 and moe.d_expert % sizes["pod"] == 0


def param_specs(moe: MoEConfig, mesh, serving: bool = False) -> dict:
    """``{leaf: spec}`` of the blocks ``moe_forward_ep`` takes: the
    reference's ``in_specs`` (``moe_ep.py:274-299``), an axis of size 1
    left out (it splits nothing)."""
    sizes = axis_sizes(mesh)
    model, data = _axis(sizes, "model"), _axis(sizes, "data")
    if serving:
        ff = data if data and moe.d_expert % sizes["data"] == 0 else None
        specs = {"router": (None, None),
                 "we_gate": (model, None, ff), "we_up": (model, None, ff),
                 "we_down": (model, ff, None)}
        sh_d = None
    else:
        pod = "pod" if pod_fsdp(moe, sizes) else None
        specs = {"router": (None, None),
                 "we_gate": (model, data, pod), "we_up": (model, data, pod),
                 "we_down": (model, pod, data)}
        sh_d = data
    if moe.num_shared:
        specs.update({"shared/w_gate": (sh_d, model),
                      "shared/w_up": (sh_d, model),
                      "shared/w_down": (model, sh_d)})
    return specs


def capacities(moe: MoEConfig, mesh, tokens: int, serving: bool = False,
               local_capacity_factor: float = 1.5) -> dict:
    """-> ``{"sliced", "t_route", "c_send", "c_loc"}`` for ``tokens`` on
    this rank, from the post-slice token count (``moe_ep.py:80-97``)."""
    sizes = axis_sizes(mesh)
    m = sizes["model"]
    e_loc = moe.num_experts // m
    t_eff = tokens * sizes.get("data", 1) if serving else tokens
    sliced = t_eff % m == 0 and m > 1
    t_route = t_eff // m if sliced else t_eff
    c_send = _round4(int(t_route * moe.top_k * moe.capacity_factor / m) + 1)
    c_loc = _round4(int(m * c_send * local_capacity_factor / e_loc) + 1)
    return {"sliced": sliced, "t_route": t_route, "c_send": c_send,
            "c_loc": c_loc}


def _stable_dispatch(keys: torch.Tensor, buckets: int, cap: int):
    """The choices' stable sort by ``keys`` -> (order, sorted keys, each
    sorted choice's position within its bucket, kept, its slot:
    ``key * cap + pos`` when kept, else the trash slot ``buckets * cap``)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    counts = torch.zeros(buckets, dtype=torch.int64, device=keys.device)
    counts.scatter_add_(0, keys, torch.ones_like(keys))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(keys.numel(), device=keys.device) - starts[sorted_keys]
    keep = pos < cap
    slot = torch.where(keep, sorted_keys * cap + pos,
                       torch.full_like(pos, buckets * cap))
    return order, sorted_keys, pos, keep, slot


def _scatter_rows(rows: torch.Tensor, slot: torch.Tensor, n: int):
    """[n + 1, D] with ``rows[i]`` at ``slot[i]``; row n is the trash."""
    buf = rows.new_zeros((n + 1, rows.shape[-1]))
    return buf.index_copy_(0, slot, rows)


def _f32(x, device) -> torch.Tensor:
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """[1] f32: the true entries of ``mask`` (exact below 2**24), on the
    device, no host read."""
    return mask.to(torch.float32).sum().reshape(1)


def moe_forward_ep(params: dict, x: torch.Tensor, moe: MoEConfig, mesh, *,
                   local_capacity_factor: float = 1.5,
                   serving: bool = False, router_axes=()):
    """The reference's ``moe_forward_ep`` on this rank: ``params`` its
    blocks under ``param_specs(moe, mesh, serving)`` (the router whole),
    ``x`` [B_loc, S, D] its rows of the batch (split over (pod, data),
    replicated over ``model``).  -> (y [B_loc, S, D], aux dict of 0-d f32
    tensors, the same on every rank).

    ``router_axes``: the router held as its block of expert columns split
    over these axes (the serving layout splits it over ``model``): the
    logits of every token the model peers share are computed on the
    block and all-gathered, so no weight is gathered."""
    sizes = axis_sizes(mesh)
    dp = _dp_axes(sizes)
    m = sizes["model"]
    e, k, d = moe.num_experts, moe.top_k, x.shape[-1]
    e_loc = e // m
    data_size = sizes.get("data", 1)
    bl, sl, _ = x.shape
    t_local = bl * sl
    caps = capacities(moe, mesh, t_local, serving, local_capacity_factor)
    sliced, c_send, c_loc = caps["sliced"], caps["c_send"], caps["c_loc"]
    dev = x.device

    # x is replicated over model: its gradient is the sum of the peers'
    x = Enter.apply(x, mesh, "model")
    xf_local = x.reshape(t_local, d)
    xf_full = xf_local
    if serving and data_size > 1:
        xf_full = Gather.apply(xf_local, mesh, ((0, "data", True),))
    t_full = xf_full.shape[0]
    if sliced:
        tl = t_full // m
        xf = xf_full.narrow(0, axis_index(mesh, "model") * tl, tl)
    else:
        tl = t_full
        xf = xf_full

    # -- 1. routing (the whole router, f32) --
    if router_axes:
        logits = xf_full.to(torch.float32) @ params["router"]
        for axis in reversed(tuple(router_axes)):
            logits = all_gather_dim(logits, 1, mesh, axis)
        if sliced:
            logits = logits.narrow(0, axis_index(mesh, "model") * tl, tl)
    else:
        logits = xf.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    e_flat = top_e.reshape(tl * k)
    w_flat = top_p.reshape(tl * k)
    token_of = torch.arange(tl * k, device=dev) // k

    # -- 2. first-stage dispatch, by destination shard --
    n_send = m * c_send
    order, _, _, _, slot = _stable_dispatch(e_flat // e_loc, m, c_send)
    send_x = _scatter_rows(xf[token_of[order]], slot, n_send)[:n_send]
    send_eid = torch.full((n_send + 1,), -1, dtype=torch.int64, device=dev
                          ).index_copy_(0, slot, (e_flat % e_loc)[order])
    # where each (token, choice) went in the send buffer (trash: n_send)
    slot_of_choice = torch.empty_like(slot).index_copy_(0, order, slot)

    # -- 3. ship to the expert shards --
    recv_x = AllToAll.apply(send_x.view(m, c_send, d), mesh, "model"
                            ).reshape(n_send, d)
    recv_eid = all_to_all_dim(send_eid[:n_send].view(m, c_send), mesh,
                              "model").reshape(n_send)

    # -- 4. second-stage local dispatch, the expert GLU --
    eid_safe = torch.where(recv_eid >= 0, recv_eid,
                           torch.full_like(recv_eid, e_loc))
    order2, sorted_eid, pos2, _, _ = _stable_dispatch(eid_safe, e_loc + 1,
                                                      c_loc)
    keep2 = (pos2 < c_loc) & (sorted_eid < e_loc)
    slot2 = torch.where(keep2, sorted_eid * c_loc + pos2,
                        torch.full_like(pos2, e_loc * c_loc))
    buf = _scatter_rows(recv_x[order2], slot2, e_loc * c_loc)
    expert_in = buf[:e_loc * c_loc].view(e_loc, c_loc, d)
    wg, wu, wd = params["we_gate"], params["we_up"], params["we_down"]
    if not serving:
        plan_in, plan_out = [], []
        if data_size > 1:
            plan_in.append((1, "data", True))
            plan_out.append((2, "data", True))
        if pod_fsdp(moe, sizes):
            plan_in.append((2, "pod", True))
            plan_out.append((1, "pod", True))
        if plan_in:
            wg = Gather.apply(wg, mesh, tuple(plan_in))
            wu = Gather.apply(wu, mesh, tuple(plan_in))
            wd = Gather.apply(wd, mesh, tuple(plan_out))
    out = torch.bmm(F.silu(torch.bmm(expert_in, wg))
                    * torch.bmm(expert_in, wu), wd)          # [E_loc, C, D]
    if serving and param_specs(moe, mesh, True)["we_down"][1] is not None:
        # each data rank holds a block of F: the partial outputs summed
        out = AllReduce.apply(out, mesh, "data")
    out_flat = torch.cat([out.reshape(e_loc * c_loc, d),
                          out.new_zeros((1, d))])
    out_recv = torch.empty_like(recv_x).index_copy_(0, order2,
                                                    out_flat[slot2])

    # -- 5. ship back, combine --
    back = AllToAll.apply(out_recv.view(m, c_send, d), mesh, "model"
                          ).reshape(n_send, d)
    back = torch.cat([back, back.new_zeros((1, d))])
    contrib = back[slot_of_choice].to(torch.float32) * w_flat[:, None]
    y = contrib.view(tl, k, d).sum(1)
    if sliced:
        y = Gather.apply(y, mesh, ((0, "model", False),))
    else:
        # every model peer routed the same tokens: count them once
        y = GradScale.apply(y, 1.0 / m)
    if serving and data_size > 1:
        y = y.narrow(0, axis_index(mesh, "data") * t_local, t_local)
    y = y.reshape(bl, sl, d).to(x.dtype)

    # -- the shared experts, Megatron-style over model --
    if moe.num_shared:
        sg, su, sd = (params["shared/w_gate"], params["shared/w_up"],
                      params["shared/w_down"])
        if not serving and data_size > 1:
            sg = Gather.apply(sg, mesh, ((0, "data", True),))
            su = Gather.apply(su, mesh, ((0, "data", True),))
            sd = Gather.apply(sd, mesh, ((1, "data", True),))
        ysh = mlp_forward({"w_gate": sg, "w_up": su, "w_down": sd},
                          xf_local)
        y = y + Leave.apply(ysh, mesh, "model").reshape(bl, sl, d
                                                         ).to(x.dtype)

    # -- aux, globally reduced --
    red = dp + ("model",) if sliced else dp
    n_red = math.prod(sizes[a] for a in red)
    dup = 1 if sliced else m
    kept2 = all_reduce(_count(keep2), mesh, dp + ("model",))[0] / dup
    total = _f32(tl * k * n_red, dev)
    probs_sum, z_loc = probs.sum(0), torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    if not sliced:
        probs_sum = GradScale.apply(probs_sum, 1.0 / m)
        z_loc = GradScale.apply(z_loc, 1.0 / m)
    probs_sum = Leave.apply(probs_sum, mesh, red)
    counts_e = torch.zeros(e, dtype=torch.float32, device=dev)
    counts_e.scatter_add_(0, e_flat, torch.ones_like(e_flat,
                                                     dtype=torch.float32))
    counts_e = all_reduce(counts_e, mesh, red)
    f_e = counts_e / torch.clamp(total, min=1.0)
    p_e = probs_sum / torch.clamp(total / k, min=1.0)
    z_mean = Leave.apply(z_loc, mesh, red) / n_red
    aux = {"load_balance_loss": e * torch.sum(f_e * p_e),
           "router_z_loss": moe.router_z_loss * z_mean,
           "drop_fraction": 1.0 - kept2 / torch.clamp(total, min=1.0)}
    return y, aux


def moe_forward_global(params: dict, x: torch.Tensor, moe: MoEConfig,
                       mesh, row_axes=None):
    """The reference's ``moe_forward`` over the global batch, on this
    rank's rows ``x`` [B_loc, S, D] (split over ``row_axes``, the batch
    axes the global rows divide over, by default every one; any ``model``
    peers, and the ranks of the batch axes the rows do not split over,
    hold the same rows and compute the same), ``params`` whole: one
    capacity for all B_global * S tokens and each choice's global position
    in its expert's stable sort.  -> (y [B_loc, S, D], the global aux).
    The aux means count a row as often as ranks hold it, so their values
    are the reference's and so is their gradient summed over the ranks."""
    sizes = axis_sizes(mesh)
    axes = _live(sizes, BATCH_AXES)
    if not axes:
        return moe_forward(params, x, moe)
    split = axes if row_axes is None else _live(sizes, row_axes)
    b, s, d = x.shape
    t = b * s
    k, e = moe.top_k, moe.num_experts
    idx, n = batch_index(mesh, split)
    t_global = t * n
    t_held = t * math.prod(sizes[a] for a in axes)
    c = capacity(t_global, moe)
    dev = x.device
    xf = x.reshape(t, d)

    logits = xf.to(torch.float32) @ params["router"]
    r = route(logits, moe, c)
    every = r["counts"][None]
    for a in reversed(split):                  # the innermost first
        every = all_gather_dim(every, 0, mesh, a)
    # a choice's global rank in its expert: its rank here plus the
    # expert's choices on the ranks before this one
    before = every[:idx].sum(0)
    keep = r["pos"] + before[r["sorted_e"]] < c
    r["slot"] = torch.where(keep, r["sorted_e"] * c + r["pos"],
                            torch.full_like(r["pos"], e * c))
    y = routed_experts(params, xf, r, c, moe).to(x.dtype).reshape(b, s, d)
    if moe.num_shared:
        y = y + mlp_forward(params["shared"], x)

    kept = all_reduce(_count(keep), mesh, split)[0]
    f_e = every.sum(0).to(torch.float32) / max(t_global * k, 1)
    p_e = Leave.apply(r["probs"].sum(0), mesh, axes) / t_held
    z = Leave.apply(torch.sum(torch.logsumexp(logits, dim=-1) ** 2), mesh,
                    axes) / t_held
    aux = {"load_balance_loss": e * torch.sum(f_e * p_e),
           "router_z_loss": moe.router_z_loss * z,
           "drop_fraction": 1.0 - kept / _f32(t_global * k, dev)}
    return y, aux


__all__ = ["applicable", "pod_fsdp", "param_specs", "capacities",
           "moe_forward_ep", "moe_forward_global"]
