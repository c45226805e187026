"""Decode on a (data, model) mesh under the serving layout (the port's
counterpart of the reference's decode cells, ``repro/launch/dryrun.py``'s
``serve_step`` under ``SERVING_RULES``, and of ``serve/decode.py``'s step
on one device).

The weights stay where ``sharding.param_shardings(..., SERVING_RULES)``
puts them: every weight dim split over ``model`` and ``data`` where it
divides, nothing split over ``fsdp``, and nothing gathered.  The caches
stay where ``sharding.cache_shardings`` puts them: the batch over (pod,
data), the KV heads over ``model`` when the model size divides them, else
the cache's sequence over ``model`` (``kv_seq``), the SSM and RG-LRU
states over their heads and channels.  The activations move instead; in
decode they are a few rows a rank:

* the token rows of this rank are all-gathered over the batch axes, and
  the hidden state ``x`` [B, 1, D] is then whole on every rank;
* a linear layer (``lin``) multiplies its input's block of columns (the
  weight's input dim split: an all-reduce of the partial products over
  those axes) by this rank's weight block, and all-gathers the output
  columns over the axes its output dim is split over;
* the MLP is Megatron-style over its split hidden dim: ``w_gate`` /
  ``w_up`` column blocks and the matching ``w_down`` row block, one
  all-reduce of the partial output;
* attention runs on this rank's cache block: its batch rows and its KV
  heads, the new K/V column written in place.  With the sequence split
  (``kv_seq``) the rank that owns the slot writes it, and the softmax's
  max, sum of exponentials and weighted values are all-reduced over
  ``model`` (``attention.decode_attend``, the one-device step's core,
  with that reduction as its ``combine``).  The heads' outputs are
  all-gathered (heads, then rows) before ``wo``;
* the SSM and RG-LRU recurrences run on this rank's rows and heads or
  channels of the state (the one-device steps ``ssm.ssm_step`` and
  ``rglru.rglru_step``), their outputs all-gathered before the out
  projection.  A depthwise conv whose weight splits its channels over
  (``model``, ``data``) while its state splits them over ``model`` alone
  gathers the conv state (K - 1 rows a sequence) and cuts the new one
  back;
* an MoE layer whose experts divide ``model`` takes the expert-parallel
  dispatch (``moe_ep.moe_forward_ep(serving=True)``; the router's logits
  computed on its expert-column block and gathered); otherwise the
  routing runs on the whole batch under the one-device capacity and the
  experts' GLU on this rank's blocks of E, D and F, the partial products
  all-reduced.  The shared experts are an MLP as above;
* the logits come back whole on every rank (the reference's
  ``out_shardings`` is None): the head's vocabulary columns all-gathered.

Collectives of one step, a layer at a time (an axis of size 1 makes
none): all-gathers of the projections' output columns and of the heads'
or channels' outputs, all-reduces of the row-parallel products (``wo``,
``w_down``, ``w_out``) and of a split softmax, the expert-parallel
all-to-alls.  ``rules=None`` runs the same step on the training layout
(the reference's ``--rules train``): the ``fsdp`` input dims are then
split too, and ``lin``'s all-reduce carries them.

Plain PyTorch and ``torch.distributed``, as the reference is jnp under
GSPMD: no kernel stands behind this module.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import moe_ep
from repro_torch.distributed.collectives import all_reduce, axis_index
from repro_torch.distributed.sharding import (BATCH_AXES, SERVING_RULES,
                                              axis_sizes, block_index,
                                              cache_shardings, entry_axes,
                                              gather_block, take_block,
                                              param_shardings, shard_leaf,
                                              spec_for_shape)
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (check_decode_position,
                                          decode_attend, is_ring,
                                          torch_dtype)
from repro_torch.models.layers import (apply_rope, causal_conv1d_update,
                                       rms_norm)


class ServingLM:
    """``cfg``'s decode step on this rank's blocks of ``mesh`` (module
    docstring), for a global batch of ``batch`` sequences and caches of
    ``cache_len`` positions.  ``specs``: ``{path: spec}`` of the port's
    parameter tree (``layers/<i>/...``) under ``rules``;
    ``cache_specs``: of ``lm.init_caches(cfg, batch, cache_len)``."""

    def __init__(self, cfg, mesh, batch: int, cache_len: int,
                 rules=SERVING_RULES):
        lm.check_supported(cfg)
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name}: an encoder has no decode step")
        self.cfg, self.mesh = cfg, mesh
        self.sizes = axis_sizes(mesh)
        self.coords = {a: axis_index(mesh, a) for a in self.sizes}
        self.abstract = lm.abstract_params(cfg)
        self.specs = param_shardings(self.abstract, mesh, rules)
        self.caches_abs = lm.init_caches(cfg, batch, cache_len,
                                         device="meta")
        self.cache_specs = cache_shardings(self.caches_abs, mesh)
        self.rows = spec_for_shape((batch,), ("batch",), mesh)[0]
        self.s_max = lm.attention_cache_len(self.caches_abs)
        dp = math.prod(self.sizes.get(a, 1) for a in BATCH_AXES)
        self.expert_parallel = (
            cfg.moe is not None and rules is SERVING_RULES
            and moe_ep.applicable(cfg.moe, self.sizes) and batch % dp == 0)
        if self.expert_parallel:
            self.ep_moe = dataclasses.replace(cfg.moe, num_shared=0)

    # -- blocks --------------------------------------------------------------
    def place(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the parameter leaf ``path`` (for
        ``lm.init_params(place=...)``)."""
        return shard_leaf(full, self.specs[path], self.mesh, self.coords)

    def shard_params(self, params: dict) -> dict:
        """This rank's blocks of a whole parameter tree (the port's
        layout)."""
        from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

        return tree_unflatten(params, [
            self.place(p, x) for x, p in zip(tree_leaves(params),
                                             tree_paths(params))])

    # -- moving activations --------------------------------------------------
    def own(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` split by ``entry``."""
        return take_block(x, dim, entry, self.mesh, self.coords)

    def gather(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        return gather_block(x, dim, entry, self.mesh)

    def reduce(self, x: torch.Tensor, entry, op=None) -> torch.Tensor:
        axes = entry_axes(entry)
        if not axes:
            return x
        x = x.contiguous()
        if op is None:
            return all_reduce(x, self.mesh, axes)
        return all_reduce(x, self.mesh, axes, op)

    def lin(self, x: torch.Tensor, w: torch.Tensor, spec,
            bias: torch.Tensor | None = None) -> torch.Tensor:
        """``x @ W (+ bias)`` whole on every rank from this rank's block
        ``w`` of ``W`` under ``spec`` (its last two entries: the input and
        the output dim), ``x`` whole."""
        k_ent, n_ent = spec[-2], spec[-1]
        y = self.own(x, -1, k_ent) @ w
        y = self.reduce(y, k_ent)
        if bias is not None:
            y = y + bias
        return self.gather(y, -1, n_ent)

    def _spec(self, i: int, sub: str):
        return self.specs[f"layers/{i}/{sub}"]

    # -- the step ------------------------------------------------------------
    def decode_step(self, params: dict, tokens_t: torch.Tensor, caches,
                    position):
        """One new token for every sequence.  ``params`` and ``caches``:
        this rank's blocks; ``tokens_t``: this rank's rows of the [B, 1]
        tokens (split as the batch is); ``position``: an int (checked
        against the caches: ``CachePositionError``) or a one-element int64
        tensor.  The caches are written in place.  -> (logits [B, 1,
        V_pad] f32, whole on every rank; caches)."""
        cfg = self.cfg
        tokens = self.gather(tokens_t, 0, self.rows)
        b, dev = tokens.shape[0], tokens.device
        if not isinstance(position, torch.Tensor):
            if self.s_max is not None:
                check_decode_position(cfg, self.s_max, int(position))
            position = torch.full((1,), int(position), dtype=torch.int64,
                                  device=dev)
        rope = lm.decode_rope(cfg, position, b)
        x = self.embed(params, tokens).to(torch_dtype(cfg.compute_dtype))
        for i, (lp, kind) in enumerate(zip(params["layers"],
                                           cfg.layer_pattern)):
            cache, cspecs = self._layer_cache(caches, i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if kind == "attn":
                y = self._attn(i, lp["mixer"], h, cache, cspecs, position,
                               rope)
            elif kind == "ssm":
                y = self._ssm(i, lp["mixer"], h, cache, cspecs)
            else:
                y = self._rglru(i, lp["mixer"], h, cache, cspecs)
            x = x + y
            if kind != "ssm" and "ffn" in lp:
                h = rms_norm(x, lp["ln2"], cfg.norm_eps)
                if cfg.moe is not None:
                    y = self._moe(i, lp["ffn"], h)
                else:
                    y = self._mlp(lambda sub: self._spec(i, "ffn/" + sub),
                                  lp["ffn"], h)
                x = x + y
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self.head(params, x), caches

    def _layer_cache(self, caches, i: int):
        if isinstance(caches, dict):
            return ({n: leaf[i] for n, leaf in caches.items()},
                    {n: self.cache_specs[n][1:] for n in caches})
        return caches[i], {n: self.cache_specs[f"{i}/{n}"]
                           for n in caches[i]}

    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-split lookup: each rank its rows of the table, zeros
        for the others, all-reduced; the D columns gathered."""
        table = params["embed"]
        v_ent, d_ent = self.specs["embed"]
        vl = table.shape[0]
        idx, _ = block_index(v_ent, self.sizes, self.coords)
        t = tokens.long() - idx * vl
        ok = (t >= 0) & (t < vl)
        x = table[t.clamp(0, vl - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        return self.gather(self.reduce(x, v_ent), -1, d_ent)

    def head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if not cfg.vocab_size:
            return x.to(torch.float32)
        if cfg.tie_embeddings:
            v_ent, d_ent = self.specs["embed"]
            return self.lin(x, params["embed"].T, (d_ent, v_ent)).to(
                torch.float32)
        return self.lin(x, params["head"], self.specs["head"]).to(
            torch.float32)

    # -- mixers ---------------------------------------------------------------
    def _attn(self, i, p, h, cache, cspecs, position, rope):
        cfg = self.cfg
        b = h.shape[0]
        nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        g = nh // kvh
        sp = lambda sub: self._spec(i, "mixer/" + sub)   # noqa: E731
        q = self.lin(h, p["wq"], sp("wq"), p.get("bq"))
        k = self.lin(h, p["wk"], sp("wk"), p.get("bk"))
        v = self.lin(h, p["wv"], sp("wv"), p.get("bv"))
        q, k, v = (q.reshape(b, 1, nh, hd), k.reshape(b, 1, kvh, hd),
                   v.reshape(b, 1, kvh, hd))
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        q, k = apply_rope(q, k, None, hd, cfg.rope_theta, cfg.rope,
                          tables=rope)

        rows, seq, heads = cspecs["k"][0], cspecs["k"][1], cspecs["k"][2]
        pos_seq = cspecs["pos"][1]
        kc, vc, pc = cache["k"], cache["v"], cache["pos"]
        s_loc = kc.shape[1]
        s_full = s_loc * block_index(seq, self.sizes, self.coords)[1]
        ring = is_ring(cfg, s_full)
        slot = position % cfg.sliding_window if ring else position
        q, k, v = (self.own(t, 0, rows) for t in (q, k, v))
        q, k, v = (self.own(t, 2, heads) for t in (q, k, v))
        bl, hl = q.shape[0], q.shape[2]
        new_pos = position.view(1, 1).expand(bl, 1)

        # the new column, on the rank that owns its slot
        for buf, new, entry in ((kc, k, seq), (vc, v, seq),
                                (pc, new_pos, pos_seq)):
            self._write(buf, slot, new, entry)
        if pos_seq != seq:
            # the positions split otherwise than the K/V (cache_shardings
            # gives ``pos`` the sequence split whenever it divides)
            pc = self.own(self.gather(pc, 1, pos_seq), 1, seq)

        combine = None if seq is None else (
            lambda op, x: self.reduce(x, seq, torch.distributed.ReduceOp.MAX
                                      if op == "max" else None))
        out = decode_attend(q.reshape(bl, hl // g, g, hd).to(torch.float32),
                            kc, vc, pc, position, cfg, combine)
        out = out.reshape(bl, 1, hl, hd).to(h.dtype)
        out = self.gather(self.gather(out, 2, heads), 0, rows)
        return self.lin(out.reshape(b, 1, nh * hd), p["wo"], sp("wo"))

    def _write(self, buf, slot, new, entry) -> None:
        """``buf[:, slot] = new`` in place, ``buf`` this rank's block of
        the sequence split by ``entry``: only the owner of ``slot``
        changes its column."""
        if entry is None:
            buf.index_copy_(1, slot, new.to(buf.dtype))
            return
        s_loc = buf.shape[1]
        idx, _ = block_index(entry, self.sizes, self.coords)
        local = slot - idx * s_loc
        mine = (local >= 0) & (local < s_loc)
        lslot = local.clamp(0, s_loc - 1)
        old = buf.index_select(1, lslot)
        keep = mine.view(*([1] * old.dim()))
        buf.index_copy_(1, lslot, torch.where(keep, new.to(buf.dtype), old))

    def _conv(self, x, state, state_spec, w, w_spec):
        """The depthwise conv's step: ``x`` [B, C] whole, ``state`` this
        rank's [B_l, K-1, C_s] block, ``w`` its [K, C_w] block ->
        (the conv's output [B, C] whole, the new state block)."""
        rows, c_state, c_w = state_spec[0], state_spec[-1], w_spec[-1]
        if c_state == c_w:
            y, new = causal_conv1d_update(
                self.own(self.own(x, 0, rows), -1, c_w), state, w)
            return self.gather(self.gather(y, -1, c_w), 0, rows), new
        full = self.gather(self.gather(state, 2, c_state), 0, rows)
        y, new = causal_conv1d_update(self.own(x, -1, c_w),
                                      self.own(full, 2, c_w), w)
        new = self.own(self.own(self.gather(new, 2, c_w), 0, rows), 2,
                       c_state)
        return self.gather(y, -1, c_w), new

    def _ssm(self, i, p, h, cache, cspecs):
        cfg = self.cfg
        s_cfg, d_inner, n_heads = ssm_mod._dims(cfg)
        pdim, n = s_cfg.head_dim, s_cfg.state_dim
        sp = lambda sub: self._spec(i, "mixer/" + sub)   # noqa: E731
        b, f32 = h.shape[0], torch.float32
        proj = self.lin(h[:, 0, :], p["w_in"], sp("w_in"))
        z, x, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * n,
                                              n_heads], dim=-1)
        conv_out, conv_state = self._conv(torch.cat([x, bc], dim=-1),
                                          cache["conv"], cspecs["conv"],
                                          p["conv_w"], sp("conv_w"))
        x, bm, cm = torch.split(F.silu(conv_out), [d_inner, n, n], dim=-1)

        rows, heads = cspecs["h"][0], cspecs["h"][1]
        x, bm, cm, dt_raw = (self.own(t, 0, rows) for t in
                             (x, bm, cm, dt_raw))
        bl = x.shape[0]
        xh = self.own(x.reshape(bl, n_heads, pdim), 1, heads).to(f32)
        y, st = ssm_mod.ssm_step(
            xh, self.own(dt_raw, -1, heads), bm, cm, cache["h"],
            {k: self.own(p[k], 0, heads)
             for k in ("dt_bias", "a_log", "d_skip")})
        y = self.gather(self.gather(y, 1, heads), 0, rows)
        y = y.reshape(b, d_inner) * F.silu(z.to(f32))
        y = rms_norm(y.to(h.dtype), p["norm"], cfg.norm_eps)
        out = self.lin(y, p["w_out"], sp("w_out"))[:, None, :]
        cache["h"].copy_(st)
        cache["conv"].copy_(conv_state.to(cache["conv"].dtype))
        return out

    def _rglru(self, i, p, h, cache, cspecs):
        cfg = self.cfg
        sp = lambda sub: self._spec(i, "mixer/" + sub)   # noqa: E731
        h0 = h[:, 0, :]
        u = self.lin(h0, p["w_x_branch"], sp("w_x_branch"))
        gate = F.gelu(self.lin(h0, p["w_gate_branch"], sp("w_gate_branch")),
                      approximate="tanh")
        u_conv, conv_state = self._conv(u, cache["conv"], cspecs["conv"],
                                        p["conv_w"], sp("conv_w"))
        rows, chans = cspecs["h"][0], cspecs["h"][1]
        gates = {k: self.own(p[k], 0, chans)
                 for k in ("w_a", "b_a", "w_i", "b_i", "lam")}
        uc = self.own(self.own(u_conv, 0, rows), -1, chans)
        st = rglru_mod.rglru_step(gates, uc, cache["h"],
                                  cfg.rglru.c_exponent)
        y = st.to(h.dtype) * self.own(self.own(gate, 0, rows), -1, chans)
        y = self.gather(self.gather(y, -1, chans), 0, rows)
        out = self.lin(y, p["w_out"], sp("w_out"))[:, None, :]
        cache["h"].copy_(st)
        cache["conv"].copy_(conv_state.to(cache["conv"].dtype))
        return out

    # -- feed-forward ---------------------------------------------------------
    def _mlp(self, spec_of, p, h):
        sg, su, sd = spec_of("w_gate"), spec_of("w_up"), spec_of("w_down")
        if sg[0] is None and su == sg and sd[1] is None and sd[0] == sg[1]:
            return self.reduce(
                (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"],
                sg[1])
        gate = F.silu(self.lin(h, p["w_gate"], sg))
        return self.lin(gate * self.lin(h, p["w_up"], su), p["w_down"], sd)

    def _moe(self, i, p, h):
        cfg, moe = self.cfg, self.cfg.moe
        sp = lambda sub: self._spec(i, "ffn/" + sub)     # noqa: E731
        b, s, d = h.shape
        if self.expert_parallel:
            rows = spec_for_shape((b,), ("batch",), self.sizes)[0]
            routed = {k: p[k] for k in ("router", "we_gate", "we_up",
                                        "we_down")}
            y, _ = moe_ep.moe_forward_ep(
                routed, self.own(h, 0, rows), self.ep_moe, self.mesh,
                serving=True, router_axes=entry_axes(sp("router")[-1]))
            y = self.gather(y, 0, rows)
        else:
            xf = h.reshape(b * s, d)
            logits = self.lin(xf.to(torch.float32), p["router"],
                              sp("router"))
            c = moe_mod.capacity(b * s, moe)
            r = moe_mod.route(logits, moe, c)
            y = moe_mod.routed_experts(
                p, xf, r, c, moe, glu=lambda ein: self._glu(sp, p, ein))
            y = y.to(h.dtype).reshape(b, s, d)
        if moe.num_shared:
            y = y + self._mlp(lambda sub: sp("shared/" + sub), p["shared"],
                              h)
        return y

    def _glu(self, sp, p, expert_in):
        """The experts' GLU on this rank's blocks of ``we_*`` [E, D, F]:
        ``expert_in`` [E, C, D] whole -> [E, C, D] whole."""
        e_ent, d_ent, f_ent = sp("we_gate")
        _, f_down, d_down = sp("we_down")
        xin = self.own(self.own(expert_in, 0, e_ent), 2, d_ent)
        gate = self.reduce(torch.bmm(xin, p["we_gate"]), d_ent)
        up = self.reduce(torch.bmm(xin, p["we_up"]), d_ent)
        out = self.reduce(torch.bmm(F.silu(gate) * up, p["we_down"]),
                          f_down)
        return self.gather(self.gather(out, 2, d_down), 0, e_ent)


__all__ = ["ServingLM"]
