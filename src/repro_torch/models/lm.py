"""The LM backbone: init / forward / prefill / decode (port of
``repro/models/lm.py``) for every family: dense and MoE decoders, the
attention-free SSM stack (``family == "ssm"``), the RG-LRU /
local-attention hybrid (``"hybrid"``), the vision-language decoder
(``"vlm"``: projected patches prepended to the text, M-RoPE) and the
encoder-only audio stack (``"audio"``: projected frames, bidirectional
attention, no decode step).

Structure per layer (pre-norm residual):

  attn / rec:  x += mixer(rms(x));  x += ffn(rms(x))
  ssm:         x += mixer(rms(x))                 (Mamba-style, no FFN)

with the FFN an MoE layer when ``cfg.moe`` is set.  Parameters are a dict
of tensors with ``params["layers"]`` a list of one dict per layer (the
reference stacks homogeneous stacks ``[L, ...]`` for ``lax.scan`` and the
period-scanned hybrid by pattern position;
``repro_torch.convert.lm_params_from_reference`` unstacks both).  Decode
caches are allocated once and written in place by ``decode_step``,
stacked by kind:

  attention stacks (dense, moe)  {"k", "v": [L, B, S, KV, hd], "pos": [L, B, S]}
  ssm                            {"h": [L, B, H, P, N] f32, "conv": [L, B, K-1, C]}
  hybrid                         a list of one cache a layer (its layers differ)

``forward`` returns the MoE layers' aux losses summed over the layers, as
the reference's does.  Given ``shard`` (``repro_torch.distributed.
tensor_parallel.ShardedLM``), ``forward`` runs on this rank's blocks of a
(data, model) mesh: the hook gathers each layer's leaves at their use,
wraps the tensor-parallel mixers and FFNs in their collectives, and
dispatches an MoE layer across the ranks (``distributed/moe_ep.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import (embed_inputs, init_frontend,
                                          text_mrope_t0)
from repro_torch.models.layers import (embed_init, rms_norm, rope_tables,
                                       truncated_normal_init)
from repro_torch.models.mlp import init_mlp, mlp_forward

PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
AUX_KEYS = ("load_balance_loss", "router_z_loss", "drop_fraction")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a known family."""
    if cfg.family not in PORTED:
        raise NotImplementedError(f"{cfg.name}: unknown family "
                                  f"{cfg.family!r}")


def stacked(cfg: ModelConfig) -> bool:
    """Whether the caches are stacked [L, ...] (every layer one kind, as the
    reference's scanned stacks), not one a layer."""
    return cfg.scan_layers and len(set(cfg.layer_pattern)) == 1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, layer_type: str, device) -> dict:
    dt = torch_dtype(cfg.param_dtype)
    p: dict = {"ln1": torch.zeros((cfg.d_model,), dtype=dt, device=device)}
    if layer_type == "attn":
        p["mixer"] = attn_mod.init_attention(gen, cfg, device)
    elif layer_type == "rec":
        p["mixer"] = rglru_mod.init_rglru(gen, cfg, device)
    elif layer_type == "ssm":
        p["mixer"] = ssm_mod.init_ssm(gen, cfg, device)
    else:
        raise ValueError(layer_type)
    if layer_type != "ssm":
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=dt, device=device)
        if cfg.moe is not None:
            p["ffn"] = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, dt,
                                        device)
        elif cfg.d_ff:
            p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def _build(cfg: ModelConfig, gen: torch.Generator, device,
           place=None) -> dict:
    """The parameter tree, each part drawn in turn from ``gen``; with
    ``place(path, tensor)`` each leaf is handed to it as soon as its part
    is drawn and what it returns is kept (so a rank can keep its block of
    a model that would not fit whole)."""
    dt = torch_dtype(cfg.param_dtype)
    keep = (lambda path, x: x) if place is None else place

    def kept(prefix: str, part):
        if isinstance(part, dict):
            return {k: kept(f"{prefix}/{k}", v) for k, v in part.items()}
        return keep(prefix, part)

    params: dict = {}
    if cfg.vocab_size:
        params["embed"] = kept("embed", embed_init(
            gen, (cfg.padded_vocab, cfg.d_model), dt, device))
    if cfg.frontend != "none":
        params["frontend"] = kept("frontend", init_frontend(gen, cfg,
                                                            device))
    params["layers"] = [kept(f"layers/{i}", _init_layer(gen, cfg, t, device))
                        for i, t in enumerate(cfg.layer_pattern)]
    params["final_norm"] = kept("final_norm", torch.zeros(
        (cfg.d_model,), dtype=dt, device=device))
    if cfg.vocab_size and not cfg.tie_embeddings:
        params["head"] = kept("head", truncated_normal_init(
            gen, (cfg.d_model, cfg.padded_vocab), 1.0, dt, device))
    return params


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None,
                place=None) -> dict:
    """Random weights on ``device`` (``None``: the card), drawn from
    ``generator`` (default: a generator on the device seeded with
    ``seed``).  The embedding is [padded_vocab, D]; an untied head
    [D, padded_vocab]; a patch or frame frontend's ``frontend/proj``
    [frontend_dim, D]; the router, the SSM's ``a_log`` / ``dt_bias`` /
    ``d_skip`` and the RG-LRU's gates f32, as in the reference.
    ``place(path, leaf)``: what to keep of each leaf as it is drawn (e.g.
    ``distributed.serving.ServingLM.place``: this rank's block); the same
    draws, so the blocks are those of the whole tree."""
    check_supported(cfg)
    device = resolve_device(device)
    if device.type == "meta":
        return abstract_params(cfg)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    return _build(cfg, gen, device, place)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes on the ``meta`` device (no
    allocation)."""
    check_supported(cfg)
    return _build(cfg, torch.Generator(), torch.device("meta"))


def tree_size_from_param_count(cfg: ModelConfig) -> int:
    """The element count of the parameter tree, from the analytic
    ``cfg.param_count()``: plus the vocabulary padding rows of the embedding
    (and of an untied head), the q/k norm scales and the qkv biases of the
    attention layers, the SSM's ``dt_bias`` and the RG-LRU's ``lam``, which
    the analytic count leaves out, less the one d_model vector an attention
    layer that it adds beyond the two norm scales that layer has."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    pattern = cfg.layer_pattern
    n_attn, n_ssm, n_rec = (pattern.count(t) for t in ("attn", "ssm", "rec"))
    heads = 1 if cfg.tie_embeddings else 2
    size = cfg.param_count() + heads * (cfg.padded_vocab - cfg.vocab_size) * d
    if cfg.qk_norm:
        size += n_attn * 2 * hd
    if cfg.attn_bias:
        size += n_attn * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    if n_ssm:
        size += n_ssm * ssm_mod._dims(cfg)[2]
    if n_rec:
        size += n_rec * rglru_mod._width(cfg)
    return size - n_attn * d


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def _apply_block(layer_params, x, positions, cfg: ModelConfig,
                 layer_type: str, *, mode: str, cache=None,
                 attn_impl: str = "auto", chunk: int = 512, decode_pos=None,
                 cache_len=None, rows=None, rope=None, tp=None):
    """Returns (x, new_cache, aux).  ``tp``: a sharded layer's
    tensor-parallel regions (``tensor_parallel.LayerRegions``): the mixer's
    or the FFN's input enters its region and its output leaves it; an MoE
    FFN runs the mesh's dispatch (``tp.moe``)."""
    aux = {}
    h = rms_norm(x, layer_params["ln1"], cfg.norm_eps)
    if tp is not None and tp.mixer:
        h = tp.enter(h)
    prefill = mode == "prefill"
    if layer_type == "attn":
        if mode == "decode":
            y, new_cache = attn_mod.attention_decode(
                layer_params["mixer"], h, cache, decode_pos, cfg, rows=rows,
                rope=rope)
        else:
            y, new_cache = attn_mod.attention_forward(
                layer_params["mixer"], h, positions, cfg, impl=attn_impl,
                chunk=chunk, return_cache=prefill, cache_len=cache_len,
                rope=rope)
    elif layer_type == "rec":
        if mode == "decode":
            y, new_cache = rglru_mod.rglru_decode(
                layer_params["mixer"], h, cache, cfg, rows=rows)
        else:
            y, new_cache = rglru_mod.rglru_forward(
                layer_params["mixer"], h, cfg, return_state=prefill)
    elif layer_type == "ssm":
        if mode == "decode":
            y, new_cache = ssm_mod.ssm_decode(
                layer_params["mixer"], h, cache, cfg, rows=rows)
        else:
            y, new_cache = ssm_mod.ssm_forward(
                layer_params["mixer"], h, cfg, return_state=prefill)
    else:
        raise ValueError(layer_type)
    if tp is not None and tp.mixer:
        y = tp.leave(y)
    x = x + y
    if layer_type != "ssm" and "ffn" in layer_params:
        h = rms_norm(x, layer_params["ln2"], cfg.norm_eps)
        if cfg.moe is not None and tp is not None and tp.moe is not None:
            y, aux = tp.moe(layer_params["ffn"], h)
        elif cfg.moe is not None:
            y, aux = moe_mod.moe_forward(layer_params["ffn"], h, cfg.moe)
        elif tp is not None and tp.ffn:
            y = tp.leave(mlp_forward(layer_params["ffn"], tp.enter(h)))
        else:
            y = mlp_forward(layer_params["ffn"], h)
        x = x + y
    return x, new_cache, aux


def _zero_aux(cfg: ModelConfig, device) -> dict:
    if cfg.moe is None:
        return {}
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def remat_groups(cfg: ModelConfig) -> list:
    """The runs of layers that train mode checkpoints as one, with each
    run's policy, where the reference puts its ``jax.checkpoint``: each
    layer of a scanned stack with ``cfg.remat`` ("dots" saves the outputs
    of the plain matrix products), each period of a period-scanned hybrid
    in full and its tail layers not at all, and each layer of any other
    per-layer list in full."""
    n = cfg.num_layers
    if stacked(cfg):
        return [([i], cfg.remat) for i in range(n)]
    if cfg.use_period_scan:
        period, n_per, _ = cfg.period_info
        plen = len(period)
        return ([(list(range(i * plen, (i + 1) * plen)), "full")
                 for i in range(n_per)]
                + [([i], "none") for i in range(n_per * plen, n)])
    return [([i], "full") for i in range(n)]


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep what a 2-D matrix
    product (``x @ W``, folded to ``mm``) returns, recompute the rest
    (batched ``bmm`` included)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------

def forward(params: dict, batch: dict, cfg: ModelConfig, *,
            mode: str = "train", attn_impl: str = "auto", chunk: int = 512,
            cache_len: Optional[int] = None, shard=None):
    """-> (logits [B, S, V_pad] f32, caches|None, aux dict).

    ``batch["tokens"]`` [B, S] ints; with the patch frontend also
    ``batch["patches"]`` [B, n_patch, frontend_dim], whose slots come first
    in the logits (and optional ``mrope_positions`` [B, S, 3]); with the
    frame frontend ``batch["frames"]`` [B, S, frontend_dim] and no tokens
    (``params`` then needs no ``embed``).  ``cache_len``: KV-cache capacity when
    mode == 'prefill' (defaults to the prefill length, or the window for
    local attention; pass the decode horizon to pre-allocate room).
    ``aux``: the MoE layers' ``load_balance_loss``, ``router_z_loss`` and
    ``drop_fraction``, each summed over the layers (empty without MoE).
    In train mode with autograd recording, ``cfg.remat`` checkpoints the
    layers as ``remat_groups`` says: less memory, the same numbers.
    ``shard``: run on this rank's blocks (module docstring); the logits are
    then this rank's vocabulary columns when the head is vocab-parallel."""
    assert mode in ("train", "prefill")
    check_supported(cfg)
    if shard is None:
        x, positions, mrope = embed_inputs(params, batch, cfg,
                                           params.get("embed"))
    else:
        x, positions, mrope = shard.embed_inputs(params, batch)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta,
                       cfg.rope, mrope)
    aux_total = _zero_aux(cfg, x.device)

    def run_layers(idx, x):
        caches, auxes = [], []
        for i in idx:
            lp, lcfg, tp = params["layers"][i], cfg, None
            if shard is not None:
                lp, lcfg, tp = shard.layer(lp, cfg.layer_pattern[i])
            x, new_cache, aux = _apply_block(
                lp, x, positions, lcfg, cfg.layer_pattern[i],
                mode=mode, attn_impl=attn_impl, chunk=chunk,
                cache_len=cache_len, rope=rope, tp=tp)
            caches.append(new_cache)
            auxes.append(aux)
        return x, caches, auxes

    caches = []
    remat = mode == "train" and cfg.remat != "none" \
        and torch.is_grad_enabled()
    groups = remat_groups(cfg) if remat \
        else [(list(range(cfg.num_layers)), "none")]
    for idx, policy in groups:
        if policy == "none":
            x, group_caches, auxes = run_layers(idx, x)
        else:
            x, group_caches, auxes = checkpoint(
                run_layers, idx, x, use_reentrant=False,
                **({"context_fn": _save_dots} if policy == "dots" else {}))
        caches.extend(group_caches)
        for aux in auxes:
            for k in aux_total:
                aux_total[k] = aux_total[k] + aux.get(k, 0.0)
    if mode != "prefill":
        caches = None
    elif stacked(cfg):
        caches = {name: torch.stack([c[name] for c in caches])
                  for name in caches[0]}
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _head(params, x, cfg) if shard is None \
        else shard.head(params, x)
    return logits, caches, aux_total


def _head(params, x, cfg: ModelConfig):
    """Logits in f32 over the padded vocabulary: the matmul in the compute
    dtype (tied: the embedding's transpose), then cast; without a
    vocabulary, the final hidden states in f32."""
    if not cfg.vocab_size:
        return x.to(torch.float32)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ w).to(torch.float32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _one_cache(cfg: ModelConfig, layer_type: str, batch: int, max_len: int,
               dtype, device) -> dict:
    if layer_type == "attn":
        return attn_mod.init_cache(cfg, batch, max_len, dtype, device)
    if layer_type == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device=None):
    """Empty decode caches for every layer (see the module docstring for
    the layout): K/V in the compute dtype (zeros) with positions -1 (empty)
    over ``min(max_len, window)`` slots, the SSM and RG-LRU states f32 and
    their conv tails in the compute dtype (zeros)."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.compute_dtype)
    pattern = cfg.layer_pattern
    if stacked(cfg):
        one = _one_cache(cfg, pattern[0], batch, max_len, dt, "meta")
        return {name: torch.full((cfg.num_layers,) + tuple(a.shape),
                                 -1 if name == "pos" else 0, dtype=a.dtype,
                                 device=device)
                for name, a in one.items()}
    return [_one_cache(cfg, t, batch, max_len, dt, device) for t in pattern]


def layer_cache(caches, i: int) -> dict:
    """Layer ``i``'s cache: views into a stacked tree, or its list entry."""
    if isinstance(caches, dict):
        return {name: leaf[i] for name, leaf in caches.items()}
    return caches[i]


def cache_leaves(caches):
    """(name, tensor, batch dim) of every leaf of a cache tree."""
    if isinstance(caches, dict):
        return [(name, leaf, 1) for name, leaf in caches.items()]
    return [(name, leaf, 0) for c in caches for name, leaf in c.items()]


def attention_cache_len(caches) -> Optional[int]:
    """The slots of the attention caches (None when no layer attends)."""
    if isinstance(caches, dict):
        return caches["k"].shape[2] if "k" in caches else None
    lens = {c["k"].shape[1] for c in caches if "k" in c}
    if len(lens) > 1:
        raise ValueError(f"attention caches of {sorted(lens)} slots")
    return lens.pop() if lens else None


def check_position(cfg: ModelConfig, caches, position: int) -> None:
    """Raise ``attention.CachePositionError`` unless every attention cache
    has a slot for a decode step at ``position``."""
    s_max = attention_cache_len(caches)
    if s_max is not None:
        attn_mod.check_decode_position(cfg, s_max, position)


def decode_rope(cfg: ModelConfig, position: torch.Tensor, b: int) -> list:
    """The rope tables of a decode step of ``b`` rows at ``position`` (a
    one-element int64 tensor).  Under M-RoPE the text ``t`` coordinate
    continues from the patch grid's end, as ``frontends.patch_grid_mrope``
    numbered the prefill: ``text_mrope_t0(n_patch) + position - n_patch``
    (the reference's)."""
    pos_arr = position.view(1, 1).expand(b, 1)
    mrope = None
    if cfg.rope == "mrope":
        t_coord = pos_arr
        if cfg.frontend == "patch" and cfg.frontend_tokens:
            t_coord = text_mrope_t0(cfg.frontend_tokens) \
                + (pos_arr - cfg.frontend_tokens)
        mrope = t_coord[..., None].expand(b, 1, 3)
    return rope_tables(pos_arr, cfg.resolved_head_dim, cfg.rope_theta,
                       cfg.rope, mrope)


def decode_step(params: dict, tokens_t: Optional[torch.Tensor], caches,
                position, cfg: ModelConfig, *, rows=None,
                embeds_t: Optional[torch.Tensor] = None):
    """One new token for every sequence.

    tokens_t [B, 1] ints (or ``embeds_t`` [B, 1, D], the input already
    embedded); position: the current absolute position, an int
    (checked against the attention caches first: ``CachePositionError``)
    or a one-element int64 tensor on the device.  The caches are written in
    place; with ``rows`` (indices or a bool [B] mask) every row is computed
    as the reference computes it (its new K/V column in place, its new
    state) but only those rows' caches keep what the step wrote.  With
    tensor ``position`` and ``rows`` nothing reads a device value on the
    host, so the step can be captured in a CUDA graph.  The rope tables:
    ``decode_rope``.
    -> (logits [B, 1, V_pad] f32, caches)
    """
    check_supported(cfg)
    lead = embeds_t if embeds_t is not None else tokens_t
    b, dev = lead.shape[0], lead.device
    if not isinstance(position, torch.Tensor):
        check_position(cfg, caches, int(position))
        position = torch.full((1,), int(position), dtype=torch.int64,
                              device=dev)
    rope = decode_rope(cfg, position, b)
    rows = attn_mod.row_mask(rows, b, dev)
    dt = torch_dtype(cfg.compute_dtype)
    x = embeds_t.to(dt) if embeds_t is not None \
        else params["embed"][tokens_t.long()].to(dt)
    for i, (lp, layer_type) in enumerate(zip(params["layers"],
                                             cfg.layer_pattern)):
        x, _, _ = _apply_block(lp, x, None, cfg, layer_type, mode="decode",
                               cache=layer_cache(caches, i),
                               decode_pos=position, rows=rows, rope=rope)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, x, cfg), caches


__all__ = ["PORTED", "AUX_KEYS", "check_supported", "stacked", "init_params",
           "abstract_params", "tree_size_from_param_count",
           "remat_groups", "forward", "init_caches", "layer_cache",
           "cache_leaves", "attention_cache_len", "check_position",
           "decode_rope", "decode_step"]
