"""The LM backbone: init / forward / prefill / decode (port of
``repro/models/lm.py``) for stacks where every layer is attention and there
are no experts (``family == "dense"``, ``frontend == "none"``).

Structure per layer (pre-norm residual):

  x += attn(rms(x));  x += ffn(rms(x))

Parameters are a dict of tensors with ``params["layers"]`` a list of one
dict per layer (the reference stacks them ``[L, ...]`` for ``lax.scan``;
``repro_torch.convert.lm_params_from_reference`` unstacks them).  Decode
caches are stacked, ``{"k", "v": [L, B, S, KV, hd], "pos": [L, B, S]}``,
allocated once and written in place by ``decode_step``.

Other families raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import check_frontend, embed_inputs
from repro_torch.models.layers import (embed_init, rms_norm, rope_tables,
                                       truncated_normal_init)
from repro_torch.models.mlp import init_mlp, mlp_forward

# families not ported yet, by their ROADMAP.md section 1 item
_LATER = {"moe": "8c", "ssm": "8d", "hybrid": "8d", "vlm": "8e",
          "audio": "8e"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense decoder with
    the token frontend, the one path ported so far."""
    item = _LATER.get(cfg.family)
    if item is None and cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: unknown family "
                                  f"{cfg.family!r}")
    if item is None and (cfg.moe or cfg.ssm or cfg.rglru):
        item = "8c" if cfg.moe else "8d"
    if item is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md section 1, item {item})")
    check_frontend(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, device) -> dict:
    dt = torch_dtype(cfg.param_dtype)
    return {"ln1": torch.zeros((cfg.d_model,), dtype=dt, device=device),
            "mixer": attn_mod.init_attention(gen, cfg, device),
            "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=device),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)}


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                generator: Optional[torch.Generator] = None) -> dict:
    """Random weights on ``device`` (``None``: the card), drawn from
    ``generator`` (default: a generator on the device seeded with
    ``seed``).  The embedding is [padded_vocab, D]; an untied head
    [D, padded_vocab]."""
    check_supported(cfg)
    device = resolve_device(device)
    if device.type == "meta":
        return abstract_params(cfg)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    dt = torch_dtype(cfg.param_dtype)
    params: dict = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt,
                            device)}
    params["layers"] = [_init_layer(gen, cfg, device)
                        for _ in range(cfg.num_layers)]
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                       device=device)
    if not cfg.tie_embeddings:
        params["head"] = truncated_normal_init(
            gen, (cfg.d_model, cfg.padded_vocab), 1.0, dt, device)
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes on the ``meta`` device (no
    allocation)."""
    check_supported(cfg)
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    dt = torch_dtype(cfg.param_dtype)

    def t(*shape):
        return torch.empty(shape, dtype=dt, device="meta")

    mixer = {"wq": t(d, h * hd), "wk": t(d, kv * hd), "wv": t(d, kv * hd),
             "wo": t(h * hd, d)}
    if cfg.attn_bias:
        mixer.update(bq=t(h * hd), bk=t(kv * hd), bv=t(kv * hd))
    if cfg.qk_norm:
        mixer.update(q_norm=t(hd), k_norm=t(hd))

    def layer():
        return {"ln1": t(d), "mixer": {n: t(*a.shape)
                                       for n, a in mixer.items()},
                "ln2": t(d), "ffn": {"w_gate": t(d, cfg.d_ff),
                                     "w_up": t(d, cfg.d_ff),
                                     "w_down": t(cfg.d_ff, d)}}

    params = {"embed": t(cfg.padded_vocab, d),
              "layers": [layer() for _ in range(cfg.num_layers)],
              "final_norm": t(d)}
    if not cfg.tie_embeddings:
        params["head"] = t(d, cfg.padded_vocab)
    return params


def tree_size_from_param_count(cfg: ModelConfig) -> int:
    """The element count of the parameter tree, from the analytic
    ``cfg.param_count()``: plus the vocabulary padding rows of the embedding
    (and of an untied head), the q/k norm scales and the qkv biases, which
    the analytic count leaves out, less the one d_model vector a layer that
    it adds beyond the two norm scales a layer has."""
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    heads = 1 if cfg.tie_embeddings else 2
    size = cfg.param_count() + heads * (cfg.padded_vocab - cfg.vocab_size) * d
    if cfg.qk_norm:
        size += n * 2 * hd
    if cfg.attn_bias:
        size += n * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    return size - n * d


def param_tensors(params: dict):
    """Every tensor of a parameter tree, in a fixed order."""
    if isinstance(params, torch.Tensor):
        yield params
    elif isinstance(params, dict):
        for key in sorted(params):
            yield from param_tensors(params[key])
    else:
        for item in params:
            yield from param_tensors(item)


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def _apply_block(layer_params, x, positions, cfg: ModelConfig, *, mode: str,
                 cache=None, attn_impl: str = "auto", chunk: int = 512,
                 decode_pos=None, cache_len=None, rows=None, rope=None):
    """Returns (x, new_cache)."""
    h = rms_norm(x, layer_params["ln1"], cfg.norm_eps)
    if mode == "decode":
        y, new_cache = attn_mod.attention_decode(
            layer_params["mixer"], h, cache, decode_pos, cfg, rows=rows,
            rope=rope)
    else:
        y, new_cache = attn_mod.attention_forward(
            layer_params["mixer"], h, positions, cfg, impl=attn_impl,
            chunk=chunk, return_cache=(mode == "prefill"),
            cache_len=cache_len, rope=rope)
    x = x + y
    h = rms_norm(x, layer_params["ln2"], cfg.norm_eps)
    x = x + mlp_forward(layer_params["ffn"], h)
    return x, new_cache


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------

def forward(params: dict, batch: dict, cfg: ModelConfig, *,
            mode: str = "train", attn_impl: str = "auto", chunk: int = 512,
            cache_len: Optional[int] = None):
    """-> (logits [B, S, V_pad] f32, caches|None, aux dict).

    ``batch["tokens"]`` [B, S] ints.  ``cache_len``: KV-cache capacity when
    mode == 'prefill' (defaults to the prefill length; pass the decode
    horizon to pre-allocate room).  ``aux`` is empty: a dense stack has no
    router losses."""
    assert mode in ("train", "prefill")
    check_supported(cfg)
    x, positions, _ = embed_inputs(params, batch, cfg, params["embed"])
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta,
                       cfg.rope)
    caches = []
    for lp in params["layers"]:
        x, new_cache = _apply_block(lp, x, positions, cfg, mode=mode,
                                    attn_impl=attn_impl, chunk=chunk,
                                    cache_len=cache_len, rope=rope)
        caches.append(new_cache)
    if mode == "prefill":
        caches = {name: torch.stack([c[name] for c in caches])
                  for name in ("k", "v", "pos")}
    else:
        caches = None
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, x, cfg), caches, {}


def _head(params, x, cfg: ModelConfig):
    """Logits in f32 over the padded vocabulary: the matmul in the compute
    dtype (tied: the embedding's transpose), then cast."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ w).to(torch.float32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device=None) -> dict:
    """Decode caches for every layer, stacked: k/v [L, B, max_len, KV, hd]
    in the compute dtype (zeros), pos [L, B, max_len] int32 (-1: empty)."""
    check_supported(cfg)
    one = attn_mod.init_cache(cfg, batch, max_len, torch.float32,
                              device="meta")
    device = resolve_device(device)
    dt = torch_dtype(cfg.compute_dtype)
    lead = (cfg.num_layers,)
    return {"k": torch.zeros(lead + tuple(one["k"].shape), dtype=dt,
                             device=device),
            "v": torch.zeros(lead + tuple(one["v"].shape), dtype=dt,
                             device=device),
            "pos": torch.full(lead + tuple(one["pos"].shape), -1,
                              dtype=torch.int32, device=device)}


def decode_step(params: dict, tokens_t: torch.Tensor, caches: dict,
                position, cfg: ModelConfig, *, rows=None):
    """One new token for every sequence.

    tokens_t [B, 1] ints; position: the current absolute position, an int
    or a one-element int64 tensor on the device.  The caches are written in
    place (only batch rows ``rows`` when given: indices or a bool [B]
    mask).  With tensor ``position`` and ``rows`` nothing reads a device
    value on the host, so the step can be captured in a CUDA graph.
    -> (logits [B, 1, V_pad] f32, caches)
    """
    check_supported(cfg)
    b = tokens_t.shape[0]
    dev = tokens_t.device
    if not isinstance(position, torch.Tensor):
        s_max = caches["k"].shape[2]
        if cfg.sliding_window is None and not 0 <= int(position) < s_max:
            raise IndexError(f"decode position {position} outside a cache "
                             f"of {s_max}")
        position = torch.full((1,), int(position), dtype=torch.int64,
                              device=dev)
    rope = rope_tables(position.view(1, 1).expand(b, 1),
                       cfg.resolved_head_dim, cfg.rope_theta, cfg.rope)
    rows = attn_mod.row_mask(rows, b, dev)
    x = params["embed"][tokens_t.long()].to(torch_dtype(cfg.compute_dtype))
    for i, lp in enumerate(params["layers"]):
        layer_cache = {name: caches[name][i] for name in ("k", "v", "pos")}
        x, _ = _apply_block(lp, x, None, cfg, mode="decode",
                            cache=layer_cache, decode_pos=position, rows=rows,
                            rope=rope)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, x, cfg), caches


__all__ = ["check_supported", "init_params", "abstract_params",
           "tree_size_from_param_count", "param_tensors", "forward", "init_caches", "decode_step"]
