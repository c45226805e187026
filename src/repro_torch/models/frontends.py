"""Modality frontends (port of ``repro/models/frontends.py``).

The [vlm] and [audio] archs specify the transformer backbone only; the
modality encoder is replaced by *precomputed* embeddings in the batch:

  patch  (qwen2-vl):  batch["patches"] [B, n_patch, frontend_dim] are
         precomputed vision-patch embeddings, linearly projected and
         prepended to the text-token embeddings; M-RoPE gets a (t, h, w)
         position triple per slot (grid positions for patches, running t
         for text).
  frame  (hubert):    batch["frames"] [B, S, frontend_dim] are precomputed
         acoustic frame features, linearly projected; encoder-only, no
         token embedding at all.
  none:               the token embedding alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import truncated_normal_init


def init_frontend(gen: torch.Generator, cfg: ModelConfig,
                  device=None) -> dict:
    """``{"proj": [frontend_dim, d_model]}`` (empty for ``none``)."""
    if cfg.frontend == "none":
        return {}
    return {"proj": truncated_normal_init(
        gen, (cfg.frontend_dim, cfg.d_model), 1.0,
        torch_dtype(cfg.param_dtype), device)}


def _side(n_patch: int) -> int:
    return max(int(n_patch ** 0.5), 1)


def patch_grid_mrope(n_patch: int, text_len: int, batch: int,
                     device=None) -> torch.Tensor:
    """M-RoPE position triples: patches on an h x w grid at t = 0, text at
    running t after the grid.  [B, n_patch + text_len, 3] int32."""
    side = _side(n_patch)
    idx = torch.arange(n_patch, dtype=torch.int64, device=device)
    patch_pos = torch.stack([torch.zeros_like(idx), idx // side, idx % side],
                            -1)
    tpos = text_mrope_t0(n_patch) + torch.arange(text_len, dtype=torch.int64,
                                                 device=device)
    text_pos = torch.stack([tpos, tpos, tpos], -1)
    pos = torch.cat([patch_pos, text_pos], 0).to(torch.int32)
    return pos[None].expand(batch, n_patch + text_len, 3)


def text_mrope_t0(n_patch: int) -> int:
    """First text ``t`` coordinate after an n_patch grid (matches
    ``patch_grid_mrope``)."""
    return 1 + (n_patch - 1) // _side(n_patch)


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig, embed_table,
                 lookup=None
                 ) -> tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """-> (x [B, S, D], positions [B, S] int32, mrope_positions|None).

    ``lookup(table, tokens)``: the token embedding (default: index the
    table); the sharded step passes its vocab-parallel lookup."""
    dt = torch_dtype(cfg.compute_dtype)
    if cfg.frontend == "frame":
        x = batch["frames"].to(dt) @ params["frontend"]["proj"]
        b, s, _ = x.shape
        return x, _arange_positions(b, s, x.device), None

    tokens = batch["tokens"]
    tok_x = (embed_table[tokens.long()] if lookup is None
             else lookup(embed_table, tokens)).to(dt)
    if cfg.frontend == "patch":
        px = batch["patches"].to(dt) @ params["frontend"]["proj"]
        x = torch.cat([px, tok_x], dim=1)
        b, s, _ = x.shape
        mrope = batch.get("mrope_positions")
        if mrope is None and cfg.rope == "mrope":
            mrope = patch_grid_mrope(px.shape[1], tok_x.shape[1], b, x.device)
        return x, _arange_positions(b, s, x.device), mrope

    b, s, _ = tok_x.shape
    return tok_x, _arange_positions(b, s, tok_x.device), None


def _arange_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


__all__ = ["init_frontend", "patch_grid_mrope", "text_mrope_t0",
           "embed_inputs"]
