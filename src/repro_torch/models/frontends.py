"""Input embedding (port of ``repro/models/frontends.py``): the token
embedding of ``frontend == "none"``.  The ``patch`` and ``frame`` stub
frontends are not ported yet (ROADMAP.md section 1, item 8e)."""

from __future__ import annotations

import torch

from repro_torch.models.attention import torch_dtype
from repro_torch.models.config import ModelConfig


def check_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported yet "
            f"(ROADMAP.md section 1, item 8e)")


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig, embed_table
                 ) -> tuple[torch.Tensor, torch.Tensor, None]:
    """-> (x [B, S, D], positions [B, S] int32, mrope_positions None)."""
    check_frontend(cfg)
    tokens = batch["tokens"]
    x = embed_table[tokens.long()].to(torch_dtype(cfg.compute_dtype))
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, pos, None


__all__ = ["check_frontend", "embed_inputs"]
