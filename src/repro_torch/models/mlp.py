"""Gated-linear-unit FFN (SwiGLU family), the dense archs' MLP (port of
``repro/models/mlp.py``).  Weights are stored [d_in, d_out] and applied as
``x @ W``, as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import truncated_normal_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device=None) -> dict:
    return {
        "w_gate": truncated_normal_init(gen, (d_model, d_ff), 1.0, dtype,
                                        device),
        "w_up": truncated_normal_init(gen, (d_model, d_ff), 1.0, dtype,
                                      device),
        "w_down": truncated_normal_init(gen, (d_ff, d_model), 1.0, dtype,
                                        device),
    }


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    up = x @ params["w_up"]
    return (gate * up) @ params["w_down"]


__all__ = ["init_mlp", "mlp_forward"]
