"""RG-LRU recurrent block (RecurrentGemma / Griffin; port of
``repro/models/rglru.py``).

    r_t = sigmoid(w_a * u_t + b_a)            (recurrence gate, per-channel)
    i_t = sigmoid(w_x * u_t + b_x)            (input gate, per-channel)
    log a_t = -c * softplus(lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The block wraps the LRU with the Griffin recurrent-block plumbing: two input
branches (x branch -> causal conv -> LRU; gate branch -> tanh-approximated
GeLU, ``jax.nn.gelu``'s default), merged multiplicatively, then an output
projection.  Gates are per-channel (diagonal).

Prefill scans the recurrence in log2(S) doubling steps over the sequence
(Hillis-Steele over the associative combine (a1, b1) o (a2, b2) =
(a1 a2, a2 b1 + b2)), where the reference calls ``lax.associative_scan``.
Not the cumprod/cumsum closed form: log a_t reaches about -8 softplus(2) ~
-17 a step, so a running product underflows f32 within a few steps and the
division by it blows up.  Decode is the O(1) single-step update, written
into the cache in place (with ``rows``, every row computed, only those
committed).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.attention import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_update,
                                       truncated_normal_init)
from repro_torch.models.ssm import commit


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d = cfg.d_model
    w = _width(cfg)
    dt = torch_dtype(cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_x_branch": truncated_normal_init(gen, (d, w), 1.0, dt, device),
        "w_gate_branch": truncated_normal_init(gen, (d, w), 1.0, dt, device),
        "conv_w": truncated_normal_init(gen, (cfg.rglru.conv_width, w), 1.0,
                                        dt, device),
        # LRU gate parameters (diagonal)
        "w_a": torch.zeros((w,), **f32),
        "b_a": torch.zeros((w,), **f32),
        "w_i": torch.zeros((w,), **f32),
        "b_i": torch.zeros((w,), **f32),
        "lam": torch.linspace(0.5, 2.0, w, **f32),
        "w_out": truncated_normal_init(gen, (w, d), 1.0, dt, device),
    }


def _lru_coeffs(params, u, c_exp: float):
    """u [..., W] -> (log_a, b) of the linear recurrence, in f32."""
    uf = u.to(torch.float32)
    r = torch.sigmoid(params["w_a"] * uf + params["b_a"])
    i = torch.sigmoid(params["w_i"] * uf + params["b_i"])
    log_a = -c_exp * F.softplus(params["lam"]) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * uf)
    return log_a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, every t, in
    ceil(log2 S) doubling steps."""
    off, s = 1, a.shape[1]
    while off < s:
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:],
                                                 b[:, :-off])], dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  return_state: bool = False):
    """x [B, S, D] -> (y [B, S, D], the decode cache or None)."""
    cw = cfg.rglru.conv_width
    u = x @ params["w_x_branch"]                       # [B, S, W]
    gate = F.gelu(x @ params["w_gate_branch"], approximate="tanh")
    u_conv = causal_conv1d(u, params["conv_w"])

    log_a, b = _lru_coeffs(params, u_conv, cfg.rglru.c_exponent)
    h = linear_scan(torch.exp(log_a), b)
    y = (h.to(x.dtype) * gate) @ params["w_out"]

    if not return_state:
        return y, None
    conv_tail = u[:, -(cw - 1):, :]
    if conv_tail.shape[1] < cw - 1:
        conv_tail = F.pad(conv_tail, (0, 0, cw - 1 - conv_tail.shape[1], 0))
    return y, {"h": h[:, -1, :].contiguous(),
               "conv": conv_tail.contiguous()}


def rglru_step(params: dict, u: torch.Tensor, h: torch.Tensor,
               c_exp: float) -> torch.Tensor:
    """The recurrence's step on a block of channels: the conv's output
    ``u`` [B, W], the state ``h`` [B, W] f32 (not changed) and the
    channels' gates (``w_a``, ``b_a``, ``w_i``, ``b_i``, ``lam`` [W] in
    ``params``) -> the new state."""
    log_a, b = _lru_coeffs(params, u, c_exp)
    return torch.exp(log_a) * h + b


def rglru_decode(params: dict, x_t: torch.Tensor, cache: dict,
                 cfg: ModelConfig, *, rows: Optional[torch.Tensor] = None):
    """x_t [B, 1, D]; cache {h [B, W] f32, conv [B, K-1, W]}, written in
    place (only the rows of the bool [B] mask ``rows`` when given)."""
    u = x_t[:, 0, :] @ params["w_x_branch"]
    gate = F.gelu(x_t[:, 0, :] @ params["w_gate_branch"], approximate="tanh")
    u_conv, conv_state = causal_conv1d_update(u, cache["conv"],
                                              params["conv_w"])
    h = rglru_step(params, u_conv, cache["h"], cfg.rglru.c_exponent)
    y = ((h.to(x_t.dtype) * gate) @ params["w_out"])[:, None, :]
    commit(cache["h"], h, rows)
    commit(cache["conv"], conv_state, rows)
    return y, cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> dict:
    w = _width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                            dtype=dtype, device=device),
    }


__all__ = ["init_rglru", "linear_scan", "rglru_forward", "rglru_step",
           "rglru_decode", "init_rglru_cache"]
