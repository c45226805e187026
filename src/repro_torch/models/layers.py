"""Shared primitives: RMSNorm, rotary variants (RoPE / 2-D partial RoPE /
M-RoPE), causal depthwise conv, initializers (port of
``repro/models/layers.py``).

All functions are plain functions on tensors; parameters are dicts of
tensors.  Initializers draw from an explicit ``torch.Generator`` on the
tensor's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# the uniform interval whose inverse normal CDF is the [-2, 2] truncation
_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))
_TRUNC_HI = math.erf(2.0 / math.sqrt(2.0))


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale / sqrt(fan_in)`` times a standard normal truncated to
    [-2, 2] (fan_in = ``shape[0]`` for matrices), drawn in f32 by inverse
    CDF and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / max(fan_in, 1) ** 0.5
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(_TRUNC_LO, _TRUNC_HI, generator=gen)
    x = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.normal_(generator=gen).to(dtype) * 0.02


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, scaled by ``1 + scale`` (the scales are
    zero-centred), cast back to ``x``'s dtype."""
    y = F.rms_norm(_as(x, torch.float32), (x.shape[-1],), eps=eps)
    y = torch.addcmul(y, y, _as(scale, torch.float32))   # y * (1 + scale)
    return _as(y, x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (three variants from the assigned archs)
# ---------------------------------------------------------------------------

def _rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0, variant: str = "rope",
                mrope_positions: Optional[torch.Tensor] = None) -> list:
    """The rotation of each rotary section, computed once for every layer
    of a step: ``[(offset, dim, cos, sin)]`` with ``cos`` = [cos, cos] and
    ``sin`` = [-sin, sin] over the section's split halves, each
    [B, S, 1, dim] f32.  Dims past the sections pass unrotated.

    positions: [B, S] int absolute positions.
    variant:
      "rope"   - standard full-dim rotary.
      "rope2d" - ChatGLM-style: rotary on the first half of head_dim only.
      "mrope"  - Qwen2-VL multimodal rotary: head_dim split into 3 sections
                 (t, h, w) each rotated by its own position stream
                 (``mrope_positions`` [B, S, 3]; text degenerates to t=h=w).
      "none"   - no section.
    """
    if variant == "none":
        return []
    if variant == "rope":
        streams = [(0, head_dim, positions)]
    elif variant == "rope2d":
        streams = [(0, head_dim // 2, positions)]
    elif variant == "mrope":
        if mrope_positions is None:
            mrope_positions = positions[..., None].expand(
                *positions.shape, 3)
        # 3 sections [t, h, w] summing to head_dim (t takes the remainder:
        # hd=128 -> 64/32/32, Qwen2-VL's 2:1:1 split)
        dh = head_dim // 4
        dims = (head_dim - 2 * dh, dh, dh)
        offs = (0, dims[0], dims[0] + dh)
        streams = [(offs[i], dims[i], mrope_positions[..., i])
                   for i in range(3)]
    else:
        raise ValueError(f"unknown rope variant {variant!r}")
    out = []
    for off, dim, pos in streams:
        freqs = _rope_freqs(dim, theta, pos.device)             # [dim/2]
        ang = pos.to(torch.float32)[..., None, None] * freqs    # [B,S,1,d/2]
        sin, cos = torch.sin(ang), torch.cos(ang)
        out.append((off, dim, torch.cat([cos, cos], -1),
                    torch.cat([-sin, sin], -1)))
    return out


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin),
    in f32, cast back to ``x``'s dtype."""
    x32 = _as(x, torch.float32)
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    return _as(torch.addcmul(x32 * cos, torch.cat([x2, x1], -1), sin),
               x.dtype)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               head_dim: int, theta: float = 10_000.0,
               variant: str = "rope",
               mrope_positions: Optional[torch.Tensor] = None,
               tables: Optional[list] = None):
    """Apply a rotary variant (see :func:`rope_tables`) to q [B, S, H, hd]
    and k [B, S, KV, hd]; ``tables`` from ``rope_tables`` spares computing
    the angles again.  Rotation in f32, cast back to the input dtype."""
    if tables is None:
        tables = rope_tables(positions, head_dim, theta, variant,
                             mrope_positions)
    if not tables:
        return q, k

    def rot(x):
        if len(tables) == 1 and tables[0][1] == head_dim:
            return _rotate(x, tables[0][2], tables[0][3])
        parts, end = [], 0
        for off, dim, cos, sin in tables:
            parts.append(_rotate(x[..., off:off + dim], cos, sin))
            end = off + dim
        if end < head_dim:
            parts.append(x[..., end:])
        return torch.cat(parts, -1)

    return rot(q), rot(k)


# ---------------------------------------------------------------------------
# causal depthwise 1-D convolution (Mamba2 / RG-LRU front convs)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], w [K, C] depthwise taps; causal (pads K-1 on the left)."""
    k = w.shape[0]
    pads = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):                       # K is 4: unrolled taps
        out = out + pads[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out


def causal_conv1d_update(x_t: torch.Tensor, conv_state: torch.Tensor,
                         w: torch.Tensor):
    """Single-step conv for decode.  x_t [B, C]; conv_state [B, K-1, C]
    -> (y [B, C], new conv_state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # [B, K, C]
    y = torch.sum(window * w[None, :, :], dim=1)
    return y, window[:, 1:, :]


__all__ = ["truncated_normal_init", "embed_init", "rms_norm", "rope_tables",
           "apply_rope",
           "causal_conv1d", "causal_conv1d_update"]
