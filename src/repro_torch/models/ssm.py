"""Mamba-2 mixer via the SSD (state-space duality) chunked algorithm (port
of ``repro/models/ssm.py``).

Per head h with state size N and head dim P, the SSM recurrence is

    h_t = a_t * h_{t-1} + dt_t * (x_t outer B_t)        h in R^{P x N}
    y_t = h_t C_t + D * x_t

with a_t = exp(dt_t * A) in (0, 1) (A = -exp(A_log) < 0).  SSD splits the
sequence into chunks of Q tokens (the reference's rule: halve the
configured chunk until it divides S): the intra-chunk part is a masked
Q x Q "attention" G[t, s] = (C_t . B_s) * exp(cumlog_a_t - cumlog_a_s), the
triangle masked before the exp (the upper one has positive exponents), and
the inter-chunk part carries the f32 [P, N] state across chunks.  All of it
runs in f32, as in the reference.  B and C are shared across heads
(n_groups = 1).

Decode is the O(1) recurrence on the carried state.  ``ssm_decode`` writes
the new state into the cache in place, and with ``rows`` it computes every
row's new state but commits only those rows', as
``attention.attention_decode`` does for its K/V column.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.attention import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_update,
                                       rms_norm, truncated_normal_init)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return s, d_inner, n_heads


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    s, d_inner, n_heads = _dims(cfg)
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    conv_ch = d_inner + 2 * s.state_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": truncated_normal_init(
            gen, (d, 2 * d_inner + 2 * s.state_dim + n_heads), 1.0, dt,
            device),
        "conv_w": truncated_normal_init(gen, (s.conv_width, conv_ch), 1.0,
                                        dt, device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "d_skip": torch.ones((n_heads,), **f32),
        "norm": torch.zeros((d_inner,), dtype=dt, device=device),
        "w_out": truncated_normal_init(gen, (d_inner, d), 1.0, dt, device),
    }


def _split_proj(params, u, cfg: ModelConfig):
    s, d_inner, n_heads = _dims(cfg)
    proj = u @ params["w_in"]
    return torch.split(proj, [d_inner, d_inner, 2 * s.state_dim, n_heads],
                       dim=-1)


def chunk_len(seq: int, chunk: int) -> int:
    """The SSD chunk: the configured one (at most S), halved until it
    divides S."""
    q = min(chunk, seq)
    while seq % q:
        q //= 2
    return q


def ssm_forward(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
                return_state: bool = False):
    """u [B, S, D] -> (y [B, S, D], the final decode cache or None)."""
    s_cfg, d_inner, n_heads = _dims(cfg)
    b, seq, _ = u.shape
    p_dim, n_dim = s_cfg.head_dim, s_cfg.state_dim
    q = chunk_len(seq, s_cfg.chunk)
    nc = seq // q
    f32 = torch.float32

    z, x, bc, dt_raw = _split_proj(params, u, cfg)
    conv_in = torch.cat([x, bc], dim=-1)
    conv_out = F.silu(causal_conv1d(conv_in, params["conv_w"]))
    x, bmat, cmat = torch.split(conv_out, [d_inner, n_dim, n_dim], dim=-1)

    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])                     # [H] negative
    log_a = dt * a[None, None, :]                       # [B, S, H]

    xh = x.reshape(b, nc, q, n_heads, p_dim).to(f32)
    bm = bmat.reshape(b, nc, q, n_dim).to(f32)
    cm = cmat.reshape(b, nc, q, n_dim).to(f32)
    la = log_a.reshape(b, nc, q, n_heads)
    dtc = dt.reshape(b, nc, q, n_heads)

    # cumulative log-decay within each chunk (inclusive)
    cla = torch.cumsum(la, dim=2)                       # [B,nc,Q,H]

    # ---- intra-chunk: masked QxQ "attention" per head ----
    cb = torch.einsum("bcqn,bcsn->bcqs", cm, bm)        # [B,nc,Q,Q]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))
    log_decay = cla[:, :, :, None, :] - cla[:, :, None, :, :]
    # mask BEFORE exp: the upper triangle has positive exponents (overflow)
    decay = torch.exp(log_decay.masked_fill_(~tri[None, None, :, :, None],
                                             float("-inf")))
    # out of place: exp's backward reads its output
    g = decay * cb[..., None]                           # [B,nc,Q,Q,H]
    dtx = xh * dtc[..., None]                           # [B,nc,Q,H,P]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", g, dtx)
    del g, decay, log_decay

    # ---- inter-chunk: carry the [H, P, N] state across chunks ----
    chunk_decay = torch.exp(cla[:, :, -1:, :] - cla)    # [B,nc,Q,H]
    state_in = torch.einsum("bcqhp,bcqn->bchpn", dtx * chunk_decay[..., None],
                            bm)
    total_decay = torch.exp(cla[:, :, -1, :])           # [B,nc,H]
    h = torch.zeros((b, n_heads, p_dim, n_dim), dtype=f32, device=u.device)
    h_before = []
    for ci in range(nc):
        h_before.append(h)                              # state BEFORE chunk
        h = h * total_decay[:, ci, :, None, None] + state_in[:, ci]
    h_before = torch.stack(h_before, dim=1)             # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cm, h_before) \
        * torch.exp(cla)[..., None]
    y = (y_intra + y_inter).reshape(b, seq, d_inner)
    y = y + x.to(f32) * torch.repeat_interleave(params["d_skip"],
                                                p_dim)[None, None, :]
    y = y * F.silu(z.to(f32))
    y = rms_norm(y.to(u.dtype), params["norm"], cfg.norm_eps)
    out = y @ params["w_out"]

    if not return_state:
        return out, None
    k1 = s_cfg.conv_width - 1
    conv_tail = conv_in[:, -k1:, :]
    if conv_tail.shape[1] < k1:
        conv_tail = F.pad(conv_tail, (0, 0, k1 - conv_tail.shape[1], 0))
    return out, {"h": h, "conv": conv_tail.contiguous()}


def commit(buf: torch.Tensor, new: torch.Tensor,
           rows: Optional[torch.Tensor]) -> None:
    """``buf[:] = new`` in place, for the batch rows (dim 0) of the bool
    mask ``rows`` only when given."""
    new = new.to(buf.dtype)
    if rows is None:
        buf.copy_(new)
    else:
        torch.where(rows.view(-1, *([1] * (buf.dim() - 1))), new, buf,
                    out=buf)


def ssm_step(xh: torch.Tensor, dt_raw: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, h: torch.Tensor, params: dict):
    """The recurrence's step on a block of heads: ``xh`` [B, H, P] f32,
    ``dt_raw`` [B, H], ``bm`` / ``cm`` [B, N], the state ``h`` [B, H, P, N]
    f32 (not changed) and the heads' ``dt_bias``, ``a_log`` and ``d_skip``
    [H] in ``params`` -> (y [B, H, P] f32 with the skip, the new
    state)."""
    f32 = torch.float32
    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a[None, :])                  # [B, H]
    dbx = (xh * dt[..., None])[..., None] * bm.to(f32)[:, None, None, :]
    st = dbx.addcmul_(h, decay[..., None, None])
    y = torch.einsum("bn,bhpn->bhp", cm.to(f32), st)
    return y + xh * params["d_skip"][None, :, None], st


def ssm_decode(params: dict, u_t: torch.Tensor, cache: dict,
               cfg: ModelConfig, *, rows: Optional[torch.Tensor] = None):
    """One token: u_t [B, 1, D]; cache {h [B,H,P,N] f32, conv [B,K-1,C]},
    written in place (only the rows of the bool [B] mask ``rows`` when
    given).  Returns (y [B, 1, D], cache)."""
    s_cfg, d_inner, n_heads = _dims(cfg)
    b = u_t.shape[0]
    p_dim, n_dim = s_cfg.head_dim, s_cfg.state_dim
    f32 = torch.float32

    z, x, bc, dt_raw = _split_proj(params, u_t[:, 0, :], cfg)
    conv_in = torch.cat([x, bc], dim=-1)
    conv_out, conv_state = causal_conv1d_update(conv_in, cache["conv"],
                                                params["conv_w"])
    conv_out = F.silu(conv_out)
    x, bm, cm = torch.split(conv_out, [d_inner, n_dim, n_dim], dim=-1)

    xh = x.reshape(b, n_heads, p_dim).to(f32)
    y, h = ssm_step(xh, dt_raw, bm, cm, cache["h"], params)
    y = y.reshape(b, d_inner) * F.silu(z.to(f32))
    y = rms_norm(y.to(u_t.dtype), params["norm"], cfg.norm_eps)
    out = (y @ params["w_out"])[:, None, :]
    commit(cache["h"], h, rows)
    commit(cache["conv"], conv_state, rows)
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    s_cfg, d_inner, n_heads = _dims(cfg)
    return {
        "h": torch.zeros((batch, n_heads, s_cfg.head_dim, s_cfg.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s_cfg.conv_width - 1,
                             d_inner + 2 * s_cfg.state_dim), dtype=dtype,
                            device=device),
    }


__all__ = ["init_ssm", "chunk_len", "ssm_forward", "commit", "ssm_step",
           "ssm_decode", "init_ssm_cache"]
