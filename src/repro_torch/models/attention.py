"""Grouped-query attention in three schedules, and the KV-cache decode step
(port of ``repro/models/attention.py``).

Schedules (selected by ``impl``; all compute the same function):

  masked      baseline: Q chunks x KV chunks with an online softmax; causal
              masking discards the upper triangle *after* computing it.
  triangular  flash-style: only the needed (q_chunk, kv_chunk) blocks
              (i >= j), in the reference's order (j-major within i).
  banded      sliding-window attention: band offsets only, O(S * W).

All use the online-softmax accumulator (running max / denominator) in f32,
so no S x S tensor is materialized; per step one [B, KV, G, C, C] logits
block is live.  GQA is computed in grouped layout [B, S, KV, G, hd]
(G = H // KV), so K/V are never repeated in memory.

Plain torch, as the reference is plain jnp: no kernel stands behind
attention.  Two differences from the reference, neither of which changes
the function computed:

* A sequence longer than ``chunk`` and not a multiple of it is padded to
  one with positions -1 (masked like any invalid slot), where the reference
  halves the chunk until it divides S (a prime S would take chunks of 1).
* ``attention_decode`` writes the new K/V column into the cache in place,
  where the reference returns a new cache.  With ``rows`` every row still
  attends with its new column in place, as the reference's step computes
  every row before its server keeps one slot's; afterwards the old column
  is put back for the rows outside ``rows``.  So a continuous-batching
  server runs the whole batch at one slot group's position without
  touching the other slots' caches, and rows that are coupled (an MoE
  layer's capacity) see what they see in the reference.

A decode position past a cache that is not a ring raises
``CachePositionError`` (an ``IndexError``) before anything is written.  A
windowed cache is a ring only when it holds the whole window; a prefill
shorter than the window keeps a shorter cache, and there the reference
clamps its write to the last slot.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, rms_norm,
                                       truncated_normal_init)

NEG_INF = -1e30


class CachePositionError(IndexError):
    """A decode position that the cache has no slot for: past the end of a
    cache that is not a ring buffer, or negative."""


def is_ring(cfg: ModelConfig, s_max: int) -> bool:
    """A local-attention cache of ``s_max`` slots is a ring buffer (position
    p in slot p % window) when it holds the whole window."""
    return cfg.sliding_window is not None and cfg.sliding_window <= s_max


def check_decode_position(cfg: ModelConfig, s_max: int,
                          position: int) -> None:
    """Raise ``CachePositionError`` unless a decode step at ``position`` has
    a slot in a cache of ``s_max``."""
    if position < 0 or (not is_ring(cfg, s_max) and position >= s_max):
        window = ("" if cfg.sliding_window is None else
                  f" (window {cfg.sliding_window}: not a ring buffer, whose "
                  f"cache must hold the whole window)")
        raise CachePositionError(f"decode position {position} outside a "
                                 f"cache of {s_max}{window}")


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "wq": truncated_normal_init(gen, (d, h * hd), 1.0, dt, device),
        "wk": truncated_normal_init(gen, (d, kv * hd), 1.0, dt, device),
        "wv": truncated_normal_init(gen, (d, kv * hd), 1.0, dt, device),
        "wo": truncated_normal_init(gen, (h * hd, d), 1.0, dt, device),
    }
    if cfg.attn_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd),
                            ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=device)
    return p


def _project_qkv(params, x, positions, cfg: ModelConfig,
                 mrope_positions=None, rope=None):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.attn_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q, k = apply_rope(q, k, positions, hd, cfg.rope_theta, cfg.rope,
                      mrope_positions, tables=rope)
    return q, k, v


# ---------------------------------------------------------------------------
# online-softmax block update (shared by all schedules)
# ---------------------------------------------------------------------------

def _block_update(q_blk, k_blk, v_blk, mask, m, l, acc, scale):
    """One (Q-block x KV-block) online-softmax step, in f32.

    q_blk [B,C,KV,G,hd]  k_blk/v_blk [B,C2,KV,hd]  mask [B,1,1,C,C2] bool
    m,l [B,KV,G,C]  acc [B,C,KV,G,hd]
    """
    s = torch.einsum("bqkgh,bskh->bkgqs", q_blk.to(torch.float32),
                     k_blk.to(torch.float32)) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # fully-masked rows: keep m finite so exp() stays 0, not NaN
    m_safe = torch.where(m_new > NEG_INF / 2, m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.where(m > NEG_INF / 2, torch.exp(m - m_safe), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskh->bqkgh", p, v_blk.to(torch.float32))
    acc_new = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def _finalize(m, l, acc):
    l_t = l.permute(0, 3, 1, 2)[..., None]              # [B,C,KV,G,1]
    return torch.where(l_t > 0, acc / torch.clamp(l_t, min=1e-30), 0.0)


def _mask_block(pq_blk, pk_blk, cfg: ModelConfig):
    """[B,1,1,C,C2] mask from absolute positions (causal + window + valid)."""
    dq = pq_blk[:, :, None]                              # [B,C,1]
    dk = pk_blk[:, None, :]                              # [B,1,C2]
    mask = dk >= 0                                       # -1: invalid slot
    if cfg.causal:
        mask = mask & (dk <= dq)
    if cfg.sliding_window is not None:
        mask = mask & (dq - dk < cfg.sliding_window)
    return mask[:, None, None, :, :]


def _init_state(b, kvh, g, c, hd, device):
    m = torch.full((b, kvh, g, c), NEG_INF, dtype=torch.float32,
                   device=device)
    l = torch.zeros((b, kvh, g, c), dtype=torch.float32, device=device)
    acc = torch.zeros((b, c, kvh, g, hd), dtype=torch.float32, device=device)
    return m, l, acc


# ---------------------------------------------------------------------------
# schedule 1: masked (baseline) and schedule 2: triangular
# ---------------------------------------------------------------------------

def _attend_blocks(q, k, v, pos_q, pos_k, cfg: ModelConfig, c: int,
                   triangular: bool):
    """Q chunks x KV chunks of ``c``; ``triangular`` visits only j <= i."""
    b, s, kvh, g, hd = q.shape
    n, nk = s // c, k.shape[1] // c
    scale = hd ** -0.5
    outs = []
    for i in range(n):
        q_blk, pq_blk = q[:, i * c:(i + 1) * c], pos_q[:, i * c:(i + 1) * c]
        m, l, acc = _init_state(b, kvh, g, c, hd, q.device)
        for j in range(i + 1 if triangular else nk):
            sl = slice(j * c, (j + 1) * c)
            mask = _mask_block(pq_blk, pos_k[:, sl], cfg)
            m, l, acc = _block_update(q_blk, k[:, sl], v[:, sl], mask, m, l,
                                      acc, scale)
        outs.append(_finalize(m, l, acc))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# schedule 3: banded (sliding window) -- O(S * W)
# ---------------------------------------------------------------------------

def _attend_banded(q, k, v, pos_q, pos_k, cfg: ModelConfig, c: int):
    b, s, kvh, g, hd = q.shape
    n = s // c
    w = cfg.sliding_window
    nband = min(-(-w // c) + 1, n)          # bands 0..nband-1 behind
    scale = hd ** -0.5
    qc = q.reshape(b, n, c, kvh, g, hd)
    kc = k.reshape(b, n, c, kvh, hd)
    vc = v.reshape(b, n, c, kvh, hd)
    pq = pos_q.reshape(b, n, c)
    pk = pos_k.reshape(b, n, c)
    m, l, acc = _init_state(b * n, kvh, g, c, hd, q.device)
    idx = torch.arange(n, device=q.device)
    for off in range(nband):
        # q chunk i attends kv chunk i - off, vectorized over i via roll;
        # wrapped chunks (i < off) get invalid positions -> fully masked
        k_sh = torch.roll(kc, off, dims=1)
        v_sh = torch.roll(vc, off, dims=1)
        pk_sh = torch.roll(pk, off, dims=1)
        pk_sh = torch.where((idx >= off)[None, :, None], pk_sh, -1)
        mask = _mask_block(pq.reshape(b * n, c), pk_sh.reshape(b * n, c),
                           cfg)
        m, l, acc = _block_update(
            qc.reshape(b * n, c, kvh, g, hd), k_sh.reshape(b * n, c, kvh, hd),
            v_sh.reshape(b * n, c, kvh, hd), mask, m, l, acc, scale)
    out = _finalize(m, l, acc)                          # [B*n,C,KV,G,hd]
    return out.reshape(b, s, kvh, g, hd)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _pad_seq(x: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    """Pad dim 1 of ``x`` by ``pad`` entries of ``value`` at the end."""
    if not pad:
        return x
    widths = [0, 0] * (x.dim() - 2) + [0, pad]
    return F.pad(x, widths, value=value)


def attention_forward(params, x, positions, cfg: ModelConfig, *,
                      impl: str = "auto", chunk: int = 512,
                      mrope_positions=None, return_cache: bool = False,
                      cache_len: Optional[int] = None, rope=None):
    """Full-sequence attention (train / prefill).

    Returns (y, cache|None); cache k/v cover the last ``cache_len`` positions
    (default: the whole sequence, or the window for local attention),
    padded with positions -1 up to ``cache_len``.  ``rope``: the step's
    ``rope_tables``, when the caller computed them once for every layer.
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = h // kvh
    q, k, v = _project_qkv(params, x, positions, cfg, mrope_positions, rope)

    c = min(chunk, s)
    pad = -s % c
    qg = _pad_seq(q.reshape(b, s, kvh, g, hd), pad)
    kp, vp = _pad_seq(k, pad), _pad_seq(v, pad)
    pos = _pad_seq(positions, pad, value=-1)
    if impl == "auto":
        impl = ("banded" if cfg.sliding_window is not None
                and cfg.sliding_window < s else "masked")
    if impl == "banded":
        out = _attend_banded(qg, kp, vp, pos, pos, cfg, c)
    else:
        out = _attend_blocks(qg, kp, vp, pos, pos, cfg, c,
                             triangular=impl == "triangular" and cfg.causal)

    out = out[:, :s].reshape(b, s, h * hd).to(x.dtype)
    y = out @ params["wo"]

    cache = None
    if return_cache:
        if cache_len is None:
            cache_len = (min(cfg.sliding_window, s)
                         if cfg.sliding_window is not None else s)
        kc, vc = k[:, -cache_len:], v[:, -cache_len:]
        pc = positions[:, -cache_len:].to(torch.int32)
        if cache_len > kc.shape[1]:
            extra = cache_len - kc.shape[1]
            kc, vc = _pad_seq(kc, extra), _pad_seq(vc, extra)
            pc = _pad_seq(pc, extra, value=-1)
        if (cfg.sliding_window is not None
                and cache_len == cfg.sliding_window and s >= cache_len):
            # ring-buffer invariant: position p lives in slot p % window
            shift = s % cache_len
            kc = torch.roll(kc, shift, dims=1)
            vc = torch.roll(vc, shift, dims=1)
            pc = torch.roll(pc, shift, dims=1)
        cache = {"k": kc.contiguous(), "v": vc.contiguous(),
                 "pos": pc.contiguous()}
    return y, cache


def _heads_major_f32(x: torch.Tensor) -> torch.Tensor:
    """[B, S, KV, hd] -> contiguous f32 [B, KV, S, hd], in one pass."""
    b, s, kvh, hd = x.shape
    out = torch.empty((b, kvh, s, hd), dtype=torch.float32, device=x.device)
    return out.copy_(x.permute(0, 2, 1, 3))


def row_mask(rows, batch: int, device) -> Optional[torch.Tensor]:
    """``rows`` (None, batch row indices, or a bool [B] tensor) as a bool
    [B] tensor on ``device``; None stays None (every row)."""
    if rows is None or isinstance(rows, torch.Tensor):
        return rows
    mask = torch.zeros(batch, dtype=torch.bool)
    mask[list(rows)] = True
    return mask.to(device)


def _write_column(buf: torch.Tensor, slot: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """``buf[:, slot] = new`` in place (``new`` [B, 1, ...]); returns the
    column it overwrote."""
    old = buf.index_select(1, slot)
    buf.index_copy_(1, slot, new.to(buf.dtype))
    return old


def _keep_rows(buf: torch.Tensor, slot: torch.Tensor, old: torch.Tensor,
               mask: torch.Tensor) -> None:
    """Put column ``slot`` of ``buf`` back to ``old`` for the rows outside
    the bool [B] ``mask``."""
    cur = buf.index_select(1, slot)
    keep = mask.view(-1, *([1] * (cur.dim() - 1)))
    buf.index_copy_(1, slot, torch.where(keep, cur, old))


def decode_attend(qg, k, v, pos_buf, position, cfg: ModelConfig,
                  combine=None) -> torch.Tensor:
    """The decode step's attention over a cache, the new column written:
    ``qg`` [B, KV, G, hd] f32, ``k`` / ``v`` [B, S, KV, hd], ``pos_buf``
    [B, S] -> [B, KV, G, hd] f32.  Scores and values in f32 over every
    slot, masked to the valid positions up to ``position`` (and inside
    the window).  ``combine(op, x)`` ("max" or "sum"), where the cache
    holds one block of the sequence, reduces over the other blocks (a
    split softmax: the max, the sum of exponentials and the weighted
    values); None on one device."""
    logits = torch.matmul(qg, _heads_major_f32(k).transpose(-1, -2))
    logits.mul_(qg.shape[-1] ** -0.5)                     # [B,KV,G,S]
    dk = pos_buf[:, None, None, :]
    mask = (dk >= 0) & (dk <= position)
    if cfg.sliding_window is not None:
        mask = mask & (position - dk < cfg.sliding_window)
    logits = torch.where(mask, logits, NEG_INF)
    if combine is None:
        p = torch.softmax(logits, dim=-1)
        return torch.matmul(p, _heads_major_f32(v))
    peak = combine("max", logits.amax(dim=-1, keepdim=True))
    e = torch.where(mask, torch.exp(logits - peak), 0.0)
    total = combine("sum", e.sum(dim=-1, keepdim=True))
    return combine("sum", torch.matmul(e, _heads_major_f32(v))) / total


def attention_decode(params, x_t, cache, position, cfg: ModelConfig, *,
                     mrope_positions=None, rows=None, rope=None):
    """One decode step.  x_t [B, 1, D]; ``cache`` from ``attention_forward``
    or ``init_cache``, written in place at column ``position`` (the ring
    slot ``position % window`` for local attention), for the batch rows
    ``rows`` only when given (indices or a bool [B] mask).  ``position`` is
    an int (checked: ``CachePositionError``) or a one-element int64 tensor
    on the device (then nothing here reads a device value on the host, so
    the step can be captured in a CUDA graph; the caller keeps it inside
    the cache).  With ``rows`` every row attends with its new column, and
    the rows outside keep their old column afterwards.  Scores and values
    are computed in f32 over the whole cache.  Returns (y [B, 1, D],
    cache).
    """
    b = x_t.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = h // kvh
    k, v, pos_buf = cache["k"], cache["v"], cache["pos"]
    s_max = k.shape[1]
    ring = is_ring(cfg, s_max)
    if not isinstance(position, torch.Tensor):
        position = int(position)
        check_decode_position(cfg, s_max, position)
        position = torch.full((1,), position, dtype=torch.int64,
                              device=x_t.device)
    pos = position.view(1, 1).expand(b, 1)
    q, k_new, v_new = _project_qkv(params, x_t, pos, cfg, mrope_positions,
                                   rope)
    slot = position % cfg.sliding_window if ring else position
    mask_rows = row_mask(rows, b, x_t.device)
    olds = [_write_column(buf, slot, new) for buf, new in
            ((k, k_new), (v, v_new), (pos_buf, pos))]

    out = decode_attend(q.reshape(b, kvh, g, hd).to(torch.float32), k, v,
                        pos_buf, position, cfg)
    out = out.reshape(b, 1, h * hd).to(x_t.dtype)
    y = out @ params["wo"]
    if mask_rows is not None:
        for buf, old in zip((k, v, pos_buf), olds):
            _keep_rows(buf, slot, old, mask_rows)
    return y, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None) -> dict:
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, kvh, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, kvh, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


__all__ = ["NEG_INF", "CachePositionError", "is_ring",
           "check_decode_position", "torch_dtype", "init_attention", "attention_forward",
           "row_mask", "decode_attend", "attention_decode", "init_cache"]
