"""Synthetic, *deterministic* LM data pipeline (port of
``repro/data/pipeline.py``, copied: numpy only, so both packages draw the
same batches bit for bit).

Every batch is a pure function of (seed, step), the property resuming
relies on: a run restarted from a checkpoint that holds k updates consumes
byte-identical batches from step k onward, so the resumed run ends where
the uninterrupted one does.

The token stream is not uniform noise: tokens follow a noisy affine
recurrence t_{i+1} = (a * t_i + b) mod V with probability (1 - noise), so
a model can learn structure and a training run shows a falling loss.

Host sharding: ``host_slice`` carves the global batch into one process's
contiguous slice (by process index).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    mult: int = 31
    offset: int = 17


def batch_at(dc: DataConfig, step: int) -> dict:
    """[global_batch, seq_len] int32 tokens for this step (host-global)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, 0xA5A5]))
    b, s, v = dc.global_batch, dc.seq_len, dc.vocab_size
    toks = np.empty((b, s), np.int64)
    toks[:, 0] = rng.integers(0, v, b)
    noise_mask = rng.random((b, s)) < dc.noise
    noise_vals = rng.integers(0, v, (b, s))
    for i in range(1, s):
        nxt = (dc.mult * toks[:, i - 1] + dc.offset) % v
        toks[:, i] = np.where(noise_mask[:, i], noise_vals[:, i], nxt)
    return {"tokens": toks.astype(np.int32)}


def host_slice(batch: dict, process_index: int, process_count: int) -> dict:
    """This process's contiguous slice of every array's leading dim."""
    def sl(x):
        per = x.shape[0] // process_count
        return x[process_index * per:(process_index + 1) * per]

    return {k: sl(v) for k, v in batch.items()}


def encoder_batch_at(dc: DataConfig, step: int, frontend_dim: int) -> dict:
    """Frames + per-position labels for the encoder-only (audio) arch."""
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, 0xE0C0]))
    b, s, v = dc.global_batch, dc.seq_len, dc.vocab_size
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    # frames carry their label in a noisy linear code -> learnable
    code = rng.standard_normal((v, frontend_dim)).astype(np.float32)
    frames = code[labels] + 0.1 * rng.standard_normal(
        (b, s, frontend_dim)).astype(np.float32)
    return {"frames": frames, "labels": labels}


__all__ = ["DataConfig", "batch_at", "host_slice", "encoder_batch_at"]
