"""Serving steps: prefill + decode (port of ``repro/serve/decode.py``).

``make_serve_step`` builds the one-token decode step
(params, caches, tokens, pos) -> (next_token_logits, caches); sampling
(greedy / temperature) happens on top, so one step serves both.  The
reference's ``lax.scan`` over decode steps is a Python loop here, and the
caches are written in place.  Every family with a decode step serves
through these (dense, MoE, SSM, hybrid, vlm).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

PAD_LOGIT = -1e30


def make_prefill(cfg: ModelConfig, *, cache_len: int, chunk: int = 512):
    def prefill(params, batch):
        logits, caches, _ = lm.forward(params, batch, cfg, mode="prefill",
                                       chunk=chunk, cache_len=cache_len)
        return logits[:, -1:, :], caches

    return prefill


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens_t, position, rows=None):
        return lm.decode_step(params, tokens_t, caches, position, cfg,
                              rows=rows)

    return serve_step


class GraphedDecodeStep:
    """``lm.decode_step`` over fixed caches (any family's cache tree),
    captured once as a CUDA graph and replayed: the port's counterpart of
    the reference server's ``jax.jit`` of the step, which the host would
    otherwise pay for in thousands of kernel launches a token.

    The graph reads three static buffers: the tokens [B, 1], the position
    (one int64) and the row mask [B] of the slots whose cache it writes.  A
    call checks the position on the host, copies them in, replays and
    returns the graph's own logits [B, 1, V_pad], overwritten by the next
    call.  Capture runs the step on a side stream first with every row
    masked (the caches keep their own values), as CUDA graphs need.

    A windowed cache that is not a ring (shorter than the window, as a
    prefill shorter than the window leaves it) is refused with
    ``CachePositionError`` before anything is captured: inside the graph no
    host code sees the index the step writes.
    """

    def __init__(self, params: dict, caches, cfg: ModelConfig):
        self.params, self.caches, self.cfg = params, caches, cfg
        s_max = lm.attention_cache_len(caches)
        if s_max is not None and cfg.sliding_window is not None \
                and not attn_mod.is_ring(cfg, s_max):
            raise attn_mod.CachePositionError(
                f"{cfg.name}: a cache of {s_max} slots under a window of "
                f"{cfg.sliding_window} is not a ring buffer; a graphed step "
                f"could write past it unchecked")
        _, leaf, batch_dim = lm.cache_leaves(caches)[0]
        self.batch, dev = leaf.shape[batch_dim], leaf.device
        self.tokens = torch.zeros((self.batch, 1), dtype=torch.int32,
                                  device=dev)
        self.position = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.rows = torch.zeros((self.batch,), dtype=torch.bool, device=dev)
        self.graph = None
        self.logits = None

    def _step(self):
        return lm.decode_step(self.params, self.tokens, self.caches,
                              self.position, self.cfg, rows=self.rows)[0]

    def _capture(self):
        self.rows.zero_()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = self._step()

    def __call__(self, tokens_t: torch.Tensor, position: int,
                 rows=None) -> torch.Tensor:
        position = int(position)
        lm.check_position(self.cfg, self.caches, position)
        if self.graph is None:
            self._capture()
        mask = torch.ones(self.batch, dtype=torch.bool)
        if rows is not None:
            mask[:] = False
            mask[list(rows)] = True
        self.tokens.copy_(tokens_t)
        self.position.fill_(position)
        self.rows.copy_(mask)
        self.graph.replay()
        return self.logits


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0,
           vocab_size: Optional[int] = None) -> torch.Tensor:
    """logits [B, 1, V_pad] -> tokens [B, 1] int32.  The padded ids (past
    ``vocab_size``) are set to -1e30 first, so none is ever returned.
    t = 0 -> greedy (argmax); otherwise a Gumbel-max draw from
    ``softmax(logits / t)`` with uniforms from ``generator``."""
    if vocab_size is not None and logits.shape[-1] > vocab_size:
        logits = logits.clone()
        logits[..., vocab_size:] = PAD_LOGIT
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits / temperature + gumbel,
                        dim=-1).to(torch.int32)


def generate(params, cfg: ModelConfig, prompt_tokens: torch.Tensor, *,
             max_new_tokens: int, temperature: float = 0.0, seed: int = 0,
             chunk: int = 256, eos_id: Optional[int] = None):
    """Batched generation (greedy / temperature): prompt_tokens [B, S0]
    ints -> [B, S0 + max_new_tokens] int32.  Once a row emits ``eos_id``
    it emits ``eos_id`` to the end."""
    b, s0 = prompt_tokens.shape
    total = s0 + max_new_tokens
    dev = prompt_tokens.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    logits, caches, _ = lm.forward(params, {"tokens": prompt_tokens}, cfg,
                                   mode="prefill", chunk=chunk,
                                   cache_len=total)
    tok = sample(logits[:, -1:, :], gen, temperature, cfg.vocab_size)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = []
    for t in range(s0, total):
        if eos_id is not None:
            done = done | (tok[:, 0] == eos_id)
        out.append(tok)
        if t == total - 1:
            break                    # the last step's token is not emitted
        lg, caches = lm.decode_step(params, tok, caches, t, cfg)
        tok = sample(lg, gen, temperature, cfg.vocab_size)
        if eos_id is not None:
            tok = torch.where(done[:, None], eos_id, tok)
    return torch.cat([prompt_tokens.to(torch.int32)] + out, dim=1)


__all__ = ["make_prefill", "make_serve_step", "GraphedDecodeStep", "sample",
           "generate"]
