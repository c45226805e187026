"""Continuous batching for the LM serving path (port of
``repro/serve/batching.py``).

A fixed pool of B slots; requests join free slots, are prefilled into their
slot's region of the batched KV cache, all active slots at one position
decode as one ``decode_step`` call, and requests leave on EOS /
max-new-tokens.  Per-slot bookkeeping (positions, last token) lives on the
host; the device state is the batched cache, allocated once at
[L, B, max_len] so slot churn never reallocates device memory.

The reference's decode step returns new caches and the server merges one
slot's rows back; here the step writes the cache in place, for the calling
group's slots only (``rows``), so a call at one group's position never
touches another slot's cache.  Every row is still computed as the
reference computes it (its new K/V column in place, its new recurrent
state), which matters where the rows of a call are coupled: an MoE layer's
capacity is shared by every row of the call.  Admission resets every leaf
of the slot's own slice.  Dense, MoE, SSM, hybrid and vision-language
stacks are served (the latter over token prompts, its M-RoPE ``t``
continuing after the patch grid as in the reference); a period-scanned
hybrid and an encoder-only config are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.decode import GraphedDecodeStep, sample


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [S0] int32
    max_new_tokens: int
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Synchronous continuous-batching engine over ``decode_step``.

    On the card the step is captured once as a CUDA graph
    (``GraphedDecodeStep``, as the reference jits it); on the host it runs
    eagerly."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_len: int, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0, device=None):
        lm.check_supported(cfg)
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        if cfg.use_period_scan:
            raise NotImplementedError(
                "BatchedServer does not serve period-scanned hybrids (as "
                "the reference's slot merge does not); use "
                "serve.decode.generate for them")
        self.params = params
        self.cfg = cfg
        self.b = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.caches = lm.init_caches(cfg, batch_slots, max_len,
                                     device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int64)
        self.slot_tok = np.zeros((batch_slots, 1), np.int32)
        self.queue: list[Request] = []
        # batch_occupancy is a bounded histogram view
        self.stats = obs_metrics.get_registry().stats_view(
            "serve.decode", {"ticks": 0, "tokens_out": 0,
                             "batch_occupancy": []})
        if self.device.type == "cuda":
            step = GraphedDecodeStep(params, self.caches, cfg)
            self._decode = lambda p, c, t, pos, rows: (step(t, pos, rows), c)
        else:
            self._decode = lambda p, c, t, pos, rows: lm.decode_step(
                p, t, c, pos, cfg, rows=rows)

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.b):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                self._reset_slot(slot)
                self._prefill_slot(slot, req)

    def _reset_slot(self, slot: int):
        """Empty the slot's own slice of every leaf of every layer's cache
        (positions -1, everything else 0), as ``init_caches`` makes it."""
        for name, leaf, batch_dim in lm.cache_leaves(self.caches):
            leaf.select(batch_dim, slot).fill_(-1 if name == "pos" else 0)

    def _tokens(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _prefill_slot(self, slot: int, req: Request):
        """Token-by-token prefill through the decode step (one function for
        the whole engine), writing the slot's rows only."""
        for i, tok in enumerate(req.prompt[:-1]):
            t = self._tokens(np.full((self.b, 1), tok, np.int32))
            self._decode(self.params, self.caches, t, i, [slot])
        self.slot_pos[slot] = len(req.prompt) - 1
        self.slot_tok[slot, 0] = int(req.prompt[-1])

    # -- one decode tick -----------------------------------------------------
    def step(self) -> list[Request]:
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return []
        self.stats["ticks"] += 1
        self.stats["batch_occupancy"].append(len(active) / self.b)
        finished = []
        # group slots by position so each group is one batched device call
        pos_groups: dict[int, list[int]] = {}
        for s in active:
            pos_groups.setdefault(int(self.slot_pos[s]), []).append(s)
        for pos, slots in sorted(pos_groups.items()):
            toks = self._tokens(self.slot_tok)
            logits, _ = self._decode(self.params, self.caches, toks, pos,
                                     slots)
            for s in slots:
                nxt = int(sample(logits[s:s + 1], self.generator,
                                 self.temperature, self.cfg.vocab_size)[0, 0])
                req = self.slot_req[s]
                req.output.append(nxt)
                self.stats["tokens_out"] += 1
                self.slot_tok[s, 0] = nxt
                self.slot_pos[s] += 1
                if ((self.eos_id is not None and nxt == self.eos_id)
                        or len(req.output) >= req.max_new_tokens
                        or self.slot_pos[s] >= self.max_len - 1):
                    req.done = True
                    finished.append(req)
                    self.slot_req[s] = None
        return finished

    def run(self) -> list[Request]:
        done = []
        while self.queue or any(r is not None for r in self.slot_req):
            done.extend(self.step())
        return done


# GEEDeltaServer lives in repro_torch.search.service, next to the query
# service it composes with; this re-export mirrors the reference's.
from repro_torch.search.service import GEEDeltaServer  # noqa: E402,F401

__all__ = ["Request", "BatchedServer", "GEEDeltaServer"]
