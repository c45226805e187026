"""Abstract input and state specs (port of ``repro/launch/specs.py``).

``train_input_specs(cfg, shape)`` returns ``meta``-device stand-ins for
every model input of an (architecture x assigned-shape) cell: the shapes
and dtypes, zero bytes allocated.  ``sharding.batch_shardings`` and
``param_shardings`` read them as they read real tensors.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

I32 = torch.int32
META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "frame":
        return {"frames": _meta((b, s, cfg.frontend_dim), torch.bfloat16),
                "labels": _meta((b, s), I32)}
    batch = {"tokens": _meta((b, s - cfg.frontend_tokens
                              if cfg.frontend == "patch" else s), I32)}
    if cfg.frontend == "patch":
        batch["patches"] = _meta((b, cfg.frontend_tokens, cfg.frontend_dim),
                                 torch.bfloat16)
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return train_input_specs(cfg, shape)


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """-> (caches, tokens_t, position), on ``meta``.  The KV cache covers
    ``shape.seq_len`` positions (the windowed/SSM archs keep
    O(window)/O(1) state instead)."""
    b, s = shape.global_batch, shape.seq_len
    caches = lm.init_caches(cfg, b, s, device=META)
    return caches, _meta((b, 1), I32), _meta((), I32)


def abstract_params(cfg: ModelConfig) -> dict:
    return lm.abstract_params(cfg)


def param_bytes(tree) -> int:
    """Bytes of every leaf of a tree of tensors (``meta`` ones too)."""
    from repro_torch.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


__all__ = ["train_input_specs", "prefill_input_specs", "decode_input_specs",
           "abstract_params", "param_bytes"]
