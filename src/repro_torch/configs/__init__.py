"""Architecture registry + assigned input shapes (port of
``repro/configs/__init__.py``; the ten config modules are copied as data).

``get_config(name)`` returns the full published config; every arch also
responds to ``get_config(name).reduced()`` for CPU smoke tests.

The four assigned input shapes (LM-family):
  train_4k     seq 4096,   global batch 256   (train_step)
  prefill_32k  seq 32768,  global batch 32    (prefill forward)
  decode_32k   1 new token, KV cache 32768, batch 128  (serve_step)
  long_500k    1 new token, context 524288, batch 1    (serve_step,
               sub-quadratic archs only)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-2.7b": "mamba2_2p7b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-0.6b": "qwen3_0p6b",
    "command-r-35b": "command_r_35b",
    "granite-3-8b": "granite_3_8b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCH_NAMES = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def get_config(name: str) -> ModelConfig:
    key = name.lower()
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Implements the assignment's skip rules.  -> (runnable, reason)."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch: no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention: 500k context skipped"
    return True, ""


def all_cells():
    """Yield (arch_name, shape_name, runnable, reason) for all 40 cells."""
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, reason = cell_is_runnable(cfg, shape)
            yield arch, sname, ok, reason
