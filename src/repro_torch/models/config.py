"""Model configuration system for the architecture zoo (port of
``repro/models/config.py``, copied: plain dataclasses, no tensors).

One ``ModelConfig`` describes any of the 10 assigned architectures (dense /
MoE / SSM / hybrid / VLM / audio).  ``reduced()`` produces the small-but-
same-family config used by the CPU tests; the port serves the full
``qwen3-0.6b`` on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int               # hidden width of each routed expert
    num_shared: int = 0         # shared (always-on) experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3

    def scaled(self, experts: int, d_expert: int) -> "MoEConfig":
        return dataclasses.replace(
            self, num_experts=experts,
            top_k=min(self.top_k, experts), d_expert=d_expert)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128        # N in SSD
    head_dim: int = 64          # P in SSD
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128            # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0          # 0 -> d_model
    conv_width: int = 4
    c_exponent: float = 8.0     # Griffin's fixed `c` in a_t = a^(c r_t)
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int               # 0 for attention-free families
    num_kv_heads: int
    d_ff: int                    # dense FFN width (0 for ssm)
    vocab_size: int

    head_dim: int = 0            # 0 -> d_model // num_heads
    rope: str = "rope"           # none | rope | rope2d | mrope
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: Optional[int] = None   # local attention width
    causal: bool = True                    # False -> encoder-only
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    frontend: str = "none"       # none | patch | frame
    frontend_dim: int = 0        # stub embedding width for patch/frame
    frontend_tokens: int = 0     # patch tokens prepended (vlm only)

    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"          # none | full | dots
    scan_layers: bool = True     # False for hybrid pattern models
    vocab_round: int = 256       # physical vocab padding multiple

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab_size, self.vocab_round)

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Mixer type per layer."""
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.family == "hybrid":
            assert self.rglru is not None
            pat = self.rglru.block_pattern
            full = pat * math.ceil(self.num_layers / len(pat))
            return tuple(full[: self.num_layers])
        return ("attn",) * self.num_layers

    @property
    def period_info(self):
        """Hybrid pattern periodicity: (period, n_periods, tail)."""
        if self.family != "hybrid" or self.rglru is None:
            return None
        p = self.rglru.block_pattern
        n = self.num_layers // len(p)
        tail = self.layer_pattern[n * len(p):]
        return p, n, tail

    @property
    def use_period_scan(self) -> bool:
        """Scan over pattern periods (HLO stays one-period-sized).  Without
        this the 26-layer hybrid unrolls fully and SPMD compile time
        explodes (>8 min/cell measured)."""
        info = self.period_info
        return info is not None and info[1] >= 2

    @property
    def has_decode(self) -> bool:
        return self.causal          # encoder-only models have no decode step

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM / sliding-window hybrid)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Total parameter count (analytic; excludes vocab padding)."""
        d, l, v = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d                          # tok embedding
        if not self.tie_embeddings and self.vocab_size:
            total += d * v                     # lm head
        if self.frontend != "none":
            total += self.frontend_dim * d
        per_layer = 0
        counts = {"attn": 0, "ssm": 0, "rec": 0}
        for t in self.layer_pattern:
            counts[t] += 1
        # attention mixers
        qkv = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
        attn = qkv + self.num_heads * hd * d
        per_layer += counts["attn"] * (attn + 2 * d)      # + ln scales
        # ssm mixers
        if self.ssm is not None:
            s = self.ssm
            din = s.expand * d
            nh = din // s.head_dim
            ssm = (d * (2 * din + 2 * s.state_dim + nh)   # in_proj
                   + s.conv_width * (din + 2 * s.state_dim)
                   + 2 * nh                               # A_log, D
                   + din * d + din)                       # out_proj + norm
            per_layer += counts["ssm"] * (ssm + d)
        # recurrent mixers
        if self.rglru is not None:
            w = self.rglru.lru_width or d
            rec = (d * 2 * w + self.rglru.conv_width * w + 4 * w  # gates
                   + w * d + d)
            per_layer += counts["rec"] * rec
        # FFN
        if self.moe is not None:
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_expert
            shared = m.num_shared * 3 * d * m.d_expert
            router = d * m.num_experts
            total += l * (routed + shared + router + d)
        elif self.d_ff:
            ffn_layers = counts["attn"] + counts["rec"]
            total += ffn_layers * (3 * d * self.d_ff + d)
        total += per_layer
        total += d                                        # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return int(self.param_count() - self.num_layers * inactive)

    # ---- reduced config for CPU smoke tests ----
    def reduced(self) -> "ModelConfig":
        """Same family/features, tiny dims: runs a real step on CPU."""
        changes: dict = dict(
            num_layers=min(self.num_layers, 4 if self.family == "hybrid"
                           else 2),
            d_model=64,
            num_heads=min(self.num_heads, 4) or 0,
            num_kv_heads=min(self.num_kv_heads, 2) or 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256),
            head_dim=16 if self.num_heads else 0,
            sliding_window=8 if self.sliding_window else None,
            vocab_round=32,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )
        if self.moe is not None:
            # capacity_factor high enough to be drop-free: keeps the smoke
            # tests' decode == forward equivalence exact (capacity dropping
            # is batch-size-dependent by design).
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=min(self.moe.top_k, 2),
                d_expert=32, capacity_factor=8.0,
                num_shared=min(self.moe.num_shared, 1))
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=16)
        if self.rglru is not None:
            changes["rglru"] = dataclasses.replace(self.rglru, lru_width=64)
        if self.frontend != "none":
            changes["frontend_dim"] = 32
            changes["frontend_tokens"] = min(self.frontend_tokens, 4)
        return dataclasses.replace(self, **changes)
