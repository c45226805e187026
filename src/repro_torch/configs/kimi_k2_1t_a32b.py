"""kimi-k2-1t-a32b [moe]: trillion-parameter MoE, 384 experts top-8,
one shared expert.  [arXiv:2501.kimi2; unverified paper-table]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,                      # expert hidden width (spec's d_ff)
    vocab_size=163_840,
    head_dim=128,
    rope="rope",
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048, num_shared=1,
                  capacity_factor=1.25),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",                   # 1T params: remat to fit activations
)
