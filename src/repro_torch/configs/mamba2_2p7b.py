"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,                    # attention-free
    num_kv_heads=0,
    d_ff=0,                         # Mamba blocks have no separate FFN
    vocab_size=50_280,
    rope="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=128),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
