"""deepseek-moe-16b [moe]: fine-grained experts, 2 shared + 64 routed
top-6.  [arXiv:2401.06066; hf]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,                # MHA
    d_ff=1408,                      # expert hidden width
    vocab_size=102_400,
    head_dim=128,
    rope="rope",
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  capacity_factor=1.25),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
