"""command-r-35b [dense]: GQA kv=8, no biases anywhere.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_528,
    vocab_size=256_000,
    head_dim=128,
    rope="rope",
    attn_bias=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
