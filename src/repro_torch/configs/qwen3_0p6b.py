"""qwen3-0.6b [dense]: GQA kv=8 with per-head q/k RMS normalization.
[hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151_936,
    head_dim=128,                   # decoupled from d_model (Qwen3 style)
    rope="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
