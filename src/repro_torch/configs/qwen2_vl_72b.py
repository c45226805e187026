"""qwen2-vl-72b [vlm]: M-RoPE (t/h/w sections), dynamic resolution.
The vision tower is a STUB per the assignment: ``input_specs`` provides 256
precomputed patch embeddings of width 1176 (= 2x2x3x14x14 pixel-patch dim),
linearly projected and prepended to the text stream.
[arXiv:2409.12191; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    head_dim=128,
    rope="mrope",
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_dim=1176,
    frontend_tokens=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="dots",
)
