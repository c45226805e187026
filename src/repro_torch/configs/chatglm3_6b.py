"""chatglm3-6b [dense]: GQA kv=2, 2-D (partial) RoPE.
[arXiv:2406.12793; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13_696,
    vocab_size=65_024,
    head_dim=128,
    rope="rope2d",                  # rotary on half the head dim
    attn_bias=True,                 # ChatGLM uses qkv bias
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
