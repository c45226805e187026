"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, pattern
(rec, rec, attn) -- 1 attention per 2 recurrent blocks.
[arXiv:2402.19427; hf]"""

from repro_torch.models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,                 # MQA in the attention blocks
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    rope="rope",
    sliding_window=2048,            # local attention -> sub-quadratic
    rglru=RGLRUConfig(lru_width=2560, conv_width=4,
                      block_pattern=("rec", "rec", "attn")),
    tie_embeddings=True,            # Gemma family ties in/out embeddings
    scan_layers=False,              # heterogeneous pattern: period-scanned
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
