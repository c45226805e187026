"""granite-3-8b [dense]: GQA kv=8.  Note the vocab (49,155) is not
divisible by the 16x16 mesh -- the physical embedding is padded to
vocab_round (49,408), exercising the framework's vocab-padding path.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12_800,
    vocab_size=49_155,
    head_dim=128,
    rope="rope",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
