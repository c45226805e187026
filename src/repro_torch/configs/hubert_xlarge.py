"""hubert-xlarge [audio]: encoder-only transformer (wav2vec2 backbone);
bidirectional attention, no decode step.  The conv waveform frontend is a
STUB: ``input_specs`` provides precomputed 512-d acoustic frames.
[arXiv:2106.07447; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,                # MHA
    d_ff=5120,
    vocab_size=504,                 # target cluster inventory
    head_dim=80,
    rope="none",                    # conv/learned positions in the original
    causal=False,                   # encoder-only
    frontend="frame",
    frontend_dim=512,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
