"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.

12L enc + 12L dec, d_model=1024 16H (GQA kv=16 = MHA) d_ff=4096
vocab=256206 (padded to 256256 for TP divisibility). [arXiv:2308.11596; hf]
Audio frontend is a STUB: input_specs() supplies pre-computed frame
embeddings to the encoder.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    enc_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=256206,
    attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=64),
    activation="gelu",       # classic (ungated) transformer FFN
    norm="layernorm",
    tie_embeddings=True,
    embed_scale=True,
    frontend="audio",
)
