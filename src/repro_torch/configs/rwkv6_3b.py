"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent decay.

32L d_model=2560 (attn-free) d_ff=8960 vocab=65536. [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    attn=None,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    norm="layernorm",
    tie_embeddings=False,
)
