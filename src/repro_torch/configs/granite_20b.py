"""granite-20b [dense]: llama-arch code model, MQA.

52L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576 vocab=49152.
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    d_ff=24576,
    vocab_size=49152,
    attn=AttnConfig(num_heads=48, num_kv_heads=1, head_dim=128),
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
    fsdp=True,
)
