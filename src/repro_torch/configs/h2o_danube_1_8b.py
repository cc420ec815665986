"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8, head_dim=80) d_ff=6912 vocab=32000, SWA 4096.
[arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    d_ff=6912,
    vocab_size=32000,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=80, window=4096),
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)
